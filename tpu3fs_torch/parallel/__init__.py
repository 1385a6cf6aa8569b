"""The multi-device data plane on ``torch.distributed``: the CRAQ chain
write as a send/recv ring, the pod-scale rebuild as all-gather plus RS
decode, and the partition shuffle as all-to-all.

Counterpart of ``tpu3fs/parallel/``. The JAX package ran one program over a
device mesh (``shard_map``); the port runs one process per device. Every
function here is called on every rank with that rank's LOCAL shard and
returns that rank's LOCAL result, which is what the ``shard_map`` bodies
compute. Importing the package initialises neither CUDA nor a process
group: the caller runs ``torch.distributed.init_process_group`` with the
backend ``backend_for(device)`` names (NCCL for the card, gloo for
``device="cpu"``).
"""

from tpu3fs_torch.parallel.chain import chain_replicate, chain_write_step  # noqa: F401
from tpu3fs_torch.parallel.mesh import backend_for, make_storage_mesh  # noqa: F401
from tpu3fs_torch.parallel.rebuild import rebuild_lost_shard  # noqa: F401
from tpu3fs_torch.parallel.shuffle import shuffle_partitions  # noqa: F401
