"""The storage tier on one device: the port's own copies of
``tpu3fs/storage/`` types, engines (``engine``: mem; ``native_engine``:
the C++ engine on disk), target, update worker, CRAQ service, CR resync,
EC rebuild, the maintenance workers (``workers``) and the C++ transport's
fast-path registries (``native_fastpath``). ``ici_chain`` (ROADMAP M8)
is not ported."""

from tpu3fs_torch.storage.types import ChunkId, ChunkMeta, UpdateType  # noqa: F401
from tpu3fs_torch.storage.engine import MemChunkEngine, ChunkEngine  # noqa: F401
from tpu3fs_torch.storage.target import StorageTarget  # noqa: F401
from tpu3fs_torch.storage.craq import StorageService, WriteReq, ReadReq  # noqa: F401
