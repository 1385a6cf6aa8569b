"""The transactional KV interface and its in-memory engine (``kv``,
``mem``), and the binaries' ``--kv`` flag (``remote.engine_from_flag``):
the port's own copies of those modules of ``tpu3fs/kv/``. The remote,
replicated and served engines are not ported yet (ROADMAP M6a-2b)."""

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction  # noqa: F401
from tpu3fs_torch.kv.mem import MemKVEngine  # noqa: F401
