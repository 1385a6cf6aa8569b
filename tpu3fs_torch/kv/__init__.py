"""The transactional KV interface and its in-memory engine (``kv``,
``mem``): the port's own copies of those modules of ``tpu3fs/kv/``. The
remote, replicated and served engines need the RPC transport and are not
ported (ROADMAP M6a)."""

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction  # noqa: F401
from tpu3fs_torch.kv.mem import MemKVEngine  # noqa: F401
