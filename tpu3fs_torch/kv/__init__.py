"""The transactional KV interface and its engines: the port's own copies of
``tpu3fs/kv/``. ``kv`` and ``mem`` are the interface and the in-memory MVCC
engine; ``service`` serves an engine as the Kv RPC service (the kvd, with
its write-ahead log); ``replica`` is the replicated kvd group (a Raft log
with quorum commit); ``remote`` holds the network engines a binary's
``--kv`` flag names."""

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction  # noqa: F401
from tpu3fs_torch.kv.mem import MemKVEngine  # noqa: F401
