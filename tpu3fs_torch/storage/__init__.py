"""The storage tier on one device: the port's own copies of
``tpu3fs/storage/`` types, engine (mem only), target, update worker, CRAQ
service, CR resync and EC rebuild. ``ici_chain``, ``native_engine``,
``native_fastpath`` and ``workers`` are not ported (ROADMAP M6b)."""

from tpu3fs_torch.storage.types import ChunkId, ChunkMeta, UpdateType  # noqa: F401
from tpu3fs_torch.storage.engine import MemChunkEngine, ChunkEngine  # noqa: F401
from tpu3fs_torch.storage.target import StorageTarget  # noqa: F401
from tpu3fs_torch.storage.craq import StorageService, WriteReq, ReadReq  # noqa: F401
