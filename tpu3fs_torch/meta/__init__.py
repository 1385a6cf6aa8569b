"""File metadata over the KV store (``types``, ``store``, ``scan``): the
port's own copies of those modules of ``tpu3fs/meta/``. ``distributor`` is
not ported (ROADMAP M6a-2b)."""

from tpu3fs_torch.meta.types import (  # noqa: F401
    Acl,
    DirEntry,
    Inode,
    InodeType,
    Layout,
    ROOT_INODE_ID,
)
from tpu3fs_torch.meta.store import MetaStore, OpenFlags  # noqa: F401
