"""File metadata over the KV store (``types``, ``store``, ``scan``,
``distributor``): the port's own copies of ``tpu3fs/meta/``."""

from tpu3fs_torch.meta.types import (  # noqa: F401
    Acl,
    DirEntry,
    Inode,
    InodeType,
    Layout,
    ROOT_INODE_ID,
)
from tpu3fs_torch.meta.store import MetaStore, OpenFlags  # noqa: F401
