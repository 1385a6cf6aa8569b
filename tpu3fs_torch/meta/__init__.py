"""File metadata over the KV store (``types``, ``store``): the port's own
copies of those modules of ``tpu3fs/meta/``. ``scan`` and ``distributor``
are not ported (ROADMAP M6a)."""

from tpu3fs_torch.meta.types import (  # noqa: F401
    Acl,
    DirEntry,
    Inode,
    InodeType,
    Layout,
    ROOT_INODE_ID,
)
from tpu3fs_torch.meta.store import MetaStore, OpenFlags  # noqa: F401
