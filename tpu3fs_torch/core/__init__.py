"""Users and tokens: the port's own copy of ``tpu3fs/core/user.py``
(``UserStore``, the TTL ``AclCache``)."""

from tpu3fs_torch.core.user import AclCache, UserRecord, UserStore

__all__ = ["AclCache", "UserRecord", "UserStore"]
