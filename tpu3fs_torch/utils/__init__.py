"""Host utilities (``result``, ``config``, ``fault_injection``, ``trash``):
the port's own copies of the modules of ``tpu3fs/utils/`` that the storage
tier and the checkpoint retention import."""

from tpu3fs_torch.utils.result import (  # noqa: F401
    Code,
    FsError,
    Result,
    Status,
    make_error,
)
from tpu3fs_torch.utils.config import Config, ConfigItem  # noqa: F401
