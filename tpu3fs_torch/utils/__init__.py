"""Host utilities (``result``, ``config``, ``fault_injection``, ``trash``,
``executor``, ``logging``, ``bufpool``): the port's own copies of the modules of
``tpu3fs/utils/`` that the storage tier, the checkpoint retention, the
loader's fetch workers and the readahead import."""

from tpu3fs_torch.utils.result import (  # noqa: F401
    Code,
    FsError,
    Result,
    Status,
    make_error,
)
from tpu3fs_torch.utils.config import Config, ConfigItem  # noqa: F401
