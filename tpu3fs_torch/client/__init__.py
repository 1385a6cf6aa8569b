"""The storage and file clients (``storage_client``, ``file_io``,
``hedging``, ``prefetch``, ``stubs``): the port's own copies of those
modules of ``tpu3fs/client/``. ``inmem`` is not ported (ROADMAP
M6a-2b)."""

from tpu3fs_torch.client.storage_client import (  # noqa: F401
    StorageClient,
    TargetSelectionMode,
    UpdateChannelAllocator,
)
from tpu3fs_torch.client.file_io import FileIoClient  # noqa: F401
from tpu3fs_torch.client.prefetch import (  # noqa: F401
    PrefetchConfig,
    ReadaheadPrefetcher,
)
