"""The storage and file clients (``storage_client``, ``file_io``,
``hedging``, ``prefetch``, ``stubs``) and the in-memory storage double
(``inmem``): the port's own copies of ``tpu3fs/client/``."""

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
