"""The storage and file clients (``storage_client``, ``file_io``,
``hedging``): the port's own copies of those modules of ``tpu3fs/client/``.
``prefetch``, ``inmem`` and ``stubs`` are not ported (ROADMAP M6c)."""

from tpu3fs_torch.client.storage_client import (  # noqa: F401
    StorageClient,
    TargetSelectionMode,
    UpdateChannelAllocator,
)
from tpu3fs_torch.client.file_io import FileIoClient  # noqa: F401
