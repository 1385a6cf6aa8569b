"""The USRBIO shared-memory data plane: the port's own copy of
``tpu3fs/usrbio/`` (the ring ABI, the ring transport and its host, the
agent and the ``hf3fs_usrbio.h`` client API), with the same exports."""

from tpu3fs_torch.usrbio.ring import (  # noqa: F401
    Cqe,
    Iov,
    IoRing,
    Sqe,
    reap_stale_shm,
)
from tpu3fs_torch.usrbio.api import UsrbioClient  # noqa: F401
from tpu3fs_torch.usrbio.agent import UsrbioAgent  # noqa: F401
from tpu3fs_torch.usrbio.transport import (  # noqa: F401
    RING_METHODS,
    USRBIO_SERVICE_ID,
    RingClient,
)
from tpu3fs_torch.usrbio.server import (  # noqa: F401
    UsrbioRpcHost,
    bind_usrbio_service,
)
