from tpu3fs_torch.simple_example.service import (
    SIMPLE_EXAMPLE_SERVICE_ID,
    SimpleExampleApp,
    SimpleExampleService,
    bind_simple_example_service,
)

__all__ = [
    "SIMPLE_EXAMPLE_SERVICE_ID",
    "SimpleExampleApp",
    "SimpleExampleService",
    "bind_simple_example_service",
]
