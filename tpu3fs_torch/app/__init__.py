"""The service-binary skeleton: the port's own copy of
``tpu3fs/app/application.py``. Every app takes a keyword ``device`` (or
the ``--device`` flag), which resolves to ``cuda`` unless the caller asks
for another device."""

from tpu3fs_torch.app.application import (
    AppInfo,
    ApplicationBase,
    OnePhaseApplication,
    TwoPhaseApplication,
)

__all__ = [
    "AppInfo",
    "ApplicationBase",
    "OnePhaseApplication",
    "TwoPhaseApplication",
]
