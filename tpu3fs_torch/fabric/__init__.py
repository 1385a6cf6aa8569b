"""The in-process cluster (``fabric``): the port's own copy of
``tpu3fs/fabric/``, on one device."""

from tpu3fs_torch.fabric.fabric import Fabric, SystemSetupConfig  # noqa: F401
