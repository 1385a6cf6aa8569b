"""Scale fabric: thousands of lightweight in-process nodes driving the
REAL control plane (docs/scale.md). The port's own copy of
``tpu3fs/scale/``: the placement solver runs on the fabric's device."""

from tpu3fs_torch.scale.fabric import ScaleConfig, ScaleFabric, ScaleNode

__all__ = ["ScaleConfig", "ScaleFabric", "ScaleNode"]
