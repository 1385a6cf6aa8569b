"""The FUSE client: the operation table (``ops``) and its libfuse 2.9
binding (``mount``). The port's own copy of ``tpu3fs/fuse``, with the same
exports."""

from tpu3fs_torch.fuse.ops import FuseOps, VIRT_DIR

__all__ = ["FuseOps", "VIRT_DIR"]
