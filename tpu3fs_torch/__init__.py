"""tpu3fs_torch: the tpu3fs stripe data plane in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The package mirrors ``tpu3fs/ops`` module for module (see ``ops/``) and is
bit-exact with it: RS(k, m) erasure coding and batched CRC32C. It imports
neither ``jax`` nor ``tpu3fs``. Importing it initialises no CUDA context and
builds nothing: the kernel library is built by ``kernels.library()`` on the
first launch.
"""
