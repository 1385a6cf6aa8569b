"""tpu3fs_torch: the tpu3fs stripe data plane, multi-device data plane,
chain-table placement and storage tier in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The package mirrors ``tpu3fs`` module for module (``ops/``, ``parallel/``,
``placement/``, ``storage/`` and the host modules they need) and is
bit-exact with it: RS(k, m) erasure coding, batched CRC32C, the chain
ring's checksum, the placement annealer's tables, and a storage node's
replies and stored chunks, whose checksums run on the device. It imports
neither ``jax`` nor ``tpu3fs``. Importing it initialises no CUDA context
and builds nothing: the kernel library is built by ``kernels.library()``
on the first launch.
"""
