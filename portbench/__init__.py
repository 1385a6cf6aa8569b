"""The benchmark of the PyTorch and CUDA port (``tpu3fs_torch``): one
harness, and every configuration, traffic mix, driver, per-layer metric and
kernel job in files of its own (README.md)."""
