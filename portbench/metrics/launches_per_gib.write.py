"""Kernel launches (tpu3fs_torch.kernels.counts()) over the window per
acknowledged GiB."""

from portbench.readers import per_gib


def read(rec):
    return per_gib(rec, "launches")
