"""Seconds from the process's start to the window's start: torch and CUDA,
the cluster, the data, the warm-up."""


def read(rec):
    return rec.setup_s
