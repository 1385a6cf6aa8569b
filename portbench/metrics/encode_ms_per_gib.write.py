"""The client's wall around encode_parity (StorageClient.encode_cpu_s, copies
included) over the window, ms per acknowledged GiB."""

from portbench.readers import per_gib


def read(rec):
    seconds = per_gib(rec, "encode_s")
    return None if seconds is None else 1000.0 * seconds
