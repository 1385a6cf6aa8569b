"""The KV cache's read under get_blocks (PrefixBlockStore.stage_s
"fs_read": the cache's batch_get, the entries' stats and one striped batch
read through the client and the storage engines) over the window, ms per
GiB of pages landed."""

from portbench.readers import per_gib


def read(rec):
    seconds = per_gib(rec, "fs_read_s")
    return None if seconds is None else 1000.0 * seconds
