"""The hand-off of get_blocks into the pool (PrefixBlockStore.stage_s
"copy": the host's copies into the pinned staging, the copy engine's 2-D
copies into the slots, waited for) over the window, ms per GiB of pages
landed."""

from portbench.readers import per_gib


def read(rec):
    seconds = per_gib(rec, "h2d_s")
    return None if seconds is None else 1000.0 * seconds
