"""Stripes the clients decoded (their ec.degraded_read counter) over the
stripes read in the window, %: that the cell really decodes."""


def read(rec):
    decoded = rec.counter("degraded_stripes")
    stripes = rec.done_bytes // rec.cell.config["chunk_size"]
    if decoded is None or stripes == 0:
        return None
    return 100.0 * decoded / stripes
