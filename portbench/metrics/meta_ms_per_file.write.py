"""Metadata time a file: the harness's spans around each file's create and
close in the window, summed, over the files created, ms."""


def read(rec):
    created = [s for s in rec.spans if s[0] == "meta.create"]
    closed = [s for s in rec.spans if s[0] == "meta.close"]
    if not created:
        return None
    return sum(s[2] - s[1] for s in created + closed) / 1e6 / len(created)
