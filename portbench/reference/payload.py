"""The bytes of the file traffic: a pool drawn from the seed, and stamps.

A call writes ``call_bytes`` taken from the pool at an offset fixed by the
writer, with the first 16 bytes of every shard-sized piece replaced by a
stamp (seed, writer and piece, file, call), so no two calls, files or
writers carry the same bytes and a misplaced piece cannot read back right.
The harness writes exactly what ``call_bytes_of`` returns.
"""

from __future__ import annotations

import numpy as np
import torch

STAMP_BYTES = 16


def make_pool(seed: int, nbytes: int, device) -> np.ndarray:
    """``nbytes`` uniform bytes drawn on ``device`` from ``seed`` in one
    call, returned on the host."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    pool = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=g,
                         device=device)
    return pool.cpu().numpy()


def pool_bytes(call_bytes: int, piece_bytes: int, writers: int) -> int:
    return call_bytes + writers * 5 * piece_bytes


def base_of(pool: np.ndarray, writer: int, call_bytes: int,
            piece_bytes: int) -> np.ndarray:
    """The writer's unstamped call bytes (a view of the pool)."""
    off = writer * 5 * piece_bytes
    return pool[off:off + call_bytes]


def stamp(buf: np.ndarray, seed: int, writer: int, file_no: int,
          call_no: int, piece_bytes: int) -> None:
    """Stamp every piece of ``buf`` (a writable uint8 array) in place."""
    pieces = buf.reshape(-1, piece_bytes)
    n = pieces.shape[0]
    words = np.empty((n, 4), dtype=np.uint32)
    words[:, 0] = int(seed) & 0xFFFFFFFF
    words[:, 1] = (writer << 16) | np.arange(n, dtype=np.uint32)
    words[:, 2] = file_no
    words[:, 3] = call_no
    pieces[:, :STAMP_BYTES] = words.view(np.uint8)


def call_bytes_of(pool: np.ndarray, seed: int, writer: int, file_no: int,
                  call_no: int, call_bytes: int,
                  piece_bytes: int) -> np.ndarray:
    """What call ``call_no`` of file ``file_no`` of ``writer`` writes."""
    buf = base_of(pool, writer, call_bytes, piece_bytes).copy()
    stamp(buf, seed, writer, file_no, call_no, piece_bytes)
    return buf
