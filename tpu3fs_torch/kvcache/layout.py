"""On-disk layout shared by every kvcache module: shard paths, the array
wire format, the lease xattr.

One module owns the formats so the fs tier (cache.py), the host tier
(tier.py), the prefix-block store (blocks.py), the lease manager
(leases.py) and the GC can never drift apart on what an entry looks
like.

The port writes the bytes the JAX package writes, for every dtype that
package round-trips (bool, u1-u8, i1-i8, f2, f4, f8). ``encode_array``
also takes a ``torch.Tensor`` (copied to the host first). bfloat16 has no
numpy type: the JAX package writes an ``ml_dtypes.bfloat16`` page under
numpy's ``dtype.str`` for it, ``<V2``, and reads it back as a ``|V2``
void array. The port keeps that format: a ``torch.bfloat16`` tensor is
written under ``<V2`` with its raw bits, and a ``<V2`` entry decodes to
the same void array the JAX package returns (the element type is lost in
both). ``as_tensor`` reads a decoded page under the element type its
caller declares: a ``<V2`` page declared ``torch.bfloat16`` is a bfloat16
tensor over the same bits, and the bytes on disk stay the JAX package's.
"""

from __future__ import annotations

import hashlib
import struct
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpu3fs_torch.utils.result import Code
from tpu3fs_torch.utils.result import err as _err

_HEADER = struct.Struct("<8sII")  # dtype name, ndim, magic
#: Array-header magic. Its real job is STALENESS detection for cached
#: inodes: a content-addressed entry GC'd out from under a client-side
#: inode cache reads back as all zeros (removed chunks are holes), which
#: fails the magic check deterministically — the reader invalidates and
#: re-stats instead of serving zeros as KV state.
ARRAY_MAGIC = 0x4B564131  # "KVA1"
_DIM = struct.Struct("<Q")

#: xattr carrying a pin lease: b"<expire_ts> <owner>". GC skips entries
#: whose lease has not expired — an active decode can never lose its
#: prefix blocks to TTL or capacity eviction underneath it.
LEASE_XATTR = "kvcache.lease"


def shard_path(root: str, key: str) -> str:
    """Entry path: two hex levels (256x256 dirs) keep listings short at
    billions of entries."""
    h = hashlib.blake2b(key.encode(), digest_size=16).hexdigest()
    return f"{root}/{h[:2]}/{h[2:4]}/{h}"


# -- array wire format (decoder-layer KV tensors) ----------------------------

#: the header name of a bfloat16 page: numpy's ``dtype.str`` of
#: ``ml_dtypes.bfloat16``, which is what the JAX package writes
BF16_NAME = "<V2"


def _host_array(array) -> "tuple[np.ndarray, str]":
    """-> (host array, header dtype name). A tensor is copied to the host;
    a bfloat16 tensor travels as its raw 16-bit words under BF16_NAME."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16_NAME
        arr = t.numpy()
    else:
        arr = np.asarray(array)
    return arr, arr.dtype.str


def encode_array(array) -> bytes:
    """dtype+shape header then raw bytes: zero parsing beyond a 16-byte
    prefix, so inference servers can copy the payload to the card
    directly. ``array`` is anything ``np.asarray`` takes, or a tensor."""
    arr, dtype_name = _host_array(array)
    name = dtype_name.encode().ljust(8, b"\0")
    header = _HEADER.pack(name, arr.ndim, ARRAY_MAGIC)
    dims = b"".join(_DIM.pack(d) for d in arr.shape)
    return header + dims + arr.tobytes()


def decode_array(raw) -> np.ndarray:
    """Inverse of encode_array; `raw` may be a zero-copy transport view
    (the result is a frombuffer VIEW over it, no payload copy). Raises
    KVCACHE_STALE on an all-hole read (see ARRAY_MAGIC), KVCACHE_CORRUPT
    on any other malformed header."""
    if len(raw) < _HEADER.size:
        raise _err(Code.KVCACHE_CORRUPT, f"{len(raw)}-byte array entry")
    name, ndim, magic = _HEADER.unpack_from(raw, 0)
    if magic != ARRAY_MAGIC:
        if magic == 0 and name == b"\0" * 8:
            raise _err(Code.KVCACHE_STALE, "zero-hole read (entry GC'd)")
        raise _err(Code.KVCACHE_CORRUPT, f"bad magic {magic:#x}")
    off = _HEADER.size
    shape = tuple(
        _DIM.unpack_from(raw, off + i * _DIM.size)[0] for i in range(ndim)
    )
    off += ndim * _DIM.size
    try:
        dtype = np.dtype(name.rstrip(b"\0").decode())
    except (TypeError, UnicodeDecodeError) as e:
        raise _err(Code.KVCACHE_CORRUPT, f"dtype {name!r}: {e!r}")
    return np.frombuffer(raw, dtype=dtype, offset=off).reshape(shape)


def as_tensor(arr: np.ndarray, dtype=None) -> torch.Tensor:
    """A host tensor over a decoded page (a view, no copy) under the
    element type the caller declares. A ``<V2`` page has no element type
    of its own: declared ``torch.bfloat16`` its bits are bfloat16's, and
    undeclared it raises TypeError as ``torch.from_numpy`` does for any
    void array. A declared type that is not the page's raises INVALID_ARG.
    The view may lie over immutable read bytes, which torch warns about;
    it is only ever a copy's source."""
    void = arr.dtype.kind == "V"
    if void and dtype is not None:
        if dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise _err(Code.INVALID_ARG,
                       f"a {arr.dtype.str} page declared {dtype}")
        arr = arr.view(np.int16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if void:
        return t.view(torch.bfloat16)
    if dtype is not None and t.dtype != dtype:
        raise _err(Code.INVALID_ARG, f"a {t.dtype} page declared {dtype}")
    return t


def zero_hole(raw) -> bool:
    """True when a read came back as the all-zero hole a GC'd entry
    leaves behind — the cheap staleness probe for servers that relay raw
    entry bytes without decoding them (the serving host's serve-through
    path validates HERE before shipping to a peer: serving zeros-as-KV
    across the fleet is the one unforgivable outcome)."""
    if len(raw) < _HEADER.size:
        return False
    name, _, magic = _HEADER.unpack_from(raw, 0)
    return magic == 0 and name == b"\0" * 8


# -- lease encoding ----------------------------------------------------------

def encode_lease(expire_ts: float, owner: str) -> bytes:
    # repr round-trips exactly: unpin compares the decoded expiry against
    # the lease handle's to tell its own pin from a longer one stacked on
    # the same (content-addressed) entry
    return f"{expire_ts!r} {owner}".encode()


def decode_lease(raw: bytes) -> Tuple[float, str]:
    """-> (expire_ts, owner); a malformed value reads as expired."""
    try:
        ts_s, _, owner = bytes(raw).decode().partition(" ")
        return float(ts_s), owner
    except (ValueError, UnicodeDecodeError):
        return 0.0, ""


def lease_active(inode, now: Optional[float] = None) -> bool:
    """Whether an entry inode carries an unexpired pin lease. The lease
    rides the inode's xattrs, so every GC stat() already has it — the
    check costs no extra metadata round trip."""
    raw = getattr(inode, "xattrs", {}).get(LEASE_XATTR)
    if raw is None:
        return False
    expire_ts, _ = decode_lease(raw)
    return expire_ts > (time.time() if now is None else now)
