"""CRC32C (Castagnoli): scalar gold, the GF(2) block/shift matrices, the
host composition helpers (``crc32c_combine``, ``crc32c_zeros``,
``crc32c_xor``: 32x32 matrix powers on scalars), and ``BatchCrc32c`` with
kernel K2.

Counterpart of ``tpu3fs/ops/crc32c.py``. The CRC register update is affine
over GF(2) in (state, message), so a row of N blocks of ``block`` bytes has

  crc(row) = const XOR  XOR_j Ks[j] @ raw(0, block_j),  Ks[j] = A_blk^(N-1-j)

where raw(0, .) is the register after the block from init 0 and A_blk
advances the register through ``block`` zero bytes. ``BatchCrc32c.__call__``
launches a CUDA kernel of ``csrc/crc32c.cu`` for a CUDA tensor: the
tensor-core one (raw = B^T . bits as a 1-bit ``mma``) where
``tensor_core_takes`` says so, the table walk otherwise; both then shift by
Ks[j] and XOR-reduce. It runs the plain version ``compute`` (two float32
matmuls over bit-planes, as the JAX codec's einsums) only for a tensor on
the CPU.

``crc32c_many`` checksums buffers of any lengths (the storage tier's chunk
checksums) with one ``BatchCrc32c`` call over front-padded rows;
``crc32c_pieces`` does so over fixed-size pieces of each buffer, so buffers
of very different lengths (a checkpoint's shards) are not all padded to
the longest.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from tpu3fs_torch import kernels
from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.ops.bitops import (
    np_bits_to_u32,
    np_mat2_mul,
    np_mat2_pow,
    np_u32_to_bits,
    pack_u32,
    u32_tensor,
    unpack_bits_last,
)

_POLY_REFLECTED = 0x82F63B78  # CRC32C, reflected form
_XOROUT = 0xFFFFFFFF
# rows of float32 bit-planes the plain version materialises at once
_PLAIN_CHUNK_BYTES = 1 << 28


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY_REFLECTED if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _make_table()


def _raw_update(state: int, data: bytes) -> int:
    """Advance the raw CRC register (no init/xorout) over data."""
    c = state & 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ int(_TABLE[(c ^ b) & 0xFF])
    return c


def crc32c_py(data: Union[bytes, bytearray, memoryview, np.ndarray],
              crc: int = 0) -> int:
    """Pure-Python CRC32C with standard init/xorout, chainable via ``crc``:
    the gold the kernel is held against."""
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    return _raw_update((crc & 0xFFFFFFFF) ^ _XOROUT, bytes(data)) ^ _XOROUT


def crc32c(data: Union[bytes, bytearray, memoryview, np.ndarray],
           crc: int = 0) -> int:
    """The port's scalar host CRC32C (``crc32c_py``): one shard's stored
    bytes, chainable via ``crc``."""
    return crc32c_py(data, crc)


@functools.lru_cache(maxsize=1)
def _byte_shift_matrix() -> np.ndarray:
    """A: 32x32 GF(2) matrix advancing the register through one zero byte."""
    A = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        A[:, i] = np_u32_to_bits(_raw_update(1 << i, b"\x00"))
    return A


@functools.lru_cache(maxsize=64)
def _shift_matrix_pow(nbytes: int) -> np.ndarray:
    """A^nbytes: advances the register through ``nbytes`` zero bytes."""
    return np_mat2_pow(_byte_shift_matrix(), nbytes)


def _shift(reg: int, nbytes: int) -> int:
    bits = _shift_matrix_pow(int(nbytes)) @ np_u32_to_bits(reg).astype(np.int64)
    return np_bits_to_u32(bits & 1)


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC of concat(A, B) given crc32c(A), crc32c(B) and len(B) in bytes.

    With F = 0xFFFFFFFF and S = A^len_b, crc(A||B) = S @ crc(A) XOR crc(B):
    the F terms cancel by linearity."""
    if len_b == 0:
        return crc_a
    return _shift(crc_a, len_b) ^ crc_b


@functools.lru_cache(maxsize=64)
def crc32c_zeros(length: int) -> int:
    """CRC32C of ``length`` zero bytes, cached per length: the register
    F = 0xFFFFFFFF shifted through ``length`` zero bytes, XOR F. A matrix
    power, so a shard-sized length costs no byte loop."""
    if length == 0:
        return 0
    return _shift(_XOROUT, length) ^ _XOROUT


def crc32c_xor(crc_a: int, crc_b: int, length: int) -> int:
    """CRC of A ^ B for equal-``length`` buffers given their CRCs.

    CRC32C with init/xorout F is affine over GF(2): crc(X) = L(X) ^
    f(length), L linear in the message bits, so crc(A ^ B) = crc(A) ^
    crc(B) ^ crc(zeros(length)). A chain-encode hop CRCs only its
    contribution and composes with this."""
    return crc_a ^ crc_b ^ crc32c_zeros(length)


@functools.lru_cache(maxsize=16)
def _block_matrix(blk: int) -> np.ndarray:
    """B^T, shape (8*blk, 32): message bits of a blk-byte block -> raw register.

    Column construction uses raw(0, e || 0^d) = A^d @ raw(0, e): start from the
    8 unit responses of the final byte and left-multiply by A per position.
    """
    A = _byte_shift_matrix()
    base = np.zeros((32, 8), dtype=np.uint8)  # columns: bits of last byte
    for t in range(8):
        base[:, t] = np_u32_to_bits(_raw_update(0, bytes([1 << t])))
    B = np.zeros((32, 8 * blk), dtype=np.uint8)
    cur = base
    for p in range(blk - 1, -1, -1):
        B[:, 8 * p : 8 * p + 8] = cur
        if p:
            cur = np_mat2_mul(A, cur)
    return np.ascontiguousarray(B.T)


def _shift_columns(ks: np.ndarray) -> np.ndarray:
    """(N, 32, 32) 0/1 shift matrices -> (N, 32) int32 holding the uint32
    columns (column t of Ks[j], bit o = Ks[j, o, t]), for the kernel."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    cols = (ks.astype(np.uint64) * weights[None, :, None]).sum(axis=1)
    return np.ascontiguousarray(cols.astype(np.uint32).view(np.int32))


# blocks the tensor-core kernel takes: B^T's fragments fit in shared memory
_MMA_MAX_BLOCK = 2048


def tensor_core_block(block: int) -> bool:
    """True when the tensor-core kernel takes rows of ``block``-byte blocks:
    a multiple of 32 bytes (whole 256-bit K-steps of 16-byte loads) up to
    2048 bytes."""
    return block % 32 == 0 and 32 <= block <= _MMA_MAX_BLOCK


def tensor_core_takes(block: int, data_ptr: int) -> bool:
    """``tensor_core_block`` and a 16-byte-aligned base."""
    return tensor_core_block(block) and data_ptr % 16 == 0


def _mma_fragments(b_t: np.ndarray) -> np.ndarray:
    """B^T (8*block, 32) 0/1 -> (steps, 32, 8) int32: the B operand of
    ``mma.m16n8k256.b1`` in the order ``csrc/crc32c.cu`` reads it.

    Message bit q = 1024c + 32w + b is bit b of little-endian word w of the
    block's 128-byte chunk c. Step s = 4c + u, lane 4g + t, slot 2n + h
    holds column 8n + g of B^T over word 4t + u + 16h of chunk c: lane t
    loads words 4t..4t+3 and 16+4t..16+4t+3 of each chunk, and step u takes
    word u of both loads. A partial last chunk is zero-padded."""
    nbits = b_t.shape[0]
    chunks = -(-nbits // 1024)
    bits = np.zeros((chunks * 1024, 32), dtype=np.uint64)
    bits[:nbits] = np.asarray(b_t, dtype=np.uint64) & 1
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.reshape(chunks, 32, 32, 32)
             * weights[None, None, :, None]).sum(axis=2)  # (c, w, column)
    c, u, g, t, n, h = np.ix_(*(np.arange(d) for d in (chunks, 4, 8, 4, 4, 2)))
    frags = words[c, 4 * t + u + 16 * h, 8 * n + g]  # (c, u, g, t, n, h)
    return np.ascontiguousarray(
        frags.reshape(chunks * 4, 32, 8).astype(np.uint32).view(np.int32))


def _check_rows(chunks: torch.Tensor, ks_cols: torch.Tensor, block: int):
    rows, size = chunks.shape
    if chunks.device.type != "cuda" or ks_cols.device != chunks.device:
        raise ValueError(f"chunks on {chunks.device}, shifts on {ks_cols.device}")
    if chunks.dtype != torch.uint8 or not chunks.is_contiguous():
        raise ValueError("crc32c_blocks takes contiguous uint8 rows")
    if size % block or ks_cols.shape != (size // block, 32):
        raise ValueError(f"size {size}, block {block}, shifts {ks_cols.shape}")
    return rows, size


def _filled(rows: int, const: int, device) -> torch.Tensor:
    signed = const - (1 << 32) if const >= 1 << 31 else const
    return torch.full((rows,), signed, dtype=torch.int32, device=device)


def crc32c_blocks(chunks: torch.Tensor, ks_cols: torch.Tensor,
                  frags: torch.Tensor, block: int, const: int) -> torch.Tensor:
    """Kernel K2 on a CUDA tensor: (rows, size) uint8 -> (rows,) uint32.

    The tensor-core kernel where ``tensor_core_takes`` says so (``frags``
    from ``_mma_fragments``), else ``crc32c_blocks_table``.
    ``crc32c_blocks.launches`` counts tensor-core launches."""
    if frags is None or not tensor_core_takes(block, chunks.data_ptr()):
        return crc32c_blocks_table(chunks, ks_cols, block, const)
    rows, size = _check_rows(chunks, ks_cols, block)
    if frags.device != chunks.device or frags.shape != (4 * -(-block // 128), 32, 8):
        raise ValueError(f"fragments {tuple(frags.shape)} on {frags.device}")
    out = _filled(rows, const, chunks.device)
    if rows:
        kernels.launch("tpu3fs_crc32c_mma", chunks.device, chunks, frags,
                       ks_cols, out, rows, size, block)
        kernels.count(crc32c_blocks)
    return out.view(torch.uint32)


crc32c_blocks.launches = 0


def crc32c_blocks_table(chunks: torch.Tensor, ks_cols: torch.Tensor,
                        block: int, const: int) -> torch.Tensor:
    """The table-walk kernel on a CUDA tensor, any block and alignment.
    ``crc32c_blocks_table.launches`` counts its launches."""
    rows, size = _check_rows(chunks, ks_cols, block)
    out = _filled(rows, const, chunks.device)
    if rows:
        kernels.launch("tpu3fs_crc32c_blocks", chunks.device, chunks, ks_cols,
                       out, rows, size, block)
        kernels.count(crc32c_blocks_table)
    return out.view(torch.uint32)


crc32c_blocks_table.launches = 0


class BatchCrc32c:
    """Batched CRC32C over fixed-size rows on one device.

    __call__(chunks: (batch, size) uint8) -> (batch,) torch.uint32, bit-exact
    with crc32c_py(). ``size`` must be a multiple of ``block`` (default 512).
    """

    def __init__(self, size: int, block: int = 512, device=None):
        if block <= 0 or size % block != 0:
            raise ValueError(f"size {size} not a multiple of block {block}")
        nblocks = size // block
        B_T = _block_matrix(block).astype(np.int8)  # (8*blk, 32)
        A_blk = _shift_matrix_pow(block)
        # K[j] = A_blk^(nblocks-1-j): shifts block j's register to the end.
        Ks = np.zeros((nblocks, 32, 32), dtype=np.int8)
        cur = np.eye(32, dtype=np.uint8)
        for j in range(nblocks - 1, -1, -1):
            Ks[j] = cur
            cur = np_mat2_mul(A_blk, cur)
        # init correction: the CRC of `size` zero bytes
        self._setup(B_T, Ks, np.uint32(crc32c_zeros(size)), device)

    @classmethod
    def from_arrays(cls, b_t: np.ndarray, ks: np.ndarray, const,
                    device=None) -> "BatchCrc32c":
        """Build from given state: B^T (8*block, 32), Ks (N, 32, 32), const."""
        self = cls.__new__(cls)
        self._setup(b_t, ks, const, device)
        return self

    def _setup(self, b_t, ks, const, device) -> None:
        self.device = resolve_device(device)
        self.block = b_t.shape[0] // 8
        self.nblocks = ks.shape[0]
        self.size = self.nblocks * self.block
        self._b_t = np.asarray(b_t, dtype=np.int8)
        self._ks = np.asarray(ks, dtype=np.int8)
        self._const = int(np.uint32(const))
        # plain-version operands (float32 0/1 is exact) and kernel operands
        self._b_t_f = torch.from_numpy(self._b_t).to(self.device, torch.float32)
        self._ks_f = torch.from_numpy(self._ks).to(self.device, torch.float32)
        self._ks_cols = torch.from_numpy(_shift_columns(self._ks)).to(self.device)
        self._frags = (torch.from_numpy(_mma_fragments(self._b_t)).to(self.device)
                       if tensor_core_block(self.block) else None)

    def compute(self, chunks: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version (the JAX codec's two einsums in float32).

        Exact: the first sum is at most 8 * block, the second 32 * N, both
        far below 2**24. Chunked along rows so the float expansion stays
        bounded. ``BatchCrc32c.compute.calls`` counts its calls."""
        kernels.count(BatchCrc32c.compute, "calls")
        batch = chunks.shape[0]
        regs_out = torch.empty((batch,), dtype=torch.int64, device=chunks.device)
        step = max(1, _PLAIN_CHUNK_BYTES // (self.size * 8 * 4))
        for r0 in range(0, batch, step):
            part = chunks[r0:r0 + step]
            blocks = part.reshape(part.shape[0], self.nblocks, self.block)
            bits = unpack_bits_last(blocks)  # (b, N, 8*blk) float32
            regs = torch.matmul(bits, self._b_t_f).to(torch.int64) & 1
            out_bits = torch.einsum(
                "jot,bjt->bo", self._ks_f, regs.to(torch.float32))
            regs_out[r0:r0 + step] = pack_u32(out_bits.to(torch.int64) & 1)
        return u32_tensor(regs_out ^ self._const)

    def __call__(self, chunks: torch.Tensor) -> torch.Tensor:
        if chunks.ndim != 2 or chunks.shape[1] != self.size:
            raise ValueError(f"chunks {tuple(chunks.shape)}, size {self.size}")
        if chunks.device.type == "cpu":
            return self.compute(chunks)
        return crc32c_blocks(chunks, self._ks_cols, self._frags, self.block,
                             self._const)


BatchCrc32c.compute.calls = 0

# crc32c_many's row codecs, one per (row size, device), shared by the
# storage tier's threads
_many_lock = threading.Lock()
_many_codecs: Dict[Tuple[int, torch.device], BatchCrc32c] = {}


def padded_row_size(n: int) -> int:
    """The row ``crc32c_many`` pads an n-byte buffer into: the next power
    of two, at least 512 bytes. Few sizes, so few cached codecs."""
    return max(512, 1 << (max(n, 1) - 1).bit_length())


def _row_codec(size: int, device: torch.device) -> BatchCrc32c:
    key = (size, device)
    with _many_lock:
        crc = _many_codecs.get(key)
        if crc is None:
            crc = BatchCrc32c(size, block=512, device=device)
            _many_codecs[key] = crc
        return crc


def _as_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    if isinstance(buf, memoryview) and not buf.contiguous:
        buf = buf.tobytes()
    return np.frombuffer(buf, dtype=np.uint8)


def crc32c_many(bufs: Sequence, device=None) -> List[int]:
    """CRC32C of each buffer (bytes-like or numpy, any lengths) with one K2
    launch on ``device`` (the plain version for the CPU).

    The CRC is affine: crc(x) = lin(x) ^ crc32c_zeros(len(x)), with lin the
    register advanced from 0, which leading zero bytes leave unchanged. So
    each buffer is zero-padded at the FRONT into a row of L bytes
    (``padded_row_size`` of the longest), the rows are checksummed in one
    ``BatchCrc32c`` call, and row r's CRC is XORed with crc32c_zeros(L) ^
    crc32c_zeros(len(x_r)) on the host."""
    dev = resolve_device(device)
    views = [_as_u8(b) for b in bufs]
    if not views:
        return []
    size = padded_row_size(max(v.size for v in views))
    rows = np.zeros((len(views), size), dtype=np.uint8)
    for row, v in zip(rows, views):
        if v.size:
            row[size - v.size:] = v
    crcs = _row_codec(size, dev)(torch.from_numpy(rows).to(dev))
    raw = crcs.view(torch.int32).cpu().numpy().view(np.uint32)
    pad = crc32c_zeros(size)
    return [int(c) ^ pad ^ crc32c_zeros(v.size) for c, v in zip(raw, views)]


#: the piece ``crc32c_pieces`` cuts buffers into: the default chunk size
PIECE_BYTES = 1 << 20


def combine_spans(crcs: Sequence[int], sizes: Sequence[int],
                  spans: Sequence[Tuple[int, int]]) -> List[int]:
    """Fold consecutive pieces into one CRC per span: span (lo, hi) is the
    CRC of pieces lo..hi-1 (CRCs ``crcs``, lengths ``sizes``) end to end,
    by ``crc32c_combine``. The write path's per-file sums and
    ``crc32c_pieces`` both fold this way."""
    out = []
    for lo, hi in spans:
        acc = 0
        for j in range(lo, hi):
            acc = crc32c_combine(acc, crcs[j], sizes[j])
        out.append(acc)
    return out


def crc32c_pieces(bufs: Sequence, device=None) -> List[int]:
    """CRC32C of each buffer with one ``crc32c_many`` call (one K2 launch)
    over its ``PIECE_BYTES`` slices, folded per buffer by
    ``combine_spans``. Rows are padded to the longest piece, not to the
    longest buffer."""
    views = [_as_u8(b) for b in bufs]
    parts, spans = [], []
    for v in views:
        lo = len(parts)
        parts.extend(v[o:o + PIECE_BYTES]
                     for o in range(0, v.size, PIECE_BYTES))
        spans.append((lo, len(parts)))
    crcs = crc32c_many(parts, device) if parts else []
    return combine_spans(crcs, [p.size for p in parts], spans)
