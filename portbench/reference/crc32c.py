"""CRC32C (Castagnoli), frozen: the checksum every stored shard must carry.

Reflected polynomial 0x82F63B78, initial register 0xFFFFFFFF, final XOR
0xFFFFFFFF (RFC 3720): CRC32C(b"123456789") = 0xE3069283.

Plain PyTorch on the rows' device. A row is cut into blocks of ``BLOCK``
bytes (zeros in front make it a whole power of two of blocks: a register
of 0 stays 0 through zero bytes), every block's raw CRC is taken at once
byte by byte through the 256-entry table, and neighbouring blocks are
combined in a tree, ``raw(a || b) = shift(raw(a), len(b)) ^ raw(b)``,
where ``shift`` runs a register through zero bytes: a 32 x 32 matrix over
GF(2), applied as a 0/1 matrix product reduced mod 2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x82F63B78
BLOCK = 256


@functools.lru_cache(maxsize=1)
def table() -> np.ndarray:
    out = np.zeros(256, dtype=np.int64)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        out[n] = c
    return out


def crc32c_bytes(data: bytes, crc: int = 0) -> int:
    """Byte-at-a-time CRC32C of one buffer (slow; small inputs and tests)."""
    t = table()
    reg = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for byte in data:
        reg = (reg >> 8) ^ int(t[(reg ^ byte) & 0xFF])
    return reg ^ 0xFFFFFFFF


def _raw_zero_byte(reg: int) -> int:
    return (reg >> 8) ^ int(table()[reg & 0xFF])


@functools.lru_cache(maxsize=64)
def shift_matrix(nbytes: int) -> np.ndarray:
    """(32, 32) 0/1 matrix M: bits of the register after ``nbytes`` zero
    bytes = M @ bits before (bit u of column b: bit u of the image of 1<<b)."""
    one = np.zeros((32, 32), dtype=np.int64)
    for b in range(32):
        img = _raw_zero_byte(1 << b)
        one[:, b] = [(img >> u) & 1 for u in range(32)]
    out = np.eye(32, dtype=np.int64)
    power, n = one, nbytes
    while n:
        if n & 1:
            out = (power @ out) % 2
        power = (power @ power) % 2
        n >>= 1
    return out


def _shift(regs: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Registers (int64, low 32 bits) run through ``nbytes`` zero bytes."""
    m = torch.from_numpy(shift_matrix(nbytes)).to(regs.device,
                                                 torch.float64)
    bits = (regs.unsqueeze(-1) >> torch.arange(32, device=regs.device)) & 1
    out_bits = (bits.to(torch.float64) @ m.T).remainder(2).to(torch.int64)
    return (out_bits << torch.arange(32, device=regs.device)).sum(-1)


def crc32c_rows(rows: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 -> (N,) int64 CRC32C of each row, on the rows' device."""
    n, length = rows.shape
    if length == 0:
        return torch.zeros(n, dtype=torch.int64, device=rows.device)
    nblocks = 1
    while nblocks * BLOCK < length:
        nblocks *= 2
    pad = nblocks * BLOCK - length
    if pad:
        rows = torch.cat([torch.zeros((n, pad), dtype=torch.uint8,
                                      device=rows.device), rows], dim=1)
    blocks = rows.reshape(n * nblocks, BLOCK)
    t = torch.from_numpy(table()).to(rows.device)
    reg = torch.zeros(n * nblocks, dtype=torch.int64, device=rows.device)
    for i in range(BLOCK):
        reg = (reg >> 8) ^ t[(reg ^ blocks[:, i].long()) & 0xFF]
    reg = reg.reshape(n, nblocks)
    span = BLOCK
    while reg.shape[1] > 1:
        reg = _shift(reg[:, 0::2], span) ^ reg[:, 1::2]
        span *= 2
    raw = reg[:, 0]
    init = _shift(torch.full((1,), 0xFFFFFFFF, dtype=torch.int64,
                             device=rows.device), length)
    return raw ^ init ^ 0xFFFFFFFF


def crc32c_many(bufs, device="cpu") -> list:
    """CRC32C of each buffer (bytes-like), rows of one length batched."""
    out = [0] * len(bufs)
    by_len: dict = {}
    for i, b in enumerate(bufs):
        by_len.setdefault(len(b), []).append(i)
    for length, idx in by_len.items():
        arr = np.stack([np.frombuffer(bufs[i], dtype=np.uint8) for i in idx]) \
            if length else np.zeros((len(idx), 0), dtype=np.uint8)
        got = crc32c_rows(torch.from_numpy(arr).to(device)).tolist()
        for i, v in zip(idx, got):
            out[i] = int(v)
    return out
