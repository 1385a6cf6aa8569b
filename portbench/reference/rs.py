"""RS(k, m) over GF(2^8), frozen: the code every stored stripe must carry.

Field: x^8 + x^4 + x^3 + x^2 + 1 (0x11D). Generator: [I_k ; C] with
C[i, j] = 1 / (i ^ (m + j)), each column scaled by the inverse of its row-0
entry, so parity row 0 is the XOR of the data shards. Shard j of a stripe
is bytes [j * S, (j + 1) * S) of the chunk, zero-padded; parity shards
k .. k+m-1 are C applied to the data shards.

Encode and decode apply a GF(2^8) matrix byte by byte through a 256 x 256
product table on whatever device the shards live on (plain PyTorch
gathers and XORs), which is slow but needs nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D


@functools.lru_cache(maxsize=1)
def tables():
    """(exp[512], log[256]) of the field."""
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = tables()
    return int(exp[log[a] + log[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    exp, log = tables()
    return int(exp[255 - log[a]])


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """(256, 256) uint8 table of products."""
    exp, log = tables()
    out = np.zeros((256, 256), dtype=np.uint8)
    nz = np.arange(1, 256)
    out[1:, 1:] = exp[(log[nz][:, None] + log[nz][None, :]) % 255]
    return out


@functools.lru_cache(maxsize=16)
def parity_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) uint8 parity coefficients of the frozen code."""
    c = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            c[i, j] = gf_inv(i ^ (m + j))
    for j in range(k):
        scale = gf_inv(int(c[0, j]))
        for i in range(m):
            c[i, j] = gf_mul(int(c[i, j]), scale)
    return c.astype(np.uint8)


def generator(k: int, m: int) -> np.ndarray:
    return np.concatenate([np.eye(k, dtype=np.uint8), parity_matrix(k, m)])


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over the field; raises if singular."""
    n = a.shape[0]
    aug = [[int(v) for v in row] + [int(i == r) for i in range(n)]
           for r, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r][col]), None)
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = gf_inv(aug[col][col])
        aug[col] = [gf_mul(v, inv) for v in aug[col]]
        for r in range(n):
            f = aug[r][col]
            if r != col and f:
                aug[r] = [v ^ gf_mul(f, w) for v, w in zip(aug[r], aug[col])]
    return np.array([row[n:] for row in aug], dtype=np.uint8)


def apply(matrix: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """(r, n) GF(2^8) matrix applied to (B, n, S) uint8 shards -> (B, r, S),
    on the shards' device."""
    table = torch.from_numpy(mul_table()).to(shards.device)
    b, n, s = shards.shape
    out = torch.zeros((b, matrix.shape[0], s), dtype=torch.uint8,
                      device=shards.device)
    for i in range(matrix.shape[0]):
        for j in range(n):
            c = int(matrix[i, j])
            if c == 1:
                out[:, i].bitwise_xor_(shards[:, j])
            elif c:
                out[:, i].bitwise_xor_(table[c][shards[:, j].long()])
    return out


def encode(data: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """(B, k, S) uint8 data shards -> (B, m, S) parity shards."""
    if data.shape[1] != k:
        raise ValueError(f"data {tuple(data.shape)} for k={k}")
    return apply(parity_matrix(k, m), data)


def decode(present: list, lost: list, shards: torch.Tensor, k: int,
           m: int) -> torch.Tensor:
    """Rebuild shards ``lost`` from the k shards ``present`` ((B, k, S),
    in that order) -> (B, len(lost), S)."""
    if len(present) != k:
        raise ValueError(f"{len(present)} survivors, k={k}")
    gen = generator(k, m)
    inv = mat_inv(gen[list(present)])
    rows = np.array([[np.bitwise_xor.reduce(
        [gf_mul(int(gen[x, t]), int(inv[t, c])) for t in range(k)])
        for c in range(k)] for x in lost], dtype=np.uint8)
    return apply(rows, shards)
