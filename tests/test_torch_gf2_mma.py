"""The operand layouts of the tensor-core kernels, emulated in numpy.

``csrc/crc32c.cu`` and ``csrc/gf2_matmul.cu`` compute GF(2) products with
``mma.m16n8k256 .b1 .and.popc``: per output element, the low bit of the sum
of popcount(a AND b) over the 32-bit words of the A and B fragments. The
emulations below form exactly the words the kernels read (the host-packed
CRC fragments, the K1 fragments as the kernel builds them in shared memory,
the data words after the kernel's byte transposes) and must equal the plain
versions and the JAX package. The shape predicates that choose between a
tensor-core kernel and its integer-unit kernel are checked here too.
Tolerance 0: the outputs are checksums and erasure-code bytes.
"""

import importlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3fs.ops import pallas_rs
from tpu3fs.ops import rs as jrs
from tpu3fs_torch.ops import crc32c as tcrc
from tpu3fs_torch.ops import gf2_matmul as tgm
from tpu3fs_torch.ops.gf256 import GF as TGF
from tpu3fs_torch.ops.stripe import StripeCodec, shard_size_of

jcrc = importlib.import_module("tpu3fs.ops.crc32c")
CSRC = pathlib.Path(tgm.__file__).resolve().parents[1] / "csrc"


def popc_low_bit(a: np.ndarray, b: np.ndarray, axes) -> np.ndarray:
    """AND, popcount, sum over ``axes``, low bit: the b1 mma's GF(2) dot."""
    return np.bitwise_count(a & b).astype(np.int64).sum(axis=axes) & 1


# -- K2: CRC raw registers ---------------------------------------------------

def emulate_crc(bc: tcrc.BatchCrc32c, chunks: np.ndarray) -> np.ndarray:
    """CRCs of (rows, size) uint8 through the fragments the kernel reads."""
    rows, size = chunks.shape
    block, nblocks = bc.block, bc.nblocks
    frags = bc._frags.numpy().view(np.uint32)  # (steps, 32 lanes, 8 slots)
    nchunk = frags.shape[0] // 4
    blocks = np.zeros((rows * nblocks, nchunk * 128), dtype=np.uint8)
    blocks[:, :block] = chunks.reshape(rows * nblocks, block)
    words = blocks.view("<u4").reshape(-1, nchunk, 32)
    # A: lane t loads words 4t..4t+3 (h=0) and 16+4t.. (h=1); step u takes word u
    c, u, t, h = np.ix_(np.arange(nchunk), np.arange(4), np.arange(4),
                        np.arange(2))
    a = words[:, c, 4 * t + u + 16 * h]  # (blocks, c, u, t, h)
    f = frags.reshape(nchunk, 4, 8, 4, 4, 2)  # (c, u, g, t, n, h)
    d = popc_low_bit(a[:, :, :, None, :, None, :], f[None],
                     axes=(1, 2, 4, 6))  # (blocks, g, n): register bit 8n + g
    raw = (d.transpose(0, 2, 1).reshape(-1, 32).astype(np.uint64)
           << np.arange(32, dtype=np.uint64)).sum(axis=1)
    raw = raw.reshape(rows, nblocks)
    cols = bc._ks_cols.numpy().view(np.uint32).astype(np.uint64)  # (N, 32)
    out = np.full(rows, bc._const, dtype=np.uint64)
    for j in range(nblocks):
        for o in range(32):
            out ^= np.where((raw[:, j] >> np.uint64(o)) & np.uint64(1),
                            cols[j, o], np.uint64(0))
    return out.astype(np.uint32)


@pytest.mark.parametrize("size,block", [(4096, 512), (1536, 512), (576, 192),
                                        (192, 192), (640, 64), (64, 64),
                                        (4096, 2048)])
def test_crc_fragments_match_plain_jax_and_scalar(size, block):
    rng = np.random.default_rng(size + block)
    chunks = rng.integers(0, 256, (5, size), dtype=np.uint8)
    chunks[1] = 0
    chunks[2] = 0xFF
    bc = tcrc.BatchCrc32c(size, block, device="cpu")
    got = emulate_crc(bc, chunks)
    assert np.array_equal(got, bc.compute(torch.from_numpy(chunks)).numpy())
    assert np.array_equal(got, np.asarray(
        jcrc.BatchCrc32c(size, block).compute(chunks)))
    assert got.tolist() == [tcrc.crc32c_py(r.tobytes()) for r in chunks]


@pytest.mark.parametrize("block", [512, 192, 64])
def test_crc_fragments_single_bit_at_every_offset(block):
    """One set bit at each bit offset of a block: every K position of the
    fragment order reaches the right column of B^T."""
    bc = tcrc.BatchCrc32c(block, block, device="cpu")
    offsets = np.arange(8 * block)
    chunks = np.zeros((offsets.size, block), dtype=np.uint8)
    chunks[offsets, offsets // 8] = (1 << (offsets % 8)).astype(np.uint8)
    got = emulate_crc(bc, chunks)
    want = [tcrc.crc32c_py(r.tobytes()) for r in chunks]
    assert got.tolist() == want


def test_crc_fragments_need_whole_steps():
    assert tcrc.BatchCrc32c(1000, 1000, device="cpu")._frags is None
    assert tcrc.BatchCrc32c(9, 9, device="cpu")._frags is None
    assert tuple(tcrc.BatchCrc32c(512, 512, device="cpu")._frags.shape) == (16, 32, 8)


# -- K1: GF(2^8) matrix apply -------------------------------------------------

def _kernel_selectors() -> list:
    """The __byte_perm selectors of transpose4x4 in csrc/gf2_matmul.cu."""
    src = (CSRC / "gf2_matmul.cu").read_text()
    body = src[src.index("void transpose4x4"):]
    body = body[:body.index("\n}\n")]
    return [int(s, 16) for s in re.findall(r"__byte_perm\([^)]*?(0x[0-9A-Fa-f]+)\)", body)]


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes {y:x}."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, dtype=np.uint64)
    for i in range(4):
        pick = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((both >> pick) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose4x4(w: list) -> list:
    s = _kernel_selectors()
    assert len(s) == 8
    x0, x1 = byte_perm(w[0], w[1], s[0]), byte_perm(w[0], w[1], s[1])
    x2, x3 = byte_perm(w[2], w[3], s[2]), byte_perm(w[2], w[3], s[3])
    return [byte_perm(x0, x2, s[4]), byte_perm(x0, x2, s[5]),
            byte_perm(x1, x3, s[6]), byte_perm(x1, x3, s[7])]


def kernel_b_fragments(cols: np.ndarray, i0: int, steps: int) -> np.ndarray:
    """(steps, 4 n, 32 lanes, 2 h) words as gf2_mma_kernel builds them:
    column g (bit g of output symbol i0 + n) over symbols
    32st + 4(t + 4h) + r, bit 8r + q = bit g of cols[i, j, q]."""
    o, k, _ = cols.shape
    out = np.zeros((steps, 4, 32, 2), dtype=np.uint32)
    for st in range(steps):
        for n in range(4):
            if i0 + n >= o:
                continue
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    word = 0
                    for r in range(4):
                        j = 32 * st + 4 * (t + 4 * h) + r
                        if j < k:
                            for q in range(8):
                                word |= ((int(cols[i0 + n, j, q]) >> g) & 1) << (8 * r + q)
                    out[st, n, lane, h] = word
    return out


def emulate_gf2(cols: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(B, k, S) -> (B, o, S) through the words gf2_mma_kernel reads: rows of
    4 positions as little-endian words, transposed to 4 symbols of one
    position, against the B fragments; S % 8 == 0."""
    o, k, _ = cols.shape
    B, _, S = data.shape
    steps = -(-k // 32)
    rows = np.zeros((B, 32 * steps, S), dtype=np.uint8)
    rows[:, :k] = data
    rw = rows.view("<u4").reshape(B, steps, 8, 4, S // 4)  # (b, st, w, r, pos/4)
    # a[b, st, w, pos]: symbols 32st + 4w + (0..3) of one position
    a = np.stack(transpose4x4([rw[:, :, :, r] for r in range(4)]), axis=-1)
    a = a.reshape(B, steps, 8, S)  # position 4p + q from transposed word q
    out = np.zeros((B, o, S), dtype=np.uint8)
    for i0 in range(0, o, 4):
        f = kernel_b_fragments(cols, i0, steps).reshape(steps, 4, 8, 4, 2)
        # word w = t + 4h of the K-step pairs with lane (g, t), half h
        aw = a.reshape(B, steps, 2, 4, S)  # (b, st, h, t, pos)
        d = popc_low_bit(aw[:, :, None, None, :, :, :].transpose(0, 1, 2, 3, 5, 4, 6),
                         f[None, :, :, :, :, :, None],
                         axes=(1, 4, 5))  # (b, n, g, pos)
        for n in range(min(4, o - i0)):
            out[:, i0 + n] = (d[:, n] << np.arange(8)[None, :, None]).sum(axis=1)
    return out


@pytest.mark.parametrize("k,m,o,S", [(12, 4, 4, 256), (12, 4, 1, 192),
                                     (40, 4, 4, 64), (40, 6, 6, 64),
                                     (3, 1, 1, 128)])
def test_gf2_fragments_match_plain_and_jax(k, m, o, S):
    """Encode (o = m) or a decode matrix (o < m) through the emulated mma:
    RS(12,4), k = 40 for two K-steps, o = 1, o = 6 for two output passes."""
    rng = np.random.default_rng(k * 100 + o + S)
    code = jrs.RSCode(k, m)
    if o == m:
        A = np.asarray(code._parity_bits)
    else:
        lost = tuple(range(o))
        present = tuple(i for i in range(k + m) if i not in lost)[:k]
        A = TGF.expand_to_bits(code._reconstruct_matrix(present, lost))
    data = rng.integers(0, 256, (2, k, S), dtype=np.uint8)
    cols = tgm.prepare_matrix(A, "cpu")
    got = emulate_gf2(cols.numpy(), data)
    assert np.array_equal(got, tgm.gf2_matmul_plain(cols, torch.from_numpy(data)).numpy())
    assert np.array_equal(got, np.asarray(jrs._bit_matmul(A, data)))
    want = np.asarray(pallas_rs.gf2_matmul(pallas_rs.prepare_matrix(A),
                                           jnp.asarray(data), interpret=True))
    assert np.array_equal(got, want)


def test_gf2_fragments_unit_matrix_and_single_bits():
    """The probe of the chip run: a unit matrix copies the data, and a single
    set bit of one symbol lights exactly the products of that column."""
    k = 12
    eye = tgm.prepare_matrix(TGF.expand_to_bits(np.eye(k, dtype=np.uint8)), "cpu")
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (1, k, 64), dtype=np.uint8)
    assert np.array_equal(emulate_gf2(eye.numpy(), data), data)
    code = jrs.RSCode(k, 4)
    cols = tgm.prepare_matrix(np.asarray(code._parity_bits), "cpu").numpy()
    probe = np.zeros((1, k, 8 * k), dtype=np.uint8)
    for j in range(k):
        for t in range(8):
            probe[0, j, 8 * j + t] = 1 << t
    got = emulate_gf2(cols, probe)
    want = np.stack([cols[:, j, t] for j in range(k) for t in range(8)], axis=-1)
    assert np.array_equal(got[0], want)


def test_transpose_selectors_transpose():
    w = [np.array([0x03020100 + 0x10101010 * r], dtype=np.uint32) for r in range(4)]
    out = transpose4x4(w)
    assert [int(v[0]) for v in out] == [0x30201000 + 0x01010101 * p for p in range(4)]


# -- the shape predicates ------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 6, 8, 12, 16, 32, 64, 240])
def test_every_codec_shard_takes_the_tensor_cores(k):
    for chunk in (1, 100, 4095, 4096, 65536, 1 << 20, 4 << 20, 3_000_001,
                  64 << 20):
        S = shard_size_of(chunk, k)
        block = 512 if S % 512 == 0 else S
        assert tgm.tensor_core_takes(S, 0), (chunk, k, S)
        assert tcrc.tensor_core_takes(block, 256), (chunk, k, S)


def test_codec_crc_builds_fragments():
    codec = StripeCodec(12, 4, shard_size_of(4 << 20, 12), device="cpu")
    assert codec._crc._frags is not None
    assert StripeCodec(3, 1, 64, device="cpu")._crc._frags is not None


@pytest.mark.parametrize("S,ptr,takes", [(1000, 0, False), (4104, 0, False),
                                         (4096, 1, False), (4096, 8, False),
                                         (4096, 16, True), (16, 0, True)])
def test_gf2_predicate(S, ptr, takes):
    assert tgm.tensor_core_takes(S, ptr) is takes


@pytest.mark.parametrize("block,ptr,takes", [(1000, 0, False), (9, 0, False),
                                             (16, 0, False), (4096, 0, False),
                                             (512, 1, False), (512, 8, False),
                                             (512, 16, True), (32, 0, True),
                                             (2048, 0, True)])
def test_crc_predicate(block, ptr, takes):
    assert tcrc.tensor_core_takes(block, ptr) is takes


def test_cuda_only_kernels_refuse_cpu_tensors_and_cpu_never_launches():
    """On the CPU the codec runs the plain versions; the kernels' wrappers
    take only CUDA tensors and raise on others (no fallback)."""
    bc = tcrc.BatchCrc32c(1024, 512, device="cpu")
    cols = tgm.prepare_matrix(TGF.expand_to_bits(np.ones((2, 4), np.uint8)), "cpu")
    counters = [tcrc.crc32c_blocks, tcrc.crc32c_blocks_table, tgm.gf2_matmul,
                tgm.gf2_matmul_bitslice]
    before = [f.launches for f in counters]
    bc(torch.zeros((3, 1024), dtype=torch.uint8))
    tgm.gf2_matmul(cols, torch.zeros((1, 4, 64), dtype=torch.uint8))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError):
        tcrc.crc32c_blocks_table(torch.zeros((3, 1024), dtype=torch.uint8),
                                 bc._ks_cols, 512, bc._const)
    with pytest.raises(ValueError):
        tgm.gf2_matmul_bitslice(cols, torch.zeros((1, 4, 64), dtype=torch.uint8))
