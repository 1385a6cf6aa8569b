#!/usr/bin/env python3
"""Drive the tpu3fs_torch data plane on one CUDA card.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: the kernel library from tpu3fs_torch/csrc with nvcc;
  3. K1: layout probes (a unit matrix, single set bits), then both kernels
     (the tensor-core gf2_matmul and gf2_matmul_bitslice) against the plain
     PyTorch version, byte for byte, and the numpy gold encode/reconstruct;
     a ragged S and an unaligned base must take the bit-sliced kernel;
  4. K2: a probe (one set bit at each offset of a block), then both kernels
     (the tensor-core crc32c_blocks and crc32c_blocks_table) against the
     plain version and the scalar crc32c_py; block 1000, a 9-byte row and an
     unaligned base must take the table kernel;
  5. K3: the XOR-rebuild kernel xor_reduce against xor_reduce_plain at the
     rebuild shape, k of 2, 7 and 12, a ragged S and an unaligned base;
  6. the stripe server answering requests through StripeCodec(12, 4, 1 MiB):
     writes, a verify, degraded reads, a rebuild over a 1 GiB device store
     and a 4 MiB chunk;
  7. the codec's chain-encode hops: delta_parity and hop_accumulate (numpy
     and device accumulators) at RS(12,4), S = 1 MiB, B = 12, against the
     plain versions on the CPU;
  8. the multi-device path on a one-rank NCCL group: dryrun_multichip, a
     chain write of 12 x 1 MiB rows checksummed by BatchCrc32c (K2) and an
     all-to-all shuffle. One card holds one NCCL rank, so the chain ring
     and the rebuild's all-gather (chain > 1) are not reached here: they
     are held against the JAX package on gloo ranks by
     tests/test_torch_parallel.py;
  9. times with CUDA events at the phase-6 shapes, the earlier kernel and
     the new one in turns, beside each kernel's bound and its plain
     version's time; the times of the hop ops and the one-rank chain step.
Phases 6, 7 and 8 are the main path: every kernel count is set to 0 just
before each and read just after; every K1 and K2 launch there must be a
tensor-core one and every K3 call a kernel launch.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch

MIB = 1 << 20
# H100 SXM published peaks (dense): HBM3 bandwidth and int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
K, M, S_WRITE, B_WRITE = 12, 4, MIB, 12   # bench.py's RS(12,4) write batch
CHUNK_BYTES, S_CHUNK = 4 * MIB, 349_696    # shard_size_of(4 MiB, 12)
STORE_STRIPES = 64                         # 64 x 16 x 1 MiB = 1 GiB store
NO_LIBRARY = ("no single PyTorch call computes a GF(2^8) matrix apply "
              "or a CRC32C")
NO_XOR_LIBRARY = ("torch has no XOR reduction: no single PyTorch call "
                  "computes the XOR of k rows")


def log(*parts) -> None:
    print(*parts, flush=True)


def require(ok, what: str) -> None:
    """A failed check ends the run with a nonzero exit."""
    if not ok:
        raise AssertionError(what)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def rand_u8(shape, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=g)


def as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:  # few kernels take uint32: go through int32
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


class Compare:
    """Holds a kernel's results against a reference; keeps the worst error."""

    def __init__(self):
        self.max_abs_err = 0
        self.cases = 0

    def __call__(self, got: torch.Tensor, want: torch.Tensor, label: str):
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}")
        err = int((as_i64(got) - as_i64(want)).abs().max()) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        if err:
            raise AssertionError(f"{label}: kernel differs from reference "
                                 f"(max abs err {err})")


def cuda_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device time of fn() over iters calls, with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, int8_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters() -> dict:
    """name -> (function, attribute) of every kernel wrapper's launch count,
    and of K3's plain version's call count."""
    from tpu3fs_torch.ops.crc32c import crc32c_blocks, crc32c_blocks_table
    from tpu3fs_torch.ops.gf2_matmul import gf2_matmul, gf2_matmul_bitslice
    from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain

    return {"gf2_matmul": (gf2_matmul, "launches"),
            "gf2_matmul_bitslice": (gf2_matmul_bitslice, "launches"),
            "crc32c_blocks": (crc32c_blocks, "launches"),
            "crc32c_blocks_table": (crc32c_blocks_table, "launches"),
            "xor_reduce": (xor_reduce, "launches"),
            "xor_reduce_plain": (xor_reduce_plain, "calls")}


def read_counts() -> dict:
    return {n: getattr(f, a) for n, (f, a) in counters().items()}


def zero_counts() -> None:
    for f, a in counters().values():
        setattr(f, a, 0)


def require_main_path(path: str, counts: dict, launched) -> None:
    """Every kernel in ``launched`` ran in this path; no K1 or K2 launch
    took the earlier integer-unit kernels and no K3 call the plain loop."""
    for name in launched:
        require(counts[name] > 0, f"{name} was not launched on {path}")
    for name in ("gf2_matmul_bitslice", "crc32c_blocks_table",
                 "xor_reduce_plain"):
        require(counts[name] == 0,
                f"{name} ran on {path}: every K1 and K2 launch there must "
                "be a tensor-core launch and every K3 call a kernel launch")


# -- phase 1 -----------------------------------------------------------------
def environment() -> str:
    phase("phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a card")
    # the plain versions take 0/1 products in float32; keep them full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind} count {torch.cuda.device_count()}")
    return kind


# -- phase 2 -----------------------------------------------------------------
def build() -> None:
    from tpu3fs_torch import kernels

    t0 = phase("phase 2: build")
    kernels.library()
    log(f"kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            log("  ptxas:", line.strip())


# -- phase 3 -----------------------------------------------------------------
def check_k1(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.gf2_matmul import (gf2_matmul, gf2_matmul_bitslice,
                                             gf2_matmul_plain, prepare_matrix)
    from tpu3fs_torch.ops.rs import RSCode

    t0 = phase("phase 3: K1 gf2_matmul (both kernels) against its plain version")

    def both(cols, data, label, tensor_core=True):
        """gf2_matmul (the tensor-core kernel where it takes the shape) and
        the bit-sliced kernel, each against the plain version."""
        n_tc, n_bs = gf2_matmul.launches, gf2_matmul_bitslice.launches
        got = gf2_matmul(cols, data)
        want = gf2_matmul_plain(cols, data)
        cmp(got, want, label)
        cmp(gf2_matmul_bitslice(cols, data), want, label + " (bit-sliced)")
        require(gf2_matmul.launches - n_tc == int(tensor_core) and
                gf2_matmul_bitslice.launches - n_bs == 2 - int(tensor_core),
                f"{label}: launched the wrong K1 kernel")
        return got

    # layout probes first: a unit matrix copies the data; one set bit of one
    # symbol at a time lights exactly the matrix column of that bit
    eye = prepare_matrix(GF.expand_to_bits(np.eye(K, dtype=np.uint8)), dev)
    probe_data = rand_u8((2, K, 4096), 21, dev)
    cmp(both(eye, probe_data, "probe: unit matrix"), probe_data,
        "probe: unit matrix copies")
    rs = RSCode(K, M, device=dev)
    single = torch.zeros((1, K, 8 * K * 16), dtype=torch.uint8, device=dev)
    for j in range(K):
        for t in range(8):
            single[0, j, 16 * (8 * j + t)] = 1 << t
    got = both(rs._parity_cols, single, "probe: single bits")
    want = rs._parity_cols.reshape(M, 8 * K)  # column 8j + t
    cmp(got[0, :, ::16], want, "probe: single bits light their columns")

    for S in (S_WRITE, S_CHUNK):
        data = rand_u8((B_WRITE, K, S), 1, dev)
        parity = both(rs._parity_cols, data, f"encode RS(12,4) S={S}")
        gold = rs.encode_np(data[:2].cpu().numpy())
        cmp(parity[:2].cpu(), torch.from_numpy(gold), f"encode gold S={S}")
    shards = torch.cat([data, parity], dim=1)
    for lost in [(0,), (0, 5), (0, 5, 12), (0, 5, 12, 15)]:
        present = [i for i in range(K + M) if i not in lost][:K]
        R = rs._reconstruct_matrix(tuple(present), lost)
        cols = prepare_matrix(GF.expand_to_bits(R), dev)
        out = both(cols, shards[:, present].contiguous(), f"decode o={len(lost)}")
        cmp(out, shards[:, list(lost)], f"decode o={len(lost)} restores")
        gold = rs.reconstruct_np(present, lost, shards[:1, present].cpu().numpy())
        cmp(out[:1].cpu(), torch.from_numpy(gold), f"decode gold o={len(lost)}")
    for k, m, S, B in [(3, 1, S_WRITE, 2), (6, 3, S_WRITE, 2),
                       (240, 16, 4096, 2), (255, 1, 4096, 2), (40, 6, 4160, 3)]:
        code = RSCode(k, m, device=dev)
        both(code._parity_cols, rand_u8((B, k, S), k, dev), f"RS({k},{m}) S={S}")
    # a ragged S and a base that is not 16-byte aligned: the bit-sliced kernel
    both(rs._parity_cols, rand_u8((3, K, 1000), 12, dev), "RS(12,4) S=1000",
         tensor_core=False)
    flat = rand_u8((2 * K * 4096 + 1,), 7, dev)
    both(rs._parity_cols, flat[1:].view(2, K, 4096), "unaligned base",
         tensor_core=False)
    # zero-size work returns without a launch
    n0 = gf2_matmul.launches + gf2_matmul_bitslice.launches
    empty_o = RSCode(4, 0, device=dev).encode(rand_u8((2, 4, 64), 3, dev))
    empty_b = rs.encode(rand_u8((0, K, 64), 3, dev))
    require(empty_o.shape == (2, 0, 64) and empty_b.shape == (0, M, 64)
            and gf2_matmul.launches + gf2_matmul_bitslice.launches == n0,
            "a zero-size call launched")
    torch.cuda.synchronize()
    log(f"K1: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 4 -----------------------------------------------------------------
def check_k2(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.crc32c import (BatchCrc32c, crc32c_blocks,
                                         crc32c_blocks_table, crc32c_py)

    t0 = phase("phase 4: K2 crc32c_blocks (both kernels) against its plain version")

    def both(bc, x, label, tensor_core=True):
        """The codec's kernel (tensor cores where it takes the shape) and the
        table kernel, each against the plain version."""
        n_tc, n_tb = crc32c_blocks.launches, crc32c_blocks_table.launches
        got = bc(x)
        want = bc.compute(x)
        cmp(got, want, label)
        cmp(crc32c_blocks_table(x, bc._ks_cols, bc.block, bc._const), want,
            label + " (table)")
        require(crc32c_blocks.launches - n_tc == int(tensor_core) and
                crc32c_blocks_table.launches - n_tb == 2 - int(tensor_core),
                f"{label}: launched the wrong K2 kernel")
        return got

    # layout probe first: one set bit at each bit offset of a block
    for block in (512, 192, 64):
        bc = BatchCrc32c(block, block, device=dev)
        off = torch.arange(8 * block, device=dev)
        x = torch.zeros((8 * block, block), dtype=torch.uint8, device=dev)
        x[off, off // 8] = (1 << (off % 8)).to(torch.uint8)
        got = both(bc, x, f"probe: single bits, block {block}")
        gold = torch.tensor([crc32c_py(r.tobytes()) for r in x.cpu().numpy()],
                            dtype=torch.int64)
        cmp(as_i64(got).cpu(), gold, f"probe gold, block {block}")

    for size, block, rows, tensor_core in [
            (S_WRITE, 512, B_WRITE * (K + M), True), (S_CHUNK, 512, K + M, True),
            (4096, 512, 64, True), (192, 192, 64, True), (64, 64, 33, True),
            (1000, 1000, 8, False)]:
        bc = BatchCrc32c(size, block, device=dev)
        x = rand_u8((rows, size), size, dev)
        x[1] = 0
        x[2] = 0xFF
        got = both(bc, x, f"crc size={size} block={block}", tensor_core)
        checked = [0, 1, 2] if size <= S_CHUNK else [0]
        host = x[checked].cpu().numpy()
        gold = torch.tensor([crc32c_py(r.tobytes()) for r in host],
                            dtype=torch.int64)
        cmp(as_i64(got)[checked].cpu(), gold, f"crc gold size={size}")
    # a base that is not 16-byte aligned: the table kernel
    bc = BatchCrc32c(4096, 512, device=dev)
    flat = rand_u8((16 * 4096 + 1,), 8, dev)
    both(bc, flat[1:].view(16, 4096), "unaligned base", tensor_core=False)
    n_tb = crc32c_blocks_table.launches
    vec = BatchCrc32c(9, 9, device=dev)(
        torch.frombuffer(bytearray(b"123456789"), dtype=torch.uint8)
        .reshape(1, 9).to(dev))
    require(int(as_i64(vec)[0]) == 0xE3069283, "crc32c(b'123456789')")
    require(crc32c_blocks_table.launches == n_tb + 1,
            "the 9-byte row did not take the table kernel")
    torch.cuda.synchronize()
    log(f"K2: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 5 -----------------------------------------------------------------
def check_k3(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain

    t0 = phase("phase 5: K3 xor_reduce against its plain version")

    def check(x, label):
        n = xor_reduce.launches
        got = xor_reduce(x)
        require(xor_reduce.launches == n + 1, f"{label}: K3 did not launch")
        cmp(got, xor_reduce_plain(x), label)
        return got

    # layout probe first: one set byte per row lands in its own column
    probe = torch.zeros((2, K, 16 * K), dtype=torch.uint8, device=dev)
    for j in range(K):
        probe[:, j, 16 * j + j % 16] = 1 << (j % 8)
    want = torch.zeros((2, 1, 16 * K), dtype=torch.uint8, device=dev)
    for j in range(K):
        want[:, 0, 16 * j + j % 16] = 1 << (j % 8)
    cmp(check(probe, "probe: one byte per row"), want, "probe lands")

    for k in (2, 7, K):
        check(rand_u8((B_WRITE, k, S_WRITE), 30 + k, dev), f"k={k} S=1 MiB")
    check(rand_u8((3, K, S_CHUNK), 41, dev), f"k=12 S={S_CHUNK}")
    check(rand_u8((3, K, 1000), 42, dev), "ragged S=1000")
    flat = rand_u8((2 * K * 4096 + 1,), 43, dev)
    check(flat[1:].view(2, K, 4096), "unaligned base")
    check(rand_u8((K, 4096), 44, dev), "no batch dimension")
    n0 = xor_reduce.launches
    empty = xor_reduce(rand_u8((0, K, 64), 45, dev))
    require(empty.shape == (0, 1, 64) and xor_reduce.launches == n0,
            "a zero-size call launched")
    torch.cuda.synchronize()
    log(f"K3: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 6 -----------------------------------------------------------------
def serve(dev) -> dict:
    """The stripe server answers requests; returns launch counts per request."""
    from tpu3fs_torch.ops.crc32c import crc32c_py
    from tpu3fs_torch.ops.stripe import StripeCodec, shard_size_of

    t0 = phase("phase 6: the stripe server answers requests")
    codec = StripeCodec(K, M, S_WRITE, device=dev)
    chunk_codec = StripeCodec(K, M, shard_size_of(CHUNK_BYTES, K), device=dev)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (B_WRITE, K, S_WRITE), dtype=np.uint8)
               for _ in range(3)]
    requests = []

    def request(name, fn):
        before = read_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        requests.append({"request": name,
                         "host_ms": (time.perf_counter() - t) * 1e3,
                         **{n: after[n] - before[n] for n in after}})
        return out

    zero_counts()
    written = [request(f"write batch {i}", lambda d=d: codec.encode_batch(d))
               for i, d in enumerate(batches)]
    shards, crcs = written[0]
    n = K + M
    flat = shards.reshape(B_WRITE * n, S_WRITE)
    verified = request("verify 192 shards", lambda: codec.crc_batch(flat))
    bad = flat.copy()
    bad[5 * n + 7, 12345] ^= 0x40
    flagged = request("verify with one corrupt byte",
                      lambda: codec.crc_batch(bad)) != crcs.reshape(-1)
    lost4 = (0, 5, 12, 15)
    present4 = [i for i in range(n) if i not in lost4]
    read4 = request("degraded read, lost {0,5,12,15}",
                    lambda: codec.reconstruct_batch(present4, lost4,
                                                    shards[:, present4]))
    present1 = [i for i in range(K + 1) if i != 3]
    read1 = request("degraded read, lost {3} (XOR)",
                    lambda: codec.reconstruct_batch(present1, (3,),
                                                    shards[:, present1]))

    # rebuild one failed shard index across a 64-stripe, 1 GiB device store
    store = torch.empty((STORE_STRIPES, n, S_WRITE), dtype=torch.uint8,
                        device=dev)
    store_crcs = torch.empty((STORE_STRIPES, n), dtype=torch.int32, device=dev)
    for b0 in range(0, STORE_STRIPES, 16):
        sh, cr = codec.encode_batch(rand_u8((16, K, S_WRITE), 100 + b0, dev))
        store[b0:b0 + 16] = sh
        store_crcs[b0:b0 + 16] = cr.view(torch.int32)
    failed = 7
    survivors = [i for i in range(n) if i not in (failed, K)][:K]

    def rebuild():
        rebuilt = codec.reconstruct_batch(
            survivors, (failed,), store[:, survivors].contiguous())
        return rebuilt, codec.crc_batch(
            rebuilt.reshape(STORE_STRIPES, S_WRITE))
    rebuilt, rebuilt_crcs = request("rebuild shard 7 of a 1 GiB store", rebuild)

    chunk = rng.integers(0, 256, CHUNK_BYTES, dtype=np.uint8).tobytes()
    lostc = (2, 9, 13)

    def chunk_round_trip():
        cs, cc = chunk_codec.encode_stripe(chunk)
        pres = [i for i in range(n) if i not in lostc][:K]
        back = chunk_codec.reconstruct_batch(pres, lostc, cs[None, pres])[0]
        full = cs.copy()
        full[list(lostc)] = back
        again = chunk_codec.crc_batch(full)
        return cs, cc, full, again, chunk_codec.assemble(
            [full[j].tobytes() for j in range(K)], len(chunk))
    cs, cc, full, again, assembled = request("4 MiB chunk write + degraded read",
                                             chunk_round_trip)
    launches = read_counts()

    # answers are right: numpy gold, scalar CRC, restored bytes
    rs = codec.rs
    for d, (sh, _) in zip(batches, written):
        require(np.array_equal(sh[:2, K:], rs.encode_np(d[:2])),
                "write parity differs from the numpy gold")
    require(int(crcs[3, 14]) == crc32c_py(shards[3, 14].tobytes()),
            "stored CRC differs from crc32c_py")
    require(np.array_equal(verified, crcs.reshape(-1)),
            "verify disagrees with the stored CRCs")
    require(np.flatnonzero(flagged).tolist() == [5 * n + 7],
            f"corrupt shard flags {np.flatnonzero(flagged)}")
    require(np.array_equal(read4, shards[:, list(lost4)]),
            "4-loss degraded read differs")
    require(np.array_equal(read1, shards[:, [3]]),
            "XOR degraded read differs")
    require(torch.equal(rebuilt[:, 0], store[:, failed]),
            "rebuilt shard differs from the original")
    require(torch.equal(rebuilt_crcs.view(torch.int32), store_crcs[:, failed]),
            "rebuilt shard's CRCs differ from the stored CRCs")
    require(np.array_equal(full, cs) and np.array_equal(again, cc)
            and assembled == chunk, "4 MiB chunk round trip differs")
    require_main_path("the stripe server", launches,
                      ("gf2_matmul", "crc32c_blocks", "xor_reduce"))
    del store, rebuilt
    log(json.dumps({"requests": requests}))
    log(f"main-path launches {launches} over {len(requests)} requests "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


# -- phase 7 -----------------------------------------------------------------
def hops(dev, cmp: Compare):
    """The codec's delta-parity and chain-encode hop ops on the card, held
    against their plain versions on the CPU; logs their times and returns
    the run's launch counts."""
    from tpu3fs_torch.ops.crc32c import crc32c_xor
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.stripe import StripeCodec

    t0 = phase("phase 7: chain-encode hops (delta_parity, hop_accumulate)")
    codec = StripeCodec(K, M, S_WRITE, device=dev)
    plain = StripeCodec(K, M, S_WRITE, device="cpu")
    rng = np.random.default_rng(7)
    B, S, j = B_WRITE, S_WRITE, 5
    deltas = rng.integers(0, 256, (B, S), dtype=np.uint8)
    lens = rng.integers(0, S + 1, B)
    lens[:2] = (0, S)  # an empty and a full shard among the trimmed ones
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lens]
    start = rng.integers(0, 256, (B, M, S), dtype=np.uint8)

    zero_counts()
    delta = codec.delta_parity(j, deltas)
    acc_np = start.copy()
    crcs_np = codec.hop_accumulate(j, payloads, acc_np)
    acc_dev = torch.tensor(start, device=dev)  # a copy
    crcs_dev = codec.hop_accumulate(j, payloads, acc_dev)
    torch.cuda.synchronize()
    counts = read_counts()
    require_main_path("the chain-encode hops", counts,
                      ("gf2_matmul", "crc32c_blocks"))

    want_delta = plain.delta_parity(j, deltas)
    acc_cpu = start.copy()
    want_crcs = plain.hop_accumulate(j, payloads, acc_cpu)
    as_t = torch.from_numpy
    cmp(as_t(delta), as_t(want_delta), "delta_parity")
    cmp(as_t(acc_np), as_t(acc_cpu), "hop_accumulate, numpy accumulator")
    cmp(acc_dev.cpu(), as_t(acc_cpu), "hop_accumulate, device accumulator")
    want_crcs = as_t(want_crcs.astype(np.int64))
    cmp(as_t(crcs_np.astype(np.int64)), want_crcs, "hop CRCs, numpy")
    cmp(as_i64(crcs_dev).cpu(), want_crcs, "hop CRCs, device")
    col = codec.rs.parity_delta_matrix(j)
    gold = np.stack([GF.MUL_TABLE[int(c)][deltas[0]] for c in col[:, 0]])
    require(np.array_equal(delta[0], gold), "delta rows differ from the gold")
    # the hop CRC composes: crc(acc') = crc(acc) ^ crc(contribution) ^ crc(0)
    before, after = codec.crc_batch(start[0]), codec.crc_batch(acc_np[0])
    require(all(crc32c_xor(int(before[i]), int(crcs_np[0, i]), S)
                == int(after[i]) for i in range(M)),
            "hop CRCs do not compose to the accumulator's CRCs")

    # times: the device-resident ops with CUDA events; the numpy and bytes
    # requests on the host clock, ending in a synchronise
    d_dev = torch.from_numpy(deltas).to(dev)

    def hop_device():
        contrib = codec.rs.gf_accumulate(j, d_dev, acc_dev)
        return codec.crc_batch(contrib.reshape(B * M, S))

    def host_ms(fn, n=3):
        runs = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        return sorted(runs)[n // 2]

    out = {
        "delta_parity_device_ms": cuda_ms(lambda: codec.rs.delta_parity(j, d_dev), 30),
        "delta_parity_bound_ms": (B * S + B * M * S) / HBM_BYTES_PER_S * 1e3,
        "hop_device_ms": cuda_ms(hop_device, 30),
        "hop_bound_ms": (B * S + 2 * B * M * S + 4 * B * M)
        / HBM_BYTES_PER_S * 1e3,
        "delta_parity_numpy_host_ms": host_ms(lambda: codec.delta_parity(j, deltas)),
        "hop_bytes_device_acc_host_ms": host_ms(
            lambda: codec.hop_accumulate(j, payloads, acc_dev)),
        "hop_bytes_numpy_acc_host_ms": host_ms(
            lambda: codec.hop_accumulate(j, payloads, acc_np)),
        "shapes": "RS(12,4), j=5, B=12 stripes, S=1 MiB",
    }
    log(json.dumps({"hop_ops": out}))
    log(f"hops: launches {counts}, {cmp.cases} comparisons equal "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts


# -- phase 8 -----------------------------------------------------------------
def multi_device(dev):
    """dryrun_multichip, a checksummed chain write and a shuffle on a
    one-rank NCCL group; logs the chain step's time and returns the run's
    launch counts."""
    import torch.distributed as dist

    from tpu3fs_torch.entry import dryrun_chain_len, dryrun_multichip
    from tpu3fs_torch.ops.crc32c import BatchCrc32c
    from tpu3fs_torch.parallel import (backend_for, chain_write_step,
                                       make_storage_mesh, shuffle_partitions)

    t0 = phase("phase 8: the multi-device path on a one-rank NCCL group")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_storage_mesh(dryrun_chain_len(1), device=dev)
        crc = BatchCrc32c(S_WRITE, device=dev)
        rows = rand_u8((B_WRITE, S_WRITE), 80, dev)
        part = rand_u8((2, 4, 4096), 81, dev)
        zero_counts()
        t = time.perf_counter()
        shape = dryrun_multichip(mesh)
        replica, ok = chain_write_step(mesh, rows, crc_fn=crc)
        shuffled = shuffle_partitions(mesh, part)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) * 1e3
        counts = read_counts()
        require_main_path("the multi-device path", counts, ("crc32c_blocks",))
        require(shape == (1, 1), f"dry run mesh {shape}, want (1, 1)")
        require(bool(ok.all()) and torch.equal(replica[0], rows),
                "chain write: replica or checksum cross-check differs")
        require(torch.equal(shuffled, part), "one-rank shuffle moved rows")
        out = {"host_ms": run_ms,
               "chain_write_step_ms": cuda_ms(
                   lambda: chain_write_step(mesh, rows, crc_fn=crc), 30),
               "chain_write_step_bound_ms": 3 * B_WRITE * S_WRITE
               / HBM_BYTES_PER_S * 1e3,
               "shapes": "one rank, mesh (1, 1); chain write of 12 x 1 MiB "
                         "rows, BatchCrc32c(1 MiB)"}
    finally:
        dist.destroy_process_group()
    log(json.dumps({"multi_device": out}))
    log(f"multi-device: launches {counts} ({time.perf_counter() - t0:.1f} s)")
    return counts


# -- phase 9 -----------------------------------------------------------------
def mma_rates(dev) -> dict:
    """Issue rate of the two mma forms on register operands, every SM busy
    (csrc/mma_rate.cu): the card's data sheet has no 1-bit rate."""
    from tpu3fs_torch import kernels

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks, iters = 8 * sms, 512
    rates = {}
    for kind, name, ops in ((0, "b1_m16n8k256", 2 * 16 * 8 * 256),
                            (1, "s8_m16n8k32", 2 * 16 * 8 * 32)):
        def launch(kind=kind):
            kernels.launch("tpu3fs_mma_rate", dev, kind, blocks, iters, out)
        ms = cuda_ms(launch, 5)
        per_s = blocks * 8 * iters * 8 / (ms / 1e3)
        rates[name] = {"ms": ms, "mma_per_s_per_sm": per_s / sms,
                       "dense_TOP_s": per_s * ops / 1e12}
    return rates


def times(dev, paths: dict, cmps: dict):
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.gf2_matmul import (gf2_matmul, gf2_matmul_bitslice,
                                             gf2_matmul_plain, prepare_matrix)
    from tpu3fs_torch.ops.crc32c import BatchCrc32c, crc32c_blocks_table
    from tpu3fs_torch.ops.rs import RSCode
    from tpu3fs_torch.ops.stripe import StripeCodec
    from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain

    phase("phase 9: times (CUDA events, after warm-up)")
    rs = RSCode(K, M, device=dev)
    B, S = B_WRITE, S_WRITE
    data = rand_u8((B, K, S), 11, dev)
    crc = BatchCrc32c(S, 512, device=dev)
    rows = rand_u8((B * (K + M), S), 12, dev)

    def turns(old, new):
        """The earlier kernel and the new one in turns: old, new, new, old."""
        t = [cuda_ms(old, 30), cuda_ms(new, 30), cuda_ms(new, 30),
             cuda_ms(old, 30)]
        return {"new_ms": [t[1], t[2]], "old_ms": [t[0], t[3]],
                "new": (t[1] + t[2]) / 2, "old": (t[0] + t[3]) / 2}

    enc = turns(lambda: gf2_matmul_bitslice(rs._parity_cols, data),
                lambda: gf2_matmul(rs._parity_cols, data))
    crct = turns(lambda: crc32c_blocks_table(rows, crc._ks_cols, 512, crc._const),
                 lambda: crc(rows))
    enc_plain = cuda_ms(lambda: gf2_matmul_plain(rs._parity_cols, data), 3, 1)
    crc_plain = cuda_ms(lambda: crc.compute(rows), 3, 1)
    lost = (0, 5, 12, 15)
    present = [i for i in range(K + M) if i not in lost]
    dec_cols = prepare_matrix(GF.expand_to_bits(
        rs._reconstruct_matrix(tuple(present), lost)), dev)
    dec_ms = cuda_ms(lambda: gf2_matmul(dec_cols, data), 30)
    dec_old_ms = cuda_ms(lambda: gf2_matmul_bitslice(dec_cols, data), 30)
    one_cols = prepare_matrix(GF.expand_to_bits(
        rs._reconstruct_matrix(tuple(range(1, K + 1)), (0,))), dev)
    dec1_ms = cuda_ms(lambda: gf2_matmul(one_cols, data), 30)
    xort = turns(lambda: xor_reduce_plain(data), lambda: xor_reduce(data))
    # the chain-encode hop's K1 shape (k = 1, o = 4): both kernels in turns
    hop_cols = rs._delta_col(5)[1]
    hop_data = rand_u8((B, 1, S), 14, dev)
    hopt = turns(lambda: gf2_matmul_bitslice(hop_cols, hop_data),
                 lambda: gf2_matmul(hop_cols, hop_data))
    cdata = rand_u8((1, K, S_CHUNK), 13, dev)
    chunk_ms = cuda_ms(lambda: gf2_matmul(rs._parity_cols, cdata), 50)
    rates = mma_rates(dev)

    # where one write request's time goes: host->device copy of the numpy
    # stripes, the device work (K1, concatenation, K2), device->host copy
    codec = StripeCodec(K, M, S, device=dev)
    host = np.random.default_rng(6).integers(0, 256, (B, K, S), dtype=np.uint8)
    for _ in range(2):  # the second pass is the one kept (warm allocator)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.from_numpy(host).to(dev)
        ev[1].record()
        shards, crcs = codec.encode_batch(x)
        ev[2].record()
        shards.cpu(), crcs.view(torch.int32).cpu()
        ev[3].record()
        ev[3].synchronize()
    write_ms = {part: ev[i].elapsed_time(ev[i + 1]) for i, part in
                enumerate(["host_to_device", "encode_and_crc", "device_to_host"])}

    gib = lambda nbytes, ms: nbytes / (1 << 30) / (ms / 1e3)  # noqa: E731
    k1_bytes = B * K * S + B * M * S + M * K * 8
    k1_bound, k1_by = bound_ms(k1_bytes, 2 * (8 * M) * (8 * K) * B * S)
    nrows, nblk = B * (K + M), S // 512
    k2_bytes = nrows * S + nrows * 4 + nblk * 32 * 4
    k2_bound, k2_by = bound_ms(
        k2_bytes, nrows * (2 * 8 * S * 32 + 2 * nblk * 32 * 32))
    xor_bound = (B * K * S + B * S) / HBM_BYTES_PER_S * 1e3
    log(json.dumps({
        "encode_GiB_s": gib(B * K * S, enc["new"]),
        "encode_bitslice_GiB_s": gib(B * K * S, enc["old"]),
        "encode_turns_ms": enc, "crc_turns_ms": crct,
        "decode_4_loss_GiB_s": gib(B * K * S, dec_ms), "decode_4_loss_ms": dec_ms,
        "decode_4_loss_bitslice_ms": dec_old_ms, "decode_1_loss_ms": dec1_ms,
        "crc_GiB_s": gib(nrows * S, crct["new"]),
        "crc_table_GiB_s": gib(nrows * S, crct["old"]),
        "xor_rebuild_GiB_s": gib(B * K * S, xort["new"]),
        "xor_rebuild_plain_GiB_s": gib(B * K * S, xort["old"]),
        "xor_turns_ms": xort,
        "encode_4MiB_chunk_ms": chunk_ms,
        "delta_k1_turns_ms": hopt,
        "write_request_ms": write_ms, "mma_rates": rates,
        "shapes": "RS(12,4), B=12 stripes, S=1 MiB; CRC over 192 shards of "
                  "1 MiB, block 512; chunk S=349,696",
    }))

    def record(name, variant, source, replaces, cmp, ms, earlier_ms, plain,
               bound, by, note=NO_LIBRARY):
        """``earlier_ms``: the integer-unit kernel in the same run (K1, K2),
        or the plain torch loop that K3 was before it had a kernel."""
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {"name": name, "variant": variant, "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "equal_to_plain": cmp.max_abs_err == 0,
                "max_abs_err": cmp.max_abs_err, "ms": ms, "pr1_ms": earlier_ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": None, "library_note": note}

    k1 = ("tpu3fs_torch/csrc/gf2_matmul.cu", "tpu3fs/ops/pallas_rs.py:68")
    k2 = ("tpu3fs_torch/csrc/crc32c.cu", "tpu3fs/ops/crc32c.py:242")
    k3 = ("tpu3fs_torch/csrc/xor_reduce.cu", "tpu3fs/ops/rs.py:42")
    return [
        record("gf2_matmul", "tensor_core", *k1, cmps["K1"], enc["new"],
               enc["old"], enc_plain, k1_bound, k1_by),
        record("gf2_matmul_bitslice", "bitslice", *k1, cmps["K1"], enc["old"],
               enc["old"], enc_plain, k1_bound, k1_by),
        record("crc32c_blocks", "tensor_core", *k2, cmps["K2"], crct["new"],
               crct["old"], crc_plain, k2_bound, k2_by),
        record("crc32c_blocks_table", "table", *k2, cmps["K2"], crct["old"],
               crct["old"], crc_plain, k2_bound, k2_by),
        record("xor_reduce", "one_pass", *k3, cmps["K3"], xort["new"],
               xort["old"], xort["old"], xor_bound, "bytes", NO_XOR_LIBRARY),
    ]


def main() -> int:
    t0 = time.perf_counter()
    kind = environment()
    import tpu3fs_torch  # noqa: F401  (fails when run outside the repo)

    dev = torch.device("cuda")
    build()
    cmps = {"K1": Compare(), "K2": Compare(), "K3": Compare()}
    check_k1(dev, cmps["K1"])
    check_k2(dev, cmps["K2"])
    check_k3(dev, cmps["K3"])
    paths = {"stripe_server": serve(dev)}
    paths["hops"] = hops(dev, Compare())
    paths["multi_device"] = multi_device(dev)
    kernels = times(dev, paths, cmps)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
