"""Stripe codec: the EC data plane the serving path calls, on one device.

Counterpart of ``tpu3fs/ops/stripe.py``. One stripe is one file chunk split
into k data shards of S bytes plus m parity shards. Write is RS encode (K1)
plus a CRC32C of every shard (K2); verify is the CRC; degraded read and
rebuild are ``RSCode.reconstruct_fn`` (K1, or the K3 XOR for a single loss).
A sub-stripe write's parity delta and a chain-encode hop apply one parity
column through K1 (k = 1); the hop CRCs its contribution through K2. The
JAX codec ran those two on host kernels; here they run on the codec's
device like everything else.

The codec runs on its device. It takes numpy arrays and returns numpy
arrays, as the JAX codec does, or takes a tensor already on its device and
returns tensors there. The JAX codec padded batches to a power of two
(``_bucket``) only to bound XLA recompiles; PyTorch runs eagerly, so the
batch goes to the kernels as it is.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu3fs_torch.device import as_tensor, resolve_device
from tpu3fs_torch.ops.crc32c import BatchCrc32c, crc32c_many
from tpu3fs_torch.ops.rs import RSCode

# codecs hold device matrices: share one per (k, m, S, device) per process
_cache_lock = threading.Lock()
_codecs: Dict[Tuple[int, int, int, torch.device], "StripeCodec"] = {}


def get_codec(k: int, m: int, shard_size: int, device=None) -> "StripeCodec":
    dev = resolve_device(device)
    key = (k, m, shard_size, dev)
    with _cache_lock:
        codec = _codecs.get(key)
        if codec is None:
            codec = StripeCodec(k, m, shard_size, device=dev)
            _codecs[key] = codec
        return codec


def aligned_shard_size(n: int) -> int:
    """Round a working shard size up to the 512B/64B grid shard_size_of
    uses — zero padding is free for RS/CRC math."""
    align = 512 if n >= 512 else 64
    return -(-n // align) * align


def shard_size_of(chunk_size: int, k: int) -> int:
    """Shard size for a chunk striped over k data shards (last shard padded),
    rounded up to 512B (64B for tiny shards). Client and server both derive
    S through here, so the alignment is part of the stripe format."""
    s0 = -(-chunk_size // k)
    align = 512 if s0 >= 512 else 64
    return -(-s0 // align) * align


def _out(t: torch.Tensor, as_numpy: bool):
    if not as_numpy:
        return t
    if t.dtype == torch.uint32:  # copied as int32: uint32 has few kernels
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


class StripeCodec:
    """Encode/decode/checksum a batch of stripes on one device."""

    def __init__(self, k: int, m: int, shard_size: int, device=None):
        dev = resolve_device(device)
        block = 512 if shard_size % 512 == 0 else shard_size
        self._setup(RSCode(k, m, device=dev),
                    BatchCrc32c(shard_size, block=block, device=dev))

    @classmethod
    def from_parts(cls, rs: RSCode, crc: BatchCrc32c) -> "StripeCodec":
        if rs.device != crc.device:
            raise ValueError(f"RS on {rs.device}, CRC on {crc.device}")
        self = cls.__new__(cls)
        self._setup(rs, crc)
        return self

    def _setup(self, rs: RSCode, crc: BatchCrc32c) -> None:
        self.rs = rs
        self._crc = crc
        self.k, self.m = rs.k, rs.m
        self.shard_size = crc.size
        self.device = rs.device

    def _check(self, data, k: int) -> None:
        if tuple(data.shape[1:]) != (k, self.shard_size):
            raise ValueError(
                f"stripes {tuple(data.shape)}, want (B, {k}, {self.shard_size})")

    # -- encode --------------------------------------------------------------
    def encode_batch(self, data):
        """(B, k, S) uint8 -> (shards (B, k+m, S), crcs (B, k+m) uint32)."""
        self._check(data, self.k)
        x = as_tensor(data, self.device)
        b = x.shape[0]
        shards = torch.cat([x, self.rs.encode(x)], dim=1)
        crcs = self._crc(shards.reshape(b * (self.k + self.m), self.shard_size))
        as_np = not isinstance(data, torch.Tensor)
        return (_out(shards, as_np),
                _out(crcs.reshape(b, self.k + self.m), as_np))

    def encode_parity(self, data):
        """(B, k, S) uint8 -> (parity (B, m, S), crcs (B, k+m) uint32)."""
        shards, crcs = self.encode_batch(data)
        return shards[:, self.k:], crcs

    def delta_parity(self, j: int, delta):
        """Parity-row deltas for a sub-stripe change on data shard j:
        ``delta`` is D'_j ^ D_j zero-padded to S bytes (bytes, or an array of
        S bytes) -> (m, S) rows to XOR into the stored parity shards
        (``P'_i = P_i ^ c_ij * dD``). Leading batch dimensions pass through."""
        as_np = not isinstance(delta, torch.Tensor)
        if isinstance(delta, (bytes, bytearray, memoryview)):
            delta = np.frombuffer(delta, dtype=np.uint8).copy()  # writable
        if delta.shape[-1] != self.shard_size:
            raise ValueError(f"delta {tuple(delta.shape)}, shard size "
                             f"{self.shard_size}")
        return _out(self.rs.delta_parity(j, delta), as_np)

    def hop_accumulate(self, j: int, payloads, acc):
        """One chain-encode hop over a stripe batch: XOR data shard j's
        coefficient-scaled contribution into the parity accumulators and
        return the contribution CRCs.

        ``payloads`` is a length-B sequence of the hop's stored (trimmed)
        shard-j bytes, one per stripe, each zero-padded here to S; ``acc``
        is the (B, m, S) uint8 accumulator riding the chain, updated IN
        PLACE: a numpy array is written back into, a tensor on the codec's
        device is updated there. Returns the (B, m) uint32 CRC32Cs (K2) of
        the contribution rows, numpy for a numpy ``acc``, for the per-hop
        partial-CRC composition (``crc32c_xor``)."""
        B, S = len(payloads), self.shard_size
        if tuple(acc.shape) != (B, self.m, S):
            raise ValueError(f"accumulator {tuple(acc.shape)}, want "
                             f"({B}, {self.m}, {S})")
        d = np.zeros((B, S), dtype=np.uint8)
        for b, p in enumerate(payloads):
            flat = np.frombuffer(p, dtype=np.uint8)
            if flat.size > S:
                raise ValueError(f"payload {b} has {flat.size} bytes, S = {S}")
            d[b, :flat.size] = flat
        contrib = self.rs.gf_accumulate(j, d, acc)
        crcs = self._crc(contrib.reshape(B * self.m, S)).reshape(B, self.m)
        return _out(crcs, not isinstance(acc, torch.Tensor))

    def encode_stripe(self, chunk: bytes) -> Tuple[np.ndarray, np.ndarray]:
        """One chunk (<= k*S bytes, zero-padded) -> ((k+m, S), (k+m,))."""
        buf = np.zeros((self.k, self.shard_size), dtype=np.uint8)
        flat = np.frombuffer(chunk, dtype=np.uint8)
        buf.reshape(-1)[: flat.size] = flat
        shards, crcs = self.encode_batch(buf[None])
        return shards[0], crcs[0]

    # -- decode --------------------------------------------------------------
    def reconstruct_batch(self, present_idx: Sequence[int],
                          lost_idx: Sequence[int], present):
        """(B, k, S) survivors at present_idx -> (B, len(lost), S) rebuilt."""
        self._check(present, self.k)
        out = self.rs.reconstruct(present_idx, lost_idx, present)
        return _out(out, not isinstance(present, torch.Tensor))

    def crc_batch(self, shards):
        """(N, S) uint8 -> (N,) uint32."""
        out = self._crc(as_tensor(shards, self.device))
        return _out(out, not isinstance(shards, torch.Tensor))

    # -- host-side assembly helpers ------------------------------------------
    def assemble(self, data_shards: List[Optional[bytes]], length: int) -> bytes:
        """Concatenate k data shards (None = absent, an error upstream)
        and trim the stripe padding to the chunk's logical length."""
        assert all(s is not None for s in data_shards)
        return b"".join(data_shards)[:length]

    def crc_host(self, shard: bytes) -> int:
        """CRC32C of one shard's stored (trimmed) bytes, the
        ShardWriteReq.crc wire convention: one ``crc32c_many`` call (K2)
        on the codec's device."""
        return crc32c_many([shard], self.device)[0]


def trim_rebuilt_shard(
    rebuilt: bytes, j: int, survivor_lens: Dict[int, int], k: int, S: int
) -> bytes:
    """Trim a rebuilt data shard back to its stored (logical) extent.

    Shards are stored trimmed — shard j holds chunk bytes [j*S, (j+1)*S) up
    to the stripe's logical length — so the rebuilt padded bytes must be
    cut back or the re-installed shard would inflate the stripe's recorded
    length. survivor_lens maps surviving DATA shard index -> stored length.

    Exact cases: any nonempty survivor above j proves shard j was full; a
    nonempty-to-empty boundary below j proves it was empty. The one
    ambiguous case (j is the last nonempty shard, partially filled) falls
    back to trailing-zero trimming: bytes stay exact either way, only the
    recorded length can undershoot if the true content ends in zeros."""
    if j >= k:
        return rebuilt  # parity shards are always stored full
    if any(lj > 0 for i, lj in survivor_lens.items() if i > j and i < k):
        return rebuilt  # a later data shard has content: j was full
    below = [lj for i, lj in survivor_lens.items() if i < j]
    if below and min(below) < S:
        return b""  # an earlier shard is short: logical length < j*S
    return rebuilt.rstrip(b"\x00")
