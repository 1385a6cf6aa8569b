"""Content-addressed prefix-block store: prompt-prefix KV dedup.

Decoder KV tensors are cached as fixed-size TOKEN-BLOCK pages keyed by a
rolling prefix-hash chain:

    key[0] = H(root, tokens[0:B])
    key[i] = H(key[i-1], tokens[i*B:(i+1)*B])

A block's key therefore commits to the ENTIRE token prefix up to and
including it — two requests sharing a prompt prefix derive the same chain
of keys and dedupe to the same fs entries (vLLM-style prefix caching, but
the page table is the filesystem namespace: nothing to synchronize
between inference processes). Divergent suffixes fork the chain at the
first differing block; partial trailing blocks are never stored (their
tokens recompute in one step's prefill).

Because keys are content-addressed, entries are IMMUTABLE: the host tier
(tier.py) can cache them forever without staleness, a double store is
idempotent, and ``match_prefix`` is pure presence-probing — one batched
stat for the whole chain, then the longest present prefix.

``get_blocks`` returns device-ready arrays: the fs bytes decode as
zero-copy views (layout.decode_array) and ``device=`` copies each block
into a ``torch.Tensor`` on that device (the card: ``"cuda"``), so a
serving loop can feed attention kernels directly; ``dtype=`` declares the
element type (a bfloat16 page is stored as ``<V2``), and ``out=`` with
``slots=`` lands the blocks in the caller's layer-first paged pool
(``landing.py``). ``stage_s`` sums the seconds ``get_blocks`` spends in
each stage: the cache read, the decode and the copy to the device (the
landing, where a pool is given). The spans ``kvcache.get_blocks`` (stages
``fs_read``, ``decode``, ``h2d``) and ``kvcache.match_prefix`` and the
counters ``kvcache.pages_landed`` and ``kvcache.page_bytes_landed`` are
in ``analytics/spans.py``'s glossary.
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.device import checked_device
from tpu3fs_torch.kvcache.landing import PageLander
from tpu3fs_torch.kvcache.layout import as_tensor, decode_array, encode_array
from tpu3fs_torch.monitor.recorder import CounterRecorder
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

_TOKEN = struct.Struct("<q")
_ROOT = b"tpu3fs-kvblock-v1"


def _digest(parent: bytes, token_ids: Sequence[int]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    for t in token_ids:
        h.update(_TOKEN.pack(t))
    return h.digest()


def chain_keys(token_ids: Sequence[int], block_tokens: int,
               *, salt: bytes = b"") -> List[str]:
    """Keys of every FULL block of the sequence, in chain order. The
    trailing ``len % block_tokens`` tokens have no key (never stored)."""
    if block_tokens <= 0:
        raise _err(Code.INVALID_ARG, f"block_tokens {block_tokens}")
    parent = _ROOT + salt
    keys: List[str] = []
    for lo in range(0, len(token_ids) - block_tokens + 1, block_tokens):
        parent = _digest(parent, token_ids[lo:lo + block_tokens])
        keys.append(parent.hex())
    return keys


@dataclass
class PrefixMatch:
    """Longest stored prefix of a token sequence."""

    tokens: int = 0                       # matched token count (blocks*B)
    blocks: int = 0                       # matched full blocks
    keys: List[str] = field(default_factory=list)   # their chain keys


class PrefixBlockStore:
    """Prefix-hash-chained KV block pages over any cache with the
    get/put/batch surface (``KVCacheClient`` or ``TieredKVCache``)."""

    def __init__(self, cache, *, block_tokens: int = 16,
                 salt: bytes = b"", leases=None):
        if block_tokens <= 0:
            raise _err(Code.INVALID_ARG, f"block_tokens {block_tokens}")
        self._cache = cache
        self.block_tokens = block_tokens
        self._salt = salt
        self._leases = leases
        self._stage_mu = threading.Lock()
        #: seconds spent by get_blocks, summed: "fs_read" (the cache's
        #: batch_get: host-tier hits, peer fills and storage reads),
        #: "decode" (the header parse and stale re-probes) and "copy"
        #: (the copy to ``device``, which ends when the block is there)
        self.stage_s: Dict[str, float] = {"fs_read": 0.0, "decode": 0.0,
                                          "copy": 0.0}
        #: blocks put on a device or into a pool, and their payload bytes
        self.pages_landed = CounterRecorder("kvcache.pages_landed")
        self.page_bytes_landed = CounterRecorder("kvcache.page_bytes_landed")
        self._lander = PageLander()

    @property
    def cache(self):
        return self._cache

    def block_keys(self, token_ids: Sequence[int]) -> List[str]:
        return chain_keys(token_ids, self.block_tokens, salt=self._salt)

    # -- lookup -------------------------------------------------------------
    def match_prefix(self, token_ids: Sequence[int]) -> PrefixMatch:
        """Longest-prefix lookup: ONE batched presence probe over the
        whole chain, then the longest run of present blocks from the
        start. (A mid-chain hole ends the match — later blocks' KV
        depends on the missing tokens' positions being resident.)"""
        keys = self.block_keys(token_ids)
        if not keys:
            return PrefixMatch()
        with _spans.root_span("kvcache.match_prefix"):
            present = self._cache.batch_contains(keys)
        n = 0
        for hit in present:
            if not hit:
                break
            n += 1
        return PrefixMatch(tokens=n * self.block_tokens, blocks=n,
                           keys=keys[:n])

    # -- writes -------------------------------------------------------------
    def append_blocks(self, token_ids: Sequence[int], kv_blocks,
                      *, start_block: int = 0,
                      write_through: Optional[bool] = None) -> int:
        """Store per-block KV arrays for blocks [start_block,
        start_block + len(kv_blocks)) of the sequence; returns blocks
        actually WRITTEN. Already-present keys are skipped (one batched
        probe), so two sessions extending a shared prefix store each
        shared block exactly once — content addressing makes the racy
        double-store idempotent anyway (same key, same bytes)."""
        keys = self.block_keys(token_ids)
        want = keys[start_block:start_block + len(kv_blocks)]
        if len(want) != len(kv_blocks):
            raise _err(Code.INVALID_ARG,
                       f"{len(kv_blocks)} blocks at {start_block} but the "
                       f"sequence only chains {len(keys)} full blocks")
        present = self._cache.batch_contains(want)
        items = [(key, encode_array(arr))
                 for key, arr, hit in zip(want, kv_blocks, present)
                 if not hit]
        if not items:
            return 0
        # drain as ONE batched put (KVCacheClient.batch_put: one
        # batch_create + one striped batch write + one batch_close for
        # the whole drain) — the last per-block serial-create path
        # (ROADMAP carried follow-up; regression-pinned in
        # tests/test_kvcache.py, and in the port's tests)
        batched = getattr(self._cache, "batch_put", None)
        if batched is not None and len(items) > 1:
            if write_through is None:
                batched(items)
            else:
                try:
                    batched(items, write_through=write_through)
                except TypeError:  # fs-tier cache: always through
                    batched(items)
        else:
            for key, raw in items:
                if write_through is None:
                    self._cache.put(key, raw)
                else:
                    self._cache.put(key, raw, write_through=write_through)
        return len(items)

    # -- reads --------------------------------------------------------------
    def get_blocks(self, token_ids: Sequence[int], *,
                   count: Optional[int] = None, device=None, dtype=None,
                   out: Optional[torch.Tensor] = None,
                   slots: Optional[Sequence[int]] = None) -> List:
        """Fetch the sequence's first `count` blocks (default: every full
        block) — host-tier hits from RAM, all misses as ONE striped batch
        underneath. Missing blocks come back as None (the caller
        re-prefills that suffix). With ``device=None`` each block is a
        numpy view over the bytes read; with ``device=`` (``"cuda"``, or
        ``"cpu"`` for a host tensor) it is copied into a ``torch.Tensor``
        there. ``"cuda"`` on a machine with no card raises.

        ``dtype`` declares the blocks' element type (``layout.as_tensor``):
        a bfloat16 page, stored as ``<V2``, comes back as
        ``torch.bfloat16`` (on the host without ``device``); undeclared,
        such a page raises TypeError where it would become a tensor.

        ``out`` and ``slots`` land the blocks in a caller's layer-first
        pool instead: ``out`` is ``(L, P, *page[1:])``, contiguous, of the
        declared (or the pages') type, on ``device`` where one is given;
        block ``i`` lands in ``out[:, slots[i]]`` (``landing.PageLander``)
        and the call returns ``slots[i]``, or None for a miss, whose slot
        is left as it was. A pool, slot or page that does not fit raises
        INVALID_ARG before any block lands."""
        dev = None if device is None else checked_device(device)
        keys = self.block_keys(token_ids)
        if count is not None:
            keys = keys[:count]
        if out is not None or slots is not None:
            dev = _check_pool(out, slots, len(keys), dev, dtype)
        with _spans.root_span("kvcache.get_blocks"):
            t0 = time.perf_counter()
            with _spans.span("kvcache.get_blocks", "fs_read"):
                blobs = self._cache.batch_get(keys)
            t1 = time.perf_counter()
            with _spans.span("kvcache.get_blocks", "decode"):
                blocks = [None if raw is None else self._decode(keys[i], raw)
                          for i, raw in enumerate(blobs)]
                hits = [i for i, blk in enumerate(blocks) if blk is not None]
                if out is not None or dtype is not None:
                    for i in hits:
                        blocks[i] = as_tensor(blocks[i], dtype)
                if out is not None:
                    _check_pages([blocks[i] for i in hits], out)
            t2 = time.perf_counter()
            result: List = blocks
            if out is not None:
                with _spans.span("kvcache.get_blocks", "h2d"):
                    self._lander.land([blocks[i] for i in hits], out,
                                      [slots[i] for i in hits])
                result = [None] * len(keys)
                for i in hits:
                    result[i] = slots[i]
            elif dev is not None:
                with _spans.span("kvcache.get_blocks", "h2d"):
                    result = [None if blk is None else _to_device(blk, dev)
                              for blk in blocks]
            t3 = time.perf_counter()
        if dev is not None and hits:
            self.pages_landed.add(len(hits))
            self.page_bytes_landed.add(sum(blocks[i].nbytes for i in hits))
        with self._stage_mu:
            self.stage_s["fs_read"] += t1 - t0
            self.stage_s["decode"] += t2 - t1
            self.stage_s["copy"] += t3 - t2
        return result

    def _decode(self, key: str, raw):
        """Decode one block; a KVCACHE_STALE read (cached inode outlived
        a GC'd entry — zero-hole payload) invalidates and re-probes ONCE
        so the caller sees a plain miss, never zeros-as-KV."""
        try:
            return decode_array(raw)
        except FsError as e:
            if e.code != Code.KVCACHE_STALE:
                raise
        invalidate = getattr(self._cache, "invalidate", None)
        if invalidate is None:
            return None
        invalidate(key)
        raw = self._cache.get(key)
        if raw is None:
            return None
        return decode_array(raw)

    # -- leases -------------------------------------------------------------
    def pin_prefix(self, match: PrefixMatch, ttl_s: Optional[float] = None):
        """Pin a matched prefix's blocks for the decode's lifetime (needs
        a LeaseManager wired at construction)."""
        if self._leases is None:
            raise _err(Code.INVALID_ARG,
                       "PrefixBlockStore built without a LeaseManager")
        return self._leases.pin(match.keys, ttl_s)


def _to_device(block, device: torch.device) -> torch.Tensor:
    """The device hand-off: a host tensor over the decoded view (a numpy
    block is read by ``layout.as_tensor``), copied to ``device`` (a
    blocking copy, so the block is there on return). A void (``|V2``,
    bfloat16) page with no declared type raises TypeError, as
    ``jax.device_put`` does in the JAX package."""
    if not isinstance(block, torch.Tensor):
        block = as_tensor(block)
    return block.to(device, copy=True)


def _check_pool(out, slots, n: int, dev, dtype) -> torch.device:
    """The pool and slots of a landing get: -> the pool's device. Raises
    INVALID_ARG for a pool that is not a contiguous tensor of at least two
    dims on ``dev`` and of ``dtype`` (where given), or slots that are not
    ``n`` distinct indices of its second dim."""
    if out is None or slots is None:
        raise _err(Code.INVALID_ARG, "out and slots go together")
    if not isinstance(out, torch.Tensor) or out.dim() < 2:
        raise _err(Code.INVALID_ARG, "out is not a tensor (L, P, ...)")
    if not out.is_contiguous():
        raise _err(Code.INVALID_ARG, "out is not contiguous")
    if dev is not None and (dev.type != out.device.type or (
            dev.index is not None and dev.index != out.device.index)):
        raise _err(Code.INVALID_ARG, f"out on {out.device}, device {dev}")
    if dtype is not None and out.dtype != dtype:
        raise _err(Code.INVALID_ARG, f"out of {out.dtype}, dtype {dtype}")
    slots = list(slots)
    if len(slots) != n:
        raise _err(Code.INVALID_ARG, f"{len(slots)} slots for {n} blocks")
    P = out.shape[1]
    if any(not isinstance(s, (int, np.integer)) or not 0 <= s < P
           for s in slots) or len(set(slots)) != n:
        raise _err(Code.INVALID_ARG, f"slots must be {n} distinct indices "
                   f"in [0, {P})")
    return out.device


def _check_pages(pages, out: torch.Tensor) -> None:
    """Every page fits a slot of ``out``: shape ``out.shape[:1] +
    out.shape[2:]`` and ``out``'s dtype; else INVALID_ARG."""
    want = (out.shape[0],) + tuple(out.shape[2:])
    for p in pages:
        if tuple(p.shape) != want or p.dtype != out.dtype:
            raise _err(Code.INVALID_ARG,
                       f"a {p.dtype} page {tuple(p.shape)} for slots of "
                       f"{out.dtype} {want}")
