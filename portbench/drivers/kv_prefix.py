"""A prefill node's KV loader: returning sessions' MLA prefixes read from the
KV cache into the card's paged pool.

Set-up stores each session's prefix (``prefix_tokens``, one length a
session; token ids and page values from the seed) through
``PrefixBlockStore.append_blocks`` (batched puts), allocates the pool (``pool_slots``
slots of one page, layer-first, bfloat16) and lands each session once.
One reader then loops until the deadline: it picks a session from the
seed, appends a new turn of ``turn_tokens`` seeded ids (never stored),
runs ``match_prefix`` and one ``get_blocks(count=match.blocks,
device=..., dtype=torch.bfloat16, out=pool, slots=...)``; slots come from
a ring over the pool, as an engine recycles finished requests. A call's
unit is the page bytes it landed.

The comparison: a seeded reservoir over every call keeps copies, taken on
the card right after the call, of four of its slots (the first, the last
and two drawn from the seed); after the window each is held bit for bit
against ``reference.kv_pages`` in every layer. Every match must cover the
whole stored prefix, every page must land, and the program's count of
landed bytes must equal the calls'.

``--control layer_swap`` lands every page with layers 0 and 1 exchanged,
``--control zero_pages`` every page as zeros, ``--control fp8_pages`` every
page rounded through float8_e5m2, the next precision below bfloat16: each
must come out not correct.
"""

from __future__ import annotations

import inspect
import random
import time

import numpy as np

from portbench import cluster
from portbench.reference import kv_pages
from portbench.runtime import Check

CONTROLS = ("layer_swap", "zero_pages", "fp8_pages")
# set-up stores the pages as batched puts of SETUP_BATCH pages
SETUP_BATCH = 32


class Driver:
    unit = "get"

    def __init__(self, ctx):
        self.ctx = ctx
        c, t = ctx.cell.config, ctx.cell.traffic
        self.T = c["page_tokens"]
        self.page_shape = (c["num_hidden_layers"], self.T,
                           c["kv_lora_rank"] + c["qk_rope_head_dim"])
        self.page_bytes = 2 * int(np.prod(self.page_shape))
        self.P = c["pool_slots"]
        self.prefixes = list(t["prefix_tokens"])
        self.turn = tuple(t["turn_tokens"])
        self.workers = t["readers"]
        if c["kv_dtype"] != "bfloat16":
            raise ValueError("the pages are bfloat16")
        if len(self.prefixes) != c["sessions"]:
            raise ValueError("one prefix length a session")
        if any(n % self.T for n in self.prefixes):
            raise ValueError("prefixes are whole pages")
        if max(self.prefixes) // self.T > self.P:
            raise ValueError("a prefix must fit the pool")
        if self.workers != 1:
            raise ValueError("one reader owns the pool's ring")

    def setup(self) -> None:
        import torch
        from tpu3fs_torch.kvcache import KVCacheClient, PrefixBlockStore

        ctx, c = self.ctx, self.ctx.cell.config
        params = inspect.signature(PrefixBlockStore.get_blocks).parameters
        if not {"dtype", "out", "slots"} <= set(params):
            raise RuntimeError("the program's get_blocks cannot land pages "
                               "of a declared type into a pool")
        if ctx.control is not None and ctx.control not in CONTROLS:
            raise ValueError(f"no control {ctx.control!r} for KV reads")
        with ctx.phase("cluster"):
            self.fab = cluster.build(c, ctx.device)
        self.fio = self.fab.file_client()
        self.cache = KVCacheClient(
            self.fab.meta, self.fio,
            inode_cache=c["inode_cache"],
            touch_coalesce_s=c["touch_coalesce_s"])
        self.store = PrefixBlockStore(self.cache, block_tokens=self.T)
        self.tokens = [self._session_tokens(s, n)
                       for s, n in enumerate(self.prefixes)]
        with ctx.phase("pages"):
            for s, toks in enumerate(self.tokens):
                for lo in range(0, len(toks) // self.T, SETUP_BATCH):
                    self._store_pages(s, lo)
        with ctx.phase("pool"):
            self.pool = torch.zeros((self.page_shape[0], self.P)
                                    + self.page_shape[1:],
                                    dtype=torch.bfloat16, device=ctx.device)
        if ctx.control is not None:
            self._plant_control(ctx.control)
        self.head = 0
        with ctx.phase("warm-up"):  # one get of each session
            for s in range(len(self.tokens)):
                self._get(self.tokens[s])

    def _store_pages(self, s: int, lo: int) -> None:
        """Pages [lo, lo + SETUP_BATCH) of session s, as one batched put."""
        toks = self.tokens[s]
        hi = min(len(toks) // self.T, lo + SETUP_BATCH)
        self.store.append_blocks(toks, [
            kv_pages.as_bf16(kv_pages.page_bits(self.ctx.seed, s, p,
                                                self.page_shape))
            for p in range(lo, hi)], start_block=lo)

    def _session_tokens(self, s: int, n: int) -> list:
        rng = np.random.default_rng([self.ctx.seed % (1 << 64), 1, s])
        vocab = self.ctx.cell.config["vocab_size"]
        return rng.integers(0, vocab, n).tolist()

    def _get(self, toks: list):
        """One load: match, then land the matched pages at the ring's
        head. -> (matched pages, the slots returned)."""
        import torch

        match = self.store.match_prefix(toks)
        slots = [(self.head + i) % self.P for i in range(match.blocks)]
        got = self.store.get_blocks(toks, count=match.blocks,
                                    device=self.ctx.device,
                                    dtype=torch.bfloat16, out=self.pool,
                                    slots=slots)
        self.head = (self.head + match.blocks) % self.P
        return match.blocks, got

    def _plant_control(self, control: str) -> None:
        """The hand-off with a guarantee broken, in the program's place."""
        import torch
        from tpu3fs_torch.kvcache import landing

        land = landing.PageLander.land

        def broken(lander, pages, out, slots):
            if control == "layer_swap":
                order = [1, 0] + list(range(2, out.shape[0]))
                pages = [p[order] for p in pages]
            elif control == "fp8_pages":
                pages = [p.to(torch.float8_e5m2).to(p.dtype) for p in pages]
            else:
                pages = [torch.zeros_like(p) for p in pages]
            return land(lander, pages, out, slots)

        self._restore = (landing.PageLander, "land", land)
        landing.PageLander.land = broken

    def begin_window(self) -> None:
        t = self.ctx.cell.traffic
        self.quota = t["check_calls"]
        self.kept = []      # (session, [(page, copy on the card)])
        self.offered = 0
        self.misses = 0
        self.draw = random.Random(self.ctx.seed * 31 + 7)
        self.pick = random.Random(self.ctx.seed * 31 + 11)
        self.turn_rng = np.random.default_rng(
            [self.ctx.seed % (1 << 64), 2])

    def counters(self) -> dict:
        """Program totals that nothing resets; a program without one of
        them leaves it out."""
        store, out = self.store, {}
        stage = getattr(store, "stage_s", {})
        if "fs_read" in stage:
            out["fs_read_s"] = stage["fs_read"]
        if "copy" in stage:
            out["h2d_s"] = stage["copy"]
        for key in ("pages_landed", "page_bytes_landed"):
            rec = getattr(store, key, None)
            if rec is not None:
                out[key] = rec.total
        return out

    def _slot_of(self):
        """Where the next done call's copies go in the reservoir (a uniform
        sample of ``check_calls`` calls of the window), or None."""
        i, self.offered = self.offered, self.offered + 1
        if i < self.quota:
            self.kept.append(None)
            return i
        j = self.draw.randrange(i + 1)
        return j if j < self.quota else None

    def worker(self, r: int, deadline: int) -> None:
        spans = self.ctx.spans
        vocab = self.ctx.cell.config["vocab_size"]
        while time.perf_counter_ns() < deadline:
            s = self.pick.randrange(len(self.tokens))
            n_turn = self.pick.randint(*self.turn)
            toks = self.tokens[s] + self.turn_rng.integers(
                0, vocab, n_turn).tolist()
            want = len(self.tokens[s]) // self.T
            head = self.head
            t0 = time.perf_counter_ns()
            try:
                matched, got = self._get(toks)
            except Exception as e:
                spans.add(self.unit + ".failed", t0, time.perf_counter_ns())
                self.ctx.log(f"# get failed: {e!r}")
                continue
            t1 = time.perf_counter_ns()
            landed = sum(g is not None for g in got)
            if matched != want or landed != want:
                self.misses += 1
            spans.add(self.unit, t0, t1, landed * self.page_bytes)
            at = self._slot_of()
            if at is not None and landed:
                picks = {0, landed - 1}
                while len(picks) < min(4, landed):
                    picks.add(self.draw.randrange(landed))
                self.kept[at] = (s, [(p, self.pool[:, (head + p) % self.P]
                                      .clone()) for p in sorted(picks)])

    def work(self, rec) -> dict:
        return {}  # no kernel: the copy engine lands the pages

    def sample_lines(self, rec) -> list:
        done = rec.done()
        n = len(done)
        stages = ", ".join(f"{k} {rec.counter(k):.3f} s" for k in
                           ("fs_read_s", "h2d_s")
                           if rec.counter(k) is not None)
        ms = {}  # pages a call -> its calls' ms, in order
        for _, t0, t1, nbytes in done:
            ms.setdefault(nbytes // self.page_bytes, []).append(
                (t1 - t0) / 1e6)
        per_size = "; ".join(
            f"{k} pages x{len(v)}: median {float(np.median(v)):.1f} ms, "
            f"first {v[0]:.1f}, max {max(v):.1f}"
            for k, v in sorted(ms.items()))
        return [f"get calls {n}, {n - int(np.ceil(0.95 * n))} beyond their "
                f"p95; {per_size}; in the program: {stages}"]

    def check(self, rec) -> list:
        import torch

        failed = len([s for s in rec.spans if s[0] == self.unit + ".failed"])
        wrong = dtype_wrong = checked = 0
        for s, copies in (k for k in self.kept if k is not None):
            for p, got in copies:
                checked += 1
                if got.dtype != torch.bfloat16:
                    dtype_wrong += 1
                    continue
                want = kv_pages.page_bits(self.ctx.seed, s, p,
                                          self.page_shape)
                wrong += int(not np.array_equal(kv_pages.bits_of(got),
                                                want))
        for s, toks in enumerate(self.tokens):  # a block of each, unpooled
            (blk,) = self.store.get_blocks(toks, count=1,
                                           device=self.ctx.device,
                                           dtype=torch.bfloat16)
            dtype_wrong += int(blk is None or blk.dtype != torch.bfloat16)
        landed = rec.counter("page_bytes_landed")
        self.ctx.log(f"# check: {checked} pages of {len(self.kept)} calls; "
                     f"program counted {landed} bytes landed")
        return [Check("failed_calls", failed, 0),
                Check("checked_pages", checked, 1, ">="),
                Check("pages_wrong", wrong, 0),
                Check("dtype_wrong", dtype_wrong, 0),
                Check("prefix_misses", self.misses, 0),
                Check("landed_bytes_unequal",
                      int(landed is None or landed != rec.done_bytes), 0)]

    def close(self) -> None:
        restore = getattr(self, "_restore", None)
        if restore is not None:
            setattr(*restore)
        fio = getattr(self, "fio", None)
        if fio is not None:
            fio.close()
        fab = getattr(self, "fab", None)
        if fab is not None:
            fab.close()
