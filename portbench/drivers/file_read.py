"""Closed-loop file readers with a storage node down: the degraded read.

Set-up writes the files (every call ``reference.payload.call_bytes_of``),
then fails the node that holds shard ``fail_shard`` of the first chain.
Reader ``r`` reads files ``r``, ``r + readers``, ... one after another,
each front to back in calls of ``call_bytes``, and again from the first.
The comparison holds a sample of the reads, drawn from the seed over every
call of the window (a reservoir a reader), byte for byte against the bytes
written.
"""

from __future__ import annotations

import random
import time

import numpy as np

from portbench import cluster
from portbench.reference import payload
from portbench.runtime import Check


def offer(kept: list, quota: int, i: int, item, draw: random.Random) -> None:
    """Item ``i`` (from 0) of a stream into ``kept``, a uniform sample of
    ``quota`` items of the stream so far (reservoir sampling)."""
    if i < quota:
        kept.append(item)
    else:
        j = draw.randrange(i + 1)
        if j < quota:
            kept[j] = item


class Driver:
    unit = "read"

    def __init__(self, ctx):
        self.ctx = ctx
        c, t = ctx.cell.config, ctx.cell.traffic
        self.k, self.m = c["ec_k"], c["ec_m"]
        self.S, self.stripe = c["shard_size"], c["chunk_size"]
        self.workers = t["readers"]
        self.nfiles = t["files"]
        self.file = t["file_bytes"]
        self.call = t["call_bytes"]
        if self.call % self.stripe or self.file % self.call:
            raise ValueError("calls must be whole stripes, files whole calls")
        self.calls_per_file = self.file // self.call
        if self.nfiles < self.workers:
            raise ValueError("every reader needs a file of its own")

    def setup(self) -> None:
        from tpu3fs_torch.meta.store import OpenFlags

        ctx = self.ctx
        with ctx.phase("cluster"):
            self.fab = cluster.build(ctx.cell.config, ctx.device)
        with ctx.phase("pool"):
            self.pool = payload.make_pool(
                ctx.seed, payload.pool_bytes(self.call, self.S, 4),
                ctx.device)
        fio = self.fab.file_client()
        self.inodes = []
        t_fill = time.perf_counter()
        for f in range(self.nfiles):
            path = f"/r{f}"
            res = self.fab.meta.create(path, flags=OpenFlags.WRITE
                                       | OpenFlags.CREATE, client_id="setup")
            for c in range(self.file // self.call):
                fio.write(res.inode, c * self.call, self._call_bytes(f, c))
            self.fab.meta.close(res.inode.id, res.session_id,
                                length_hint=self.file, wrote=True)
            self.inodes.append(self.fab.meta.stat(path))
        fio.close()
        ctx.log(f"# setup: files {time.perf_counter() - t_fill:.3f} s")
        first = self.fab.chain_ids[0]
        self.failed_node = cluster.node_of_shard(
            self.fab, first, ctx.cell.traffic["fail_shard"])
        self.fab.fail_node(self.failed_node)
        self.lost = {cid: self._lost_shard(cid) for cid in self.fab.chain_ids}
        self.clients = [self.fab.file_client() for _ in range(self.workers)]
        if ctx.control == "no_decode":
            self._plant_control()
        elif ctx.control is not None:
            raise ValueError(f"no control {ctx.control!r} for file reads")
        with ctx.phase("warm-up"):  # one read each
            for r in range(self.workers):
                self.clients[r].read(self.inodes[r % self.nfiles], 0,
                                     self.call)

    def begin_window(self) -> None:
        # each reader's reservoir of (file, offset, bytes, done ns): a
        # uniform sample of its calls, drawn from the seed
        quota = -(-self.ctx.cell.traffic["check_calls"] // self.workers)
        self.kept = [[] for _ in range(self.workers)]
        self.quota = quota
        self.draws = [random.Random(self.ctx.seed * 31 + r)
                      for r in range(self.workers)]

    def _call_bytes(self, f: int, c: int) -> np.ndarray:
        return payload.call_bytes_of(self.pool, self.ctx.seed, f % 4, f, c,
                                     self.call, self.S)

    def _lost_shard(self, chain_id: int):
        for j in range(self.k + self.m):
            if cluster.node_of_shard(self.fab, chain_id, j) == \
                    self.failed_node:
                return j
        return None

    def _plant_control(self) -> None:
        """A client with no degraded decode in the decoder's place: the
        lost shards of a stripe read back as zeros, so a read with a node
        down does not return the bytes written."""
        import torch
        from tpu3fs_torch.ops import stripe

        def reconstruct_batch(codec, present_idx, lost_idx, present):
            out = np.zeros((present.shape[0], len(lost_idx), present.shape[2]),
                           dtype=np.uint8)
            return out if not isinstance(present, torch.Tensor) else \
                torch.from_numpy(out).to(present.device)

        self._restore = (stripe.StripeCodec, "reconstruct_batch",
                         stripe.StripeCodec.reconstruct_batch)
        stripe.StripeCodec.reconstruct_batch = reconstruct_batch

    def counters(self) -> dict:
        return {"launches": cluster.kernel_launches(),
                "degraded_stripes": sum(c.storage._ec_degraded._value
                                        for c in self.clients)}

    def worker(self, r: int, deadline: int) -> None:
        fio, spans = self.clients[r], self.ctx.spans
        draw, kept = self.draws[r], self.kept[r]
        mine = list(range(r, self.nfiles, self.workers))
        i = 0
        while time.perf_counter_ns() < deadline:
            f = mine[i // self.calls_per_file % len(mine)]
            off = (i % self.calls_per_file) * self.call
            t0 = time.perf_counter_ns()
            try:
                got = fio.read(self.inodes[f], off, self.call)
            except Exception as e:
                spans.add(self.unit + ".failed", t0, time.perf_counter_ns())
                self.ctx.log(f"# read failed: {e!r}")
                i += 1
                continue
            t1 = time.perf_counter_ns()
            if len(got) != self.call:
                spans.add(self.unit + ".failed", t0, t1)
                self.ctx.log(f"# short read: {len(got)} of {self.call}")
            else:
                spans.add(self.unit, t0, t1, self.call)
            offer(kept, self.quota, i, (f, off, got, t1), draw)
            i += 1

    def work(self, rec) -> dict:
        """The decode of a stripe whose lost shard is a data shard reads k
        survivors and writes the lost shard; a read of whole stripes needs
        every data shard."""
        stripes = rec.done_bytes // self.stripe
        lost = {j for j in self.lost.values() if j is not None}
        if len(lost) != 1 or lost.pop() >= self.k:
            return {}
        return {"decode": stripes * (self.k + 1) * self.S}

    def sample_lines(self, rec) -> list:
        n = len(rec.done())
        return [f"read calls {n}, {n - int(np.ceil(0.95 * n))} beyond their "
                f"p95; node {self.failed_node} down, lost shard by chain "
                f"{sorted(set(self.lost.values()))}"]

    def check(self, rec) -> list:
        failed = len([s for s in rec.spans if s[0] == self.unit + ".failed"])
        kept = sorted((k for r in self.kept for k in r), key=lambda k: k[3])
        self.ctx.log("# check: reads done at " + ", ".join(
            f"{(k[3] - rec.t0) / 1e9:.1f}" for k in kept)
            + " s into the window")
        wrong = 0
        for f, off, got, _ in kept:
            first, last = off // self.call, (off + self.call - 1) // self.call
            span = np.concatenate([self._call_bytes(f, c)
                                   for c in range(first, last + 1)])
            want = span[off - first * self.call:][:self.call]
            arr = np.frombuffer(got, dtype=np.uint8)
            if arr.size != want.size:
                wrong += 1
            else:
                wrong += int(np.count_nonzero(arr != want) > 0)
        degraded = rec.counter("degraded_stripes")
        return [Check("failed_calls", failed, 0),
                Check("checked_reads", len(kept), 1, ">="),
                Check("reads_wrong", wrong, 0),
                Check("degraded_stripes", degraded, 1, ">=")]

    def close(self) -> None:
        restore = getattr(self, "_restore", None)
        if restore is not None:
            setattr(*restore)
        for c in getattr(self, "clients", []):
            c.close()
        fab = getattr(self, "fab", None)
        if fab is not None:
            fab.close()
