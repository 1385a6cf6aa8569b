"""Closed-loop file writers: each writes new files in stripe-aligned calls
and removes its older files once a newer one closes, keeping the files
that the traffic's ``check_files`` names for the comparison.

Every call writes ``reference.payload.call_bytes_of(...)``. The comparison
reads, for a sample of the acknowledged calls drawn from the seed in each
file kept (the named files, spread over the window, and those live at its
end), every shard of every stripe from the engine of the target that
holds it, and holds it against the reference's RS(k, m) encode and CRC32C
of the bytes written: data shards, parity shards, the stored CRC and
length, and one committed version a stripe with nothing left staged.
"""

from __future__ import annotations

import random
import time
from collections import deque

import numpy as np
import torch

from portbench import cluster
from portbench.reference import crc32c, payload, rs
from portbench.runtime import Check


class Driver:
    unit = "write"

    def __init__(self, ctx):
        self.ctx = ctx
        c, t = ctx.cell.config, ctx.cell.traffic
        self.k, self.m = c["ec_k"], c["ec_m"]
        self.S, self.stripe = c["shard_size"], c["chunk_size"]
        if self.stripe != self.k * self.S:
            raise ValueError("the stripe must be k whole shards")
        self.workers = t["writers"]
        self.call = t["call_bytes"]
        self.file = t["file_bytes"]
        if self.call % self.stripe or self.file % self.call:
            raise ValueError("calls must be whole stripes, files whole calls")
        self.calls_per_file = self.file // self.call
        self.keep = t["live_files_per_writer"]
        self.pinned = set(t["check_files"])

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        ctx = self.ctx
        with ctx.phase("cluster"):
            self.fab = cluster.build(ctx.cell.config, ctx.device)
        with ctx.phase("pool"):
            self.pool = payload.make_pool(
                ctx.seed, payload.pool_bytes(self.call, self.S,
                                             self.workers), ctx.device)
        self.bufs = [payload.base_of(self.pool, w, self.call, self.S).copy()
                     for w in range(self.workers)]
        self.clients = [self.fab.file_client() for _ in range(self.workers)]
        self.live = [deque() for _ in range(self.workers)]
        self.next_file = [1] * self.workers
        if ctx.control == "rs12_3":
            self._plant_control()
        elif ctx.control is not None:
            raise ValueError(f"no control {ctx.control!r} for file writes")
        # warm-up: a create, calls, close and removal per writer (file 0)
        warm = self.ctx.cell.traffic["warm_calls_per_writer"]
        with ctx.phase("warm-up"):
            for w in range(self.workers):
                entry = self._write_file(w, 0, warm, None)
                self._remove(w, entry)

    def _plant_control(self) -> None:
        """The reference in the encoder's place, as RS(k, m-1): the last
        parity shard is never computed (zeros), so a stripe survives one
        loss fewer than the configuration states. CRCs are the reference's
        of what is stored, so every install verifies."""
        from tpu3fs_torch.ops import stripe

        k, m, dev = self.k, self.m, self.ctx.device

        def encode_parity(codec, data):
            x = torch.as_tensor(np.ascontiguousarray(data)).to(dev)
            par = torch.zeros((x.shape[0], m, x.shape[2]), dtype=torch.uint8,
                              device=dev)
            par[:, :m - 1] = rs.encode(x, k, m - 1)
            shards = torch.cat([x, par], dim=1)
            crcs = crc32c.crc32c_rows(shards.reshape(-1, x.shape[2]))
            return (par.cpu().numpy(),
                    crcs.reshape(x.shape[0], k + m).cpu().numpy()
                    .astype(np.uint32))

        self._restore = (stripe.StripeCodec, "encode_parity",
                         stripe.StripeCodec.encode_parity)
        stripe.StripeCodec.encode_parity = encode_parity

    def begin_window(self) -> None:
        """The window starts with no file live; the warm-up's was removed."""

    # -- the window -----------------------------------------------------------
    def counters(self) -> dict:
        return {"launches": cluster.kernel_launches(),
                "encode_s": sum(c.storage.encode_cpu_s
                                for c in self.clients)}

    def _write_file(self, w: int, file_no: int, ncalls: int, deadline):
        """Create, write up to ``ncalls`` calls (none issued after
        ``deadline``), close. -> the live-file entry."""
        from tpu3fs_torch.meta.store import OpenFlags

        spans, fab, fio = self.ctx.spans, self.fab, self.clients[w]
        path = f"/w{w}-f{file_no}"
        t_create = time.perf_counter_ns()
        with spans.span("meta.create"):
            res = fab.meta.create(path, flags=OpenFlags.WRITE
                                  | OpenFlags.CREATE,
                                  client_id=f"writer-{w}")
        acked = []
        buf = self.bufs[w]
        for c in range(ncalls):
            if deadline is not None and time.perf_counter_ns() >= deadline:
                break
            payload.stamp(buf, self.ctx.seed, w, file_no, c, self.S)
            t0 = time.perf_counter_ns()
            try:
                fio.write(res.inode, c * self.call, buf)
            except Exception as e:  # a failed call counts as failed
                spans.add(self.unit + ".failed", t0, time.perf_counter_ns())
                self.ctx.log(f"# write failed: {e!r}")
                break
            spans.add(self.unit, t0, time.perf_counter_ns(), self.call)
            acked.append(c)
        with spans.span("meta.close"):
            fab.meta.close(res.inode.id, res.session_id,
                           length_hint=len(acked) * self.call, wrote=True)
        entry = (path, res.inode, file_no, acked, t_create)
        self.live[w].append(entry)
        return entry

    def _remove(self, w: int, entry) -> None:
        path, inode = entry[:2]
        with self.ctx.spans.span("remove"):
            self.fab.meta.remove(path)
            self.clients[w].remove_chunks(inode)
            self.fab.meta.gc_finish(inode.id)
        self.live[w].remove(entry)

    def worker(self, w: int, deadline: int) -> None:
        while time.perf_counter_ns() < deadline:
            file_no = self.next_file[w]
            self.next_file[w] += 1
            entry = self._write_file(w, file_no, self.calls_per_file,
                                     deadline)
            if len(entry[3]) < self.calls_per_file:
                break  # the deadline came mid-file
            older = list(self.live[w])[:len(self.live[w]) - (self.keep - 1)]
            for e in older:
                if e[2] not in self.pinned:
                    self._remove(w, e)

    # -- what the window did -------------------------------------------------
    def work(self, rec) -> dict:
        """Bytes each job needs for the acknowledged calls: the encode reads
        k shards and writes m a stripe; every shard is checksummed at the
        client and again where it is installed."""
        data = rec.done_bytes
        width = (self.k + self.m) / self.k
        return {"encode": width * data, "checksum": 2 * width * data}

    def sample_lines(self, rec) -> list:
        from tpu3fs_torch.storage.engine import arena_stats

        n = len(rec.done())
        files = sum(1 for s in rec.spans if s[0] == "meta.create")
        return [f"write calls {n}, {n - int(np.ceil(0.95 * n))} beyond "
                f"their p95; files created {files}",
                f"engine content arena {arena_stats()}"]

    # -- the comparison ------------------------------------------------------
    def check(self, rec) -> list:
        ctx = self.ctx
        failed = len([s for s in rec.spans if s[0] == self.unit + ".failed"])
        files = [(w, entry) for w in range(self.workers)
                 for entry in self.live[w] if entry[2] > 0 and entry[3]]
        rng = random.Random(ctx.seed)
        quota = -(-ctx.cell.traffic["check_calls"] // max(1, len(files)))
        picked = [(w, entry, c) for w, entry in files
                  for c in sorted(rng.sample(entry[3],
                                             min(quota, len(entry[3]))))]
        ctx.log("# check: calls " + ", ".join(
            f"{len([p for p in picked if p[1] is e])} of file {e[2]} "
            f"(writer {w}, created {(e[4] - rec.t0) / 1e9:.1f} s into the "
            "window)" for w, e in files))
        per_call = self.call // self.stripe
        width = self.k + self.m
        wrong = crc_wrong = torn = stripes = 0
        for w, entry, c in picked:
            _, inode, file_no = entry[:3]
            want = payload.call_bytes_of(self.pool, ctx.seed, w, file_no, c,
                                         self.call, self.S)
            data = torch.from_numpy(want.reshape(per_call, self.k, self.S))
            data = data.to(ctx.device)
            parity = rs.encode(data, self.k, self.m)
            ref = torch.cat([data, parity], dim=1)
            ref_crc = crc32c.crc32c_rows(ref.reshape(-1, self.S)).reshape(
                per_call, width).cpu().tolist()
            for s in range(per_call):
                idx = c * per_call + s
                chain_id = inode.layout.chain_of_chunk(idx)
                got = cluster.stored_shards(self.fab, chain_id, inode.id,
                                            idx, width)
                stripes += 1
                vers = set()
                rows = cluster.as_rows(
                    [g[4] if g is not None else b"" for g in got], self.S)
                same = (torch.from_numpy(rows).to(ctx.device) == ref[s]) \
                    .all(dim=1).cpu().tolist()
                for j, g in enumerate(got):
                    if g is None or g[2] != self.S or not same[j]:
                        wrong += 1
                    if g is None or g[3] != ref_crc[s][j]:
                        crc_wrong += 1
                    if g is not None:
                        vers.add(g[0])
                        if g[1] != 0:
                            torn += 1
                if len(vers) > 1:
                    torn += 1
        return [Check("failed_calls", failed, 0),
                Check("checked_stripes", stripes, 1, ">="),
                Check("shards_wrong", wrong, 0),
                Check("crcs_wrong", crc_wrong, 0),
                Check("stripes_torn", torn, 0)]

    def close(self) -> None:
        restore = getattr(self, "_restore", None)
        if restore is not None:
            setattr(*restore)
        for c in getattr(self, "clients", []):
            c.close()
        fab = getattr(self, "fab", None)
        if fab is not None:
            fab.close()
