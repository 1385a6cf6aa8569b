"""admin_cli: cluster administration + FS shell.

Re-expresses src/client/cli/admin (dispatcher Dispatcher.cc:296, ~60
commands): topology bootstrap (create-target / upload-chain /
upload-chain-table, the files gen_chain_table emits), cluster inspection
(list-nodes/chains/targets, routing-info), target maintenance
(offline-target), FS operations (ls/mkdir/stat/rm/mv/touch/read/write/
truncate/checksum), GC, config render/hot-update, the placement solver, and
a storage bench (ref benchmarks/storage_bench). Runs as a REPL or one-shot;
drives any object exposing the mgmtd/meta/client surfaces (the in-process
fabric or RPC clients — same dispatcher either way).

The port's own copy of ``tpu3fs/cli.py``: the same commands, replies and
wire. The device work of a command runs on the fabric's device (the
in-process ``Fabric``'s, or ``RpcFabricView``'s ``device``: ``cuda``
unless the caller asks for the CPU, raising without a card):
``solve-placement`` scores its proposals with K5 there, the file and
storage clients encode, checksum and decode there, and ``verify-checksums
--data`` (the port's addition) re-reads every committed chunk of every
target, CR and EC, and checksums the bytes with K2 there against the CRC
its engine keeps. ``placement-plan``, ``rebalance`` and ``drain`` plan on
the host (numpy), as in the JAX package. Run it as ``python -m
tpu3fs_torch.cli [--device cuda] --connect HOST:PORT [command...]``.
"""

from __future__ import annotations

import shlex
import sys
import time
from typing import Callable, Dict, List, Optional

from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.mgmtd.types import LocalTargetState
from tpu3fs_torch.ops.crc32c import crc32c
from tpu3fs_torch.utils.result import FsError


class AdminCli:
    def __init__(self, fabric):
        """fabric: a Fabric (or compatible: .mgmtd, .meta, .file_client(),
        .storage_client(), .routing(), .run_gc(), .nodes)."""
        self.fab = fabric
        self._migration_svc = None
        self._commands: Dict[str, Callable[[List[str]], str]] = {}
        for name in dir(self):
            if name.startswith("cmd_"):
                self._commands[name[4:].replace("_", "-")] = getattr(self, name)

    # -- dispatch ------------------------------------------------------------
    def run(self, line: str) -> str:
        args = shlex.split(line)
        if not args:
            return ""
        cmd = args[0]
        fn = self._commands.get(cmd)
        if fn is None:
            return f"unknown command: {cmd} (try help)"
        try:
            return fn(args[1:])
        except FsError as e:
            return f"error: {e.status}"
        except (ValueError, IndexError, KeyError, TypeError, AttributeError) as e:
            return f"usage error: {e!r}"

    def repl(self, stdin=None, stdout=None) -> None:  # pragma: no cover
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            out = self.run(line.strip())
            if out:
                print(out, file=stdout)

    @staticmethod
    def _flag(args: List[str], name: str, default=None):
        if name in args:
            return args[args.index(name) + 1]
        return default

    # -- inspection ----------------------------------------------------------
    def cmd_help(self, args: List[str]) -> str:
        return "commands: " + ", ".join(sorted(self._commands))

    def cmd_list_nodes(self, args: List[str]) -> str:
        ri = self.fab.routing()
        lines = ["NODE  TYPE      STATUS                LAST_HB"]
        for n in sorted(ri.nodes.values(), key=lambda n: n.node_id):
            lines.append(
                f"{n.node_id:<5} {n.type.name:<9} {n.status.name:<21} "
                f"{n.last_heartbeat:.0f}"
            )
        return "\n".join(lines)

    def cmd_list_chains(self, args: List[str]) -> str:
        ri = self.fab.routing()
        lines = ["CHAIN    VER  TARGETS (state)"]
        for c in sorted(ri.chains.values(), key=lambda c: c.chain_id):
            ts = " ".join(
                f"{t.target_id}({t.public_state.name})" for t in c.targets
            )
            lines.append(f"{c.chain_id:<8} {c.chain_version:<4} {ts}")
        return "\n".join(lines)

    def cmd_list_targets(self, args: List[str]) -> str:
        ri = self.fab.routing()
        lines = ["TARGET  NODE  CHAIN    PUBLIC   LOCAL"]
        for t in sorted(ri.targets.values(), key=lambda t: t.target_id):
            lines.append(
                f"{t.target_id:<7} {t.node_id:<5} {t.chain_id:<8} "
                f"{t.public_state.name:<8} {t.local_state.name}"
            )
        return "\n".join(lines)

    def cmd_list_chain_tables(self, args: List[str]) -> str:
        ri = self.fab.routing()
        return "\n".join(
            f"table {t.table_id} v{t.version}: {t.chain_ids}"
            for t in ri.chain_tables.values()
        )

    def cmd_routing_info(self, args: List[str]) -> str:
        ri = self.fab.routing()
        return (
            f"version {ri.version}: {len(ri.nodes)} nodes, "
            f"{len(ri.chains)} chains, {len(ri.targets)} targets, "
            f"{len(getattr(ri, 'meta_partitions', {}) or {})} meta "
            f"partitions"
        )

    def cmd_meta_partitions(self, args: List[str]) -> str:
        """meta-partitions — the partitioned metadata plane's ownership
        table as mgmtd publishes it on RoutingInfo (docs/metashard.md):
        partition id, owning META node, fencing epoch, and the owner's
        last-reported per-partition load."""
        ri = self.fab.routing()
        parts = getattr(ri, "meta_partitions", None) or {}
        if not parts:
            return "no meta partition table published (legacy meta plane)"
        lines = ["PART  OWNER  EPOCH  LOAD(ops/s)"]
        for pid in sorted(parts):
            row = parts[pid]
            lines.append(f"{pid:<5} {row.node_id:<6} {row.epoch:<6} "
                         f"{row.load:.1f}")
        return "\n".join(lines)

    # -- topology ------------------------------------------------------------
    def cmd_create_target(self, args: List[str]) -> str:
        tid = int(self._flag(args, "--target-id"))
        node = int(self._flag(args, "--node-id", 0))
        self.fab.mgmtd.create_target(tid, node_id=node)
        return f"target {tid} created on node {node}"

    def cmd_upload_chain(self, args: List[str]) -> str:
        cid = int(self._flag(args, "--chain-id"))
        targets = [int(x) for x in self._flag(args, "--targets").split(",")]
        ec_k = int(self._flag(args, "--ec-k", 0))
        ec_m = int(self._flag(args, "--ec-m", 0))
        self.fab.mgmtd.upload_chain(cid, targets, ec_k=ec_k, ec_m=ec_m)
        kind = f"EC({ec_k},{ec_m})" if ec_k else "CR"
        return f"chain {cid} uploaded with {len(targets)} targets ({kind})"

    def cmd_upload_chain_table(self, args: List[str]) -> str:
        tid = int(self._flag(args, "--table-id", 1))
        chains = [int(x) for x in self._flag(args, "--chains").split(",")]
        self.fab.mgmtd.upload_chain_table(tid, chains)
        return f"chain table {tid} uploaded with {len(chains)} chains"

    def cmd_offline_target(self, args: List[str]) -> str:
        """Mark a target's local state offline and run the chain updater
        (ref OfflineTarget admin command)."""
        tid = int(self._flag(args, "--target-id"))
        for node in self.fab.nodes.values():
            node.service.offline_target(tid)
        self.fab.tick()
        return f"target {tid} offlined; routing v{self.fab.routing().version}"

    def cmd_rotate_lastsrv(self, args: List[str]) -> str:
        self.fab.tick()
        return "chain update pass complete"

    def cmd_solve_placement(self, args: List[str]) -> str:
        from tpu3fs_torch.placement import (
            PlacementProblem,
            gen_chain_table_commands,
            solve_placement,
        )

        ec_k = int(self._flag(args, "--ec-k", 0))
        ec_m = int(self._flag(args, "--ec-m", 0))
        p = PlacementProblem(
            num_nodes=int(self._flag(args, "--nodes")),
            group_size=int(self._flag(args, "--group-size")),
            targets_per_node=int(self._flag(args, "--targets-per-node")),
            chain_table_type="EC" if ec_k else "CR",
        )
        traffic = self._flag(args, "--max-peer-traffic")
        M = solve_placement(
            p,
            steps=int(self._flag(args, "--steps", 200)),
            max_peer_traffic=float(traffic) if traffic else None,
            device=self.fab.device,
        )
        return "\n".join(gen_chain_table_commands(M, ec_k=ec_k, ec_m=ec_m))

    # -- maintenance / parity sweeps (ref src/client/cli/admin: Bench,
    # ReadBench, Checksum, FindOrphanedChunks, RecursiveChown) --------------
    def cmd_bench(self, args: List[str]) -> str:
        """Raw storage write bench over the chain table (ref Bench.cc):
        bench [--chunks N] [--size BYTES] [--file-id ID]."""
        chunks = int(self._flag(args, "--chunks", 64))
        size = int(self._flag(args, "--size", 65536))
        file_id = int(self._flag(args, "--file-id", 909_090))
        ri = self.fab.routing()
        chains = [c.chain_id for c in ri.chains.values() if not c.is_ec]
        if not chains:
            return "no CR chains to bench"
        client = self.fab.storage_client()
        payload = b"\xab" * size
        from tpu3fs_torch.storage.types import ChunkId as _Cid

        t0 = time.perf_counter()
        writes = [(chains[i % len(chains)], _Cid(file_id, i), 0, payload)
                  for i in range(chunks)]
        replies = client.batch_write(writes, chunk_size=size)
        dt = time.perf_counter() - t0
        failed = sum(1 for r in replies if not r.ok)
        return (f"wrote {chunks - failed}/{chunks} x {size}B in {dt:.3f}s "
                f"({chunks * size / dt / 1e6:.1f} MB/s), {failed} failed")

    def cmd_read_bench(self, args: List[str]) -> str:
        """Raw storage read bench (ref ReadBench.cc): read the chunks
        `bench` wrote: read-bench [--chunks N] [--file-id ID]."""
        chunks = int(self._flag(args, "--chunks", 64))
        file_id = int(self._flag(args, "--file-id", 909_090))
        ri = self.fab.routing()
        chains = [c.chain_id for c in ri.chains.values() if not c.is_ec]
        if not chains:
            return "no CR chains to bench"
        client = self.fab.storage_client()
        from tpu3fs_torch.client.storage_client import ReadReq as _RR
        from tpu3fs_torch.storage.types import ChunkId as _Cid

        t0 = time.perf_counter()
        replies = client.batch_read([
            _RR(chains[i % len(chains)], _Cid(file_id, i), 0, -1)
            for i in range(chunks)
        ])
        dt = time.perf_counter() - t0
        got = sum(len(r.data) for r in replies if r.ok)
        failed = sum(1 for r in replies if not r.ok)
        return (f"read {got} bytes from {chunks - failed}/{chunks} chunks "
                f"in {dt:.3f}s ({got / dt / 1e6:.1f} MB/s), {failed} failed")

    def cmd_verify_checksums(self, args: List[str]) -> str:
        """Cross-replica checksum sweep (ref Checksum.cc): every committed
        chunk's (version, crc) must agree across its chain's replicas.
        verify-checksums [--chain ID] [--data]. With ``--data`` the sweep
        also reads every committed chunk (an EC shard included) off each
        target and checksums its bytes on the fabric's device (one K2
        launch a batch), against the CRC the target's engine keeps; a
        chunk that does not read back counts as a mismatch."""
        only = self._flag(args, "--chain")
        if "--data" in args:
            return self._verify_data(int(only) if only else None)
        ri = self.fab.routing()
        checked = mismatches = 0
        lines: List[str] = []
        for chain in ri.chains.values():
            if only and chain.chain_id != int(only):
                continue
            if chain.is_ec:
                continue  # EC shards differ by design; engine CRCs are
                # validated at install time (expected_crc)
            per_replica: Dict[int, Dict[bytes, tuple]] = {}
            for t in chain.targets:
                node = ri.node_of_target(t.target_id)
                if node is None:
                    continue
                try:
                    metas = self.fab.send(
                        node.node_id, "dump_chunkmeta", t.target_id)
                except FsError:
                    continue
                per_replica[t.target_id] = {
                    m.chunk_id.to_bytes(): (m.committed_ver,
                                            m.checksum.value)
                    for m in metas if m.committed_ver > 0
                }
            all_keys = set().union(*per_replica.values()) \
                if per_replica else set()
            for key in all_keys:
                states = {tid: rep.get(key) for tid, rep in
                          per_replica.items()}
                committed = {v for v in states.values() if v is not None}
                checked += 1
                if len(committed) > 1:
                    mismatches += 1
                    lines.append(
                        f"chain {chain.chain_id} chunk {key.hex()}: "
                        + ", ".join(f"t{tid}={v}" for tid, v in
                                    states.items()))
        head = f"checked {checked} chunks, {mismatches} mismatches"
        return head if not lines else head + "\n" + "\n".join(lines[:50])

    _VERIFY_BATCH = 32  # chunks a target-addressed read of --data

    def _verify_data(self, only: Optional[int]) -> str:
        from tpu3fs_torch.ops.crc32c import crc32c_many
        from tpu3fs_torch.storage.craq import ReadReq as _RR
        from tpu3fs_torch.utils.result import Code

        ri = self.fab.routing()
        checked = nbytes = bad = 0
        lines: List[str] = []
        for chain in sorted(ri.chains.values(), key=lambda c: c.chain_id):
            if only and chain.chain_id != only:
                continue
            for t in chain.targets:
                node = ri.node_of_target(t.target_id)
                if node is None:
                    continue
                try:
                    metas = self.fab.send(
                        node.node_id, "dump_chunkmeta", t.target_id)
                except FsError:
                    continue
                ids = sorted((m.chunk_id for m in metas
                              if m.committed_ver > 0),
                             key=lambda c: c.to_bytes())
                for lo in range(0, len(ids), self._VERIFY_BATCH):
                    part = ids[lo:lo + self._VERIFY_BATCH]
                    replies = self.fab.send(node.node_id, "batch_read", [
                        _RR(chain.chain_id, cid, 0, -1,
                            target_id=t.target_id) for cid in part])
                    ok = []
                    for cid, r in zip(part, replies):
                        if r.ok:
                            ok.append((cid, r))
                            continue
                        bad += 1
                        lines.append(
                            f"chain {chain.chain_id} target {t.target_id} "
                            f"chunk {cid.to_bytes().hex()}: unreadable "
                            f"({Code(r.code).name})")
                    crcs = crc32c_many([r.data for _, r in ok],
                                       device=self.fab.device)
                    for (cid, r), crc in zip(ok, crcs):
                        checked += 1
                        nbytes += len(r.data)
                        if crc != r.checksum.value:
                            bad += 1
                            lines.append(
                                f"chain {chain.chain_id} target "
                                f"{t.target_id} chunk "
                                f"{cid.to_bytes().hex()}: crc "
                                f"{crc:#010x} != stored "
                                f"{r.checksum.value:#010x}")
        head = (f"read {checked} chunks ({nbytes} bytes), {bad} data "
                f"mismatches")
        return head if not lines else head + "\n" + "\n".join(lines[:50])

    def cmd_find_orphaned_chunks(self, args: List[str]) -> str:
        """Chunks whose file id has no inode (ref FindOrphanedChunks.cc):
        find-orphaned-chunks [--remove]."""
        remove = "--remove" in args
        ri = self.fab.routing()
        # file id -> set of chain ids holding its chunks
        seen: Dict[int, set] = {}
        for chain in ri.chains.values():
            for t in chain.targets:
                node = ri.node_of_target(t.target_id)
                if node is None:
                    continue
                try:
                    metas = self.fab.send(
                        node.node_id, "dump_chunkmeta", t.target_id)
                except FsError:
                    continue
                for m in metas:
                    seen.setdefault(m.chunk_id.file_id,
                                    set()).add(chain.chain_id)
        file_ids = sorted(seen)
        orphans: List[int] = []
        for base in range(0, len(file_ids), 256):
            batch = file_ids[base:base + 256]
            inodes = self.fab.meta.batch_stat(batch)
            orphans.extend(
                fid for fid, ino in zip(batch, inodes) if ino is None)
        removed = 0
        if remove:
            # StorageClient.remove_file_chunks knows the fan-out rules
            # (CR: head + chain forward; EC: every node of the chain) —
            # reuse it instead of hand-rolling target selection
            client = self.fab.storage_client()
            for fid in orphans:
                for chain_id in seen[fid]:
                    try:
                        client.remove_file_chunks(chain_id, fid)
                        removed += 1
                    except FsError:
                        continue
        out = f"{len(orphans)} orphaned file ids: {orphans[:20]}"
        if remove:
            out += f"; removed chunks of {removed} (file, chain) pairs"
        return out

    def cmd_chown(self, args: List[str]) -> str:
        """chown [-R] UID[:GID] PATH (ref RecursiveChown.cc)."""
        recursive = "-R" in args
        rest = [a for a in args if a != "-R"]
        spec, path = rest[0], rest[1]
        uid_s, _, gid_s = spec.partition(":")
        uid = int(uid_s)
        gid = int(gid_s) if gid_s else None
        count = 0

        def apply(p: str) -> None:
            nonlocal count
            self.fab.meta.set_attr(p, uid=uid, gid=gid)
            count += 1
            if recursive:
                try:
                    ents = self.fab.meta.list_dir(p)
                except FsError:
                    return
                for e in ents:
                    apply(p.rstrip("/") + "/" + e.name)

        apply(path)
        return f"chowned {count} inode(s) to {uid}" + \
            (f":{gid}" if gid is not None else "")

    def cmd_query_metrics(self, args: List[str]) -> str:
        """Query the monitor sink (ref: operators query ClickHouse):
        query-metrics --db PATH [--name PREFIX] [--limit N]
        or --collector HOST:PORT to query a live monitor service."""
        name = self._flag(args, "--name", "")
        limit = int(self._flag(args, "--limit", 20))
        coll = self._flag(args, "--collector")
        if coll:
            from tpu3fs_torch.monitor.collector import (
                COLLECTOR_SERVICE_ID,
                QueryReq,
                SampleBatch,
            )
            from tpu3fs_torch.rpc.net import RpcClient

            host, port = coll.rsplit(":", 1)
            rsp = RpcClient().call(
                (host, int(port)), COLLECTOR_SERVICE_ID, 2,
                QueryReq(name_prefix=name, limit=limit), SampleBatch)
            samples = rsp.samples
        else:
            from tpu3fs_torch.monitor.recorder import SqliteSink

            db = self._flag(args, "--db")
            if not db:
                return ("usage: query-metrics "
                        "(--db <sqlite-file> | --collector <host:port>) "
                        "[--name PREFIX] [--limit N]")
            samples = SqliteSink(db).query(name, limit=limit)
        if not samples:
            return "no samples"
        return "\n".join(
            f"{s.ts:.1f} {s.name} value={s.value} count={s.count} "
            f"p99={s.p99:.1f} tags={s.tags}"
            for s in samples)

    def cmd_qos(self, args: List[str]) -> str:
        """Per-node QoS view (tpu3fs_torch/qos): per-class admission limits,
        live in-flight counts and update-queue depths.
        qos [--node N]"""
        want = self._flag(args, "--node")
        lines = []
        for node_id in sorted(getattr(self.fab, "nodes", {})):
            if want is not None and int(want) != node_id:
                continue
            service = self.fab.nodes[node_id].service
            snap = service.qos_snapshot()
            lines.append(f"node {node_id}: qos "
                         f"{'enabled' if snap.get('enabled') else 'disabled'}")
            classes = snap.get("classes", {})
            if classes:
                lines.append("  CLASS       RATE     BURST  INFLIGHT/CAP"
                             "  WEIGHT  QSHARE  QDEPTH")
                depths = snap.get("queue_depths", {})
                for name, c in classes.items():
                    cap = c["max_inflight"] or "-"
                    rate = c["rate"] or "-"
                    lines.append(
                        f"  {name:<11} {str(rate):<8} {c['burst']:<6.0f} "
                        f"{c['inflight']}/{cap:<11} {c['weight']:<7} "
                        f"{c['queue_share']:<7.2f} {depths.get(name, 0)}")
            else:
                depths = snap.get("queue_depths", {})
                if depths:
                    lines.append(f"  queue depths: {depths}")
        return "\n".join(lines) if lines else "no storage nodes"

    # -- distributed tracing (tpu3fs_torch/analytics/spans.py + assemble.py) -------
    @staticmethod
    def _load_trace_dirs(args: List[str]):
        """--dir D[,D2,...] (span files or directories, recursive)."""
        from tpu3fs_torch.analytics import assemble

        spec = None
        if "--dir" in args:
            spec = args[args.index("--dir") + 1]
        elif args and not args[0].startswith("--"):
            spec = args[0]
        if not spec:
            raise ValueError("usage: --dir <span-dir[,span-dir...]>")
        rows = assemble.load_spans(spec.split(","))
        return assemble, rows

    def cmd_trace_show(self, args: List[str]) -> str:
        """One trace as a cross-process span tree with the per-stage
        latency breakdown and stage coverage.
        trace-show --dir D[,D...] [--trace TRACE_ID | --op OP]
        (default: the slowest assembled trace)"""
        assemble, rows = self._load_trace_dirs(args)
        trees = assemble.assemble_traces(rows)
        if not trees:
            return "no traces found"
        want = self._flag(args, "--trace")
        if want:
            tree = trees.get(want)
            if tree is None:
                return f"trace {want} not found ({len(trees)} traces)"
            return assemble.format_trace(tree)
        op = self._flag(args, "--op")
        ranked = assemble.top_traces(trees, len(trees))
        if op:
            ranked = [t for t in ranked
                      if t.root is not None and t.root.get("op") == op]
            if not ranked:
                return f"no trace with root op {op}"
        return assemble.format_trace(ranked[0])

    def cmd_trace_top(self, args: List[str]) -> str:
        """Slowest traced ops + per-stage percentile breakdown over every
        loaded span file; --by-tenant adds the per-tenant op rollup.
        trace-top --dir D[,D...] [--n N] [--by-tenant]"""
        assemble, rows = self._load_trace_dirs(args)
        trees = assemble.assemble_traces(rows)
        if not trees:
            return "no traces found"
        return assemble.format_top(trees, rows,
                                   n=int(self._flag(args, "--n", 10)),
                                   by_tenant="--by-tenant" in args)

    def cmd_top(self, args: List[str]) -> str:
        """Live cluster top from monitor_collector output: per-class
        admitted/shed rates, queue depths, per-subsystem GiB/s, memory
        gauges. top --collector HOST:PORT [--window SEC] [--watch SEC]
        (--watch polls until interrupted; default prints once)"""
        coll = self._flag(args, "--collector") or (
            args[0] if args and not args[0].startswith("--") else None)
        if not coll:
            return ("usage: top --collector <host:port> [--window SEC] "
                    "[--watch SEC]")
        window = float(self._flag(args, "--window", 60))
        watch = self._flag(args, "--watch")
        out = self._top_once(coll, window)
        if watch is None:
            return out
        import time as _time  # pragma: no cover - interactive loop

        try:
            while True:
                print(out)
                _time.sleep(float(watch))
                out = self._top_once(coll, window)
        except KeyboardInterrupt:
            return out

    @staticmethod
    def _agg_rows(coll: str, window: float, prefix: str = ""):
        """Windowed rollups from the collector's aggQuery RPC — the
        cheap path `top`/`tenant-top` prefer (one pre-aggregated row
        per series instead of a raw-sample scan, and the SAME rollups
        the SLO engine judges). Returns None when the collector is too
        old to know the method (raw-scan fallback)."""
        from tpu3fs_torch.monitor.collector import (
            AggQueryReq,
            AggQueryRsp,
            COLLECTOR_SERVICE_ID,
        )
        from tpu3fs_torch.rpc.net import RpcClient

        host, port = coll.rsplit(":", 1)
        try:
            rsp = RpcClient().call(
                (host, int(port)), COLLECTOR_SERVICE_ID, 3,
                AggQueryReq(name=prefix, prefix=True, window_s=window),
                AggQueryRsp)
        except FsError:
            return None  # old collector: no aggQuery
        return rsp.rows

    def _top_once(self, coll: str, window: float) -> str:
        rows = self._agg_rows(coll, window)
        if rows:  # old collector (None) or no rollups: raw-scan fallback
            return self._top_from_agg(rows, window)
        return self._top_once_raw(coll, window)

    def _top_from_agg(self, rows, window: float) -> str:
        def is_gauge(name: str) -> bool:
            return self._is_gauge_name(name)

        counters: Dict[tuple, float] = {}
        gauges: Dict[tuple, tuple] = {}
        nsamples = 0
        for r in rows:
            if r.count == 0 and not r.last_ts:
                continue
            nsamples += r.count
            key = (r.name, r.tags.get("class", ""),
                   r.tags.get("node", ""))
            if is_gauge(r.name):
                cur = gauges.get(key)
                if cur is None or r.last_ts >= cur[0]:
                    gauges[key] = (r.last_ts, r.last)
            elif r.count:
                counters[key] = counters.get(key, 0.0) + r.vsum
        return self._render_top(counters, gauges, window, nsamples,
                                source="aggQuery rollups")

    def _top_once_raw(self, coll: str, window: float) -> str:
        import json as _json
        import time as _time

        from tpu3fs_torch.monitor.collector import (
            COLLECTOR_SERVICE_ID,
            QueryReq,
            SampleBatch,
        )
        from tpu3fs_torch.rpc.net import RpcClient

        host, port = coll.rsplit(":", 1)
        since = _time.time() - window
        rsp = RpcClient().call(
            (host, int(port)), COLLECTOR_SERVICE_ID, 2,
            QueryReq(since=since, limit=100000), SampleBatch)
        counters: Dict[tuple, float] = {}
        gauges: Dict[tuple, tuple] = {}
        for s in rsp.samples:
            tags = s.tags if isinstance(s.tags, dict) else _json.loads(
                s.tags or "{}")
            key = (s.name, tags.get("class", ""), tags.get("node", ""))
            if self._is_gauge_name(s.name):
                cur = gauges.get(key)
                if cur is None or s.ts >= cur[0]:
                    gauges[key] = (s.ts, s.value)
            else:
                counters[key] = counters.get(key, 0.0) + s.value
        return self._render_top(counters, gauges, window,
                                len(rsp.samples), source="raw samples")

    @staticmethod
    def _is_gauge_name(name: str) -> bool:
        # ValueRecorder names (last-value semantics): the memory
        # observability set + the pre-existing gauge families.
        # Everything else reports per-window deltas (counters).
        return name.startswith(("mem.", "memory.", "mgmtd.", "monitor.agg",
                                "monitor.retained", "monitor.ingest",
                                "slo.rules_firing", "slo.health",
                                "storage.disk_info",
                                "storage.allocate")) \
            or name in ("kvcache.dirty_bytes", "kvcache.host_bytes",
                        "kvcache.leases", "dataload.buffered_bytes",
                        "qos.queue_depth", "ec.rebuild_mibps",
                        "ec.encode_gibps", "tenant.kvcache_bytes",
                        "usrbio.agent_depth")

    def _render_top(self, counters: Dict[tuple, float],
                    gauges: Dict[tuple, tuple], window: float,
                    nsamples: int, *, source: str) -> str:
        lines = [f"cluster top  (window {window:.0f}s, "
                 f"{nsamples} samples, {source})"]
        qos = [(k, v) for k, v in counters.items()
               if k[0] in ("qos.admitted", "qos.shed")]
        if qos:
            lines.append(f"  {'CLASS':<12} {'NODE':<6} {'ADMIT/s':>10} "
                         f"{'SHED/s':>10}")
            combos = sorted({(k[1], k[2]) for k, _ in qos})
            for cls, node in combos:
                a = counters.get(("qos.admitted", cls, node), 0.0)
                d = counters.get(("qos.shed", cls, node), 0.0)
                lines.append(f"  {cls or '-':<12} {node or '-':<6} "
                             f"{a / window:>10.1f} {d / window:>10.1f}")
        tput = [(k, v) for k, v in counters.items()
                if k[0].endswith((".bytes", "_bytes")) and v > 0]
        if tput:
            lines.append(f"  {'THROUGHPUT':<28} {'GiB/s':>10}")
            for (name, cls, node), v in sorted(tput):
                lines.append(
                    f"  {name + (f'[{cls}]' if cls else ''):<28} "
                    f"{v / window / (1 << 30):>10.4f}")
        if gauges:
            lines.append(f"  {'GAUGE':<28} {'NODE':<6} {'VALUE':>14}")
            for (name, cls, node), (_, v) in sorted(gauges.items()):
                lines.append(f"  {name:<28} {node or '-':<6} {v:>14.0f}")
        return "\n".join(lines)

    # -- multi-tenant fairness (tpu3fs_torch/tenant; docs/tenancy.md) --------------
    def cmd_tenant_quota(self, args: List[str]) -> str:
        """Tenant quota table (tpu3fs_torch/tenant):
        tenant-quota [show] [--tenant NAME] — THIS process's registry:
                  quotas + live per-tenant totals
        tenant-quota set --spec "tenant=a,weight=4,bytes_per_s=...;..."
                  [--node-type storage] — merge a [tenants] section into
                  the node type's pushed config (heartbeats deliver it;
                  every node of that type retunes buckets + lane weights
                  live)
        tenant-quota clear [--node-type storage] — push an empty table"""
        from tpu3fs_torch.tenant.quota import parse_spec, registry

        if args and args[0] in ("set", "clear"):
            sub, rest = args[0], args[1:]
            spec = "" if sub == "clear" else self._flag(rest, "--spec", "")
            table = parse_spec(spec)  # validate BEFORE pushing
            nt = self._node_type_flag(rest)
            blob = self.fab.mgmtd.get_config(nt)
            content = self._merge_section_toml(
                blob.content, "tenants", {"spec": spec})
            ver = self.fab.mgmtd.set_config(nt, content)
            return (f"pushed {len(table)} tenant quota row(s) to "
                    f"{nt.name} config v{ver} (heartbeats deliver "
                    f"within one interval)")
        want = self._flag(args, "--tenant")
        snap = registry().snapshot()
        lines = [f"{'TENANT':<16} {'WEIGHT':>6} {'BYTES/S':>12} "
                 f"{'IOPS':>8} {'KV_BUDGET':>12} {'KV_RES':>10} "
                 f"{'ADMIT':>8} {'SHED':>6} {'BYTES':>12}"]
        for name, row in snap.items():
            if want is not None and name != want:
                continue
            star = "" if row["explicit"] else "*"
            lines.append(
                f"{name + star:<16} {row['weight']:>6} "
                f"{row['bytes_per_s']:>12.0f} {row['iops']:>8.0f} "
                f"{row['kvcache_bytes']:>12} {row['kv_resident']:>10} "
                f"{row['admitted']:>8} {row['shed']:>6} "
                f"{row['bytes']:>12}")
        lines.append("(* = default-quota tenant, no explicit row)")
        return "\n".join(lines)

    def cmd_tenant_top(self, args: List[str]) -> str:
        """Live per-tenant cluster view from monitor_collector output:
        admitted/shed rates by kind, bytes GiB/s, queue-wait p99,
        kvcache resident gauges — "who is hurting whom".
        tenant-top --collector HOST:PORT [--window SEC]"""
        import json as _json
        import time as _time

        from tpu3fs_torch.monitor.collector import (
            COLLECTOR_SERVICE_ID,
            QueryReq,
            SampleBatch,
        )
        from tpu3fs_torch.rpc.net import RpcClient

        coll = self._flag(args, "--collector") or (
            args[0] if args and not args[0].startswith("--") else None)
        if not coll:
            return ("usage: tenant-top --collector <host:port> "
                    "[--window SEC]")
        window = float(self._flag(args, "--window", 60))
        counters: Dict[tuple, float] = {}
        waits: Dict[str, float] = {}
        kv: Dict[str, tuple] = {}
        nsamples = 0
        agg_rows = self._agg_rows(coll, window, prefix="tenant.")
        if agg_rows:  # empty/None: raw-scan fallback below
            # preferred path: the collector's windowed rollups (exactly
            # what the SLO engine judges; no raw-row scan)
            for r in agg_rows:
                if r.count == 0:
                    continue
                nsamples += r.count
                tenant = r.tags.get("tenant", "-")
                if r.name == "tenant.queue_wait_us":
                    waits[tenant] = max(waits.get(tenant, 0.0), r.p99)
                elif r.name == "tenant.kvcache_bytes":
                    cur = kv.get(tenant)
                    if cur is None or r.last_ts >= cur[0]:
                        kv[tenant] = (r.last_ts, r.last)
                else:
                    key = (r.name, tenant, r.tags.get("kind", ""))
                    counters[key] = counters.get(key, 0.0) + r.vsum
        else:  # old collector: raw-sample scan fallback
            host, port = coll.rsplit(":", 1)
            rsp = RpcClient().call(
                (host, int(port)), COLLECTOR_SERVICE_ID, 2,
                QueryReq(name_prefix="tenant.",
                         since=_time.time() - window,
                         limit=100000), SampleBatch)
            nsamples = len(rsp.samples)
            for s in rsp.samples:
                tags = s.tags if isinstance(s.tags, dict) else _json.loads(
                    s.tags or "{}")
                tenant = tags.get("tenant", "-")
                if s.name == "tenant.queue_wait_us":
                    waits[tenant] = max(waits.get(tenant, 0.0), s.p99)
                elif s.name == "tenant.kvcache_bytes":
                    cur = kv.get(tenant)
                    if cur is None or s.ts >= cur[0]:
                        kv[tenant] = (s.ts, s.value)
                else:
                    key = (s.name, tenant, tags.get("kind", ""))
                    counters[key] = counters.get(key, 0.0) + s.value
        tenants = sorted({k[1] for k in counters}
                         | set(waits) | set(kv))
        if not tenants:
            return f"no tenant samples in the last {window:.0f}s"
        lines = [f"tenant top  (window {window:.0f}s, "
                 f"{nsamples} samples)",
                 f"  {'TENANT':<16} {'ADMIT/s':>9} {'SHED/s':>8} "
                 f"{'by-kind':<26} {'GiB/s':>8} {'QWAITp99':>10} "
                 f"{'KV_RES':>10}"]
        for tenant in tenants:
            admit = counters.get(("tenant.admitted", tenant, ""), 0.0)
            sheds = {k[2]: v for k, v in counters.items()
                     if k[0] == "tenant.shed" and k[1] == tenant}
            shed_total = sum(sheds.values())
            by_kind = ",".join(f"{k}={v:.0f}"
                               for k, v in sorted(sheds.items()) if v)
            gib = counters.get(("tenant.bytes", tenant, ""), 0.0) \
                / window / (1 << 30)
            wait_ms = waits.get(tenant, 0.0) / 1e3
            kres = int(kv.get(tenant, (0, 0))[1])
            lines.append(
                f"  {tenant:<16} {admit / window:>9.1f} "
                f"{shed_total / window:>8.1f} {by_kind:<26} "
                f"{gib:>8.4f} {wait_ms:>9.2f}ms {kres:>10}")
        return "\n".join(lines)

    # -- SLO engine + flight recorder (tpu3fs_torch/monitor/slo.py, flight.py;
    # docs/slo.md) -----------------------------------------------------------
    def _collector_flag(self, args: List[str]) -> str:
        coll = self._flag(args, "--collector") or (
            args[0] if args and not args[0].startswith("--")
            and ":" in args[0] else None)
        if not coll:
            raise ValueError("--collector <host:port> is required")
        return coll

    def _slo_status(self, coll: str):
        from tpu3fs_torch.monitor.slo import SloGate

        return SloGate(coll).status()

    def cmd_slo(self, args: List[str]) -> str:
        """SLO rule engine control (monitor/slo.py):
        slo show --collector HOST:PORT — rules + live states
        slo set --collector HOST:PORT --spec "rule=...;..." — validate,
                then hot-push the [slo] section through the collector's
                core hotUpdateConfig RPC (the collector boots one-phase;
                --spec default pushes slo.DEFAULT_CLUSTER_SPEC)
        slo clear --collector HOST:PORT — push an empty rule set"""
        from tpu3fs_torch.monitor.slo import DEFAULT_CLUSTER_SPEC, parse_slo_spec

        if not args:
            return "usage: slo show|set|clear --collector host:port ..."
        sub, rest = args[0], args[1:]
        if sub in ("set", "clear"):
            spec = "" if sub == "clear" else self._flag(rest, "--spec", "")
            if spec == "default":
                spec = DEFAULT_CLUSTER_SPEC
            rules = parse_slo_spec(spec)  # validate BEFORE pushing
            coll = self._collector_flag(rest)
            from tpu3fs_torch.rpc.net import RpcClient
            from tpu3fs_torch.rpc.services import (
                CORE_SERVICE_ID,
                Empty,
                StrReply,
            )

            content = self._merge_section_toml("", "slo", {"spec": spec})
            host, port = coll.rsplit(":", 1)
            RpcClient().call((host, int(port)), CORE_SERVICE_ID, 3,
                             StrReply(content), Empty)
            return (f"pushed {len(rules)} slo rule(s) to collector "
                    f"{coll} (engine reconfigured live; same-named "
                    f"rules keep their alert state)")
        if sub == "show":
            return self.cmd_slo_show(rest)
        return "usage: slo show|set|clear --collector host:port ..."

    def cmd_slo_show(self, args: List[str]) -> str:
        """slo-show --collector HOST:PORT: every rule with its condition,
        alert state and last observed value."""
        rsp = self._slo_status(self._collector_flag(args))
        if not rsp.rules:
            return f"verdict {rsp.verdict}: no slo rules configured"
        lines = [f"verdict {rsp.verdict}"
                 + (f"  (firing: {', '.join(rsp.firing)})"
                    if rsp.firing else ""),
                 f"{'RULE':<18} {'SEV':<9} {'STATE':<8} {'VALUE':>12} "
                 f"{'FIRED':>5}  CONDITION"]
        for r in rsp.rules:
            lines.append(
                f"{r.rule:<18} {r.severity:<9} {r.state:<8} "
                f"{r.value:>12.6g} {r.fired_count:>5}  {r.bound}"
                + (f"  [{r.message}]" if r.message and r.state != "ok"
                   else ""))
        return "\n".join(lines)

    def cmd_alerts(self, args: List[str]) -> str:
        """alerts --collector HOST:PORT: firing rules + the recent
        alert state-machine transitions (newest last)."""
        rsp = self._slo_status(self._collector_flag(args))
        lines = [f"verdict {rsp.verdict}: "
                 f"{len(rsp.firing)} firing"
                 + (f" ({', '.join(rsp.firing)})" if rsp.firing else "")]
        for t in rsp.transitions:
            lines.append(f"  {t.ts:.3f} {t.rule} -> {t.transition} "
                         f"value={t.value:g}"
                         + (f" ({t.message})" if t.message else ""))
        if len(lines) == 1:
            lines.append("  (no transitions recorded)")
        return "\n".join(lines)

    def cmd_health(self, args: List[str]) -> str:
        """health --collector HOST:PORT: the single cluster verdict —
        OK / DEGRADED / CRITICAL, naming the firing rules."""
        rsp = self._slo_status(self._collector_flag(args))
        if rsp.verdict == "OK":
            return f"OK ({len(rsp.rules)} rules clean)"
        firing = [r for r in rsp.rules if r.state == "firing"]
        detail = "; ".join(
            f"{r.rule}: {r.message or r.bound}" for r in firing)
        return f"{rsp.verdict}: {detail}"

    def cmd_flight_dump(self, args: List[str]) -> str:
        """Dump a process's flight-recorder black box to disk:
        flight-dump --addr HOST:PORT [--path P] — any service binary,
                    via its core flightDump RPC
        flight-dump --local [--path P] — THIS process's ring"""
        path = self._flag(args, "--path", "")
        if "--local" in args:
            from tpu3fs_torch.monitor.flight import flight

            out = flight().dump(path or None, reason="admin_cli")
            return (f"dumped {len(flight().snapshot())} events to {out}"
                    if out else "no flight dir configured (use --path)")
        addr = self._flag(args, "--addr") or (
            args[0] if args and not args[0].startswith("--") else None)
        if not addr:
            return ("usage: flight-dump (--addr <host:port> | --local) "
                    "[--path P]")
        from tpu3fs_torch.rpc.net import RpcClient
        from tpu3fs_torch.rpc.services import (
            CORE_SERVICE_ID,
            FlightDumpReq,
            FlightDumpRsp,
        )

        host, port = addr.rsplit(":", 1)
        rsp = RpcClient().call((host, int(port)), CORE_SERVICE_ID, 7,
                               FlightDumpReq(path=path), FlightDumpRsp)
        if not rsp.path:
            return (f"{addr}: ring holds {rsp.events} events but no "
                    "flight dir is configured (pass --path)")
        return f"{addr}: dumped {rsp.events} events to {rsp.path}"

    def cmd_flight_show(self, args: List[str]) -> str:
        """flight-show --dir D[,D...]: merge N processes' flight dumps
        into one timeline (alerts, config pushes) + the slowest
        cross-process span trees rebuilt from the dumped slow-op
        spans."""
        from tpu3fs_torch.analytics import assemble

        spec = self._flag(args, "--dir") or (
            args[0] if args and not args[0].startswith("--") else None)
        if not spec:
            return "usage: flight-show --dir <dump-dir[,dump-dir...]>"
        rows = assemble.load_flight(spec.split(","))
        return assemble.format_flight(rows)

    def cmd_ec_status(self, args: List[str]) -> str:
        """Per-EC-chain health: shard -> target/state map, degraded
        summary, and with --counts the per-target stripe counts
        (dump_chunkmeta), rebuild progress of SYNCING shards and the
        file ids currently served degraded.
        ec-status [--chain ID] [--counts]"""
        want = self._flag(args, "--chain")
        deep = "--counts" in args
        routing = self.fab.routing()
        lines = []
        for cid, chain in sorted(routing.chains.items()):
            if not chain.is_ec:
                continue
            if want is not None and int(want) != cid:
                continue
            states = [t.public_state.name for t in chain.targets]
            degraded = sum(1 for s in states if s != "SERVING")
            syncing = sum(1 for s in states if s == "SYNCING")
            head = (f"chain {cid} EC({chain.ec_k},{chain.ec_m}) "
                    f"v{chain.chain_version}: ")
            if degraded == 0:
                head += "healthy"
            else:
                head += f"DEGRADED ({degraded} shard(s) not serving"
                if syncing:
                    head += f", {syncing} rebuilding"
                head += ")"
            lines.append(head)
            metas = {}
            if deep:
                for t in chain.targets:
                    node = routing.node_of_target(t.target_id)
                    if node is None:
                        continue
                    try:
                        metas[t.target_id] = self.fab.send(
                            node.node_id, "dump_chunkmeta", t.target_id)
                    except FsError:
                        metas[t.target_id] = None
            # shard positions come from preferred_order (chain_sm may
            # rotate `targets`; the shard layout never moves)
            for j in range(chain.ec_k + chain.ec_m):
                t = chain.target_of_shard(j)
                if t is None:
                    lines.append(f"  shard {j}: no target")
                    continue
                node = routing.node_of_target(t.target_id)
                kind = "data" if j < chain.ec_k else "parity"
                extra = ""
                if deep:
                    got = metas.get(t.target_id)
                    extra = f"  stripes={len(got) if got is not None else '?'}"
                lines.append(
                    f"  shard {j} ({kind:<6}) target {t.target_id} node "
                    f"{node.node_id if node else '?'} "
                    f"{t.public_state.name}{extra}")
            if deep and degraded:
                # rebuild progress: the recovering shard's stripe count vs
                # the fullest serving peer; degraded files = files whose
                # stripes a serving peer still holds (reads decode inline)
                serving_ids = {t.target_id for t in chain.targets
                               if t.public_state.name == "SERVING"}
                peer_counts = [len(v) for tid, v in metas.items()
                               if v is not None and tid in serving_ids]
                goal = max(peer_counts, default=0)
                for t in chain.targets:
                    if t.public_state.name != "SYNCING":
                        continue
                    have = metas.get(t.target_id)
                    have_n = len(have) if have is not None else 0
                    lines.append(f"  rebuild: target {t.target_id} "
                                 f"{have_n}/{goal} stripes")
                files = sorted({m.chunk_id.file_id
                                for tid, v in metas.items()
                                if v is not None and tid in serving_ids
                                for m in v})
                if files:
                    shown = ", ".join(str(f) for f in files[:8])
                    more = ("" if len(files) <= 8
                            else f" (+{len(files) - 8} more)")
                    lines.append(
                        f"  degraded files: {shown}{more}")
        return "\n".join(lines) if lines else "no EC chains"

    # -- cluster fault plane (utils/fault_injection.py) ----------------------
    @staticmethod
    def _merge_faults_toml(content: str, spec: str, seed: int) -> str:
        """Merge a [faults] section into an existing pushed-config blob
        (set_config replaces the whole blob; operators must not lose the
        qos/trace sections they pushed earlier)."""
        return AdminCli._merge_section_toml(content, "faults",
                                            {"spec": spec, "seed": seed})

    @staticmethod
    def _merge_section_toml(content: str, section: str,
                            items: Dict[str, object]) -> str:
        """Merge one [section] of scalar items into a pushed-config blob,
        preserving every other section (faults/tenants share this)."""
        from tpu3fs_torch.utils.config import tomllib

        data = tomllib.loads(content) if content else {}
        data.setdefault(section, {})
        data[section].update(items)

        def render(d: dict, prefix: str = "") -> List[str]:
            lines = []
            for k in sorted(d):
                v = d[k]
                if isinstance(v, dict):
                    continue
                if isinstance(v, bool):
                    lines.append(f"{k} = {'true' if v else 'false'}")
                elif isinstance(v, (int, float)):
                    lines.append(f"{k} = {v!r}")
                else:
                    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
                    lines.append(f'{k} = "{s}"')
            for k in sorted(d):
                v = d[k]
                if isinstance(v, dict):
                    lines.append("")
                    lines.append(f"[{prefix}{k}]")
                    lines.extend(render(v, f"{prefix}{k}."))
            return lines

        return "\n".join(render(data)).strip() + "\n"

    def cmd_fault(self, args: List[str]) -> str:
        """Cluster fault plane (gray-failure chaos tooling):
        fault set --spec "point=...,kind=...,..." [--seed N]
                  [--node-type storage] — merge a [faults] section into
                  the node type's pushed config (heartbeats deliver it,
                  every node of that type arms the rules live)
        fault clear [--node-type storage] — push an empty spec
        fault show [--node-type storage] [--collector H:P [--window S]]
                  — pushed spec + local plane with PER-RULE fire counts;
                  --collector adds the cluster-wide faults.fired rollup
                  (every node's firings by kind+point), so a chaos soak
                  can assert its schedule actually fired
        fault local --spec ... [--seed N] — arm THIS process's plane"""
        from tpu3fs_torch.utils.fault_injection import parse_spec, plane

        if not args:
            return "usage: fault set|clear|show|local ..."
        sub, rest = args[0], args[1:]
        if sub == "local":
            spec = self._flag(rest, "--spec", "")
            seed = int(self._flag(rest, "--seed", 0))
            plane().configure(spec, seed)
            return (f"local fault plane: {len(plane().snapshot())} rule(s) "
                    f"armed")
        if sub == "show":
            lines = []
            for r in plane().snapshot():
                lines.append(f"local rule: point={r['point']} "
                             f"kind={r['kind']} fired={r['fired']}"
                             + (f"/{r['times']}" if r['times'] >= 0 else ""))
            lines.append(f"local fired total: {plane().fired_total}")
            coll = self._flag(rest, "--collector", "")
            if coll:
                window = float(self._flag(rest, "--window", 120.0))
                rows = self._agg_rows(coll, window, prefix="faults.fired")
                fired = {}
                for row in rows or []:
                    key = (row.tags.get("kind", "?"),
                           row.tags.get("point", "?"))
                    fired[key] = fired.get(key, 0.0) + row.vsum
                if fired:
                    lines.append(f"cluster faults.fired (last {window:g}s):")
                    for (kind, point), n in sorted(fired.items()):
                        lines.append(f"  {point:<28} {kind:<10} {int(n)}")
                else:
                    lines.append(
                        f"cluster faults.fired (last {window:g}s): none")
            nt = self._node_type_flag(rest)
            try:
                blob = self.fab.mgmtd.get_config(nt)
            except (FsError, AttributeError):
                blob = None
            if blob is not None and blob.content:
                import re as _re

                m = _re.search(r'^spec\s*=\s*"(.*)"$', blob.content,
                               _re.MULTILINE)
                lines.append(f"pushed {nt.name} config v{blob.version} "
                             f"spec: {m.group(1) if m else '(none)'}")
            return "\n".join(lines)
        if sub in ("set", "clear"):
            spec = "" if sub == "clear" else self._flag(rest, "--spec", "")
            seed = int(self._flag(rest, "--seed", 0))
            rules = parse_spec(spec)  # validate BEFORE pushing
            nt = self._node_type_flag(rest)
            blob = self.fab.mgmtd.get_config(nt)
            content = self._merge_faults_toml(blob.content, spec, seed)
            ver = self.fab.mgmtd.set_config(nt, content)
            return (f"pushed {len(rules)} fault rule(s) to {nt.name} "
                    f"config v{ver} (heartbeats deliver within one "
                    f"interval)")
        return "usage: fault set|clear|show|local ..."

    def _node_type_flag(self, args: List[str]):
        from tpu3fs_torch.mgmtd.types import NodeType

        return NodeType[self._flag(args, "--node-type", "storage").upper()]

    # -- FS shell ------------------------------------------------------------
    def cmd_ls(self, args: List[str]) -> str:
        path = args[0] if args else "/"
        ents = self.fab.meta.list_dir(path)
        return "\n".join(f"{e.type.name[:4].lower():<5} {e.name}" for e in ents)

    def cmd_mkdir(self, args: List[str]) -> str:
        recursive = "-p" in args
        path = [a for a in args if not a.startswith("-")][0]
        self.fab.meta.mkdirs(path, recursive=recursive)
        return f"created {path}"

    def cmd_stat(self, args: List[str]) -> str:
        inode = self.fab.meta.stat(args[0])
        kind = inode.type.name.lower()
        out = (
            f"{args[0]}: {kind} inode={inode.id} nlink={inode.nlink} "
            f"perm={oct(inode.acl.perm)} uid={inode.acl.uid} "
            f"length={inode.length}"
        )
        if inode.layout:
            out += (
                f"\nlayout: chains={inode.layout.chains} "
                f"chunk_size={inode.layout.chunk_size} seed={inode.layout.seed}"
            )
        return out

    def cmd_touch(self, args: List[str]) -> str:
        res = self.fab.meta.create(args[0], client_id="admin_cli")
        return f"created inode {res.inode.id}"

    def cmd_rm(self, args: List[str]) -> str:
        recursive = "-r" in args
        path = [a for a in args if not a.startswith("-")][0]
        self.fab.meta.remove(path, recursive=recursive)
        return f"removed {path}"

    def cmd_mv(self, args: List[str]) -> str:
        self.fab.meta.rename(args[0], args[1])
        return f"renamed {args[0]} -> {args[1]}"

    def cmd_truncate(self, args: List[str]) -> str:
        self.fab.meta.truncate(args[0], int(args[1]))
        return f"truncated {args[0]} to {args[1]}"

    def cmd_write(self, args: List[str]) -> str:
        path, text = args[0], args[1]
        res = self.fab.meta.create(path, flags=OpenFlags.WRITE,
                                   client_id="admin_cli")
        fio = self.fab.file_client()
        n = fio.write(res.inode, 0, text.encode())
        self.fab.meta.close(res.inode.id, res.session_id,
                            length_hint=n, wrote=True)
        return f"wrote {n} bytes"

    def cmd_read(self, args: List[str]) -> str:
        path = args[0]
        offset = int(self._flag(args, "--offset", 0))
        length = int(self._flag(args, "--length", 256))
        inode = self.fab.meta.stat(path)
        data = self.fab.file_client().read(inode, offset, length)
        try:
            return data.decode()
        except UnicodeDecodeError:
            return data.hex()

    def cmd_checksum(self, args: List[str]) -> str:
        inode = self.fab.meta.stat(args[0])
        data = self.fab.file_client().read(inode, 0, inode.length)
        return f"crc32c={crc32c(data):#010x} length={len(data)}"

    def cmd_stat_fs(self, args: List[str]) -> str:
        fs = self.fab.meta.stat_fs()
        return f"files={fs.files} used={fs.used}"

    def cmd_gc_run(self, args: List[str]) -> str:
        return f"gc reclaimed {self.fab.run_gc()} files"

    # -- namespace scans (ref src/meta/event/Scan.cc; DumpInodes admin cmds) -
    def cmd_scan_stats(self, args: List[str]) -> str:
        from tpu3fs_torch.meta.scan import namespace_stats

        st = namespace_stats(self.fab.kv)
        return (f"files={st['files']} dirs={st['dirs']} "
                f"symlinks={st['symlinks']} bytes={st['total_length']}")

    def cmd_find_orphans(self, args: List[str]) -> str:
        from tpu3fs_torch.meta.scan import find_orphan_inodes

        orphans = find_orphan_inodes(self.fab.kv)
        if not orphans:
            return "no orphan inodes"
        return "\n".join(f"inode {o.id} nlink={o.nlink}" for o in orphans)

    # -- users (ref src/core/user UserStore; admin_cli user commands) --------
    def _users(self):
        from tpu3fs_torch.core.user import UserStore

        return UserStore(self.fab.kv)

    def cmd_user_add(self, args: List[str]) -> str:
        uid = int(args[0])
        has_name = len(args) > 1 and not args[1].startswith("-")
        name = args[1] if has_name else f"user{uid}"
        rec = self._users().add_user(
            uid, name,
            gid=int(self._flag(args, "--gid", uid)),
            admin="--admin" in args, root="--root" in args,
        )
        return f"user {rec.uid} ({rec.name}) token={rec.token}"

    def cmd_user_list(self, args: List[str]) -> str:
        rows = [
            f"{r.uid:<6} {r.name:<16} gid={r.gid} admin={r.admin} root={r.root}"
            for r in self._users().list_users()
        ]
        return "\n".join(rows) if rows else "(no users)"

    def cmd_user_remove(self, args: List[str]) -> str:
        ok = self._users().remove_user(int(args[0]))
        return "removed" if ok else "no such user"

    def cmd_user_rotate_token(self, args: List[str]) -> str:
        return f"new token: {self._users().rotate_token(int(args[0]))}"

    # -- trash (ref hf3fs_utils/trash.py + trash_cleaner) --------------------
    def cmd_trash_put(self, args: List[str]) -> str:
        from tpu3fs_torch.utils import trash as _trash

        keep = int(self._flag(args, "--keep", 3 * 86400))
        dest = _trash.move_to_trash(self.fab.meta, args[0], keep_s=keep)
        return f"moved to {dest}"

    def cmd_trash_list(self, args: List[str]) -> str:
        from tpu3fs_torch.utils import trash as _trash

        rows = [
            f"{e.path} orig={e.orig_name} expires={e.expire_ts}"
            for e in _trash.list_trash(self.fab.meta)
        ]
        return "\n".join(rows) if rows else "(trash empty)"

    def cmd_trash_clean(self, args: List[str]) -> str:
        from tpu3fs_torch.utils import trash as _trash

        n = _trash.TrashCleaner(self.fab.meta).clean_once()
        self.fab.run_gc()
        return f"purged {n} expired entries"

    # -- migration (ref src/migration job control) ---------------------------
    def _migration(self):
        if self._migration_svc is None:
            from tpu3fs_torch.migration import MigrationService

            self._migration_svc = MigrationService(self.fab.storage_client())
        return self._migration_svc

    # -- elasticity: placement planning / rebalance / drain ------------------
    def _topology_delta(self, args: List[str]):
        from tpu3fs_torch.placement import TopologyDelta

        def ids(flag):
            raw = self._flag(args, flag)
            return [int(x) for x in raw.split(",")] if raw else []

        join, drain, dead = ids("--join"), ids("--drain"), ids("--dead")
        if join or drain or dead:
            return TopologyDelta(joined=join, draining=drain, dead=dead)
        return TopologyDelta.from_routing(self.fab.routing())

    @staticmethod
    def _render_plan(plan, delta) -> List[str]:
        lines = [
            f"delta: join={delta.joined} drain={delta.draining} "
            f"dead={delta.dead}",
            f"moves: {len(plan.moves)}"
            + (f" (+{len(plan.deferred_chains)} chains deferred to a "
               "later wave)" if plan.deferred_chains else ""),
        ]
        for mv in plan.moves:
            kind = "EC" if mv.is_ec else "CR"
            lines.append(
                f"  chain {mv.chain_id} [{kind}]: target {mv.out_target} "
                f"node {mv.src_node} -> node {mv.dst_node}")
        b, a = plan.before, plan.after
        lines.append(
            f"lambda: {b.lambda_max} -> {a.lambda_max} "
            f"(lower bound {a.lambda_lower_bound}); recovery traffic "
            f"factor {a.recovery_traffic_factor} => worst peer "
            f"{b.lambda_max * b.recovery_traffic_factor} -> "
            f"{a.lambda_max * a.recovery_traffic_factor} units")
        lines.append("chains/node after: " + " ".join(
            f"{n}:{c}" for n, c in sorted(plan.after.per_node.items())))
        return lines

    def cmd_placement_plan(self, args: List[str]) -> str:
        """Preview the incremental rebalance diff + predicted λ/traffic:
        placement-plan [--join N,..] [--drain N,..] [--dead N,..]
        (no flags = delta derived from routing tags/heartbeats)."""
        from tpu3fs_torch.placement import check_plan, plan_rebalance

        delta = self._topology_delta(args)
        plan = plan_rebalance(self.fab.routing(), delta)
        lines = self._render_plan(plan, delta)
        problems = check_plan(self.fab.routing(), plan, delta)
        for p in problems:
            lines.append(f"QUORUM PROBLEM: {p}")
        return "\n".join(lines)

    def cmd_rebalance(self, args: List[str]) -> str:
        """Plan and (with --apply) submit migration jobs for the current
        topology delta: rebalance [--apply] [--join/--drain/--dead N,..]."""
        from tpu3fs_torch.placement import check_plan, plan_rebalance

        delta = self._topology_delta(args)
        routing = self.fab.routing()
        plan = plan_rebalance(routing, delta)
        lines = self._render_plan(plan, delta)
        problems = check_plan(routing, plan, delta)
        if problems:
            return "\n".join(lines + [f"QUORUM PROBLEM: {p}"
                                      for p in problems]
                             + ["refused: plan violates quorum"])
        if plan.empty:
            return "\n".join(lines + ["nothing to do"])
        if "--apply" not in args:
            return "\n".join(lines + ["(preview; re-run with --apply)"])
        ids = self.fab.mgmtd.migration_submit(
            [mv.spec() for mv in plan.moves])
        return "\n".join(lines + [f"submitted jobs: {ids}"])

    def cmd_drain(self, args: List[str]) -> str:
        """Mark a node draining and plan its evacuation; --apply submits:
        drain --node N [--apply] [--undo]. Refuses when any chain would
        drop below its write-quorum (check_plan)."""
        from tpu3fs_torch.placement import DRAINING_TAG

        node = int(self._flag(args, "--node"))
        if "--undo" in args:
            self.fab.mgmtd.set_node_tags(node, {DRAINING_TAG: ""})
            return f"node {node} draining flag cleared"
        self.fab.mgmtd.set_node_tags(node, {DRAINING_TAG: "1"})
        out = self.cmd_rebalance(args)
        if "--apply" not in args:
            # preview must not leave the drain armed
            self.fab.mgmtd.set_node_tags(node, {DRAINING_TAG: ""})
            return out
        if "submitted jobs" not in out:
            # refused (quorum) or undeliverable (no eligible destination
            # for some chain): do not leave a drain half-armed
            self.fab.mgmtd.set_node_tags(node, {DRAINING_TAG: ""})
            return out + f"\ndrain of node {node} refused, ROLLED BACK"
        return out

    def cmd_migrate_status(self, args: List[str]) -> str:
        """Cluster migration jobs from the mgmtd KV (crash-safe state)."""
        jobs = self.fab.mgmtd.migration_list()
        if not jobs:
            return "(no jobs)"
        lines = ["JOB  CHAIN    PHASE     OUT->NEW (node)      "
                 "COPIED              WORKER"]
        for j in jobs:
            from tpu3fs_torch.migration import JobPhase

            lines.append(
                f"{j.job_id:<4} {j.chain_id:<8} "
                f"{JobPhase(j.phase).name:<9} "
                f"{j.out_target}->{j.new_target} (n{j.dst_node})"
                f"{'':<6} {j.copied_chunks} chunks/"
                f"{j.copied_bytes}B{'':<4} {j.worker}"
                + (f"  ERR={j.error}" if j.error else ""))
        return "\n".join(lines)

    def cmd_migrate_start(self, args: List[str]) -> str:
        svc = self._migration()
        job_id = svc.start_job(int(args[0]), int(args[1]))
        job = svc.run_job(job_id)
        return (f"job {job_id}: {job.state.name.lower()} "
                f"copied={job.copied}/{job.total}"
                + (f" error={job.error}" if job.error else ""))

    def cmd_migrate_list(self, args: List[str]) -> str:
        rows = [
            f"job {j.job_id}: {j.src_chain}->{j.dst_chain} "
            f"{j.state.name.lower()} {j.copied}/{j.total}"
            for j in self._migration().list_jobs()
        ]
        return "\n".join(rows) if rows else "(no jobs)"

    def cmd_migrate_stop(self, args: List[str]) -> str:
        ok = self._migration().stop_job(int(args[0]))
        return "stopped" if ok else "not running"

    # -- file-level bench (ref benchmarks/storage_bench) ---------------------
    def cmd_fs_bench(self, args: List[str]) -> str:
        num = int(self._flag(args, "--chunks", 16))
        size = int(self._flag(args, "--size", 1 << 16))
        fio = self.fab.file_client()
        res = self.fab.meta.create("/.bench", flags=OpenFlags.WRITE,
                                   client_id="bench")
        payload = bytes(size)
        t0 = time.perf_counter()
        for i in range(num):
            fio.write(res.inode, i * size, payload)
        w = time.perf_counter() - t0
        inode = self.fab.meta.close(res.inode.id, res.session_id)
        t0 = time.perf_counter()
        for i in range(num):
            fio.read(inode, i * size, size)
        r = time.perf_counter() - t0
        self.fab.meta.remove("/.bench")
        self.fab.run_gc()
        mb = num * size / 1e6
        return (
            f"write {mb / w:.1f} MB/s, read {mb / r:.1f} MB/s "
            f"({num} x {size}B chunks)"
        )

    # -- forensic dumps (ref DumpInodes/DumpDirEntries/DumpChunkMeta/
    # DumpChains/DumpChainTable/DumpSession in src/client/cli/admin/) ------
    def cmd_dump_inodes(self, args: List[str]) -> str:
        """dump-inodes FILE: JSONL of EVERY inode record, straight off the
        KV scan (ref DumpInodes.cc) — includes unlinked-but-open and
        orphaned inodes a path walk would miss, which is the point of a
        forensic dump."""
        import json as _json

        from tpu3fs_torch.meta.scan import scan_inodes

        n = 0
        with open(args[0], "w") as f:
            for ino in scan_inodes(self.fab.kv):
                f.write(_json.dumps({
                    "id": ino.id, "type": ino.type.name,
                    "parent": ino.parent,
                    "length": getattr(ino, "length", 0),
                    "nlink": ino.nlink, "uid": ino.acl.uid,
                    "gid": ino.acl.gid, "perm": ino.acl.perm,
                    "mtime": ino.mtime, "ctime": ino.ctime,
                }) + "\n")
                n += 1
        return f"dumped {n} inodes to {args[0]}"

    def cmd_dump_dentries(self, args: List[str]) -> str:
        """dump-dentries FILE: JSONL of every directory-entry record,
        straight off the KV scan (ref DumpDirEntries.cc)."""
        import json as _json

        from tpu3fs_torch.meta.scan import scan_dirents

        n = 0
        with open(args[0], "w") as f:
            for ent in scan_dirents(self.fab.kv):
                f.write(_json.dumps({
                    "parent_id": ent.parent, "name": ent.name,
                    "inode_id": ent.inode_id, "type": ent.type.name,
                }) + "\n")
                n += 1
        return f"dumped {n} dentries to {args[0]}"

    def cmd_dump_chunkmeta(self, args: List[str]) -> str:
        """dump-chunkmeta TARGET_ID FILE: JSONL chunk metadata of one
        storage target (ref DumpChunkMeta.cc)."""
        import json as _json

        target_id, out_path = int(args[0]), args[1]
        routing = self.fab.routing()
        node = routing.node_of_target(target_id)
        if node is None:
            return f"target {target_id} not in routing"
        metas = self.fab.send(node.node_id, "dump_chunkmeta", target_id)
        with open(out_path, "w") as f:
            for m in metas:
                f.write(_json.dumps({
                    "chunk": [m.chunk_id.file_id, m.chunk_id.index],
                    "committed_ver": m.committed_ver,
                    "pending_ver": m.pending_ver,
                    "chain_ver": m.chain_ver, "length": m.length,
                    "crc": m.checksum.value,
                }) + "\n")
        return f"dumped {len(metas)} chunk metas to {out_path}"

    def cmd_dump_chains(self, args: List[str]) -> str:
        """dump-chains FILE: routing chain snapshot (ref DumpChains.cc)."""
        import json as _json

        routing = self.fab.routing()
        blob = {
            str(cid): {
                "version": c.chain_version,
                "ec": [c.ec_k, c.ec_m] if c.is_ec else None,
                "targets": [[t.target_id, t.public_state.name]
                            for t in c.targets],
            } for cid, c in sorted(routing.chains.items())
        }
        with open(args[0], "w") as f:
            _json.dump(blob, f, indent=1)
        return f"dumped {len(blob)} chains to {args[0]}"

    def cmd_dump_chain_table(self, args: List[str]) -> str:
        """dump-chain-table FILE [TABLE_ID] (ref DumpChainTable.cc)."""
        import json as _json

        routing = self.fab.routing()
        tables = routing.chain_tables
        want = int(args[1]) if len(args) > 1 else None
        blob = {str(tid): {"version": t.version, "chains": list(t.chain_ids)}
                for tid, t in tables.items()
                if want is None or tid == want}
        with open(args[0], "w") as f:
            _json.dump(blob, f, indent=1)
        return f"dumped {len(blob)} chain tables to {args[0]}"

    def cmd_dump_sessions(self, args: List[str]) -> str:
        """dump-sessions [FILE]: live file write sessions
        (ref DumpSession.cc)."""
        import json as _json

        rows = [{"inode": s.inode_id, "client": s.client_id,
                 "session": s.session_id}
                for s in self.fab.meta.list_sessions()]
        if args:
            with open(args[0], "w") as f:
                for r in rows:
                    f.write(_json.dumps(r) + "\n")
            return f"dumped {len(rows)} sessions to {args[0]}"
        return "\n".join(
            f"inode={r['inode']} client={r['client']} "
            f"session={r['session']}" for r in rows) or "(none)"

    def cmd_list_clients(self, args: List[str]) -> str:
        """Distinct client ids holding write sessions
        (ref ListClients.cc)."""
        clients = sorted({s.client_id
                          for s in self.fab.meta.list_sessions()})
        return "\n".join(clients) or "(none)"

    def cmd_list_gc(self, args: List[str]) -> str:
        """Pending GC queue entries (ref ListGc.cc)."""
        limit = int(args[0]) if args else 64
        inodes = self.fab.meta.gc_scan(limit=limit)
        return "\n".join(
            f"inode={i.id} length={getattr(i, 'length', 0)}"
            for i in inodes) or "(empty)"

    def cmd_get_real_path(self, args: List[str]) -> str:
        """Resolve symlinks to the canonical path
        (ref GetRealPath.cc)."""
        return self.fab.meta.get_real_path(args[0])

    def cmd_decode_user_token(self, args: List[str]) -> str:
        """Resolve a bearer token to its user record
        (ref DecodeUserToken.cc)."""
        rec = self._users().authenticate(args[0])
        if rec is None:
            return "invalid token"
        return (f"uid={rec.uid} name={rec.name} gid={rec.gid} "
                f"groups={rec.groups} admin={rec.admin} root={rec.root}")

    def cmd_fill_zero(self, args: List[str]) -> str:
        """fill-zero PATH BYTES: materialize zeros (ref FillZero.cc)."""
        path, nbytes = args[0], int(args[1])
        res = self.fab.meta.create(path, flags=OpenFlags.WRITE,
                                   client_id="cli")
        fio = self.fab.file_client()
        step = 1 << 20
        for off in range(0, nbytes, step):
            fio.write(res.inode, off, b"\x00" * min(step, nbytes - off))
        self.fab.meta.close(res.inode.id, client_id="cli",
                            session_id=res.session_id)
        return f"filled {nbytes} zero bytes into {path}"

    def cmd_create_range(self, args: List[str]) -> str:
        """create-range PREFIX N: create N empty files
        (ref CreateRange.cc)."""
        prefix, n = args[0], int(args[1])
        for i in range(n):
            res = self.fab.meta.create(f"{prefix}{i}", client_id="cli")
            self.fab.meta.close(res.inode.id, client_id="cli",
                                session_id=res.session_id)
        return f"created {n} files at {prefix}0..{prefix}{n - 1}"

    # -- checkpoints (tpu3fs_torch/ckpt) -------------------------------------------
    def _ckpt(self, args: List[str]):
        from tpu3fs_torch.ckpt import CheckpointManager

        root = self._flag(args, "--root", "/ckpt")
        return CheckpointManager(self.fab.meta, self.fab.file_client(),
                                 root=root, client_id="admin_cli")

    def cmd_ckpt_list(self, args: List[str]) -> str:
        """ckpt-list [--root /ckpt]: committed steps (+ staging dirs)."""
        from tpu3fs_torch.ckpt.manifest import parse_staging

        mgr = self._ckpt(args)
        lines = ["STEP      FILES  BYTES       CREATED"]
        for step in mgr.steps():
            try:
                m = mgr.manifest(step)
                lines.append(f"{step:<9} {len(m.shards) + 1:<6} "
                             f"{m.total_bytes():<11} {m.created:.0f}")
            except FsError as e:
                lines.append(f"{step:<9} ?      ?           ({e.status})")
        try:
            staging = [
                e.name for e in self.fab.meta.list_dir(mgr.root)
                if parse_staging(e.name) is not None
            ]
        except FsError:
            staging = []
        if staging:
            lines.append("staging (crashed saves, swept by ckpt GC): "
                         + " ".join(sorted(staging)))
        return "\n".join(lines) if len(lines) > 1 or staging \
            else "(no checkpoints)"

    def cmd_ckpt_inspect(self, args: List[str]) -> str:
        """ckpt-inspect STEP [--root /ckpt]: manifest summary."""
        step = int([a for a in args if not a.startswith("-")][0])
        mgr = self._ckpt(args)
        m = mgr.manifest(step)
        lines = [
            f"step {m.step}: {len(m.leaves)} leaves, {len(m.shards)} shards,"
            f" {m.total_bytes()} bytes, created {m.created:.0f}",
        ]
        if m.mesh:
            lines.append("mesh: " + " ".join(
                f"{k}={v}" for k, v in m.mesh.items()))
        for i, leaf in enumerate(m.leaves):
            nsh = len(m.shards_of_leaf(i))
            spec = ",".join(s or "." for s in leaf.spec) or "-"
            lines.append(f"  {leaf.key or '<root>'}: {leaf.dtype} "
                         f"{tuple(leaf.shape)} sharded[{spec}] x{nsh}")
        return "\n".join(lines)

    # -- training data loader (tpu3fs_torch/dataload) ------------------------------
    def cmd_dataload_pack(self, args: List[str]) -> str:
        """dataload-pack OUT LOCAL_FILE... [--from-dir DIR]: pack local
        sample files into a packed record file (one record per file)."""
        import argparse as _argparse

        from tpu3fs_torch.bin.dataload_pack_main import run as _pack_run

        from_dir = self._flag(args, "--from-dir", "")
        rest = []
        skip = False
        for i, a in enumerate(args):
            if skip:
                skip = False
                continue
            if a == "--from-dir":
                skip = True
                continue
            rest.append(a)
        if not rest:
            return "usage: dataload-pack OUT LOCAL_FILE... [--from-dir DIR]"
        ns = _argparse.Namespace(out=rest[0], files=rest[1:],
                                 from_dir=from_dir, inspect="")
        import io as _io

        buf = _io.StringIO()
        rc = _pack_run(self.fab, ns, out=buf)
        return buf.getvalue().strip() if rc == 0 else f"pack failed ({rc})"

    def cmd_dataload_inspect(self, args: List[str]) -> str:
        """dataload-inspect PATH [--records N]: packed-file summary (+
        the first N record extents/CRCs)."""
        from tpu3fs_torch.dataload.recordio import RecordFile

        path = [a for a in args if not a.startswith("-")][0]
        show = int(self._flag(args, "--records", 0))
        rf = RecordFile.open(self.fab.meta, self.fab.file_client(), path)
        s = rf.summary()
        lines = [
            f"{path}: {s['records']} records, {s['payload_bytes']} payload "
            f"bytes ({s['file_bytes']} on disk), record size "
            f"{s['min_record']}..{s['max_record']}"
        ]
        for i in range(min(show, rf.num_records)):
            off, n = rf.extent(i)
            lines.append(f"  [{i}] offset={off} length={n} "
                         f"crc={rf.record_crc(i):#010x}")
        return "\n".join(lines)

    # -- inference KV cache (tpu3fs_torch/kvcache) ---------------------------------
    def cmd_kvcache_stats(self, args: List[str]) -> str:
        """kvcache-stats [--root /kvcache]: fs-tier entries, bytes, lease
        count, oldest/newest touch ages — the capacity-planning view."""
        from tpu3fs_torch.kvcache import KVCacheGC

        root = self._flag(args, "--root", "/kvcache")
        gc = KVCacheGC(self.fab.meta, root=root)
        now = time.time()
        entries = gc.scan_entries(now)
        if not entries:
            return f"{root}: empty"
        total = sum(length for _, length, _, _ in entries)
        leased = sum(1 for _, _, is_leased, _ in entries if is_leased)
        oldest = min(mtime for mtime, _, _, _ in entries)
        newest = max(mtime for mtime, _, _, _ in entries)
        return (f"{root}: entries={len(entries)} bytes={total} "
                f"leased={leased} oldest_age_s={now - oldest:.0f} "
                f"newest_age_s={now - newest:.0f}")

    def cmd_kvcache_gc(self, args: List[str]) -> str:
        """kvcache-gc [--root /kvcache] [--ttl S] [--capacity-bytes N]
        [--max-shards N]: one GC pass — TTL scan, then capacity-target
        LRU eviction when a bytes budget is given. Lease-pinned entries
        survive both."""
        from tpu3fs_torch.kvcache import KVCacheGC

        cap = self._flag(args, "--capacity-bytes")
        gc = KVCacheGC(
            self.fab.meta,
            root=self._flag(args, "--root", "/kvcache"),
            ttl_s=float(self._flag(args, "--ttl", 3600.0)),
            max_shards=int(self._flag(args, "--max-shards", 64)),
            capacity_bytes=int(cap) if cap is not None else None,
        )
        ttl_removed = gc.run_once()
        cap_removed = gc.capacity_pass()
        run_gc = getattr(self.fab, "run_gc", None)
        if run_gc is not None:  # live clusters reclaim via the meta GC scan
            run_gc()
        out = f"ttl pass removed {ttl_removed}"
        if cap is not None:
            out += f"; capacity pass removed {cap_removed}"
        return out

    def cmd_serving(self, args: List[str]) -> str:
        """serving [--stats]: the mgmtd serving directory (fleet KVCache
        peer endpoints, docs/serving.md); --stats also calls each live
        endpoint's servingStats — host-tier residency + the peer-fill
        protocol's outcome counters."""
        ri = self.fab.routing()
        serving = getattr(ri, "serving", {}) or {}
        if not serving:
            return "serving directory: empty"
        lines = [f"serving directory ({len(serving)} endpoints, "
                 f"routing v{ri.version}):"]
        stats = "--stats" in args
        peers = None
        if stats:
            from tpu3fs_torch.rpc.net import RpcClient
            from tpu3fs_torch.serving.service import ServingPeerClient

            peers = ServingPeerClient(RpcClient(), usrbio=False)
        for node_id, ep in sorted(serving.items()):
            line = (f"  node {node_id:<5} {ep.host}:{ep.port} "
                    f"ttl={ep.ttl_s:.0f}s")
            if peers is not None:
                try:
                    s = peers.stats(ep)
                    line += (f" host={s.host_entries}e/{s.host_bytes}B "
                             f"peer_hits={s.peer_hits} "
                             f"peer_misses={s.peer_misses} "
                             f"storage_fills={s.storage_fills} "
                             f"coalesced={s.coalesced} "
                             f"demotions={s.demotions} stale={s.stale_detected}")
                except FsError as e:
                    line += f" unreachable ({e.code.name})"
            lines.append(line)
        return "\n".join(lines)

    def cmd_ckpt_rm(self, args: List[str]) -> str:
        """ckpt-rm STEP [--root /ckpt] [--keep SECONDS]: evict one step
        through the trash subsystem (recoverable until expiry)."""
        step = int([a for a in args if not a.startswith("-")][0])
        mgr = self._ckpt(args)
        mgr.gc.trash_keep_s = int(self._flag(args, "--keep",
                                             mgr.gc.trash_keep_s))
        mgr.remove(step)
        return f"step {step} moved to trash"



class RpcFabricView:
    """Live-cluster adapter for AdminCli: exposes the same .mgmtd / .meta /
    .routing() / .file_client() / .storage_client() surfaces as the
    in-process Fabric, backed by RPC clients — the admin_cli connects to a
    running cluster exactly like the reference's (ForAdmin/ForClient mgmtd
    role split, src/client/mgmtd/MgmtdClient.cc)."""

    def __init__(self, mgmtd_addr, token: str = "", client_id: str = "admin",
                 device=None):
        """``device``: the storage and file clients' device (encode,
        checksums, decodes) and ``solve-placement``'s; ``cuda`` unless
        the caller asks for the CPU, raising without a card."""
        import itertools
        import uuid

        from tpu3fs_torch.device import checked_device

        from tpu3fs_torch.client.file_io import FileIoClient
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.mgmtd.types import NodeType
        from tpu3fs_torch.rpc.net import RpcClient
        from tpu3fs_torch.rpc.services import (
            MetaRpcClient,
            MgmtdAdminRpcClient,
            RpcMessenger,
        )

        self.device = checked_device(device)
        self._rpc = RpcClient()
        self._client_id = client_id
        # storage clients need UNIQUE wire ids (like Fabric's client-N):
        # the server's exactly-once channel table is keyed (client id,
        # channel, seq) — two client INSTANCES sharing one id restart
        # their channel seqs and the server silently dedupes the second
        # client's writes as replays (found by the live dataload drive:
        # a fresh client's 9-byte state write "succeeded" without
        # landing). The uuid part keeps two operator PROCESSES with the
        # same client_id apart as well.
        self._storage_id_base = f"{client_id}-{uuid.uuid4().hex[:8]}"
        self._storage_seq = itertools.count(1)
        self.mgmtd = MgmtdAdminRpcClient(mgmtd_addr, self._rpc)
        self._messenger = RpcMessenger(self.mgmtd.refresh_routing, self._rpc)
        self._StorageClient = StorageClient
        self._FileIoClient = FileIoClient
        meta_addrs = [
            (n.host, n.port)
            for n in self.routing().nodes.values()
            if n.type == NodeType.META and n.host
        ]
        self.meta = (
            MetaRpcClient(meta_addrs, self._rpc,
                          client_id=client_id, token=token)
            if meta_addrs else None
        )

    def routing(self):
        return self.mgmtd.refresh_routing()

    def tick(self) -> None:
        self.mgmtd.tick()

    def send(self, node_id: int, method: str, payload):
        """Storage-node RPC by node id (the Fabric.send signature), for
        maintenance sweeps like verify-checksums / find-orphaned-chunks."""
        return self._messenger(node_id, method, payload)

    def storage_client(self, **kw):
        return self._StorageClient(
            f"{self._storage_id_base}-{next(self._storage_seq)}",
            self.mgmtd.refresh_routing, self._messenger,
            **{"device": self.device, **kw})

    def file_client(self, **kw):
        return self._FileIoClient(self.storage_client(**kw))

    def close(self) -> None:
        """Close the shm rings the messenger opened and the RPC client's
        pooled connections."""
        self._messenger.close_rings()
        self._rpc.close()


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    """One-shot or REPL — against a fresh local fabric (dev mode) or a live
    cluster via --connect HOST:PORT (operator mode). A leading ``--device
    D`` picks the device (default ``cuda``)."""
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if argv[:1] == ["--device"]:
        if len(argv) < 2:
            print("usage: cli [--device D] [--connect HOST:PORT ...]",
                  file=sys.stderr)
            return 2
        device, argv = argv[1], argv[2:]
    if argv and argv[0] == "--connect":
        usage = "usage: cli --connect HOST:PORT [--token TOKEN] [command...]"
        try:
            host, port_s = argv[1].rsplit(":", 1)
            port = int(port_s)
            token = ""
            rest = argv[2:]
            if rest[:1] == ["--token"]:
                token, rest = rest[1], rest[2:]
        except (IndexError, ValueError):
            print(usage, file=sys.stderr)
            return 2
        cli = AdminCli(RpcFabricView((host, port), token=token,
                                     device=device))
        argv = rest
    else:
        from tpu3fs_torch.fabric import Fabric

        cli = AdminCli(Fabric(device=device))
    try:
        if argv:
            print(cli.run(" ".join(argv)))
            return 0
        cli.repl()
        return 0
    finally:
        close = getattr(cli.fab, "close", None)
        if close is not None:
            close()


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
