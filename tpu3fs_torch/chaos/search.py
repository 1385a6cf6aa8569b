"""Chaos search: run seeded schedules against an in-process fabric,
hunt invariant violations, shrink what's found, grow the regression
corpus.

The loop (docs/chaos.md):

1. ``search_violations`` draws schedules from consecutive seeds
   (``generate_schedule`` — recorded, hence replayable) and runs each
   with a ``FabricRunner``: a fresh single-process Fabric, a seeded
   sequential workload (tenant-tagged writes/reads with a CRC oracle),
   the schedule's events applied at their step marks, then a quiesce
   (clear faults, restart dead nodes, resync, settle migrations) and
   the invariant checker registry (chaos/invariants.py).
2. A violating schedule is SHRUNK to its minimal event prefix
   (``shrink_schedule`` — linear scan, smallest k whose prefix still
   violates; replays are deterministic so the scan is sound).
3. ``save_seed`` writes the shrunk schedule + expected verdict to
   ``tests/chaos_seeds/`` where tier-1 replays it forever after
   (tests/test_chaos.py) — every violation ever found stays fixed.

Determinism: the workload RNG derives from the schedule seed, clients
run sequentially with zero-backoff retries, and the fault plane's RNG
reseeds on every ``fault_set`` — one seed, one outcome.

The port's own copy of ``tpu3fs/chaos/search.py``, replaying the same
corpus to the same verdicts. ``FabricRunner(schedule, device=)`` runs the
port's ``Fabric``, its clients and every sidecar on ``device`` (the card
unless the caller names another; ``run_schedule``, ``search_violations``,
``shrink_schedule`` and ``replay_seed`` pass ``device`` on), and takes the
oracle's CRCs with ``crc32c_many`` there: kernel K2 on the card.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.chaos import bugs
from tpu3fs_torch.chaos.invariants import (
    ChaosContext,
    CheckOutcome,
    Violation,
    format_report,
    run_checkers,
)
from tpu3fs_torch.chaos.schedule import (
    ChaosEvent,
    Schedule,
    ScheduleSpec,
    generate_schedule,
    record_event_applied,
)
from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.monitor.recorder import CounterRecorder
from tpu3fs_torch.ops.crc32c import crc32c_many
from tpu3fs_torch.utils.fault_injection import plane

PAYLOAD_LEN = 64
FILE_ID_BASE = 7700
NUM_CHUNKS = 3

CORPUS_VERSION = 1

# -- recorders (single declaration site; docs/observability.md) --------------
_rec_runs = CounterRecorder("chaos.runs")


@dataclass
class RunReport:
    schedule: Schedule
    outcomes: List[CheckOutcome] = field(default_factory=list)
    events_applied: int = 0
    events_skipped: int = 0
    writes: int = 0
    acked: int = 0
    reads: int = 0

    @property
    def violations(self) -> List[Violation]:
        return [v for o in self.outcomes for v in o.violations]

    @property
    def violated(self) -> bool:
        return bool(self.violations)

    @property
    def violated_checkers(self) -> List[str]:
        return sorted({o.checker for o in self.outcomes
                       if o.status == "violated"})

    def summary(self) -> str:
        head = (f"seed {self.schedule.seed}: "
                f"{self.events_applied} event(s) applied "
                f"({self.events_skipped} skipped), {self.writes} writes "
                f"({self.acked} acked), {self.reads} reads")
        return head + "\n" + format_report(self.outcomes)


class FabricRunner:
    """Execute ONE schedule against ONE fresh fabric. Sequential and
    seeded throughout — running the same schedule twice produces the
    same verdict (tested)."""

    def __init__(self, schedule: Schedule, *,
                 ops_per_step: int = 3,
                 checkers: Optional[List[str]] = None,
                 device=None):
        self.schedule = schedule
        # the fabric, its clients and every sidecar run on this device
        self.device = resolve_device(device)
        self.ops_per_step = ops_per_step
        self.checkers = checkers
        self._live_violations: List[Violation] = []

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> RunReport:
        from tpu3fs_torch.fabric.fabric import Fabric, SystemSetupConfig
        from tpu3fs_torch.client.storage_client import RetryOptions
        from tpu3fs_torch.qos.core import QosConfig

        spec = self.schedule.spec
        _rec_runs.add(1)
        # EC chain-encode lever scoped to this run: write_stripes reads
        # it per call, so the restore in `finally` is airtight
        env_prev = os.environ.get("TPU3FS_EC_CHAIN_ENCODE")
        if spec.ec_chain_encode:
            os.environ["TPU3FS_EC_CHAIN_ENCODE"] = "1"
        self.fab = Fabric(SystemSetupConfig(
            num_storage_nodes=spec.storage_nodes,
            num_chains=spec.num_chains,
            num_replicas=spec.num_replicas,
            ec_k=spec.ec_k, ec_m=spec.ec_m,
            chunk_size=1 << 16,
            heartbeat_timeout_s=60.0,
            fencing=True,
            qos=QosConfig(),
        ), device=self.device)
        # step at which the open partition heals, None when whole
        self._partition_heal: Optional[int] = None
        self.base_nodes = sorted(self.fab.nodes)
        self.rng = random.Random(self.schedule.seed ^ 0x5EED)
        fast = RetryOptions(max_retries=6, backoff_base_s=0.0,
                            backoff_max_s=0.0)
        self.clients = [self.fab.storage_client(retry=fast)
                        for _ in range(2)]
        self.tag = 0
        self.is_ec = spec.ec_k > 0
        self.chains = list(self.fab.chain_ids)
        # oracle[(chain, fid, idx)] -> admissible CRC set; sent crcs for
        # torn-read detection; logical write counts for exactly-once
        self.oracle: Dict[Tuple[int, int, int], set] = {}
        self.sent: Dict[Tuple[int, int, int], set] = {}
        self.writes_issued: Dict[Tuple[int, int, int], int] = {}
        self._worker = None
        self._tenants_touched = False
        self._train = None
        self._serving = None
        self._meta = None
        self._native = None
        if spec.train_workload:
            self._train_setup()
        if spec.kv_serving:
            self._serving_setup()
        if spec.meta_shard:
            self._metashard_setup()
        if spec.native_write:
            self._native_setup()
        report = RunReport(self.schedule)
        by_step: Dict[int, List[ChaosEvent]] = {}
        for e in self.schedule.events:
            by_step.setdefault(e.step, []).append(e)
        try:
            for step in range(spec.steps):
                if (self._partition_heal is not None
                        and step >= self._partition_heal):
                    self._heal_partition()
                for event in by_step.get(step, ()):
                    if self._apply_event(event):
                        report.events_applied += 1
                        record_event_applied()
                    else:
                        report.events_skipped += 1
                for _ in range(self.ops_per_step):
                    self._workload_op(report)
                self._train_tick(step)
                self._serving_tick(step)
                self._metashard_tick(step)
                self._native_tick(step)
                self._background_tick()
                self._partition_tick()
            self._quiesce()
            ctx = self._context()
            report.outcomes = run_checkers(ctx, self.checkers)
            if self._live_violations:
                for o in report.outcomes:
                    if o.checker == "crc_oracle":
                        o.violations.extend(self._live_violations)
                        o.status = "violated"
        finally:
            plane().clear()
            if self._partition_heal is not None:
                # mid-run abort with a cut still open: balance the bug
                # window before anything else touches the fabric
                self.fab.heal_partitions()
                bugs.partition_end()
                self._partition_heal = None
            if spec.ec_chain_encode:
                if env_prev is None:
                    os.environ.pop("TPU3FS_EC_CHAIN_ENCODE", None)
                else:
                    os.environ["TPU3FS_EC_CHAIN_ENCODE"] = env_prev
            if self._train is not None:
                try:
                    self._train["loader"].close()
                except Exception:
                    pass
            if self._serving is not None:
                for fleet in self._serving["fleets"].values():
                    try:
                        fleet.close(flush=False)
                    except Exception:
                        pass
            self._native_cleanup()
            if self._tenants_touched:
                from tpu3fs_torch.tenant.quota import registry

                try:
                    registry().configure("")
                except Exception:
                    pass
            self.fab.close()
        return report

    # -- events --------------------------------------------------------------
    def _apply_event(self, e: ChaosEvent) -> bool:
        """True = applied; False = not applicable here (e.g. a meta-role
        kill on a fabric with no meta process) — counted, never silent."""
        if e.kind == "fault_set":
            spec = e.args.get("spec", "")
            idx = int(e.args.get("node_idx", -1))
            if idx >= 0 and self.base_nodes:
                node = self.base_nodes[idx % len(self.base_nodes)]
                spec = ";".join(f"{entry},node={node}"
                                for entry in spec.split(";") if entry)
            plane().configure(spec, int(e.args.get("seed", 0)))
            return True
        if e.kind == "fault_clear":
            plane().clear()
            return True
        if e.kind == "kill":
            if e.args.get("role") != "storage":
                return False
            alive = [n for n in self.fab.nodes.values() if n.alive]
            if len(alive) <= 1:
                return False
            node = alive[int(e.args.get("idx", 0)) % len(alive)]
            self.fab.fail_node(node.node_id)
            return True
        if e.kind == "restart":
            if e.args.get("role") != "storage":
                return False
            dead = [n for n in self.fab.nodes.values() if not n.alive]
            if not dead:
                return False
            node = dead[int(e.args.get("idx", 0)) % len(dead)]
            self.fab.restart_node(node.node_id)
            self._safe_resync(rounds=4)
            return True
        if e.kind == "join":
            if not self.schedule.spec.allow_elastic:
                return False
            nid = self.fab.add_storage_node()
            return self._submit_plan(joined=[nid])
        if e.kind == "drain":
            if not self.schedule.spec.allow_elastic:
                return False
            from tpu3fs_torch.placement.rebalance import DRAINING_TAG

            alive = [n for n in self.fab.nodes.values() if n.alive]
            if len(alive) <= self.schedule.spec.num_replicas:
                return False
            node = alive[int(e.args.get("idx", 0)) % len(alive)]
            self.fab.mgmtd.set_node_tags(node.node_id, {DRAINING_TAG: "1"})
            if not self._submit_plan(draining=[node.node_id]):
                self.fab.mgmtd.set_node_tags(node.node_id,
                                             {DRAINING_TAG: ""})
                return False
            return True
        if e.kind == "config_push":
            return self._apply_config_push(e.args)
        if e.kind == "partition":
            return self._apply_partition(e)
        raise ValueError(f"unknown event kind {e.kind!r}")

    # -- partitions ----------------------------------------------------------
    def _apply_partition(self, e: ChaosEvent) -> bool:
        """Cut side-a nodes off from mgmtd AND side-b peers (mgmtd is
        always implicitly on side b). The cut heals ``heal_after`` steps
        later. Side a keeps its data links to unlisted nodes — the
        interesting partitions are control-plane asymmetric ones, where
        lease fencing (not connectivity) is what stops split-brain."""
        base = self.base_nodes
        if len(base) < 2:
            return False
        a_ids = sorted({base[int(i) % len(base)] for i in e.args["a"]})
        b_ids = sorted({base[int(i) % len(base)] for i in e.args["b"]}
                       - set(a_ids))
        if not a_ids or len(a_ids) >= len(base):
            return False  # degenerate: nothing cut, or no survivor side
        self.fab.set_partition(a_ids,
                               b_ids + [self.fab.MGMTD_NODE_ID])
        heal = e.step + int(e.args["heal_after"])
        if self._partition_heal is None:
            bugs.partition_begin()
            self._partition_heal = heal
        else:
            # overlapping cuts share one window; all heal together at
            # the latest mark (heal_partitions is global)
            self._partition_heal = max(self._partition_heal, heal)
        self._partition_tick()
        return True

    def _partition_tick(self) -> None:
        """While a cut is open, ripen the failure clocks: T/2 + 1 per
        step, so the partitioned side's lease fence expires (T/2 of
        mgmtd silence) one step BEFORE mgmtd declares it dead (T) and
        the chain updater promotes a successor — the ordering the
        fencing contract promises (docs/scale.md)."""
        from tpu3fs_torch.utils.result import FsError

        if self._partition_heal is None:
            return
        self.fab.clock.advance(self.fab.cfg.heartbeat_timeout_s / 2 + 1)
        self.fab.heartbeat_all()
        try:
            self.fab.mgmtd.tick()
        except FsError:
            pass

    def _heal_partition(self) -> None:
        self.fab.heal_partitions()
        bugs.partition_end()
        self._partition_heal = None
        self.fab.heartbeat_all()
        from tpu3fs_torch.utils.result import FsError

        try:
            self.fab.mgmtd.tick()
        except FsError:
            pass
        self._safe_resync(rounds=4)

    def _submit_plan(self, *, joined=None, draining=None) -> bool:
        from tpu3fs_torch.placement.rebalance import (
            TopologyDelta,
            check_plan,
            plan_rebalance,
        )
        from tpu3fs_torch.utils.result import FsError

        routing = self.fab.routing()
        delta = TopologyDelta(joined=joined or [], draining=draining or [])
        plan = plan_rebalance(routing, delta)
        if plan.empty or check_plan(routing, plan, delta):
            return False
        try:
            self.fab.mgmtd.migration_submit([mv.spec() for mv in plan.moves])
        except FsError:
            return False  # conflicting active jobs: planner wave pending
        return True

    def _apply_config_push(self, args: Dict) -> bool:
        section, spec = args.get("section"), args.get("spec", "")
        if section == "qos":
            key, _, value = spec.partition("=")
            self.fab.cfg.qos.set(key.strip(), float(value))
            return True
        if section == "tenants":
            from tpu3fs_torch.tenant.quota import registry

            registry().configure(spec)
            self._tenants_touched = True
            return True
        # slo: judged by a collector process; the in-fabric runner hosts
        # none, so the push has nothing to land on
        return False

    def _background_tick(self) -> None:
        """What a real cluster's loops do between workload ops: migration
        worker rounds + elastic open/retire/heartbeat when jobs exist."""
        from tpu3fs_torch.utils.result import FsError

        try:
            jobs = self.fab.mgmtd.migration_list()
        except FsError:
            return
        if not any(j.active for j in jobs):
            return
        if self._worker is None:
            from tpu3fs_torch.migration.service import MigrationWorker

            self._worker = MigrationWorker(
                self.fab.mgmtd, self.fab.storage_client(),
                worker_id="chaos-worker", batch_chunks=16)
        try:
            self.fab.elastic_tick()
            self._worker.run_once()
        except (FsError, ConnectionError):
            pass  # transient mid-chaos; quiesce settles the rest

    def _safe_resync(self, rounds: int = 4) -> None:
        """Resync under an armed fault window: failures are weather, not
        verdicts — the quiesce re-runs it with the plane cleared."""
        from tpu3fs_torch.utils.result import FsError

        try:
            self.fab.resync_all(rounds=rounds)
        except (FsError, ConnectionError):
            pass

    # -- workload ------------------------------------------------------------
    def _crc(self, data: bytes) -> int:
        """The oracle's CRC32C of one payload, on the runner's device
        (one K2 launch on the card, its plain version on the CPU)."""
        return crc32c_many([data], self.device)[0]

    def _key(self, chain_pos: int, idx: int) -> Tuple[int, int, int]:
        return (self.chains[chain_pos], FILE_ID_BASE + chain_pos, idx)

    def _payload(self) -> bytes:
        self.tag += 1
        return f"w{self.tag:06d}".encode().ljust(PAYLOAD_LEN, b".")

    def _workload_op(self, report: RunReport) -> None:
        from tpu3fs_torch.storage.types import ChunkId
        from tpu3fs_torch.tenant import tenant_scope

        do_write = self.rng.random() < 0.6
        pos = self.rng.randrange(len(self.chains))
        idx = self.rng.randrange(NUM_CHUNKS)
        chain, fid, _ = self._key(pos, idx)
        key = (chain, fid, idx)
        client = self.clients[self.rng.randrange(len(self.clients))]
        tenant = f"t{self.rng.randrange(2)}"
        with tenant_scope(tenant):
            if do_write:
                data = self._payload()
                crc = self._crc(data)
                self.sent.setdefault(key, set()).add(crc)
                self.writes_issued[key] = self.writes_issued.get(key, 0) + 1
                report.writes += 1
                try:
                    if self.is_ec and self.schedule.spec.ec_chain_encode:
                        # the batched entry is the one that plans the
                        # chain-encode relay (lever scoped by run())
                        rep = client.write_stripes(
                            chain, [(ChunkId(fid, idx), data)],
                            chunk_size=1 << 16)[0]
                    elif self.is_ec:
                        rep = client.write_stripe(
                            chain, ChunkId(fid, idx), data,
                            chunk_size=1 << 16)
                    else:
                        rep = client.write_chunk(
                            chain, ChunkId(fid, idx), 0, data,
                            chunk_size=PAYLOAD_LEN)
                    ok = rep.ok
                except Exception:
                    ok = False
                if ok:
                    report.acked += 1
                    self.oracle[key] = {crc}
                else:
                    # unknown outcome: the write may have landed anywhere
                    # down the chain — admissible until superseded. For a
                    # chunk with NO acked write yet, absence is admissible
                    # too (None sentinel): a failed create may have landed
                    # nothing at all
                    self.oracle.setdefault(key, {None}).add(crc)
            else:
                report.reads += 1
                try:
                    if self.is_ec:
                        rep = client.read_stripe(
                            chain, ChunkId(fid, idx), 0, PAYLOAD_LEN,
                            chunk_size=1 << 16)
                    else:
                        rep = client.read_chunk(chain, ChunkId(fid, idx))
                    ok, data = rep.ok, rep.data
                except Exception:
                    ok = False
                if ok and key in self.sent and len(data) == PAYLOAD_LEN:
                    if self._crc(bytes(data)) not in self.sent[key]:
                        self._live_violations.append(Violation(
                            "crc_oracle",
                            f"mid-run read of {key} returned bytes no "
                            f"client ever wrote (torn read)"))

    # -- training sidecar (ckpt + dataload checkers in the SEARCH) ------------
    def _train_setup(self) -> None:
        """A miniature training tenant riding the chaos run: a packed
        dataset, a live DataLoader, and mid-run ckpt saves that compose
        the loader cursor — so ``ckpt_atomicity`` and
        ``dataload_resume`` judge every search run, not just the soak.
        All sizes tiny (ms per run); everything derives from the
        schedule seed, keeping replays byte-deterministic."""
        import numpy as np

        from tpu3fs_torch.ckpt import CheckpointManager
        from tpu3fs_torch.dataload import (
            DataLoader,
            LoaderConfig,
            PackedDataset,
            pack_records,
        )

        meta, fio = self.fab.meta, self.fab.file_client()
        meta.mkdirs("/chaos", recursive=True)
        rng = np.random.default_rng(self.schedule.seed ^ 0x7EA1)
        recs = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(24)]
        pack_records(meta, fio, "/chaos/train.rec", recs)
        ds = PackedDataset(meta, fio, ["/chaos/train.rec"])
        cfg = dict(global_batch=4, seed=7, depth=1, workers=1, epochs=1)
        # reference pass BEFORE any event fires: the exact sequence a
        # resumed run must continue
        with DataLoader(ds, LoaderConfig(**cfg)) as ref:
            expected = [list(map(int, b.ids)) for b in ref]
        self._train = {
            "mgr": CheckpointManager(meta, fio, root="/chaos/ckpt",
                                     client_id="chaos-ckpt"),
            "ds": ds, "cfg": cfg, "expected": expected,
            "loader": DataLoader(ds, LoaderConfig(**cfg)),
            "consumed": 0, "acked": [], "saved_consumed": {},
        }
        self._train["it"] = iter(self._train["loader"])

    def _train_tick(self, step: int) -> None:
        """At two deterministic step marks: consume one batch, then save
        a ckpt composing the loader cursor. Failures mid-chaos are
        weather — an UNACKED save carries no atomicity obligation."""
        tr = self._train
        if tr is None:
            return
        steps = self.schedule.spec.steps
        if step not in {max(1, steps // 3), max(2, (2 * steps) // 3)}:
            return
        import numpy as np

        try:
            next(tr["it"])
            tr["consumed"] += 1
        except StopIteration:
            pass
        except Exception:
            return  # fetch failed under the fault plane: skip this mark
        st = tr["loader"].state()
        tree = {"w": np.full((8, 8), float(step), dtype=np.float32),
                "dl": st.to_leaf()}
        try:
            tr["mgr"].save(tree, step)
        except Exception:
            return  # unacked: the checker only judges acked saves
        tr["acked"].append(step)
        tr["saved_consumed"][step] = tr["consumed"]

    def _train_list_raw(self):
        try:
            return [e.name for e in self.fab.meta.list_dir("/chaos/ckpt")]
        except Exception:
            return []

    def _train_resume_replay(self):
        """Restore the newest acked ckpt's cursor into a FRESH loader
        and hand (expected remaining, resumed) to the checker."""
        from tpu3fs_torch.dataload import DataLoader, DataloadState, LoaderConfig

        tr = self._train
        mgr = tr["mgr"]
        acked_visible = [s for s in tr["acked"] if s in mgr.steps()]
        if not acked_visible:
            return [], []  # chaos prevented every save: nothing to judge
        s = max(acked_visible)
        tree = mgr.restore(s)
        st = DataloadState.from_leaf(tree["dl"])
        with DataLoader(tr["ds"], LoaderConfig(**tr["cfg"]),
                        state=st) as lo:
            resumed = [list(map(int, b.ids)) for b in lo]
        return tr["expected"][tr["saved_consumed"][s]:], resumed

    # -- serving sidecar (kvcache_stale checker in the SEARCH) ----------------
    def _serving_setup(self) -> None:
        """Two fleet KVCache 'processes' riding the chaos run over a
        loopback peer transport, with an out-of-band GC racing their
        peer fills — the serve-through staleness hazard, deterministic:
        peer A writes + warms its cached inode, A's host tier is
        evicted, the GC removes the entry, then B's miss peer-fills
        from A. The correct path detects the zero-hole and re-probes
        (B sees a miss); the planted ``peer_fill_stale`` bug ships the
        hole as KV bytes and the ``kvcache_stale`` checker fires."""
        from tpu3fs_torch.client.hedging import HedgeController
        from tpu3fs_torch.kvcache.cache import KVCacheClient
        from tpu3fs_torch.mgmtd.types import ServingEndpoint
        from tpu3fs_torch.serving.fleet import FleetKVCache
        from tpu3fs_torch.serving.service import ServingHost

        root = "/chaos/kv"
        node_ids = (101, 102)
        endpoints = {nid: ServingEndpoint(node_id=nid)
                     for nid in node_ids}

        class _Routing:
            serving = endpoints

        peers = _LoopbackPeers()
        fleets = {}
        for nid in node_ids:
            kv = KVCacheClient(
                self.fab.meta, self.fab.file_client(), root=root,
                client_id=f"chaos-serve-{nid}", inode_cache=64)
            fleet = FleetKVCache(
                kv, node_id=nid, routing=_Routing, peer_client=peers,
                hedge=HedgeController(), capacity_bytes=1 << 20,
                write_through=True)
            peers.hosts[nid] = ServingHost(fleet, nid,
                                           claims=fleet.claims)
            fleets[nid] = fleet
        # the GC analog: a SEPARATE client (its own inode cache), so
        # removing an entry leaves A's cached inode stale — the race
        gc_kv = KVCacheClient(self.fab.meta, self.fab.file_client(),
                              root=root, client_id="chaos-serve-gc")
        self._serving = {"fleets": fleets, "gc": gc_kv,
                         "reads": [], "n": 0}

    def _serving_tick(self, step: int) -> None:
        """Every other step: one full put -> evict -> GC -> peer-fill
        round. Failures mid-chaos are weather (the fault plane may be
        chewing the very RPCs the sidecar rides) — only a COMPLETED get
        is recorded for the checker."""
        sv = self._serving
        if sv is None or step % 2 == 0:
            return
        from tpu3fs_torch.utils.result import FsError

        sv["n"] += 1
        key = f"srv-{self.schedule.seed & 0xFFFF:04x}-{sv['n']:03d}"
        payload = f"kv{sv['n']:06d}".encode().ljust(64, b"#")
        a, b = sv["fleets"][101], sv["fleets"][102]
        try:
            a.put(key, payload)       # write-through + warms A's inode
        except (FsError, ConnectionError):
            return
        admissible = {self._crc(payload)}
        a.tier.clear()                # host-tier capacity eviction
        sv["gc"].remove(key)          # the GC wins the race...
        try:
            self.fab.run_gc()         # ...and reclaims the chunks: A's
        except (FsError, ConnectionError):  # cached inode now reads a
            return                    # zero hole
        try:
            got = b.get(key)          # miss -> peer fill from A
        except (FsError, ConnectionError):
            return
        sv["reads"].append((key, admissible, got))

    # -- metashard sidecar (meta_intents checker in the SEARCH) ---------------
    def _metashard_setup(self) -> None:
        """A ShardedMetaStore riding the chaos run: every step creates a
        file in one partition and two-phase renames it into another, so
        the schedule's ``meta.twophase`` fault rules crash the
        coordinator at real phase boundaries. A crashed rename gets its
        src name legitimately recycled (remove + fresh create), then the
        resolver runs while the plane is STILL ARMED — exactly the
        window the planted ``rename_orphan_intent`` bug needs to clear
        the recreated name. The ``meta_intents`` checker audits the
        acked namespace after quiesce. Private in-memory KV; the only
        nondeterminism (txn ids, timestamps) never reaches a verdict."""
        from tpu3fs_torch.kv.mem import MemKVEngine
        from tpu3fs_torch.meta.store import ROOT_USER, ChainAllocator
        from tpu3fs_torch.metashard.store import ShardedMetaStore

        store = ShardedMetaStore(
            MemKVEngine(), ChainAllocator(1, [901, 902]), nparts=4)
        # two parent dirs on DIFFERENT partitions, so every rename
        # between them crosses partitions (pure hash of the dir path —
        # the probe loop is deterministic)
        src_dir = "/ms/src"
        base = store.pid_of_dir(src_dir)
        dst_dir = next(f"/ms/dst{i}" for i in range(64)
                       if store.pid_of_dir(f"/ms/dst{i}") != base)
        store.mkdirs(src_dir, recursive=True)
        store.mkdirs(dst_dir, recursive=True)
        self._meta = {"store": store, "user": ROOT_USER,
                      "src": src_dir, "dst": dst_dir,
                      "expected": {}, "n": 0}

    def _metashard_tick(self, step: int) -> None:
        """One create -> cross-partition rename per step. A rename the
        fault plane crashed mid-protocol drops its inode from the
        expected map (the resolver decides its resting place) and its
        src name is recycled with a NEW file; the forced resolver pass
        then races that recycle."""
        ms = self._meta
        if ms is None:
            return
        from tpu3fs_torch.utils.result import FsError

        st, user = ms["store"], ms["user"]
        ms["n"] += 1
        n = ms["n"]
        src = f"{ms['src']}/f{n:03d}"
        dst = f"{ms['dst']}/g{n:03d}"
        try:
            ino = st.create(src, user).inode.id
        except (FsError, ConnectionError):
            return
        ms["expected"][src] = ino
        try:
            st.rename(src, dst, user)
        except (FsError, ConnectionError):
            ms["expected"].pop(src, None)
            try:
                st.remove(src, user)
            except (FsError, ConnectionError):
                pass
            try:
                ms["expected"][src] = st.create(src, user).inode.id
            except (FsError, ConnectionError):
                pass
        else:
            del ms["expected"][src]
            ms["expected"][dst] = ino
        # force: a crashed coordinator's intents have no live driver
        # here, and waiting out deadlines would stall the schedule
        try:
            st.resolve_intents(force=True)
        except (FsError, ConnectionError):
            pass

    def _metashard_audit(self):
        """The checker's input, computed AFTER quiesce: one honest
        resolver pass (plane cleared — planted bugs can't fire), then
        record count + a stat of every acked namespace entry."""
        from tpu3fs_torch.metashard.twophase import list_intents, list_prepares
        from tpu3fs_torch.utils.result import FsError

        ms = self._meta
        st, user = ms["store"], ms["user"]
        st.resolve_intents(force=True)
        dangling = (len(list_intents(st.engine))
                    + len(list_prepares(st.engine)))
        actual = {}
        for path in ms["expected"]:
            try:
                actual[path] = st.stat(path, user).id
            except FsError:
                actual[path] = None
        return {"expected": dict(ms["expected"]), "actual": actual,
                "dangling": dangling}

    # -- native-write sidecar (replica_crc checker in the SEARCH) -------------
    _NATIVE_CHAIN = 730_001

    def _native_setup(self) -> None:
        """A REAL 2-node native-socket chain beside the fabric: the C++
        head write path (fp_try_head_write) never runs in-fabric — the
        fabric messenger is direct-call, no sockets — so exercising the
        planted ``native_commit_skip_crc`` bug needs its own cluster.
        Every other step the sidecar manufactures the state an in-flight
        corruption leaves (both replicas committed, DIFFERENT bytes) and
        pushes a partial-offset write through the native head: with the
        cross-check intact the write is REFUSED; with the bug armed the
        head acks OK over divergent replicas and ``replica_crc`` fires.
        Setup failures (no libtpu3fs_rpc.so / native engine) leave the
        sidecar off and the checker SKIPPED — never a false verdict."""
        import tempfile

        try:
            from tpu3fs_torch.client.storage_client import (
                RetryOptions,
                StorageClient,
            )
            from tpu3fs_torch.kv.mem import MemKVEngine
            from tpu3fs_torch.mgmtd.service import Mgmtd
            from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType
            from tpu3fs_torch.rpc.native_net import NativeRpcClient, NativeRpcServer
            from tpu3fs_torch.rpc.services import (
                MgmtdRpcClient,
                RpcMessenger,
                bind_mgmtd_service,
                bind_storage_service,
            )
            from tpu3fs_torch.storage.craq import StorageService
            from tpu3fs_torch.storage.target import StorageTarget

            tmp = tempfile.mkdtemp(prefix="tpu3fs-chaos-native-")
            nat = {"tmp": tmp, "records": [], "n": 0, "nodes": {},
                   "servers": [], "chunk": 1 << 12}
            mgmtd = Mgmtd(1, MemKVEngine())
            mgmtd.extend_lease()
            mgmtd_server = NativeRpcServer()
            bind_mgmtd_service(mgmtd_server, mgmtd)
            mgmtd_server.start()
            nat["servers"].append(mgmtd_server)
            client = NativeRpcClient()
            nat["client"] = client
            mcli = MgmtdRpcClient(mgmtd_server.address, client)
            for node_id, tid in ((210, 7300), (211, 7301)):
                svc = StorageService(node_id, mcli.refresh_routing,
                                     device=self.device)
                svc.set_messenger(RpcMessenger(mcli.refresh_routing, client))
                target = StorageTarget(
                    tid, self._NATIVE_CHAIN, engine="native",
                    path=os.path.join(tmp, f"t{tid}"),
                    chunk_size=nat["chunk"], device=self.device)
                svc.add_target(target)
                server = NativeRpcServer()
                bind_storage_service(server, svc)
                server.start()
                nat["servers"].append(server)
                mgmtd.register_node(node_id, NodeType.STORAGE,
                                    host=server.host, port=server.port)
                mgmtd.create_target(tid, node_id=node_id)
                nat["nodes"][node_id] = {"svc": svc, "server": server,
                                         "target": target}
            mgmtd.upload_chain(self._NATIVE_CHAIN, [7300, 7301])
            mgmtd.upload_chain_table(1, [self._NATIVE_CHAIN])
            for node_id, tid in ((210, 7300), (211, 7301)):
                mgmtd.heartbeat(node_id, 1,
                                {tid: LocalTargetState.UPTODATE})
            nat["sc"] = StorageClient(
                "chaos-native", mcli.refresh_routing,
                RpcMessenger(mcli.refresh_routing, client),
                retry=RetryOptions(max_retries=0, backoff_base_s=0.001),
                device=self.device)
            head = nat["nodes"][210]
            if getattr(head["server"], "fastpath_sync_head", None) is None:
                raise RuntimeError("no head write fast path in this .so")
            self._native = nat
        except Exception:
            # half-built cluster: tear down whatever started, then run
            # without the sidecar (replica_crc reports SKIPPED)
            self._native = locals().get("nat")
            self._native_cleanup()
            self._native = None

    def _native_tick(self, step: int) -> None:
        """Every other step: re-sync the registries (this pushes the
        plane/bug arm state into the .so — exactly what the production
        target scan does), then one baseline chain write, manufactured
        divergence, and a partial-offset probe write through the native
        head. Only COMPLETED probes are recorded for the checker."""
        nat = self._native
        if nat is None or step % 2 == 0:
            return
        from tpu3fs_torch.storage.native_fastpath import sync_read_fastpath
        from tpu3fs_torch.storage.types import ChunkId
        from tpu3fs_torch.utils.result import FsError

        for n in nat["nodes"].values():
            sync_read_fastpath(n["server"], n["svc"])
        nat["n"] += 1
        k = nat["n"]
        cid = ChunkId(50, k)
        sc = nat["sc"]
        chunk = nat["chunk"]
        try:
            if not sc.write_chunk(self._NATIVE_CHAIN, cid, 0,
                                  bytes([k & 0xFF]) * 1024,
                                  chunk_size=chunk).ok:
                return
        except (FsError, ConnectionError):
            return
        # manufactured divergence BELOW the chain: both replicas
        # committed at the next version with different bytes (there is
        # no corruption fault kind — this is the state one leaves)
        try:
            chain_ver = nat["sc"]._chain(self._NATIVE_CHAIN).chain_version
            for node_id, fill in ((210, b"H"), (211, b"T")):
                eng = nat["nodes"][node_id]["target"].engine
                eng.update(cid, 2, chain_ver, fill * 1024, 0,
                           chunk_size=chunk)
                eng.commit(cid, 2, chain_ver)
        except (FsError, ConnectionError):
            return
        try:
            rep = sc.write_chunk(self._NATIVE_CHAIN, cid, 100, b"x" * 50,
                                 chunk_size=chunk)
        except (FsError, ConnectionError):
            return
        try:
            hm = nat["nodes"][210]["target"].engine.get_meta(cid)
            sm = nat["nodes"][211]["target"].engine.get_meta(cid)
        except (FsError, ConnectionError):
            return
        nat["records"].append((
            f"probe-{k}", bool(rep.ok),
            (hm.committed_ver, hm.checksum.value),
            (sm.committed_ver, sm.checksum.value)))

    def _native_cleanup(self) -> None:
        import shutil

        nat = self._native
        if nat is None:
            return
        for n in nat.get("nodes", {}).values():
            try:
                n["server"].stop()
                n["svc"].stop_workers()
            except Exception:
                pass
        try:
            if nat.get("client") is not None:
                nat["client"].close()
        except Exception:
            pass
        try:
            if nat.get("servers"):
                nat["servers"][0].stop()  # mgmtd
        except Exception:
            pass
        shutil.rmtree(nat["tmp"], ignore_errors=True)

    # -- quiesce + verdict ----------------------------------------------------
    def _quiesce(self) -> None:
        from tpu3fs_torch.placement.rebalance import DRAINING_TAG
        from tpu3fs_torch.utils.result import FsError

        plane().clear()
        if self._partition_heal is not None:
            self._heal_partition()
        for node in self.fab.nodes.values():
            if not node.alive:
                self.fab.restart_node(node.node_id)
        # settle any migrations the schedule kicked off, then clear drains
        for _ in range(60):
            try:
                jobs = self.fab.mgmtd.migration_list()
            except FsError:
                break
            if not any(j.active for j in jobs):
                break
            self._background_tick()
        routing = self.fab.routing()
        for node in routing.nodes.values():
            if node.tags.get(DRAINING_TAG):
                self.fab.mgmtd.set_node_tags(node.node_id,
                                             {DRAINING_TAG: ""})
        self.fab.resync_all(rounds=8)

    def _read_chunk(self, chain: int, fid: int, idx: int):
        from tpu3fs_torch.storage.types import ChunkId

        client = self.clients[0]
        try:
            if self.is_ec:
                # the written payload region only: the oracle CRCs cover
                # PAYLOAD_LEN bytes, not the stripe's zero padding
                rep = client.read_stripe(chain, ChunkId(fid, idx), 0,
                                         PAYLOAD_LEN, chunk_size=1 << 16)
            else:
                rep = client.read_chunk(chain, ChunkId(fid, idx))
        except Exception:
            return None
        if not rep.ok:
            return None
        return bytes(rep.data)

    def _context(self) -> ChaosContext:
        train = {}
        if self._train is not None:
            # stop the live loader's fetcher before the verdict reads
            try:
                self._train["loader"].close()
            except Exception:
                pass
            train = dict(
                ckpt_manager=self._train["mgr"],
                ckpt_acked_steps=list(self._train["acked"]),
                ckpt_list_raw=self._train_list_raw,
                resume_replay=self._train_resume_replay,
            )
        return ChaosContext(
            device=self.device,
            read_chunk=self._read_chunk,
            oracle=self.oracle,
            writes_issued=self.writes_issued,
            routing=self.fab.routing,
            dump_chunkmeta=lambda node, tid: self.fab.send(
                node, "dump_chunkmeta", tid),
            serving_reads=(self._serving["reads"]
                           if self._serving is not None else []),
            meta_audit=(self._metashard_audit
                        if self._meta is not None else None),
            native_write_replicas=(self._native["records"]
                                   if self._native is not None else []),
            **train,
        )


class _LoopbackPeers:
    """In-process peer transport for the serving sidecar: the
    ServingPeerClient surface (fleet.py calls it) dispatched straight
    into the other fleet's ServingHost — no sockets, so one seeded
    thread of control and byte-deterministic replays."""

    def __init__(self):
        self.hosts: Dict[int, object] = {}

    def peer_read(self, ep, keys, *, serve_through=True, est_bytes=0,
                  deadline_s=None):  # loopback: nothing ever straggles
        from tpu3fs_torch.serving.service import PeerReadReq

        return self.hosts[ep.node_id].peer_read(PeerReadReq(
            keys=list(keys), serve_through=serve_through))

    def fill_claim(self, ep, key, owner, ttl_ms=2000):
        from tpu3fs_torch.serving.service import FillClaimReq

        return self.hosts[ep.node_id].fill_claim(FillClaimReq(
            key=key, owner=owner, ttl_ms=ttl_ms))

    def fill_release(self, ep, key, owner):
        from tpu3fs_torch.serving.service import FillReleaseReq

        return self.hosts[ep.node_id].fill_release(FillReleaseReq(
            key=key, owner=owner))

    def close(self) -> None:
        self.hosts.clear()


# -- search + shrink ----------------------------------------------------------

def run_schedule(schedule: Schedule, **kw) -> RunReport:
    return FabricRunner(schedule, **kw).run()


def search_violations(
    spec: Optional[ScheduleSpec] = None,
    *,
    base_seed: int = 0,
    max_seeds: int = 32,
    **kw,
) -> Tuple[Optional[RunReport], int]:
    """Run schedules for seeds base_seed..base_seed+max_seeds-1; return
    (first violating report, seeds tried). (None, max_seeds) = clean."""
    spec = spec or ScheduleSpec()
    for i in range(max_seeds):
        seed = base_seed + i
        report = run_schedule(generate_schedule(seed, spec), **kw)
        if report.violated:
            return report, i + 1
    return None, max_seeds


def shrink_schedule(schedule: Schedule, **kw) -> Tuple[Schedule, int]:
    """-> (minimal violating prefix, replays spent). Linear scan from
    the empty prefix up: the first k whose prefix violates IS minimal
    (replays are deterministic). The input must violate; the full
    schedule is the fallback."""
    replays = 0
    for k in range(len(schedule.events) + 1):
        candidate = schedule.prefix(k)
        replays += 1
        if run_schedule(candidate, **kw).violated:
            return candidate, replays
    return schedule, replays


# -- the regression corpus ----------------------------------------------------

def corpus_dir(root: Optional[str] = None) -> str:
    if root:
        return root
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "tests", "chaos_seeds")


def save_seed(name: str, schedule: Schedule, *,
              bug: str = "", expect: Optional[List[str]] = None,
              note: str = "", root: Optional[str] = None) -> str:
    """Write one corpus entry; returns its path. ``bug`` names a
    chaos/bugs.py planted bug the replayer arms first (empty = the
    schedule violates on the CURRENT tree — which should never ship);
    ``expect`` lists the checkers that must fire with the bug armed."""
    obj = {
        "version": CORPUS_VERSION,
        "bug": bug,
        "expect": sorted(expect or []),
        "note": note,
        "schedule": json.loads(schedule.to_json()),
    }
    d = corpus_dir(root)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True, indent=1)
        f.write("\n")
    return path


def load_corpus(root: Optional[str] = None) -> List[str]:
    d = corpus_dir(root)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.endswith(".json"))


def replay_seed(path: str, *, with_bug: bool = True,
                **kw) -> Tuple[RunReport, Dict]:
    """Replay one corpus entry. with_bug=True arms the entry's planted
    bug (proving the checkers still catch it); with_bug=False replays
    on the current tree (proving the once-violating schedule now runs
    green — the regression direction tier-1 cares about)."""
    with open(path) as f:
        obj = json.load(f)
    if obj.get("version") != CORPUS_VERSION:
        raise ValueError(f"{path}: unsupported corpus version")
    schedule = Schedule.from_json(json.dumps(obj["schedule"]))
    bug = obj.get("bug", "")
    try:
        if bug and with_bug:
            bugs.arm(bug)
        report = run_schedule(schedule, **kw)
    finally:
        if bug and with_bug:
            bugs.disarm(bug)
    return report, obj
