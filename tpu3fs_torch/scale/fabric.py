"""The thousand-node day: a scale fabric for the CONTROL plane.

The chaos fabric (tpu3fs/fabric) boots real StorageServices — engines,
targets, QoS — which tops out around tens of nodes per process. This
module instantiates THOUSANDS of lightweight nodes (an id, a failure
domain, a heartbeat counter, a set of target local-states) against the
REAL management plane: the same ``Mgmtd`` over the same MVCC KV, the
same placement solver, the same rebalance planner, the same chain state
machine. What is judged is therefore exactly what a thousand-node
deployment exercises per heartbeat interval — heartbeat fan-in, routing
fan-out, chain-update sweeps, rebalance planning — with invariants
(every chain keeps quorum through a whole-domain kill) instead of
wall-clock IO as the verdict (docs/scale.md).

Failure domains: every node carries a ``domain`` tag (mgmtd node tags,
the same channel the rebalance planner reads) and the chain table is
laid by ``solve_placement`` under ``max_per_domain`` — width-1 for CR,
ec_m for EC — so killing an entire domain can never cost any chain its
quorum BY CONSTRUCTION. ``domain_aware=False`` lays the same table
blind: the A/B that shows the constraint is what buys survival.

The port's own copy of ``tpu3fs/scale/fabric.py``. ``ScaleFabric(cfg,
device)`` lays the table with the port's ``solve_placement`` on
``device`` (the card unless the caller names another), the same table
byte for byte as the JAX package's for one seed; with ``solver_steps=0``
(the default) the greedy start is the table and no proposal is scored.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.fabric.fabric import FabricClock
from tpu3fs_torch.kv.mem import MemKVEngine
from tpu3fs_torch.mgmtd.service import Mgmtd, MgmtdConfig
from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType, PublicTargetState
from tpu3fs_torch.monitor.recorder import DistributionRecorder, ValueRecorder
from tpu3fs_torch.placement.solver import PlacementProblem, solve_placement
from tpu3fs_torch.rpc.serde import serialize
from tpu3fs_torch.rpc.services import RoutingRsp

# -- recorders (single declaration site; docs/observability.md) --------------
_rec_hb_round = DistributionRecorder("scale.heartbeat_round_s")
_rec_nodes = ValueRecorder("scale.nodes")


@dataclass
class ScaleConfig:
    num_nodes: int = 100
    num_domains: int = 5
    group_size: int = 3            # CR width, or EC k+m
    targets_per_node: int = 3      # r: num_chains = N*r / group_size
    ec_k: int = 0
    ec_m: int = 0
    heartbeat_timeout_s: float = 60.0
    # failure-domain-aware placement (the A/B lever: False lays the same
    # table domain-blind; nodes stay tagged either way so the
    # domain_quorum checker can tell the two apart)
    domain_aware: bool = True
    solver_steps: int = 0          # greedy interleave usually suffices
    # META role nodes for the partition-table churn properties
    meta_nodes: int = 0
    meta_partitions: int = 0

    def __post_init__(self):
        if self.num_nodes < self.group_size:
            raise ValueError("fewer nodes than a single group")
        if (self.num_nodes * self.targets_per_node) % self.group_size:
            raise ValueError("N*r must divide by group_size")

    @property
    def num_chains(self) -> int:
        return self.num_nodes * self.targets_per_node // self.group_size

    @property
    def domain_cap(self) -> int:
        """Members of one chain a single domain may hold: the loss a
        whole-domain kill must fit inside."""
        if self.ec_k:
            return max(self.ec_m, 1)
        return max(self.group_size - 1, 1)


@dataclass
class ScaleNode:
    """A node reduced to its control-plane footprint."""
    node_id: int
    domain: str
    hb_version: int = 1
    alive: bool = True
    # target_id -> local state the node would report (real nodes derive
    # this from engines; here it IS the node's state)
    local_states: Dict[int, LocalTargetState] = field(default_factory=dict)


class ScaleFabric:
    MGMTD_NODE_ID = 1
    FIRST_NODE_ID = 10
    FIRST_META_NODE_ID = 5000
    FIRST_TARGET_ID = 10_000
    FIRST_CHAIN_ID = 900_001

    def __init__(self, cfg: Optional[ScaleConfig] = None, device=None):
        self.cfg = cfg or ScaleConfig()
        self.device = resolve_device(device)
        self.clock = FabricClock()
        self.kv = MemKVEngine()
        self.mgmtd = Mgmtd(
            self.MGMTD_NODE_ID, self.kv,
            MgmtdConfig(heartbeat_timeout_s=self.cfg.heartbeat_timeout_s,
                        meta_partitions=self.cfg.meta_partitions),
            clock=self.clock)
        self.mgmtd.extend_lease()
        self.nodes: Dict[int, ScaleNode] = {}
        self.meta_nodes: Dict[int, ScaleNode] = {}
        self.meta_node_ids: List[int] = []
        self.chain_ids: List[int] = []
        self.boot_s = self._boot()
        _rec_nodes.set(len(self.nodes))

    # -- boot ----------------------------------------------------------------
    def _boot(self) -> float:
        cfg = self.cfg
        t0 = time.perf_counter()
        # domains are CONTIGUOUS id blocks, like racks in a machine-room
        # row — the hostile layout for naive consecutive placement (a
        # round-robin labeling would make any layout accidentally safe)
        domains = [f"d{i * cfg.num_domains // cfg.num_nodes}"
                   for i in range(cfg.num_nodes)]
        for i in range(cfg.num_nodes):
            nid = self.FIRST_NODE_ID + i
            self.mgmtd.register_node(nid, NodeType.STORAGE)
            self.mgmtd.set_node_tags(nid, {"domain": domains[i]})
            self.nodes[nid] = ScaleNode(nid, domains[i])
        for j in range(cfg.meta_nodes):
            nid = self.FIRST_META_NODE_ID + j
            self.mgmtd.register_node(nid, NodeType.META)
            self.meta_node_ids.append(nid)
            self.meta_nodes[nid] = ScaleNode(nid, domain="meta")
        problem = PlacementProblem(
            num_nodes=cfg.num_nodes,
            group_size=cfg.group_size,
            targets_per_node=cfg.targets_per_node,
            chain_table_type="EC" if cfg.ec_k else "CR",
            domains=domains if cfg.domain_aware else None,
            max_per_domain=cfg.domain_cap if cfg.domain_aware else None)
        self.incidence = solve_placement(problem, steps=cfg.solver_steps,
                                         device=self.device)
        node_ids = sorted(self.nodes)
        tid = self.FIRST_TARGET_ID
        for g in range(len(self.incidence)):
            chain_id = self.FIRST_CHAIN_ID + g
            members = np.nonzero(self.incidence[g])[0]
            target_ids = []
            for m in members:
                nid = node_ids[int(m)]
                self.mgmtd.create_target(tid, node_id=nid)
                self.nodes[nid].local_states[tid] = LocalTargetState.UPTODATE
                target_ids.append(tid)
                tid += 1
            self.mgmtd.upload_chain(chain_id, target_ids,
                                    ec_k=cfg.ec_k, ec_m=cfg.ec_m)
            self.chain_ids.append(chain_id)
        self.mgmtd.upload_chain_table(1, self.chain_ids)
        self.heartbeat_round()
        self.mgmtd.tick()
        return time.perf_counter() - t0

    # -- heartbeat fan-in ----------------------------------------------------
    def heartbeat_round(self) -> List[float]:
        """One full fan-in: every alive node heartbeats once (storage
        nodes report their target local-states, META nodes just beat).
        Returns the per-heartbeat wall latencies; the round total lands
        on ``scale.heartbeat_round_s``."""
        lat: List[float] = []
        t0 = time.perf_counter()
        for node in self.nodes.values():
            if not node.alive:
                continue
            node.hb_version += 1
            t1 = time.perf_counter()
            self.mgmtd.heartbeat(node.node_id, node.hb_version,
                                 node.local_states)
            lat.append(time.perf_counter() - t1)
        for node in self.meta_nodes.values():
            if not node.alive:
                continue
            node.hb_version += 1
            self.mgmtd.heartbeat(node.node_id, node.hb_version, None)
        _rec_hb_round.record(time.perf_counter() - t0)
        return lat

    def tick(self) -> None:
        self.mgmtd.tick()

    # -- routing fan-out -----------------------------------------------------
    def routing_fanout(self, *, up_to_date: bool) -> Tuple[int, float]:
        """One full config/routing push cycle: every alive node polls
        ``getRoutingInfo`` and the reply is SERIALIZED (the fan-out cost
        a real wire pays). ``up_to_date=True`` measures the version-gated
        fast path — every poller already at the current version gets the
        tiny ``changed=False`` reply; ``False`` forces the full snapshot
        re-serialization per poller. Returns (total reply bytes, total
        seconds) across the fleet."""
        version = self.mgmtd.get_routing_info(-1).version
        total = 0
        t0 = time.perf_counter()
        for node in self.nodes.values():
            if not node.alive:
                continue
            known = version if up_to_date else -1
            ri = self.mgmtd.get_routing_info(known)
            payload = serialize(RoutingRsp(changed=ri is not None,
                                           routing=ri))
            total += len(payload)
        return total, time.perf_counter() - t0

    # -- failure-domain machinery --------------------------------------------
    def domain_nodes(self, domain: str) -> List[int]:
        return sorted(n.node_id for n in self.nodes.values()
                      if n.domain == domain)

    def kill_domain(self, domain: str) -> List[int]:
        """Silence EVERY node of a domain at once, run the detection
        cycle (clock past the heartbeat timeout, survivors beat, chain
        updater sweeps). Returns the killed node ids."""
        killed = self.domain_nodes(domain)
        for nid in killed:
            self.nodes[nid].alive = False
        self.clock.advance(self.cfg.heartbeat_timeout_s + 1)
        self.heartbeat_round()
        self.mgmtd.tick()
        return killed

    def restart_domain(self, domain: str) -> None:
        for nid in self.domain_nodes(domain):
            node = self.nodes[nid]
            node.alive = True
            # a restarted node reports ONLINE until resynced — the chain
            # state machine readmits it through WAITING -> SYNCING
            for tid in node.local_states:
                node.local_states[tid] = LocalTargetState.ONLINE
        self.heartbeat_round()
        self.mgmtd.tick()

    def complete_resync(self, domain: str) -> None:
        """Model the data plane finishing sync for a restarted domain:
        its nodes report UPTODATE again and the chain updater readmits
        them to SERVING (the scale fabric has no chunks to copy — the
        real fabric's resync workers are exercised in tests/test_fabric
        and the chaos runs)."""
        for nid in self.domain_nodes(domain):
            node = self.nodes[nid]
            for tid in node.local_states:
                node.local_states[tid] = LocalTargetState.UPTODATE
        self.heartbeat_round()
        self.mgmtd.tick()
        # WAITING -> SYNCING -> SERVING takes two updater sweeps
        self.heartbeat_round()
        self.mgmtd.tick()

    def quorum_report(self) -> Dict[str, int]:
        """Chains still holding a usable write quorum vs broken ones:
        CR needs >= 1 SERVING member, EC needs >= k."""
        routing = self.mgmtd.get_routing_info(-1)
        need = self.cfg.ec_k if self.cfg.ec_k else 1
        ok = broken = 0
        for cid in self.chain_ids:
            chain = routing.chains[cid]
            serving = sum(1 for t in chain.targets
                          if t.public_state == PublicTargetState.SERVING)
            if serving >= need:
                ok += 1
            else:
                broken += 1
        return {"ok": ok, "broken": broken}

    def domain_violations(self) -> List[str]:
        """Chains whose membership over-concentrates in one domain
        (the domain_quorum invariant, judged from live routing)."""
        routing = self.mgmtd.get_routing_info(-1)
        doms = {nid: n.tags.get("domain")
                for nid, n in routing.nodes.items() if n.tags.get("domain")}
        cap = self.cfg.domain_cap
        bad: List[str] = []
        for cid in self.chain_ids:
            chain = routing.chains[cid]
            counts: Dict[str, int] = {}
            for t in chain.targets:
                info = routing.targets.get(t.target_id)
                d = doms.get(info.node_id) if info else None
                if d:
                    counts[d] = counts.get(d, 0) + 1
            for d, n in sorted(counts.items()):
                if n > cap:
                    bad.append(f"chain {cid}: {n} members in {d} "
                               f"(cap {cap})")
        return bad

    # -- churn + memory gauges ----------------------------------------------
    def kill_meta_node(self, nid: int) -> None:
        """META churn drives the partition-table assigner: silence the
        node and run detection so update_meta_partitions reassigns its
        rows to the least-loaded survivors."""
        self.meta_nodes[nid].alive = False
        self.clock.advance(self.cfg.heartbeat_timeout_s + 1)
        self.heartbeat_round()
        self.mgmtd.tick()

    def restart_meta_node(self, nid: int) -> None:
        self.meta_nodes[nid].alive = True
        self.heartbeat_round()
        self.mgmtd.tick()

    def meta_assignment(self) -> Dict[int, Tuple[int, int]]:
        """partition_id -> (owner node, epoch) from live routing."""
        routing = self.mgmtd.get_routing_info(-1)
        return {pid: (row.node_id, row.epoch)
                for pid, row in routing.meta_partitions.items()}

    def kv_footprint(self) -> Dict[str, int]:
        """MVCC store gauges for the bounded-memory property: keys and
        total history entries (the pruner must keep both bounded under
        sustained heartbeat traffic)."""
        with self.kv._lock:
            return {
                "keys": len(self.kv._data),
                "history": sum(len(h) for h in self.kv._data.values()),
            }
