"""Chaos schedules: seeded, recorded, exactly-replayable event timelines.

The port's own copy of ``tpu3fs/chaos/schedule.py``, unchanged but for
its imports: ``generate_schedule`` draws the same JSON byte for byte, so
both packages replay one corpus (``tests/chaos_seeds/``).

A ``Schedule`` is the ONE artifact both chaos executors consume:

- the in-fabric search runner (``chaos/search.py``) maps events onto a
  single-process ``Fabric`` (plane().configure, kill_node/restart_node,
  planner-submitted migrations, QosConfig hot updates);
- the production-day drive (``drive_production_day.py``, a JAX-package
  script) maps the SAME kinds onto real processes
  (``admin_cli fault set`` pushes, SIGKILL/respawn, ``rebalance --join/
  drain --apply``, ``[tenants]``/``[qos]``/``[slo]`` config pushes).

Determinism contract: ``generate_schedule(seed, spec)`` is a pure
function of its arguments — one ``random.Random(seed)`` draws
everything — and ``Schedule.to_json()`` is canonical (sorted keys,
fixed separators), so the SAME seed produces a BYTE-IDENTICAL recorded
timeline (tested in tests/test_chaos.py). A recorded schedule replays
without its generator: executors read only the event list.

Event kinds (``args`` keys per kind):

====================  =====================================================
``fault_set``          ``spec`` (fault-plane grammar, utils/fault_injection
                       .py), ``seed``, ``node_idx`` (-1 = unscoped; else
                       the executor appends ``,node=<real id>`` to every
                       rule) — arm/replace the cluster fault plane
``fault_clear``        — disarm every rule
``kill``               ``role`` (storage|meta|worker|client), ``idx`` —
                       SIGKILL one process of that role (idx into the
                       executor's role pool, wrapped)
``restart``            ``role``, ``idx`` — restart a previously killed one
``join``               — add a storage node and pull it to fair share via
                       the rebalance planner + migration worker
``drain``              ``idx`` — mark one storage node draining and evacuate
                       it (planner + worker); executors undo at quiesce
``config_push``        ``section`` (qos|tenants|slo), ``spec`` — a mid-
                       flight hot config push (grammar per section)
``partition``          ``a`` (storage idx list), ``b`` (storage idx list,
                       may be empty), ``heal_after`` (steps) — cut every
                       link between side a and side b ∪ {mgmtd}, heal it
                       ``heal_after`` steps later. THE way a schedule
                       expresses a network partition: hard cuts are an
                       explicit, healed, node-set × node-set EVENT, never
                       an unlimited ``drop`` rule (validate() enforces
                       the times-bound on error/drop rules; the guard
                       test in tests/test_chaos_partition.py pins it)
====================  =====================================================

Every point named in a generated ``fault_set`` spec comes from
``FAULT_POINTS`` below; tools/check_fault_points.py statically proves
each resolves to a real injection site of the JAX package, and
tests/test_torch_chaos_schedule.py to one under ``tpu3fs_torch/`` (a
typo'd point injects nothing, silently — the exact failure mode the
check exists for).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu3fs_torch.monitor.recorder import CounterRecorder
from tpu3fs_torch.utils.fault_injection import parse_spec

SCHEDULE_VERSION = 1

KINDS = (
    "fault_set", "fault_clear", "kill", "restart", "join", "drain",
    "config_push", "partition",
)

ROLES = ("storage", "meta", "worker", "client")

#: injection-point prefixes generated fault specs draw from — each must
#: resolve to a real inject()/inject_result()/plane().fire() call site
#: (tools/check_fault_points.py)
FAULT_POINTS = (
    "storage.read",
    "storage.update",
    "storage.write_shard",
    "storage.chain_encode",
    "rpc.dispatch",
    "rpc.send",
    # two-phase meta coordinator phase boundaries (metashard/twophase.py
    # .intent/.prepared/.committed) — the crash matrix docs/metashard.md
    # proves is exactly the surface schedules must be able to hit
    "meta.twophase",
)

#: fault kinds with the arg ranges the generator draws from
_FAULT_KINDS = (
    ("delay_ms", (5, 80)),    # gray straggler
    ("error", (0, 0)),        # flaky peer
    ("drop", (0, 0)),         # half-dead NIC
)

# -- recorders (single declaration site; docs/observability.md) --------------
_rec_events = CounterRecorder("chaos.events")


def record_event_applied(n: int = 1) -> None:
    """Executors count every applied schedule event here."""
    _rec_events.add(n)


@dataclass(frozen=True)
class ChaosEvent:
    step: int            # virtual workload step at which to apply
    kind: str            # one of KINDS
    args: Dict = field(default_factory=dict)

    def to_obj(self) -> Dict:
        return {"step": self.step, "kind": self.kind, "args": self.args}

    @staticmethod
    def from_obj(obj: Dict) -> "ChaosEvent":
        kind = obj["kind"]
        if kind not in KINDS:
            raise ValueError(f"unknown chaos event kind {kind!r}")
        return ChaosEvent(int(obj["step"]), kind, dict(obj.get("args", {})))


@dataclass
class ScheduleSpec:
    """Generator parameters — recorded alongside the events so a corpus
    file documents how it was produced (replay reads only the events)."""

    steps: int = 40                  # virtual workload steps
    events: int = 8                  # events to draw
    storage_nodes: int = 3           # role-pool sizes the generator targets
    meta_nodes: int = 0
    workers: int = 0
    clients: int = 0
    num_chains: int = 2
    num_replicas: int = 2
    ec_k: int = 0                    # >0: EC(k,m) fabric instead of CR
    ec_m: int = 0
    # EC writes ride the pipelined chain encode (TPU3FS_EC_CHAIN_ENCODE
    # scoped around the run) instead of the client-side encode
    ec_chain_encode: bool = False
    # run the training sidecar (mini ckpt saves + dataload cursor) so
    # the ckpt_atomicity / dataload_resume checkers judge the run too
    train_workload: bool = False
    # run the fleet-serving sidecar (two FleetKVCache processes peer-
    # filling over a loopback transport, with an out-of-band GC racing
    # them) so the kvcache_stale checker judges the run too
    kv_serving: bool = False
    # run the metashard sidecar (a ShardedMetaStore doing cross-partition
    # two-phase renames with src-name recycling racing the crash
    # resolver) so the meta_intents checker judges the run too
    meta_shard: bool = False
    # run the native-write sidecar (a REAL 2-node native-socket chain
    # beside the fabric — the C++ head write path never runs in-fabric,
    # the fabric messenger is direct-call) so the replica_crc checker
    # judges the run too
    native_write: bool = False
    allow_kill: bool = True
    allow_elastic: bool = False      # join/drain events (need a worker)
    allow_config_push: bool = True
    # partition events (node-set × node-set cut with mgmtd on side b,
    # healed after ``heal_after`` steps). Opt-in: partitions stretch the
    # fabric clock past the lease fence, which only means something on
    # fabrics running with fencing armed (search.py always does)
    allow_partition: bool = False
    fault_prob_min: float = 0.2
    fault_prob_max: float = 1.0
    max_fault_rules: int = 2

    def to_obj(self) -> Dict:
        return {k: getattr(self, k) for k in sorted(self.__dataclass_fields__)}

    @staticmethod
    def from_obj(obj: Dict) -> "ScheduleSpec":
        spec = ScheduleSpec()
        for k, v in obj.items():
            if k not in spec.__dataclass_fields__:
                raise ValueError(f"unknown ScheduleSpec field {k!r}")
            setattr(spec, k, v)
        return spec


@dataclass
class Schedule:
    seed: int
    spec: ScheduleSpec
    events: List[ChaosEvent] = field(default_factory=list)

    # -- canonical serde (byte-identical for one seed) -----------------------
    def to_json(self) -> str:
        obj = {
            "version": SCHEDULE_VERSION,
            "seed": self.seed,
            "spec": self.spec.to_obj(),
            "events": [e.to_obj() for e in self.events],
        }
        return json.dumps(obj, sort_keys=True, indent=1) + "\n"

    @staticmethod
    def from_json(text: str) -> "Schedule":
        obj = json.loads(text)
        if obj.get("version") != SCHEDULE_VERSION:
            raise ValueError(
                f"unsupported schedule version {obj.get('version')!r}")
        return Schedule(
            seed=int(obj["seed"]),
            spec=ScheduleSpec.from_obj(obj["spec"]),
            events=[ChaosEvent.from_obj(e) for e in obj["events"]],
        )

    def prefix(self, n: int) -> "Schedule":
        """The same schedule truncated to its first ``n`` events — the
        shrinker's only move (a prefix preserves every causal order the
        full timeline established)."""
        return Schedule(self.seed, self.spec, self.events[:n])

    def validate(self) -> None:
        """Raise ValueError on any malformed event (kinds, roles, and
        every fault_set spec must parse under the plane grammar).
        Enforces the partition/drop separation: error and drop rules in
        a fault_set must be times-bounded bursts — an UNLIMITED hard-
        failure rule is a network partition in disguise, and partitions
        are only expressible as the explicit ``partition`` event (which
        carries a heal and drives the lease-fence protocol)."""
        for e in self.events:
            if e.kind not in KINDS:
                raise ValueError(f"unknown event kind {e.kind!r}")
            if e.kind == "fault_set":
                for rule in parse_spec(e.args.get("spec", "")):
                    if rule.kind in ("error", "drop") and rule.times < 0:
                        raise ValueError(
                            f"unlimited {rule.kind} rule on {rule.point!r}: "
                            "a hard cut without a heal is a partition — "
                            "use the explicit partition event")
            if e.kind == "partition":
                a = e.args.get("a")
                b = e.args.get("b", [])
                heal = e.args.get("heal_after")
                if (not isinstance(a, list) or not a
                        or not all(isinstance(i, int) and i >= 0 for i in a)):
                    raise ValueError(
                        f"partition side a must be a non-empty storage idx "
                        f"list, got {a!r}")
                if (not isinstance(b, list)
                        or not all(isinstance(i, int) and i >= 0 for i in b)):
                    raise ValueError(
                        f"partition side b must be a storage idx list, "
                        f"got {b!r}")
                if set(a) & set(b):
                    raise ValueError(
                        f"partition sides overlap: {sorted(set(a) & set(b))}")
                if not isinstance(heal, int) or heal < 1:
                    raise ValueError(
                        f"partition heal_after must be an int >= 1, "
                        f"got {heal!r}")
            if e.kind in ("kill", "restart"):
                if e.args.get("role") not in ROLES:
                    raise ValueError(
                        f"{e.kind} with unknown role {e.args.get('role')!r}")
            if e.kind == "config_push":
                if e.args.get("section") not in ("qos", "tenants", "slo"):
                    raise ValueError(
                        f"config_push of unknown section "
                        f"{e.args.get('section')!r}")


# -- the generator -----------------------------------------------------------

def _gen_fault_spec(rng: random.Random, spec: ScheduleSpec) -> str:
    entries = []
    for _ in range(rng.randint(1, spec.max_fault_rules)):
        point = rng.choice(FAULT_POINTS)
        kind, (lo, hi) = rng.choice(_FAULT_KINDS)
        prob = round(rng.uniform(spec.fault_prob_min, spec.fault_prob_max), 2)
        fields = [f"point={point}", f"kind={kind}", f"prob={prob}"]
        if kind == "delay_ms":
            fields.append(f"arg={rng.randint(lo, hi)}")
            if rng.random() < 0.5:
                fields.append(f"times={rng.randint(3, 40)}")
        else:
            # error/drop rules are ALWAYS times-bounded bursts: an
            # unlimited hard-failure rule is a network partition, which
            # outlasts every retry ladder by construction and turns any
            # schedule into "everything fails" (a separate scenario, not
            # a useful random draw)
            fields.append(f"times={rng.randint(3, 40)}")
        entries.append(",".join(fields))
    return ";".join(entries)


def _gen_config_push(rng: random.Random) -> Dict:
    section = rng.choice(("qos", "tenants", "slo"))
    if section == "qos":
        # shrink or grow one background class's share mid-flight
        cls = rng.choice(("resync", "gc", "migration", "ec_rebuild"))
        share = rng.choice((0.1, 0.25, 0.5))
        return {"section": "qos", "spec": f"{cls}.queue_share={share}"}
    if section == "tenants":
        bps = rng.choice((1 << 20, 8 << 20, 64 << 20))
        return {"section": "tenants",
                "spec": f"tenant=t{rng.randrange(4)},weight=4,"
                        f"bytes_per_s={bps}"}
    bound = rng.choice((1_000_000, 2_000_000, 5_000_000))
    return {"section": "slo",
            "spec": f"rule=chaos_read_p99,metric=storage.read.latency_us,"
                    f"agg=p99,max={bound},fast_s=5,slow_s=10"}


def generate_schedule(seed: int,
                      spec: Optional[ScheduleSpec] = None) -> Schedule:
    """Draw a schedule — pure in (seed, spec); all randomness from ONE
    ``random.Random(seed)``."""
    spec = spec or ScheduleSpec()
    rng = random.Random(seed)
    kinds: List[str] = []
    weights = [("fault_set", 30), ("fault_clear", 10)]
    if spec.allow_kill and spec.storage_nodes > 1:
        weights += [("kill", 12), ("restart", 14)]
    if spec.allow_elastic:
        weights += [("join", 5), ("drain", 5)]
    if spec.allow_config_push:
        weights += [("config_push", 10)]
    if spec.allow_partition and spec.storage_nodes >= 2:
        weights += [("partition", 8)]
    for k, w in weights:
        kinds.extend([k] * w)
    events: List[ChaosEvent] = []
    for _ in range(spec.events):
        step = rng.randrange(spec.steps)
        kind = rng.choice(kinds)
        if kind == "fault_set":
            # node_idx >= 0 scopes every rule of the spec to ONE storage
            # node (executors append `,node=<real id>` when applying —
            # the spec string itself stays id-free and thus portable
            # between the fabric and a real cluster)
            args = {"spec": _gen_fault_spec(rng, spec),
                    "seed": rng.randrange(1 << 16),
                    "node_idx": (rng.randrange(spec.storage_nodes)
                                 if spec.storage_nodes
                                 and rng.random() < 0.5 else -1)}
        elif kind == "fault_clear":
            args = {}
        elif kind in ("kill", "restart"):
            roles = ["storage"] * max(spec.storage_nodes - 1, 0)
            roles += ["meta"] * spec.meta_nodes
            roles += ["worker"] * spec.workers
            roles += ["client"] * spec.clients
            if not roles:
                continue
            role = rng.choice(roles)
            pool = {"storage": spec.storage_nodes, "meta": spec.meta_nodes,
                    "worker": spec.workers, "client": spec.clients}[role]
            args = {"role": role, "idx": rng.randrange(max(pool, 1))}
        elif kind == "join":
            args = {}
        elif kind == "drain":
            args = {"idx": rng.randrange(max(spec.storage_nodes, 1))}
        elif kind == "partition":
            # side a: a minority of storage nodes; side b: mgmtd always
            # (the lease-fence shape) plus, half the time, every other
            # storage node (the full split). Always healed.
            a_size = 1 if spec.storage_nodes <= 3 or rng.random() < 0.7 \
                else rng.randint(1, spec.storage_nodes // 2)
            a = sorted(rng.sample(range(spec.storage_nodes), a_size))
            b = (sorted(set(range(spec.storage_nodes)) - set(a))
                 if rng.random() < 0.5 else [])
            args = {"a": a, "b": b, "heal_after": rng.randint(2, 6)}
        else:  # config_push
            args = _gen_config_push(rng)
        events.append(ChaosEvent(step, kind, args))
    events.sort(key=lambda e: (e.step, e.kind, json.dumps(e.args,
                                                          sort_keys=True)))
    sched = Schedule(seed, spec, events)
    sched.validate()
    return sched
