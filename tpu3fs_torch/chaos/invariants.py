"""Cross-cutting invariant checkers: the contracts the subsystems
promised piecemeal, asserted together after (and during) a chaos run.

The port's own copy of ``tpu3fs/chaos/invariants.py``: the same checkers,
statuses and messages. Where the JAX package takes one scalar CRC a
chunk, ``crc_oracle`` and ``kvcache_stale`` checksum every payload they
read with one ``crc32c_many`` call on ``ChaosContext.device`` (kernel
K2 on the card, its plain version on the CPU).

Each checker is NAMED, registered once, and individually reportable —
a chaos report says exactly which contract broke, not "something
failed". Checkers are pure readers: they never mutate the cluster.

Checkers operate on a ``ChaosContext`` — a capability bag both
executors fill (the in-fabric runner directly; the production-day drive
via RPC clients). A checker whose inputs are absent reports SKIPPED,
so one registry serves fast CR-only searches and the full soak alike.

Catalogue (docs/chaos.md):

``crc_oracle``        zero lost/corrupt bytes: every oracle chunk reads
                      back as one of its ADMISSIBLE payloads (the last
                      acknowledged write, or — when unacknowledged
                      writes followed it — any member of that ambiguous
                      suffix; an out-of-set payload is a lost/duplicated
                      /resurrected write). CRC32C compare, not bytes.
``replica_versions``  CR replica convergence: after healing, every
                      member of every CR chain holds identical
                      (committed_ver, checksum) per chunk — the
                      invariant the planted ``commit_skip`` bug breaks.
``stripe_versions``   EC whole-stripe-version invariant: all k+m shards
                      of every committed stripe sit at ONE version.
``exactly_once``      no double-apply: a chunk's committed version never
                      exceeds the logical writes issued to it (client
                      retries and chain replays consume at most one
                      version each — breaker flaps + hedges ride
                      the same replay tables).
``ckpt_atomicity``    crash-commit atomicity: every VISIBLE checkpoint
                      step loads (manifest + CRC-verified shards); no
                      ``.tmp`` partial is listed as committed.
``dataload_resume``   exact resume: replaying a saved cursor yields the
                      exact recorded remaining sample sequence.
``bounded_memory``    every registered memory gauge is below its bound
                      (leaks under chaos show up here, not in prod).
``kvcache_stale``     serving-tier staleness: a fleet KVCache get never
                      returns bytes no client ever put for that key — a
                      peer serving a GC'd block must surface as a MISS
                      (the KVCACHE_STALE re-probe), never as zeros-as-KV
                      (the planted ``peer_fill_stale`` bug's shape).
``domain_quorum``     failure-domain placement: when nodes carry a
                      ``domain`` tag, no chain concentrates more members
                      in one domain than it can lose (width-1 for CR,
                      ec_m for EC) — killing a WHOLE domain then never
                      costs any chain its quorum, by construction.
``meta_intents``      metadata two-phase convergence: after quiesce no
                      intent/prepare record survives resolution, and
                      every path the metashard sidecar's ACKED ops left
                      in the namespace still resolves to its recorded
                      inode — a stale rename intent replayed without
                      the inode guard clears a recreated name and
                      orphans a live file (the planted
                      ``rename_orphan_intent`` bug's shape).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.monitor.recorder import CounterRecorder

# -- recorders (single declaration site; docs/observability.md) --------------
_rec_violations = CounterRecorder("chaos.violations")


@dataclass
class Violation:
    checker: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.checker}] {self.detail}"


@dataclass
class CheckOutcome:
    checker: str
    status: str                    # passed | violated | skipped
    violations: List[Violation] = field(default_factory=list)
    note: str = ""


@dataclass
class ChaosContext:
    """Capability bag the executors fill. Every field optional — a
    checker skips when what it reads is None/empty."""

    # where the CRC checkers checksum (None: the card)
    device: object = None
    # read_chunk(chain_id, file_id, index) -> bytes | None (None = gone)
    read_chunk: Optional[Callable] = None
    # oracle[(chain, file_id, index)] -> admissible set of CRC32C values
    # (last acked payload's crc, plus any unacknowledged successors; a
    # None member marks a chunk with no acked write, whose absence is
    # itself admissible)
    oracle: Dict[Tuple[int, int, int], set] = field(default_factory=dict)
    # logical writes issued per oracle chunk (exactly-once bound)
    writes_issued: Dict[Tuple[int, int, int], int] = field(
        default_factory=dict)
    # routing() -> RoutingInfo; dump_chunkmeta(node_id, target_id) -> metas
    routing: Optional[Callable] = None
    dump_chunkmeta: Optional[Callable] = None
    # committed chunk versions per oracle chunk (exactly_once reads these
    # through routing+dump when present, else skips)
    # ckpt: manager with .steps() / .restore(step); acked saves
    ckpt_manager: object = None
    ckpt_acked_steps: List[int] = field(default_factory=list)
    ckpt_list_raw: Optional[Callable] = None   # -> visible step dir names
    # dataload: resume_replay() -> (expected_ids, resumed_ids)
    resume_replay: Optional[Callable] = None
    # memory gauges: name -> (value_fn, bound)
    memory_gauges: Dict[str, Tuple[Callable[[], float], float]] = field(
        default_factory=dict)
    # serving sidecar read records: (key, admissible crc32c set, got
    # bytes | None) per fleet-cache get issued against a GC race
    serving_reads: List[Tuple[str, set, Optional[bytes]]] = field(
        default_factory=list)
    # metashard sidecar audit: () -> {"expected": {path: inode_id},
    # "actual": {path: inode_id | None}, "dangling": int} after the
    # quiesce-time forced resolution
    meta_audit: Optional[Callable] = None
    # native-write sidecar probe records: (label, acked, (head committed
    # ver, head crc), (successor committed ver, successor crc)) per
    # chain write issued through the C++ head against manufactured
    # replica divergence
    native_write_replicas: List[
        Tuple[str, bool, Tuple[int, int], Tuple[int, int]]] = field(
        default_factory=list)


_REGISTRY: Dict[str, Callable[[ChaosContext], Optional[List[Violation]]]] = {}


def register(name: str):
    """Register a checker. The function returns a list of violations, or
    None to report SKIPPED (inputs absent)."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate checker {name!r}")
        _REGISTRY[name] = fn
        return fn
    return deco


def checker_names() -> List[str]:
    return sorted(_REGISTRY)


def run_checkers(ctx: ChaosContext,
                 names: Optional[List[str]] = None) -> List[CheckOutcome]:
    """Run the selected (default: all) checkers; each outcome is named
    and individually reportable. A checker that RAISES is itself a
    violation — invariant code must not crash the verdict."""
    out: List[CheckOutcome] = []
    for name in (names or checker_names()):
        fn = _REGISTRY[name]
        try:
            vs = fn(ctx)
        except Exception as e:  # checker bug ≠ silent pass
            vs = [Violation(name, f"checker raised: {e!r}")]
        if vs is None:
            out.append(CheckOutcome(name, "skipped", note="inputs absent"))
        elif vs:
            _rec_violations.add(len(vs))
            out.append(CheckOutcome(name, "violated", violations=vs))
        else:
            out.append(CheckOutcome(name, "passed"))
    return out


# -- the catalogue ------------------------------------------------------------

def _crc32c_many(bufs, device) -> List[int]:
    """CRC32C of each buffer with one ``crc32c_many`` call on ``device``."""
    if not bufs:
        return []
    from tpu3fs_torch.ops.crc32c import crc32c_many

    return crc32c_many([bytes(b) for b in bufs], device)


@register("crc_oracle")
def _check_crc_oracle(ctx: ChaosContext):
    if ctx.read_chunk is None or not ctx.oracle:
        return None
    bad: List[Violation] = []
    items = sorted(ctx.oracle.items())
    datas = [ctx.read_chunk(*key) for key, _ in items]
    crcs = iter(_crc32c_many([d for d in datas if d is not None],
                             ctx.device))
    for (key, admissible), data in zip(items, datas):
        chain, fid, idx = key
        if data is None:
            # a None member of the admissible set marks chunks that
            # never had an ACKED write: every attempt failed with an
            # unknown outcome, so absence is a legitimate state
            if admissible and None not in admissible:
                bad.append(Violation(
                    "crc_oracle",
                    f"chunk {chain}/{fid}/{idx} unreadable but has "
                    f"acknowledged content"))
            continue
        crc = next(crcs)
        if admissible and crc not in admissible:
            bad.append(Violation(
                "crc_oracle",
                f"chunk {chain}/{fid}/{idx} crc {crc:#x} not in the "
                f"admissible set ({len(admissible)} candidate(s)) — "
                f"lost/corrupt/resurrected bytes"))
    return bad


def _chain_member_metas(ctx: ChaosContext, chain, routing):
    """{target_id: {chunk_key: (committed_ver, crc, length)}} for every
    member, committed state only (pending residue is legal skew)."""
    views = {}
    for t in chain.targets:
        info = routing.targets.get(t.target_id)
        if info is None:
            continue
        metas = ctx.dump_chunkmeta(info.node_id, t.target_id)
        views[t.target_id] = {
            (m.chunk_id.file_id, m.chunk_id.index):
                (m.committed_ver, m.checksum.value, m.checksum.length)
            for m in metas if m.committed_ver > 0
        }
    return views


@register("replica_versions")
def _check_replica_versions(ctx: ChaosContext):
    if ctx.routing is None or ctx.dump_chunkmeta is None:
        return None
    bad: List[Violation] = []
    routing = ctx.routing()
    for cid in sorted(routing.chains):
        chain = routing.chains[cid]
        if chain.is_ec:
            continue
        views = _chain_member_metas(ctx, chain, routing)
        items = sorted(views.items())
        if len(items) < 2:
            continue
        base_tid, base = items[0]
        for tid, other in items[1:]:
            if other != base:
                diff = {k for k in (base.keys() | other.keys())
                        if base.get(k) != other.get(k)}
                bad.append(Violation(
                    "replica_versions",
                    f"chain {cid}: members {base_tid} and {tid} diverge "
                    f"on {len(diff)} chunk(s), e.g. "
                    f"{sorted(diff)[:3]}"))
    return bad


@register("stripe_versions")
def _check_stripe_versions(ctx: ChaosContext):
    if ctx.routing is None or ctx.dump_chunkmeta is None:
        return None
    routing = ctx.routing()
    ec_chains = [c for c in routing.chains.values() if c.is_ec]
    if not ec_chains:
        return None
    bad: List[Violation] = []
    for chain in ec_chains:
        views = _chain_member_metas(ctx, chain, routing)
        # whole-stripe-version invariant: for every stripe (chunk key)
        # present anywhere, every shard-holding member that has it must
        # hold it at ONE committed version (docs/ec.md)
        keys = set()
        for v in views.values():
            keys.update(v)
        for key in sorted(keys):
            vers = {tid: v[key][0] for tid, v in views.items() if key in v}
            if len(set(vers.values())) > 1:
                bad.append(Violation(
                    "stripe_versions",
                    f"EC chain {chain.chain_id} stripe {key}: shard "
                    f"versions diverge {vers}"))
    return bad


@register("exactly_once")
def _check_exactly_once(ctx: ChaosContext):
    if (ctx.routing is None or ctx.dump_chunkmeta is None
            or not ctx.writes_issued):
        return None
    routing = ctx.routing()
    bad: List[Violation] = []
    # committed version per oracle chunk, max across members (members
    # agree when replica_versions passes; max is the conservative bound)
    committed: Dict[Tuple[int, int, int], int] = {}
    for cid in sorted(routing.chains):
        chain = routing.chains[cid]
        if chain.is_ec:
            continue
        for _tid, view in _chain_member_metas(ctx, chain, routing).items():
            for (fid, idx), (ver, _crc, _ln) in view.items():
                key = (cid, fid, idx)
                if key in ctx.writes_issued:
                    committed[key] = max(committed.get(key, 0), ver)
    for key, ver in sorted(committed.items()):
        issued = ctx.writes_issued[key]
        if ver > issued:
            bad.append(Violation(
                "exactly_once",
                f"chunk {key}: committed version {ver} exceeds {issued} "
                f"logical writes — a retry/replay applied twice"))
    return bad


@register("ckpt_atomicity")
def _check_ckpt_atomicity(ctx: ChaosContext):
    if ctx.ckpt_manager is None:
        return None
    bad: List[Violation] = []
    mgr = ctx.ckpt_manager
    visible = mgr.steps()
    if ctx.ckpt_list_raw is not None:
        for name in ctx.ckpt_list_raw():
            if name.endswith(".tmp") and name[:-4].isdigit() \
                    and int(name[:-4]) in visible:
                bad.append(Violation(
                    "ckpt_atomicity",
                    f"step {name[:-4]} listed committed while its .tmp "
                    f"staging dir still exists"))
    for step in visible:
        try:
            mgr.restore(step)   # verify=True: whole-shard CRC checks
        except Exception as e:
            bad.append(Violation(
                "ckpt_atomicity",
                f"visible step {step} does not restore cleanly: {e!r} — "
                f"a partial commit became visible"))
    for step in ctx.ckpt_acked_steps:
        if step not in visible:
            bad.append(Violation(
                "ckpt_atomicity",
                f"acknowledged save of step {step} is not visible — "
                f"a committed checkpoint was lost"))
    return bad


@register("dataload_resume")
def _check_dataload_resume(ctx: ChaosContext):
    if ctx.resume_replay is None:
        return None
    expected, resumed = ctx.resume_replay()
    if list(expected) != list(resumed):
        k = next((i for i, (a, b)
                  in enumerate(zip(expected, resumed)) if a != b),
                 min(len(expected), len(resumed)))
        return [Violation(
            "dataload_resume",
            f"resumed sequence diverges at position {k}: expected "
            f"{list(expected)[k:k + 3]}, got {list(resumed)[k:k + 3]} "
            f"(lengths {len(expected)} vs {len(resumed)})")]
    return []


@register("bounded_memory")
def _check_bounded_memory(ctx: ChaosContext):
    if not ctx.memory_gauges:
        return None
    bad: List[Violation] = []
    for name, (fn, bound) in sorted(ctx.memory_gauges.items()):
        value = float(fn())
        if value > bound:
            bad.append(Violation(
                "bounded_memory",
                f"gauge {name} = {value:g} exceeds bound {bound:g}"))
    return bad


@register("kvcache_stale")
def _check_kvcache_stale(ctx: ChaosContext):
    if not ctx.serving_reads:
        return None
    bad: List[Violation] = []
    crcs = iter(_crc32c_many([got for _, _, got in ctx.serving_reads
                              if got is not None], ctx.device))
    for key, admissible, got in ctx.serving_reads:
        if got is None:
            continue  # staleness surfaced as a miss: the correct re-probe
        crc = next(crcs)
        if crc in admissible:
            continue
        kind = ("zeros-as-KV" if not any(bytes(got))
                else "foreign bytes")
        bad.append(Violation(
            "kvcache_stale",
            f"serving get of {key!r} returned {kind} no client ever put "
            f"— a peer served a GC'd block without the staleness "
            f"re-probe (must surface as KVCACHE_STALE/miss)"))
    return bad


@register("replica_crc")
def _check_replica_crc(ctx: ChaosContext):
    """An OK-acked chain write must leave every replica it touched
    committed at the same version with the SAME CRC — the successor
    cross-check is the guard (planted bug: native_commit_skip_crc skips
    it in the C++ head and acks divergent replicas as clean)."""
    if not ctx.native_write_replicas:
        return None
    bad: List[Violation] = []
    for label, acked, (h_ver, h_crc), (s_ver, s_crc) in \
            ctx.native_write_replicas:
        if not acked:
            continue  # refused writes may leave replicas wherever
        if h_ver == s_ver and h_crc != s_crc:
            bad.append(Violation(
                "replica_crc",
                f"write {label} acked OK but committed DIVERGENT "
                f"replicas: head crc {h_crc:#x} != successor "
                f"{s_crc:#x} at ver {h_ver} — the head committed "
                f"without cross-checking the successor's checksum"))
    return bad


@register("domain_quorum")
def _check_domain_quorum(ctx: ChaosContext):
    """Failure-domain placement invariant: a chain may not concentrate
    more members in one domain than it survives losing — width-1 for CR
    (one member must outlive any single-domain kill), ec_m for EC (at
    most m shards may share a domain's fate). Skips on untagged
    clusters: domain-blind placement predates the constraint and is
    still legal there (docs/scale.md)."""
    if ctx.routing is None:
        return None
    routing = ctx.routing()
    domains = {nid: n.tags.get("domain")
               for nid, n in routing.nodes.items()
               if n.tags.get("domain")}
    if not domains:
        return None
    bad: List[Violation] = []
    for cid in sorted(routing.chains):
        chain = routing.chains[cid]
        counts: Dict[str, int] = {}
        for t in chain.targets:
            info = routing.targets.get(t.target_id)
            if info is None:
                continue
            dom = domains.get(info.node_id)
            if dom is not None:
                counts[dom] = counts.get(dom, 0) + 1
        width = len(chain.targets)
        cap = chain.ec_m if chain.is_ec else max(width - 1, 1)
        for dom, n in sorted(counts.items()):
            if n > cap:
                bad.append(Violation(
                    "domain_quorum",
                    f"chain {cid}: {n} of {width} members in domain "
                    f"{dom!r} exceeds the loss budget {cap} — a "
                    f"single-domain kill would break quorum"))
    return bad


@register("meta_intents")
def _check_meta_intents(ctx: ChaosContext):
    if ctx.meta_audit is None:
        return None
    audit = ctx.meta_audit()
    bad: List[Violation] = []
    dangling = int(audit.get("dangling", 0))
    if dangling:
        bad.append(Violation(
            "meta_intents",
            f"{dangling} two-phase record(s) survived the quiesce "
            f"resolution — an intent was never converged"))
    actual = audit.get("actual", {})
    for path, ino in sorted(audit.get("expected", {}).items()):
        got = actual.get(path)
        if got is None:
            bad.append(Violation(
                "meta_intents",
                f"acked namespace entry {path} -> inode {ino} is gone — "
                f"a replayed rename intent cleared a recreated name "
                f"(orphaned inode)"))
        elif got != ino:
            bad.append(Violation(
                "meta_intents",
                f"{path} resolves to inode {got}, expected {ino} — a "
                f"two-phase replay crossed namespaces"))
    return bad


def format_report(outcomes: List[CheckOutcome]) -> str:
    lines = []
    for o in outcomes:
        mark = {"passed": "ok ", "violated": "VIOLATED",
                "skipped": "-- "}[o.status]
        lines.append(f"{o.checker:<18} {mark}"
                     + (f" ({o.note})" if o.note else ""))
        for v in o.violations:
            lines.append(f"    {v.detail}")
    return "\n".join(lines)
