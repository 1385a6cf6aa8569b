"""Trace assembler: join per-process span files into per-trace trees.

Each traced process streams ``spans.SpanEvent`` rows into its own
columnar file set (``spans-<stamp>.*`` parts under that process's trace
dir). This module loads any number of those file sets, groups rows by
trace id, rebuilds the span tree from parent ids (which cross process
boundaries: a server op parents to the client's rpc span carried on the
envelope), and derives the two operator views:

- ``format_trace``: one trace as an indented tree with per-span wall
  times and a STAGE COVERAGE line — the fraction of the root
  (client-observed) latency that attributed stage spans account for.
  Coverage sums additive stages only: container stages (``collect``,
  ``forward``, and the EC reads' ``fetch`` and ``fetch_degraded``) hold
  their callee's whole pipeline and would double count.
- ``top_traces`` / ``stage_percentiles``: slowest ops and per-stage
  p50/p90/p99 across every loaded trace — the trace-top view.

The port's own copy of ``tpu3fs/analytics/assemble.py``, reading the span
files the port's ``analytics/trace.py`` writes (Parquet or NPZ).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, List, Optional, Sequence

from tpu3fs_torch.analytics.trace import read_records

# stages whose duration CONTAINS downstream work (excluded from the
# additive coverage sum; see module doc)
CONTAINER_STAGES = frozenset({"collect", "forward", "fetch",
                              "fetch_degraded"})


def span_files(paths: Iterable[str]) -> List[str]:
    """Expand files/dirs into the span part files they hold (a dir is
    scanned recursively — one trace root can hold every node's subdir)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for pat in ("spans-*.npz", "spans-*.parquet"):
                out.extend(glob.glob(os.path.join(p, "**", pat),
                                     recursive=True))
        elif os.path.exists(p):
            out.append(p)
    return sorted(set(out))


def load_spans(paths: Iterable[str]) -> List[dict]:
    rows: List[dict] = []
    for path in span_files(paths):
        rows.extend(read_records(path))
    return rows


class TraceTree:
    """One assembled trace: spans indexed by id, children by parent."""

    def __init__(self, trace_id: str, rows: List[dict]):
        self.trace_id = trace_id
        self.rows = rows
        self.by_id: Dict[str, dict] = {r["span_id"]: r for r in rows}
        self.children: Dict[str, List[dict]] = {}
        self.roots: List[dict] = []
        for r in rows:
            parent = r.get("parent_id") or ""
            if parent and parent in self.by_id:
                self.children.setdefault(parent, []).append(r)
            else:
                self.roots.append(r)
        for kids in self.children.values():
            kids.sort(key=lambda r: (r.get("ts", 0.0),
                                     -r.get("dur_us", 0.0)))
        self.roots.sort(key=lambda r: -r.get("dur_us", 0.0))

    @property
    def root(self) -> Optional[dict]:
        return self.roots[0] if self.roots else None

    def stage_rows(self) -> List[dict]:
        return [r for r in self.rows if r.get("stage")]

    def coverage(self) -> float:
        """Fraction of the root (client-observed) wall during which at
        least one ATTRIBUTED stage was active: the interval UNION of
        additive stage spans clipped to the root window, over the root
        duration. Union, not sum — pipelined fan-outs run stages
        concurrently, and a plain sum would exceed 100% without meaning
        the breakdown explains the latency. Cross-process span clocks
        are wall time on (assumed loosely synced) hosts; sub-ms skew
        only blurs the interval edges."""
        root = self.root
        if root is None or not root.get("dur_us"):
            return 0.0
        r0 = root.get("ts", 0.0)
        r1 = r0 + root["dur_us"] / 1e6
        ivals = []
        for r in self.stage_rows():
            if r["stage"] in CONTAINER_STAGES:
                continue
            a = max(r0, r.get("ts", 0.0))
            b = min(r1, r.get("ts", 0.0) + r.get("dur_us", 0.0) / 1e6)
            if b > a:
                ivals.append((a, b))
        ivals.sort()
        covered = 0.0
        cur_a = cur_b = None
        for a, b in ivals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    covered += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            covered += cur_b - cur_a
        return covered / (r1 - r0)

    def services(self) -> List[str]:
        return sorted({f"{r.get('service', '')}:{r.get('node', 0)}"
                       for r in self.rows})

    def tenants(self) -> List[str]:
        """Tenant tags this trace's op spans carry (tpu3fs/tenant):
        empty for pre-tenancy span files."""
        return sorted({r.get("tenant", "") for r in self.rows
                       if r.get("tenant")})


def assemble_traces(rows: Sequence[dict]) -> Dict[str, TraceTree]:
    groups: Dict[str, List[dict]] = {}
    for r in rows:
        tid = r.get("trace_id")
        if tid:
            groups.setdefault(tid, []).append(r)
    return {tid: TraceTree(tid, trows) for tid, trows in groups.items()}


# -- flight-recorder dumps (monitor/flight.py black boxes) --------------------


def flight_files(paths: Iterable[str]) -> List[str]:
    """Expand files/dirs into flight dump files (recursive)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(glob.glob(os.path.join(p, "**", "flight-*.jsonl"),
                                 recursive=True))
        elif os.path.exists(p):
            out.append(p)
    return sorted(set(out))


def load_flight(paths: Iterable[str]) -> List[dict]:
    """Load N processes' flight dumps into one ts-sorted timeline. Each
    row keeps its dump's identity (``_service``/``_node``/``_dump``
    from the file's leading meta row), so a merged view still attributes
    every event to its black box."""
    import json

    rows: List[dict] = []
    for path in flight_files(paths):
        meta = {"service": "?", "node": 0}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("kind") == "meta":
                    meta = row
                row.setdefault("_service", meta.get("service", "?"))
                row.setdefault("_node", meta.get("node", 0))
                row["_dump"] = os.path.basename(path)
                rows.append(row)
    rows.sort(key=lambda r: r.get("ts", 0.0))
    return rows


def format_flight(rows: Sequence[dict], *, spans: int = 3,
                  events: int = 40) -> str:
    """Merged black-box view: the dump inventory, the event timeline
    (alerts, config pushes, dump reasons), and the slowest cross-process
    span trees rebuilt from the dumps' span rows through the trace
    machinery (trace ids join across processes)."""
    if not rows:
        return "no flight dumps found"
    lines: List[str] = []
    metas = [r for r in rows if r.get("kind") == "meta"]
    lines.append(f"flight view: {len(metas)} dump(s), {len(rows)} rows")
    for m in metas:
        lines.append(
            f"  {m.get('_dump')}: {m.get('service')}:{m.get('node')} "
            f"pid {m.get('pid')} reason={m.get('reason')!r} "
            f"events={m.get('events')}")
    timeline = [r for r in rows
                if r.get("kind") in ("alert", "config")]
    if timeline:
        lines.append("timeline (alerts + config pushes):")
        for r in timeline[-events:]:
            who = f"{r.get('_service')}:{r.get('_node')}"
            if r.get("kind") == "alert":
                lines.append(
                    f"  {r.get('ts', 0.0):.3f} [{who}] ALERT "
                    f"{r.get('rule')} -> {r.get('transition')} "
                    f"({r.get('message', '')})")
            else:
                ok = "applied" if r.get("ok") else "REJECTED"
                lines.append(
                    f"  {r.get('ts', 0.0):.3f} [{who}] CONFIG {ok} "
                    f"(source={r.get('source')}"
                    + (f", v{r['version']}" if "version" in r else "")
                    + ")")
    span_rows = [r for r in rows if r.get("kind") == "span"]
    if span_rows:
        trees = assemble_traces(span_rows)
        ranked = top_traces(trees, spans)
        lines.append(f"slow-op traces ({len(trees)} in the dumps, "
                     f"slowest {len(ranked)}):")
        for tree in ranked:
            lines.append(format_trace(tree))
    return "\n".join(lines)


def _fmt_row(r: dict) -> str:
    name = r.get("op", "?")
    if r.get("stage"):
        name = f"{name}/{r['stage']}"
    where = f"{r.get('service', '?')}:{r.get('node', 0)}"
    extra = ""
    if r.get("nbytes"):
        extra += f" {r['nbytes']}B"
    if r.get("code"):
        extra += f" code={r['code']}"
    if r.get("slow"):
        extra += " SLOW"
    return f"{name:<34s} {r.get('dur_us', 0.0) / 1e3:9.3f} ms" \
           f"  [{where}]{extra}"


def format_trace(tree: TraceTree) -> str:
    """Indented tree + coverage summary for one trace."""
    lines = [f"trace {tree.trace_id}  "
             f"({len(tree.rows)} spans, {len(tree.services())} processes: "
             f"{', '.join(tree.services())})"]

    def walk(r: dict, depth: int) -> None:
        lines.append("  " * depth + _fmt_row(r))
        for kid in tree.children.get(r["span_id"], []):
            walk(kid, depth + 1)

    for root in tree.roots:
        walk(root, 1)
    root = tree.root
    if root is not None:
        stages = {r["stage"] for r in tree.stage_rows()}
        lines.append(
            f"  stages: {len(stages)} distinct "
            f"({', '.join(sorted(stages))})")
        lines.append(
            f"  stage coverage: {tree.coverage() * 100.0:.1f}% of "
            f"{root.get('dur_us', 0.0) / 1e3:.3f} ms client-observed")
    return "\n".join(lines)


def _pct(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(p * len(sorted_vals)))]


def stage_percentiles(rows: Sequence[dict]) -> Dict[str, dict]:
    """stage -> {count, p50, p90, p99, total_ms} over every stage span."""
    groups: Dict[str, List[float]] = {}
    for r in rows:
        if r.get("stage"):
            groups.setdefault(r["stage"], []).append(r.get("dur_us", 0.0))
    out: Dict[str, dict] = {}
    for stage, durs in groups.items():
        durs.sort()
        out[stage] = {
            "count": len(durs),
            "p50_us": _pct(durs, 0.5),
            "p90_us": _pct(durs, 0.9),
            "p99_us": _pct(durs, 0.99),
            "total_ms": sum(durs) / 1e3,
        }
    return out


def top_traces(trees: Dict[str, TraceTree], n: int = 10) -> List[TraceTree]:
    """Slowest traces by root duration (rootless fragments sort last)."""
    def key(t: TraceTree) -> float:
        root = t.root
        return -(root.get("dur_us", 0.0) if root else 0.0)

    return sorted(trees.values(), key=key)[:max(1, n)]


def tenant_percentiles(rows: Sequence[dict]) -> Dict[str, dict]:
    """tenant -> {count, p50, p90, p99, total_ms, bytes} over every
    tenant-tagged OP span: the "who is hurting whom" rollup of trace-top
    (tpu3fs/tenant). Untagged (pre-tenancy / internal) spans group under
    '-'. Only op spans count — stage spans would double-bill an op's
    wall to its owner."""
    groups: Dict[str, List[float]] = {}
    nbytes: Dict[str, int] = {}
    for r in rows:
        if r.get("stage"):
            continue
        tenant = r.get("tenant") or "-"
        groups.setdefault(tenant, []).append(r.get("dur_us", 0.0))
        nbytes[tenant] = nbytes.get(tenant, 0) + int(r.get("nbytes", 0))
    out: Dict[str, dict] = {}
    for tenant, durs in groups.items():
        durs.sort()
        out[tenant] = {
            "count": len(durs),
            "p50_us": _pct(durs, 0.5),
            "p90_us": _pct(durs, 0.9),
            "p99_us": _pct(durs, 0.99),
            "total_ms": sum(durs) / 1e3,
            "bytes": nbytes.get(tenant, 0),
        }
    return out


def format_top(trees: Dict[str, TraceTree], rows: Sequence[dict],
               n: int = 10, by_tenant: bool = False) -> str:
    lines = [f"{len(trees)} traces, {len(rows)} spans; slowest {n}:"]
    for t in top_traces(trees, n):
        root = t.root
        if root is None:
            continue
        slow = " SLOW" if any(r.get("slow") for r in t.rows) else ""
        tenants = t.tenants()
        who = f"  [{','.join(tenants)}]" if tenants else ""
        lines.append(
            f"  {t.trace_id}  {root.get('op', '?'):<24s} "
            f"{root.get('dur_us', 0.0) / 1e3:9.3f} ms  "
            f"cov {t.coverage() * 100.0:5.1f}%  "
            f"{len(t.services())} procs{slow}{who}")
    if by_tenant:
        tp = tenant_percentiles(rows)
        if tp:
            lines.append(f"  {'tenant':<18s} {'ops':>6s} {'p50ms':>9s} "
                         f"{'p90ms':>9s} {'p99ms':>9s} {'MiB':>9s}")
            for tenant in sorted(tp):
                s = tp[tenant]
                lines.append(
                    f"  {tenant:<18s} {s['count']:>6d} "
                    f"{s['p50_us'] / 1e3:>9.3f} "
                    f"{s['p90_us'] / 1e3:>9.3f} "
                    f"{s['p99_us'] / 1e3:>9.3f} "
                    f"{s['bytes'] / (1 << 20):>9.2f}")
    pcts = stage_percentiles(rows)
    if pcts:
        lines.append(f"  {'stage':<18s} {'count':>6s} {'p50ms':>9s} "
                     f"{'p90ms':>9s} {'p99ms':>9s} {'total_ms':>9s}")
        for stage in sorted(pcts):
            s = pcts[stage]
            lines.append(
                f"  {stage:<18s} {s['count']:>6d} "
                f"{s['p50_us'] / 1e3:>9.3f} {s['p90_us'] / 1e3:>9.3f} "
                f"{s['p99_us'] / 1e3:>9.3f} {s['total_ms']:>9.3f}")
    return "\n".join(lines)
