"""Distributed request tracing: span-stamped RPCs + stage-level timings.

The port's own copy of ``tpu3fs/analytics/spans.py``. Its span sink is
the port's ``analytics/trace.py``: ``configure(directory=...)`` streams
the spans there (Parquet where ``pyarrow`` imports, NPZ otherwise).

Re-expresses the reference's three-way instrumentation (monitor latency
families on every op, a StructuredTraceLog plugged into the storage write
path, per-request identity threaded through the stack) as ONE substrate:
a ``TraceContext`` (trace id, current span id, sampled + slow bits) rides
the RPC envelope's ``message`` field on requests — a field every decoder,
old or new, python or native, already parses and ignores on requests, so
the encoding is version-tolerant in both directions — and propagates
in-process through a ``contextvars.ContextVar`` (the same machinery that
carries the QoS traffic class through WorkerPool fan-outs, chain-forward
helper threads and the fabric's direct dispatch).

Each layer emits typed ``SpanEvent`` rows — op spans (an RPC dispatch, a
client batch op) and stage spans (admission wait, update-queue wait,
engine stage, chain forward, commit, meta txn, client issue/collect) —
into the context's process-local accumulator. At op end ONE decision
flushes or drops the whole accumulation:

- HEAD SAMPLING: the root creator samples deterministically from the
  trace id (``sampled_of``), downstream hops honor the bit — a trace is
  captured everywhere or nowhere;
- SLOW-OP CAPTURE: an op whose wall time exceeds ``slow_op_ms`` flushes
  UNCONDITIONALLY, sampling rate 0 included — the ops an operator most
  needs are never the ones sampling dropped;
- FORCED capture: the wire slow bit (set via ``start_trace(force=True)``)
  makes every hop flush, for targeted debugging.

Flushed spans stream through ``analytics.trace.StructuredTraceLog`` —
the same columnar sink the storage event trace uses — one file set per
process; ``analytics.assemble`` joins the files of N processes back into
per-trace trees. Overhead discipline: with no tracer configured the only
cost on any hot path is one ContextVar read returning None.

What the port adds to the reference's schema and sinks:

- ``SpanEvent.t_ns``: the span's start on ``time.perf_counter_ns``, the
  clock a device trace (``torch.profiler``) is put on in the same
  process, so a span lines up with the card's copies and kernels; 0 where
  an emitter clocks its wall another way (the storage update rounds).
  ``ts`` stays the wall clock for the cross-process join.
- A nested client op (a ``root_span`` inside another: ``client.read_stripe``
  inside ``client.read``) gets a span of its own under the outer op, and
  the stages and RPC hops inside it parent to it.
- The IN-MEMORY SINK: ``configure(memory=True)`` keeps the spans the
  flush decision keeps (the rows the file sink gets) in a list, with or
  without a directory, for a reader in the same process;
  ``drain()`` returns ``(events, dropped)`` and empties both. Past
  ``MEMORY_CAP`` events new spans are dropped and counted.
  ``configure(memory=False)`` turns it off and discards what it held.

The stages of the port's EC read path (one reader thread, so a client's
stages never overlap; in-process dispatch runs the server's stages
inside ``fetch``):

- ``client.read_stripe`` / ``client.batch_read``: ``fetch``, the first
  round of shard reads; ``fetch_degraded``, the degraded round, the
  survivors' reads.
- ``ec.decode``: ``gather``, the replies to the survivors' host array
  (on the card, the client's page-locked staging); ``h2d``, their copy to
  the card (it blocks the host); ``launch``, the decode kernel's enqueue;
  ``d2h``, the copy back, which waits for the kernel (the device trace
  splits the two).
- ``client.read_stripe`` / ``client.read``: ``assemble``, a stripe's
  range cut from its shards' buffers, handed on as parts to the file
  client (joined and sliced into one ``bytes`` on the public
  ``read_stripe`` and ``batch_read``); a call's parts joined, the one
  copy of its bytes.
- ``storage.batch_read``: ``admit``, the server's read admission;
  ``engine``, one target group's engine crossing.

``fetch`` and ``fetch_degraded`` hold downstream work, like ``collect``
and ``forward``: ``analytics.assemble`` leaves them out of a trace's
stage coverage.

The EC read's counters on each ``StorageClient`` (``CounterRecorder``;
``total`` counts since creation, which ``collect()`` does not reset):

- ``ec.degraded_read``: stripes served by a decode;
- ``ec.read_shard_bytes``: bytes of the OK shard replies an EC read
  received, both rounds, both client paths;
- ``ec.decode_pinned``: degraded stripes whose survivors the card read
  from the client's page-locked staging; its share of
  ``ec.degraded_read`` is 100% on the card and 0 on a CPU device.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from tpu3fs_torch.utils.config import Config, ConfigItem

# -- the wire + file schema ---------------------------------------------------

WIRE_VERSION = "t1"

# wire flag bits (TraceContext.flags on the envelope)
FLAG_SAMPLED = 1
FLAG_SLOW = 2      # forced capture: every hop flushes

# the in-memory sink's bound, in events: ten times the spans of a 51 s
# window of the degraded read (about 105,000 on an H100)
MEMORY_CAP = 1 << 20


@dataclass
class SpanEvent:
    """One span row (columnar via analytics.trace; schema in
    docs/observability.md). Op spans have stage == ""; stage spans carry
    the stage name and parent to their op span."""

    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    service: str = ""      # emitting process role (storage/meta/client/...)
    node: int = 0          # emitting node id (0 = client-side)
    op: str = ""           # operation name (client.batch_write, rpc.server...)
    stage: str = ""        # "" for op spans; stage name for stage spans
    ts: float = 0.0        # wall-clock start (time.time; cross-process join)
    dur_us: float = 0.0
    t_ns: int = 0          # start on time.perf_counter_ns (in-process)
    code: int = 0          # status code (0 = OK)
    nbytes: int = 0
    tclass: str = ""       # QoS traffic class, when tagged
    tenant: str = ""       # owning tenant (op spans; tpu3fs/tenant)
    sampled: bool = False
    slow: bool = False     # flushed by the slow-op/forced path


class TraceContext:
    """Per-request trace identity + the process-local span accumulator.

    ``span_id`` is the CURRENT span: events emitted under this context
    parent to it. ``child()`` derives a nested context (new span id, same
    trace, same accumulator) for a sub-operation whose own events should
    parent to the sub-op span — the RPC client span does this so server
    spans nest under the wire hop.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled", "slow",
                 "events")

    def __init__(self, trace_id: str, span_id: str, parent_id: str = "",
                 sampled: bool = False, slow: bool = False,
                 events: Optional[list] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.slow = slow
        # list.append is GIL-atomic: overlap-forward helper threads and
        # worker threads may append concurrently with the op thread
        self.events: List[SpanEvent] = events if events is not None else []

    def child(self) -> "TraceContext":
        """Nested context for a sub-op in THIS process (shared
        accumulator: one flush decision covers the whole op)."""
        return TraceContext(self.trace_id, _new_id(), self.span_id,
                            self.sampled, self.slow, self.events)

    # -- envelope carriage -------------------------------------------------
    def to_wire(self) -> str:
        flags = (FLAG_SAMPLED if self.sampled else 0) \
            | (FLAG_SLOW if self.slow else 0)
        return f"{WIRE_VERSION}.{self.trace_id}.{self.span_id}.{flags:x}"


def decode_wire(message: str) -> Optional[TraceContext]:
    """Parse a TraceContext off a request envelope; None for absent,
    malformed or future-versioned encodings (old servers that never call
    this simply ignore the field — interop is free in both directions).
    Fields beyond the fourth are ignored: a newer peer may append."""
    if not message or not message.startswith(WIRE_VERSION + "."):
        return None
    parts = message.split(".")
    if len(parts) < 4:
        return None
    trace_id, span_id = parts[1], parts[2]
    if not trace_id or not span_id:
        return None
    try:
        flags = int(parts[3], 16)
    except ValueError:
        return None
    # fresh accumulator: this process flushes its own spans
    return TraceContext(trace_id, span_id,
                        sampled=bool(flags & FLAG_SAMPLED),
                        slow=bool(flags & FLAG_SLOW))


# span and trace ids: 64 random bits from a generator seeded from the
# system's entropy and reseeded in a forked child, so that a span costs no
# syscall (os.urandom an id took 18% of a traced degraded read's rate on
# an H100 host); a trace id stays uniform for sampled_of.
_ids = random.Random()
os.register_at_fork(after_in_child=_ids.seed)


def _new_id() -> str:
    return format(_ids.getrandbits(64), "016x")


def sampled_of(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision: a pure function of
    (trace id, rate), so any process given the same id and rate agrees —
    the property the sampling-determinism test pins."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    try:
        v = int(trace_id[:8], 16)
    except ValueError:
        return False
    return (v / float(0xFFFFFFFF)) < rate


# -- config -------------------------------------------------------------------


class TraceConfig(Config):
    """Hot-updatable tracing knobs, one section per service binary
    (config pushes through mgmtd retune sampling live — no restart)."""

    enabled = ConfigItem(True, hot=True)
    # head-sampling probability for ops with no inbound context
    sample_rate = ConfigItem(0.0, hot=True,
                             checker=lambda v: 0.0 <= v <= 1.0)
    # ops slower than this flush unconditionally (sampling=0 included);
    # <= 0 disables slow-op capture
    slow_op_ms = ConfigItem(200.0, hot=True)
    # span sink directory; "" = tracing off for this process
    dir = ConfigItem("")
    flush_rows = ConfigItem(512, hot=True, checker=lambda v: v >= 1)


# -- the per-process tracer ---------------------------------------------------


class Tracer:
    """Process-global tracing state: identity tags, sampling knobs, the
    columnar sink. ``configure()`` is idempotent and hot-callable."""

    def __init__(self):
        self.enabled = False
        self.service = "proc"
        self.node = 0
        self.sample_rate = 0.0
        self.slow_op_us = 200_000.0
        self._log = None
        self._log_dir = None
        self._lock = threading.Lock()
        # the in-memory sink: at most _mem_cap flushed events until drained
        self._mem: List[SpanEvent] = []
        self._mem_cap = 0
        self._mem_dropped = 0
        # slow-op hooks (the flight recorder's black-box feed): called
        # with the op's accumulated events whenever an op crosses the
        # slow threshold, independent of the sampling decision
        self._slow_hooks: List = []

    def configure(self, *, service: Optional[str] = None,
                  node: Optional[int] = None,
                  directory: Optional[str] = None,
                  sample_rate: Optional[float] = None,
                  slow_op_ms: Optional[float] = None,
                  enabled: Optional[bool] = None,
                  flush_rows: int = 512,
                  memory: Optional[bool] = None) -> "Tracer":
        """``memory``: True keeps up to ``MEMORY_CAP`` flushed events in
        memory for ``drain()``, with or without a directory; False turns
        the in-memory sink off and discards what it held."""
        with self._lock:
            if service is not None:
                self.service = service
            if node is not None:
                self.node = node
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)
            if slow_op_ms is not None:
                self.slow_op_us = (float(slow_op_ms) * 1e3
                                   if slow_op_ms and slow_op_ms > 0
                                   else float("inf"))
            if directory is not None and directory != self._log_dir:
                from tpu3fs_torch.analytics.trace import StructuredTraceLog

                self._log = StructuredTraceLog("spans", directory,
                                               flush_rows=flush_rows)
                self._log_dir = directory
            if memory is not None:
                self._mem_cap = MEMORY_CAP if memory else 0
                if not memory:
                    self._mem, self._mem_dropped = [], 0
            has_sink = self._log is not None or self._mem_cap > 0
            if enabled is not None:
                self.enabled = bool(enabled) and has_sink
            elif has_sink:
                self.enabled = True
        return self

    def apply_config(self, cfg: TraceConfig, *, service: str,
                     node: int) -> None:
        """Bind a TraceConfig section (and follow its hot updates)."""
        def _apply(_node=None):
            self.configure(
                service=service, node=node,
                directory=(cfg.dir or None),
                sample_rate=cfg.sample_rate, slow_op_ms=cfg.slow_op_ms,
                enabled=bool(cfg.enabled) and bool(cfg.dir),
                flush_rows=int(cfg.flush_rows))

        _apply()
        cfg.add_callback(_apply)

    def add_slow_hook(self, fn) -> None:
        """Register fn(events) to run on every slow-op flush (idempotent
        for the same callable — N apps in one process hook once)."""
        if fn not in self._slow_hooks:
            self._slow_hooks.append(fn)

    def flush(self) -> None:
        log = self._log
        if log is not None:
            log.flush()

    def drain(self) -> Tuple[List[SpanEvent], int]:
        """-> (the events the in-memory sink holds, the events it dropped
        at its cap), both taken and reset."""
        with self._lock:
            events, self._mem = self._mem, []
            dropped, self._mem_dropped = self._mem_dropped, 0
        return events, dropped

    @property
    def span_paths(self) -> List[str]:
        log = self._log
        if log is None:
            return []
        return list(log.paths)

    # -- emission ----------------------------------------------------------
    def start_trace(self, force: bool = False) -> Optional[TraceContext]:
        """Head decision for an op with no inbound context. Returns None
        when tracing is off for this process (the zero-overhead path)."""
        if not self.enabled:
            return None
        tid = _new_id()
        return TraceContext(tid, _new_id(),
                            sampled=sampled_of(tid, self.sample_rate),
                            slow=force)

    def _flush_events(self, events: Sequence[SpanEvent],
                      slow: bool) -> None:
        if slow:
            for ev in events:
                ev.slow = True
        log = self._log
        if log is not None:
            for ev in events:
                # SpanEvent is flat: its __dict__ IS the columnar row (skips
                # the per-event reflection walk on the flush path)
                log.append_row(dict(ev.__dict__))
        if self._mem_cap:
            with self._lock:
                room = max(0, self._mem_cap - len(self._mem))
                self._mem.extend(events[:room])
                self._mem_dropped += max(0, len(events) - room)

    def end_op(self, ctx: TraceContext, op: str, ts: float, dur_s: float,
               *, code: int = 0, nbytes: int = 0,
               tclass: str = "", tenant: str = "", t_ns: int = 0) -> None:
        """Append the op span for a NESTED op (the flush decision belongs
        to whichever op owns the accumulator — the process root). An
        empty tenant resolves from the ambient scope, so every op span
        carries its owner without each call site threading it."""
        if not tenant:
            from tpu3fs_torch.tenant.identity import current_tenant

            tenant = current_tenant() or ""
        ctx.events.append(SpanEvent(
            trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_id=ctx.parent_id, service=self.service, node=self.node,
            op=op, stage="", ts=ts, dur_us=dur_s * 1e6, code=code,
            nbytes=nbytes, tclass=tclass, tenant=tenant,
            sampled=ctx.sampled, t_ns=t_ns))

    def finish_op(self, ctx: TraceContext, op: str, ts: float,
                  dur_s: float, *, code: int = 0, nbytes: int = 0,
                  tclass: str = "", tenant: str = "", t_ns: int = 0) -> None:
        """Emit the op span and make the flush-or-drop decision for every
        event the op accumulated in this process."""
        self.end_op(ctx, op, ts, dur_s, code=code, nbytes=nbytes,
                    tclass=tclass, tenant=tenant, t_ns=t_ns)
        is_slow = ctx.slow or dur_s * 1e6 >= self.slow_op_us
        if is_slow and self._slow_hooks:
            for hook in self._slow_hooks:
                try:
                    hook(list(ctx.events))
                except Exception:
                    pass  # a black-box feed must never fail the op
        if ctx.sampled or is_slow:
            self._flush_events(ctx.events, is_slow and not ctx.sampled)
        ctx.events.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


# -- context propagation ------------------------------------------------------

_trace_var: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("tpu3fs_trace_ctx", default=None)

# the update worker's coalesced round may serve SEVERAL traces in one
# engine crossing; stage spans fan out to all of them (each op genuinely
# experienced the full round's stage wall time)
_round_var: contextvars.ContextVar[Optional[Tuple[TraceContext, ...]]] = \
    contextvars.ContextVar("tpu3fs_trace_round", default=None)


def current_trace() -> Optional[TraceContext]:
    return _trace_var.get()


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    token = _trace_var.set(ctx)
    try:
        yield ctx
    finally:
        _trace_var.reset(token)


@contextlib.contextmanager
def round_scope(ctxs: Sequence[TraceContext]):
    """Scope of one coalesced update round: stage spans address every
    member trace; downstream RPCs (chain forward) propagate the first."""
    ctxs = tuple(ctxs)
    tok_r = _round_var.set(ctxs if ctxs else None)
    tok_t = _trace_var.set(ctxs[0] if ctxs else None)
    try:
        yield
    finally:
        _round_var.reset(tok_r)
        _trace_var.reset(tok_t)


def round_traces() -> Tuple[TraceContext, ...]:
    """Traces the current update round serves: the round scope's set, or
    the single current context, or ()."""
    ctxs = _round_var.get()
    if ctxs is not None:
        return ctxs
    ctx = _trace_var.get()
    return (ctx,) if ctx is not None else ()


# -- emission helpers ---------------------------------------------------------


def add_span(ctx: Optional[TraceContext], op: str, stage: str, ts: float,
             dur_s: float, *, code: int = 0, nbytes: int = 0,
             t_ns: int = 0) -> None:
    """Append one already-measured stage span to a context (no-op on
    None): the storage pipeline measures its stage/forward/commit walls
    anyway — tracing reuses those numbers instead of re-clocking."""
    if ctx is None:
        return
    t = _TRACER
    ctx.events.append(SpanEvent(
        trace_id=ctx.trace_id, span_id=_new_id(), parent_id=ctx.span_id,
        service=t.service, node=t.node, op=op, stage=stage, ts=ts,
        dur_us=dur_s * 1e6, code=code, nbytes=nbytes,
        sampled=ctx.sampled, t_ns=t_ns))


def add_span_multi(ctxs: Sequence[TraceContext], op: str, stage: str,
                   ts: float, dur_s: float, *, code: int = 0,
                   nbytes: int = 0) -> None:
    for ctx in ctxs:
        add_span(ctx, op, stage, ts, dur_s, code=code, nbytes=nbytes)


class _Off:
    """The span of an untraced block: one shared object, no clock read."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """A traced block's stage span, clocked at entry and at exit."""

    __slots__ = ("ctx", "op", "stage", "nbytes", "ts", "t0")

    def __init__(self, ctx: TraceContext, op: str, stage: str, nbytes: int):
        self.ctx, self.op, self.stage, self.nbytes = ctx, op, stage, nbytes

    def __enter__(self) -> TraceContext:
        self.ts = time.time()
        self.t0 = time.perf_counter_ns()
        return self.ctx

    def __exit__(self, *exc) -> bool:
        add_span(self.ctx, self.op, self.stage, self.ts,
                 (time.perf_counter_ns() - self.t0) / 1e9,
                 nbytes=self.nbytes, t_ns=self.t0)
        return False


def span(op: str, stage: str, *, nbytes: int = 0):
    """Clock a block as a stage span under the current context (no-op —
    not even a clock read or a new object — when untraced)."""
    ctx = _trace_var.get()
    return _OFF if ctx is None else _Span(ctx, op, stage, nbytes)


class _OpSpan:
    """A client op's span over a block that runs under its context: a
    nested op's ends under the outer op; a root's makes the flush-or-drop
    decision for the whole op."""

    __slots__ = ("ctx", "op", "nbytes", "nested", "ts", "t0", "token")

    def __init__(self, ctx: TraceContext, op: str, nbytes: int,
                 nested: bool):
        self.ctx, self.op, self.nbytes, self.nested = ctx, op, nbytes, nested

    def __enter__(self) -> TraceContext:
        self.ts = time.time()
        self.t0 = time.perf_counter_ns()
        self.token = _trace_var.set(self.ctx)
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        _trace_var.reset(self.token)
        end = _TRACER.end_op if self.nested else _TRACER.finish_op
        end(self.ctx, self.op, self.ts,
            (time.perf_counter_ns() - self.t0) / 1e9,
            code=0 if exc_type is None else -1, nbytes=self.nbytes,
            t_ns=self.t0)
        return False


def root_span(op: str, *, nbytes: int = 0, force: bool = False):
    """Client-side op boundary: joins the current trace when one is
    active (a nested client op: its span parents to the outer op's, and
    the spans inside it parent to it), otherwise head-starts a trace —
    sampling decision, envelope stamping downstream, flush-or-drop at
    exit (incl. slow-op capture). Entering yields the context or None."""
    outer = _trace_var.get()
    if outer is not None:
        return _OpSpan(outer.child(), op, nbytes, nested=True)
    ctx = _TRACER.start_trace(force=force)
    return _OFF if ctx is None else _OpSpan(ctx, op, nbytes, nested=False)
