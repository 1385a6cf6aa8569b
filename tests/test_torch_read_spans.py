"""The port's spans on the degraded read, on the CPU: the span substrate's
``t_ns`` (the start on ``time.perf_counter_ns``, the clock a device trace
is put on) and its bounded in-memory sink; a degraded read with tracing
off, which makes no span and reads no clock in the substrate; and a
degraded read over the in-process fabric at RS(12,4) with one storage node
down, which emits every stage of the read path once a stripe under the
right parent, counts its shard bytes in ``ec.read_shard_bytes`` and
records the same interval in ``ec.degraded_read_ms`` on both client paths.
"""

import time
from collections import Counter

import numpy as np
import pytest

from tpu3fs_torch.analytics import spans
from tpu3fs_torch.fabric.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.monitor.recorder import CounterRecorder, Monitor

K, M, S = 12, 4, 4096
STRIPE = K * S


@pytest.fixture
def tracer():
    """A fresh process tracer (the real one is a process global)."""
    old = spans._TRACER
    spans._TRACER = spans.Tracer()
    try:
        yield spans._TRACER
    finally:
        spans._TRACER = old


# -- the substrate ---------------------------------------------------------------
def test_t_ns_lies_between_perf_counter_ns_readings(tracer):
    tracer.configure(memory=True, sample_rate=1.0)
    a = time.perf_counter_ns()
    with spans.root_span("client.op"):
        b = time.perf_counter_ns()
        with spans.span("client.op", "stage"):
            time.sleep(0.002)
        c = time.perf_counter_ns()
    d = time.perf_counter_ns()
    events, dropped = tracer.drain()
    assert dropped == 0
    by_stage = {ev.stage: ev for ev in events}
    op, st = by_stage[""], by_stage["stage"]
    assert a <= op.t_ns <= b <= st.t_ns
    assert st.t_ns + st.dur_us * 1e3 <= c + 1
    assert op.t_ns + op.dur_us * 1e3 <= d + 1
    assert st.dur_us >= 2000
    # the wall clock stays for the cross-process join
    assert abs(op.ts - time.time()) < 60


def test_add_span_and_end_op_take_t_ns(tracer):
    tracer.configure(memory=True, sample_rate=1.0)
    ctx = tracer.start_trace()
    spans.add_span(ctx, "x.op", "stage", 1.0, 0.5, t_ns=123)
    tracer.finish_op(ctx, "x.op", 1.0, 1.0, t_ns=100)
    events, _ = tracer.drain()
    assert sorted(ev.t_ns for ev in events) == [100, 123]


def _ops(n, stages=1):
    for _ in range(n):
        with spans.root_span("client.op"):
            for _ in range(stages):
                with spans.span("client.op", "stage"):
                    pass


@pytest.mark.parametrize("cap, ops, kept, dropped",
                         [(100, 3, 6, 0), (6, 3, 6, 0), (4, 3, 4, 2),
                          (1, 5, 1, 9)])
def test_memory_sink_keeps_drains_and_drops_at_its_cap(tracer, monkeypatch,
                                                       cap, ops, kept,
                                                       dropped):
    monkeypatch.setattr(spans, "MEMORY_CAP", cap)
    tracer.configure(memory=True, sample_rate=1.0)
    assert tracer.enabled  # on with no directory
    _ops(ops)
    events, n_dropped = tracer.drain()
    assert (len(events), n_dropped) == (kept, dropped)
    assert all(isinstance(ev, spans.SpanEvent) for ev in events)
    assert tracer.drain() == ([], 0)  # drained
    _ops(1)
    assert len(tracer.drain()[0]) == min(cap, 2)  # room again


def test_memory_sink_follows_the_flush_decision(tracer):
    # sampling 0: an op under the slow threshold is dropped, a slow one kept
    tracer.configure(memory=True, sample_rate=0.0, slow_op_ms=50)
    _ops(2)
    assert tracer.drain() == ([], 0)
    with spans.root_span("client.slow"):
        time.sleep(0.06)
    events, _ = tracer.drain()
    assert [(ev.op, ev.slow) for ev in events] == [("client.slow", True)]


def test_memory_sink_receives_what_the_file_sink_does(tracer, tmp_path):
    from tpu3fs_torch.analytics import assemble

    tracer.configure(memory=True, sample_rate=1.0, directory=str(tmp_path))
    _ops(3, stages=2)
    tracer.flush()
    events, _ = tracer.drain()
    rows = assemble.load_spans([str(tmp_path)])
    key = ("span_id", "parent_id", "op", "stage", "t_ns", "dur_us")
    assert sorted(tuple(r[k] for k in key) for r in rows) == sorted(
        tuple(getattr(ev, k) for k in key) for ev in events)
    assert len(events) == 9


def test_memory_sink_off_discards_and_disables(tracer):
    tracer.configure(memory=True, sample_rate=1.0)
    _ops(1)
    tracer.configure(memory=False, enabled=False)
    assert not tracer.enabled
    assert tracer.drain() == ([], 0)
    _ops(1)
    assert tracer.drain() == ([], 0)


def test_nested_op_parents_its_own_spans(tracer):
    tracer.configure(memory=True, sample_rate=1.0)
    with spans.root_span("client.outer"):
        with spans.root_span("client.inner"):
            with spans.span("client.inner", "stage"):
                pass
    events, _ = tracer.drain()
    by = {(ev.op, ev.stage): ev for ev in events}
    outer, inner = by["client.outer", ""], by["client.inner", ""]
    assert inner.parent_id == outer.span_id
    assert by["client.inner", "stage"].parent_id == inner.span_id
    assert len({ev.trace_id for ev in events}) == 1


def test_counter_total_survives_collect():
    c = CounterRecorder("test.read_spans_total", monitor=Monitor())
    c.add(3)
    assert [s.value for s in c.collect(0.0)] == [3.0]
    c.add(2)
    assert c.collect(1.0)[0].value == 2.0
    assert c.collect(2.0) == []
    assert c.total == 5


# -- the degraded read -----------------------------------------------------------
@pytest.fixture(scope="module")
def degraded():
    """An RS(12,4) chain of 16 nodes holding one file of 2 stripes, with
    the node of data shard 0 down: every stripe read decodes."""
    fab = Fabric(SystemSetupConfig(num_storage_nodes=K + M, num_chains=1,
                                   chunk_size=STRIPE, ec_k=K, ec_m=M,
                                   engine="mem"), device="cpu")
    data = np.random.default_rng(22).integers(
        0, 256, 2 * STRIPE, dtype=np.uint8).tobytes()
    res = fab.meta.create("/f", flags=OpenFlags.WRITE | OpenFlags.CREATE,
                          client_id="t")
    fio = fab.file_client()
    fio.write(res.inode, 0, data)
    fab.meta.close(res.inode.id, res.session_id, length_hint=len(data),
                   wrote=True)
    fio.close()
    inode = fab.meta.stat("/f")
    chain = fab.routing().chains[fab.chain_ids[0]]
    fab.fail_node(fab.routing().node_of_target(
        chain.target_of_shard(0).target_id).node_id)
    yield fab, inode, data
    fab.close()


def _read_traced(fab, inode, size, tracer, batch=False):
    tracer.configure(memory=True, sample_rate=1.0)
    fio = fab.file_client()
    try:
        if batch:
            got = fio.batch_read_files([(inode, 0, size)])[0]
        else:
            got = fio.read(inode, 0, size)
        events, dropped = tracer.drain()
        return fio, got, events, dropped
    finally:
        fio.close()


STRIPE_STAGES = [("client.read_stripe", "fetch"),
                 ("client.read_stripe", "fetch_degraded"),
                 ("ec.decode", "gather"), ("ec.decode", "h2d"),
                 ("ec.decode", "launch"), ("ec.decode", "d2h"),
                 ("client.read_stripe", "assemble")]


def test_degraded_read_emits_each_stage_once_a_stripe(degraded, tracer):
    fab, inode, data = degraded
    fio, got, events, dropped = _read_traced(fab, inode, len(data), tracer)
    assert got == data and dropped == 0
    n = Counter((ev.op, ev.stage) for ev in events)
    stripes = len(data) // STRIPE
    assert n["client.read", ""] == 1 and n["client.read", "assemble"] == 1
    assert n["client.read_stripe", ""] == stripes
    for key in STRIPE_STAGES:
        assert n[key] == stripes, key
    # one server batch a live node a round: 11 data shards, then 4 parity
    assert n["storage.batch_read", "admit"] == (K - 1 + M) * stripes
    assert n["storage.batch_read", "engine"] == (K - 1 + M) * stripes
    assert len({ev.trace_id for ev in events}) == 1
    # parents: the call's root, each stripe's op under it, every other
    # stage under its stripe's op (the servers run on the reader's thread)
    root = next(ev for ev in events if (ev.op, ev.stage) == ("client.read",
                                                              ""))
    stripe_ops = {ev.span_id: ev for ev in events
                  if (ev.op, ev.stage) == ("client.read_stripe", "")}
    assert all(ev.parent_id == root.span_id for ev in stripe_ops.values())
    for ev in events:
        if ev.stage and ev.op != "client.read":
            assert ev.parent_id in stripe_ops, (ev.op, ev.stage)
        elif ev.stage:
            assert ev.parent_id == root.span_id
    # one clock: every stripe's stages lie inside its op span, in order
    for sid, op in stripe_ops.items():
        mine = {(ev.op, ev.stage): ev for ev in events
                if ev.parent_id == sid and ev.op != "storage.batch_read"}
        end = op.t_ns + op.dur_us * 1e3 + 1
        starts = [mine[key].t_ns for key in STRIPE_STAGES]
        assert starts == sorted(starts)
        assert op.t_ns <= starts[0] and all(
            mine[key].t_ns + mine[key].dur_us * 1e3 <= end
            for key in STRIPE_STAGES)


def test_server_stages_nest_inside_the_fetches(degraded, tracer):
    fab, inode, data = degraded
    _, _, events, _ = _read_traced(fab, inode, STRIPE, tracer)
    fetches = [(ev.t_ns, ev.t_ns + ev.dur_us * 1e3) for ev in events
               if ev.stage in ("fetch", "fetch_degraded")]
    server = [ev for ev in events if ev.op == "storage.batch_read"]
    assert len(fetches) == 2 and len(server) == 2 * (K - 1 + M)
    for ev in server:
        assert any(a <= ev.t_ns and ev.t_ns + ev.dur_us * 1e3 <= b + 1
                   for a, b in fetches)


@pytest.mark.parametrize("batch", [False, True], ids=["read", "batch_read"])
def test_read_shard_bytes_counts_fifteen_shards_a_stripe(degraded, tracer,
                                                         batch):
    fab, inode, data = degraded
    fio, got, events, _ = _read_traced(fab, inode, len(data), tracer,
                                       batch=batch)
    assert got == data
    stripes = len(data) // STRIPE
    assert fio.storage._ec_read_shard_bytes.total == (K - 1 + M) * S * \
        stripes
    n = Counter((ev.op, ev.stage) for ev in events)
    op = "client.batch_read" if batch else "client.read_stripe"
    fetches = 1 if batch else stripes  # the batch fetches all at once
    assert n[op, "fetch"] == fetches and n[op, "fetch_degraded"] == fetches
    assert n["ec.decode", "h2d"] == stripes


@pytest.mark.parametrize("batch", [False, True], ids=["read", "batch_read"])
def test_degraded_read_ms_is_the_fetch_plus_the_decode(degraded, tracer,
                                                       batch):
    """Both client paths record, once a degraded stripe, the survivors'
    fetch plus the stripe's decode: no less than those spans, no more than
    the stripe's whole read."""
    fab, inode, data = degraded
    fio, got, events, _ = _read_traced(fab, inode, STRIPE, tracer,
                                       batch=batch)
    assert got == data[:STRIPE]
    dist = fio.storage._ec_degraded_ms
    assert fio.storage._ec_degraded.total == 1 and dist._count == 1
    dur = {(ev.op, ev.stage): ev.dur_us / 1e3 for ev in events}
    op = "client.batch_read" if batch else "client.read_stripe"
    least = dur[op, "fetch_degraded"] + sum(
        dur["ec.decode", st] for st in ("gather", "h2d", "launch", "d2h"))
    assert least <= dist._sum <= dur[op, ""]


@pytest.mark.parametrize("batch", [False, True], ids=["read", "batch_read"])
def test_fetch_stages_leave_stage_coverage_unchanged(degraded, tracer, batch):
    """The fetches contain the servers' stages and the wire: a trace's
    stage coverage reads the same with them as without them."""
    from tpu3fs_torch.analytics import assemble

    fab, inode, data = degraded
    _, got, events, _ = _read_traced(fab, inode, len(data), tracer,
                                     batch=batch)
    assert got == data
    rows = [dict(ev.__dict__) for ev in events]
    fetch = {"fetch", "fetch_degraded"}
    assert any(r["stage"] in fetch for r in rows)
    (tree,) = assemble.assemble_traces(rows).values()
    (bare,) = assemble.assemble_traces(
        [r for r in rows if r["stage"] not in fetch]).values()
    assert tree.root["op"] == ("client.batch_read" if batch
                               else "client.read")
    assert 0.0 < tree.coverage() < 1.0
    assert tree.coverage() == bare.coverage()


def test_tracing_off_makes_no_span_and_reads_no_clock(degraded, tracer,
                                                      monkeypatch):
    fab, inode, data = degraded

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"the span substrate read time.{name}")

    def no_event(*a, **kw):
        raise AssertionError("a SpanEvent was made with tracing off")

    def no_id():
        raise AssertionError("a span id was drawn with tracing off")

    assert not tracer.enabled
    monkeypatch.setattr(spans, "time", NoClock())
    monkeypatch.setattr(spans, "SpanEvent", no_event)
    monkeypatch.setattr(spans, "_new_id", no_id)
    fio = fab.file_client()
    try:
        assert fio.read(inode, 0, len(data)) == data
        assert fio.batch_read_files([(inode, 0, len(data))])[0] == data
        assert fio.storage._ec_degraded.total == 4
    finally:
        fio.close()
    assert tracer.drain() == ([], 0)
