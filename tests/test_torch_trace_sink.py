"""The trace sink and the trace assembler on the CPU, each case run over both
packages (the JAX package's ``tpu3fs.analytics.{trace,assemble}`` and the
port's copies), and over both writers: Parquet (``pyarrow`` imports here)
and the NPZ container, forced as ``tests/test_analytics.py`` forces it.
The cases of ``tests/test_analytics.py`` (columnar round trips, the serde
object stream, the rotating log, a fabric write's ``StorageEventTrace``
rows through ``set_trace_log``) and ``tests/test_trace.py``'s assembler
(a join across two processes' span files, coverage without the container
stages, stage and tenant percentiles, the top view) and flight files.
``read_records`` must return the same rows from either writer and either
package, the span sink (``Tracer.configure(directory=...)``) the same
trees, and a CR write the same storage-event rows. Then the port's own
addition: an EC file's shard writes leave a row each. Tolerance 0."""

import dataclasses
import enum
import importlib
import json
import tempfile
from types import SimpleNamespace

import pytest

PACKAGES = ["tpu3fs", "tpu3fs_torch"]
FORMATS = ["parquet", "npz"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("trace", "analytics.trace"), ("assemble", "analytics.assemble"),
        ("spans", "analytics.spans"), ("fabric", "fabric.fabric"),
        ("meta", "meta.store"), ("craq", "storage.craq"),
        ("tenant", "tenant.identity"))}
    pkg = SimpleNamespace(**mods)
    pkg.dev = {"device": "cpu"} if root == "tpu3fs_torch" else {}
    return pkg


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture(params=FORMATS)
def fmt(request, pkg, monkeypatch):
    """The writer: Parquet (pyarrow imports here), or NPZ with pyarrow
    hidden."""
    if request.param == "npz":
        monkeypatch.setattr(pkg.trace, "_pa", None)
        monkeypatch.setattr(pkg.trace, "_pq", None)
    return "." + request.param


@pytest.fixture
def tracer(pkg):
    """A fresh process tracer (the real one is a process global)."""
    old = pkg.spans._TRACER
    pkg.spans._TRACER = pkg.spans.Tracer()
    try:
        yield pkg.spans._TRACER
    finally:
        pkg.spans._TRACER = old


class Kind(enum.IntEnum):
    READ = 1
    WRITE = 2


@dataclasses.dataclass
class Inner:
    x: int = 0
    y: float = 0.0


@dataclasses.dataclass
class Event:
    name: str = ""
    kind: Kind = Kind.READ
    ok: bool = True
    payload: bytes = b""
    inner: Inner = dataclasses.field(default_factory=Inner)


ROWS = [{"a": 3, "b": 1.25, "c": "s", "d": False, "e": b"\x01\xff"},
        {"a": -7, "b": -2.0, "c": "", "d": True, "e": b""},
        {"a": 1 << 40, "b": 0.5, "c": "té", "d": True, "e": b"\x00"}]


# -- columnar ------------------------------------------------------------------
def test_write_read_round_trip(pkg, fmt, tmp_path):
    path = pkg.trace.write_records(str(tmp_path / "t"), ROWS)
    assert path.endswith(fmt)
    assert pkg.trace.read_records(path) == ROWS


def test_missing_keys_read_back(pkg, fmt, tmp_path):
    path = pkg.trace.write_records(str(tmp_path / "t"), [{"a": 1},
                                                          {"b": "x"}])
    back = pkg.trace.read_records(path)
    assert back[0]["a"] == 1 and back[1]["a"] in (0, None)
    assert back[0]["b"] in ("", None) and back[1]["b"] == "x"


@pytest.mark.parametrize("writer", PACKAGES)
@pytest.mark.parametrize("reader", PACKAGES)
def test_both_writers_and_packages_give_the_same_rows(writer, reader,
                                                      tmp_path, monkeypatch):
    w, r = _pkg(writer), _pkg(reader)
    got = {}
    for fmt in FORMATS:
        if fmt == "npz":
            monkeypatch.setattr(w.trace, "_pa", None)
            monkeypatch.setattr(w.trace, "_pq", None)
        path = w.trace.write_records(str(tmp_path / fmt), ROWS)
        got[fmt] = r.trace.read_records(path)
    assert got["parquet"] == got["npz"] == ROWS


def test_serde_object_stream_round_trip(pkg, fmt, tmp_path):
    w = pkg.trace.SerdeObjectWriter(str(tmp_path / "ev"), flush_rows=3)
    events = [Event(name=f"e{i}", kind=Kind.WRITE if i % 2 else Kind.READ,
                    ok=bool(i % 3), payload=bytes([i]),
                    inner=Inner(x=i, y=i * 0.5)) for i in range(7)]
    for e in events:
        w.write(e)
    w.close()
    assert len(w.paths) == 3 and all(p.endswith(fmt) for p in w.paths)
    back = pkg.trace.SerdeObjectReader(Event).read(w.paths)
    assert [(b.name, b.kind, b.ok, b.payload, b.inner) for b in back] == [
        (e.name, e.kind, e.ok, e.payload, e.inner) for e in events]


def test_trace_log_rotation_and_disable(pkg, fmt, tmp_path):
    t = pkg.trace.StructuredTraceLog("x", str(tmp_path), flush_rows=2)
    for i in range(5):
        t.append(Inner(x=i))
    t.flush()
    rows = [r for p in t.paths for r in pkg.trace.read_records(p)]
    assert [r["x"] for r in rows] == [0, 1, 2, 3, 4]
    off = pkg.trace.StructuredTraceLog("y", str(tmp_path), enabled=False)
    off.append(Inner(x=1))
    off.flush()
    assert off.paths == []


def test_write_path_emits_storage_event_rows(pkg, fmt, tmp_path):
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
        num_storage_nodes=2, num_chains=1, num_replicas=2, chunk_size=4096),
        **pkg.dev)
    try:
        log = pkg.trace.StructuredTraceLog("storage-event", str(tmp_path),
                                           flush_rows=4)
        for node in fab.nodes.values():
            node.service.set_trace_log(log)
        res = fab.meta.create("/tr", flags=pkg.meta.OpenFlags.WRITE,
                              client_id="c")
        fab.file_client().write(res.inode, 0, b"m" * 9000)  # 3 chunks
        log.flush()
    finally:
        fab.close()
    events = pkg.trace.SerdeObjectReader(pkg.craq.StorageEventTrace).read(
        log.paths)
    # one row a chunk, written at the chain's head
    assert len(events) == 3 and all(p.endswith(fmt) for p in log.paths)
    assert {e.file_id for e in events} == {res.inode.id}
    assert all(e.code == 0 and e.latency_us > 0 for e in events)
    assert sorted((e.chunk_index, e.length) for e in events) == [
        (0, 4096), (1, 4096), (2, 808)]


# -- the span sink ---------------------------------------------------------------
def test_span_sink_writes_a_tree_per_op(pkg, fmt, tracer, tmp_path):
    tracer.configure(service="loader", node=3, directory=str(tmp_path),
                     sample_rate=1.0)
    with pkg.tenant.tenant_scope("team-c"):
        for i in range(3):
            with pkg.spans.root_span("dataload.fetch", nbytes=100 + i):
                with pkg.spans.span("dataload.fetch", "read", nbytes=i):
                    pass
                with pkg.spans.span("dataload.fetch", "collect"):
                    pass
    tracer.flush()
    assert tracer.span_paths and all(p.endswith(fmt)
                                     for p in tracer.span_paths)
    rows = pkg.assemble.load_spans([str(tmp_path)])
    assert len(rows) == 9
    trees = pkg.assemble.assemble_traces(rows)
    assert len(trees) == 3
    for tree in trees.values():
        assert tree.root["op"] == "dataload.fetch"
        assert tree.root["service"] == "loader" and tree.root["node"] == 3
        assert {r["stage"] for r in tree.children[tree.root["span_id"]]} \
            == {"read", "collect"}
        assert tree.tenants() == ["team-c"]
        assert 0.0 <= tree.coverage() <= 1.0
    pct = pkg.assemble.stage_percentiles(rows)
    assert sorted(pct) == ["collect", "read"] and pct["read"]["count"] == 3
    by_tenant = pkg.assemble.tenant_percentiles(rows)
    assert by_tenant["team-c"]["count"] == 3
    assert by_tenant["team-c"]["bytes"] == 100 + 101 + 102


def test_span_sink_rows_equal_across_packages_and_formats(tmp_path,
                                                          monkeypatch):
    shapes = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        for fmt in FORMATS:
            if fmt == "npz":
                monkeypatch.setattr(pkg.trace, "_pa", None)
                monkeypatch.setattr(pkg.trace, "_pq", None)
            d = tmp_path / root / fmt
            t = pkg.spans.Tracer().configure(service="s", node=1,
                                             directory=str(d),
                                             sample_rate=1.0)
            old, pkg.spans._TRACER = pkg.spans._TRACER, t
            try:
                with pkg.spans.root_span("client.read", nbytes=7):
                    with pkg.spans.span("client.read", "stage", nbytes=3):
                        pass
                t.flush()
            finally:
                pkg.spans._TRACER = old
            rows = pkg.assemble.load_spans([str(d)])
            shapes[root, fmt] = sorted(
                (r["op"], r["stage"], r["service"], r["node"], r["nbytes"],
                 r["code"], r["sampled"], r["slow"], bool(r["parent_id"]))
                for r in rows)
    assert len(set(map(tuple, shapes.values()))) == 1
    assert len(shapes["tpu3fs_torch", "npz"]) == 2


# -- the assembler ----------------------------------------------------------------
def _mk(pkg, d, service, node, events):
    t = pkg.spans.Tracer().configure(service=service, node=node,
                                     directory=str(d), sample_rate=1.0)
    for ev in events:
        t._log.append(ev)
    t.flush()


def test_join_across_process_dirs(pkg, fmt, tmp_path):
    ev = pkg.spans.SpanEvent
    tid = "t1" * 8
    root = ev(trace_id=tid, span_id="r" * 16, service="client", node=0,
              op="client.batch_write", ts=100.0, dur_us=1000.0, sampled=True)
    hop = ev(trace_id=tid, span_id="h" * 16, parent_id="r" * 16,
             service="client", node=0, op="rpc.client.3.14", ts=100.0,
             dur_us=900.0, sampled=True)
    srv = ev(trace_id=tid, span_id="s" * 16, parent_id="h" * 16,
             service="storage", node=101, op="rpc.StorageSerde.batch_write",
             ts=100.0, dur_us=800.0, sampled=True)
    st = ev(trace_id=tid, span_id="st" + "a" * 14, parent_id="s" * 16,
            service="storage", node=101, op="storage.update", stage="stage",
            ts=100.0, dur_us=600.0, sampled=True)
    cm = ev(trace_id=tid, span_id="cm" + "a" * 14, parent_id="s" * 16,
            service="storage", node=101, op="storage.update",
            stage="commit", ts=100.0007, dur_us=200.0, sampled=True)
    _mk(pkg, tmp_path / "proc_a", "client", 0, [root, hop])
    _mk(pkg, tmp_path / "proc_b", "storage", 101, [srv, st, cm])
    rows = pkg.assemble.load_spans([str(tmp_path / "proc_a"),
                                    str(tmp_path / "proc_b")])
    assert len(rows) == 5
    trees = pkg.assemble.assemble_traces(rows)
    tree = trees[tid]
    assert len(trees) == 1 and tree.root["span_id"] == "r" * 16
    assert len(tree.services()) == 2
    assert tree.coverage() == pytest.approx(0.8)
    assert "s" * 16 in {r["span_id"] for r in tree.children["h" * 16]}
    text = pkg.assemble.format_trace(tree)
    assert "storage:101" in text and "client:0" in text
    assert "client.batch_write" in pkg.assemble.format_top(trees, rows, n=5,
                                                           by_tenant=True)
    assert pkg.assemble.top_traces(trees, 1) == [tree]


def test_container_stages_excluded_from_coverage(pkg):
    ev = pkg.spans.SpanEvent
    x = "x" * 16
    rows = [ev(trace_id=x, span_id="r" * 16, service="c", op="client.op",
               ts=1.0, dur_us=100.0).__dict__,
            ev(trace_id=x, span_id="a" * 16, parent_id="r" * 16, service="c",
               op="rpc.client", stage="collect", ts=1.0,
               dur_us=95.0).__dict__,
            ev(trace_id=x, span_id="b" * 16, parent_id="r" * 16, service="s",
               node=1, op="storage.update", stage="forward", ts=1.0,
               dur_us=90.0).__dict__,
            ev(trace_id=x, span_id="c" * 16, parent_id="r" * 16, service="s",
               node=1, op="storage.update", stage="stage", ts=1.0,
               dur_us=50.0).__dict__]
    assert pkg.assemble.assemble_traces(rows)[x].coverage() == \
        pytest.approx(0.5)


def test_stage_percentiles(pkg):
    rows = [{"stage": "stage", "dur_us": float(v)} for v in range(100)]
    pct = pkg.assemble.stage_percentiles(rows)["stage"]
    assert (pct["count"], pct["p50_us"], pct["p90_us"], pct["p99_us"]) == (
        100, 50.0, 90.0, 99.0)


def test_load_flight_merges_dumps(pkg, tmp_path):
    for node, ts in ((1, 5.0), (2, 3.0)):
        lines = [{"kind": "meta", "service": "storage", "node": node,
                  "pid": 10 + node, "reason": "test", "events": 1, "ts": 0.0},
                 {"kind": "alert", "rule": "slow", "transition": "firing",
                  "ts": ts}]
        (tmp_path / f"flight-{node}.jsonl").write_text(
            "\n".join(json.dumps(x) for x in lines) + "\n")
    rows = pkg.assemble.load_flight([str(tmp_path)])
    assert [(r["kind"], r["_node"]) for r in rows] == [
        ("meta", 1), ("meta", 2), ("alert", 2), ("alert", 1)]
    text = pkg.assemble.format_flight(rows)
    assert "2 dump(s)" in text and "ALERT slow -> firing" in text


def test_storage_event_rows_equal_across_packages(tmp_path):
    """A CR file's rows (one a chunk, at the head) are the same in both
    packages, but for the clock and the client's name."""
    got = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
            num_storage_nodes=3, num_chains=2, num_replicas=2,
            chunk_size=4096), **pkg.dev)
        try:
            log = pkg.trace.StructuredTraceLog("ev", str(tmp_path / root),
                                               flush_rows=64)
            for node in fab.nodes.values():
                node.service.set_trace_log(log)
            res = fab.meta.create("/cr", flags=pkg.meta.OpenFlags.WRITE,
                                  client_id="c")
            fio = fab.file_client()
            fio.write(res.inode, 0, bytes(range(256)) * 64)
            fio.write(res.inode, 5000, b"\x07" * 3000)
            log.flush()
        finally:
            fab.close()
        got[root] = sorted(
            (r["chain_id"], r["file_id"], r["chunk_index"], r["update_ver"],
             r["code"], r["length"])
            for p in log.paths for r in pkg.trace.read_records(p))
    assert got["tpu3fs_torch"] == got["tpu3fs"]
    assert len(got["tpu3fs"]) == 4 + 1  # 4 chunks, then chunk 1 again


def test_ec_shard_writes_leave_a_row_a_shard():
    """The port's addition: an EC file's shard installs each leave a row
    (the JAX package's log sees CRAQ writes only), so every stripe of the
    file appears in the log."""
    from tpu3fs_torch.analytics.trace import (SerdeObjectReader,
                                              StructuredTraceLog)
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.storage.craq import StorageEventTrace

    with tempfile.TemporaryDirectory() as d:
        fab = Fabric(SystemSetupConfig(num_storage_nodes=6, num_chains=2,
                                       chunk_size=4096, ec_k=4, ec_m=2),
                     device="cpu")
        try:
            log = StructuredTraceLog("ev", d, flush_rows=1024)
            for node in fab.nodes.values():
                node.service.set_trace_log(log)
            res = fab.meta.create("/ec", flags=OpenFlags.WRITE,
                                  client_id="c")
            fab.file_client().write(res.inode, 0, b"\x5a" * (8 * 4096))
            log.flush()
        finally:
            fab.close()
        rows = SerdeObjectReader(StorageEventTrace).read(log.paths)
    installs = [r for r in rows if r.length > 0]
    assert {r.file_id for r in rows} == {res.inode.id}
    assert sorted({r.chunk_index for r in installs}) == list(range(8))
    assert len(installs) == 8 * 6 and all(r.code == 0 for r in rows)
