"""The port's windowed aggregation (``tpu3fs_torch.monitor.agg``), SLO
engine (``monitor.slo``) and collector service (``monitor.collector``)
against the JAX package's.

``FixedDigest`` and ``WindowedAggregator`` fed the same seeded samples
give equal quantiles and ``AggRow``s; ``parse_slo_spec`` gives equal rules
and equal errors; ``SloEngine`` on a fake clock walks the same states and
transitions; and a port ``CollectorService`` and a JAX one, each on its
own package's ``RpcServer`` over loopback, answer the same pushes with
equal ``write``, ``aggQuery`` and ``sloStatus`` replies (the reply's
evaluation wall-clock stamp zeroed), to either package's client. Each
package's ``SloGate`` reads the other's collector. Tolerance 0."""

import importlib

import numpy as np
import pytest

PKGS = ("tpu3fs", "tpu3fs_torch")
T0 = 1_800_000_000.0


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def dist_sample(pkg, name, ts, value, tags=None):
    Sample = mod(pkg, "monitor.recorder").Sample
    return Sample(name, ts, tags or {}, value=value, count=1, min=value,
                  max=value, mean=value, p50=value, p90=value, p99=value)


def seeded_samples(pkg, seed: int, n: int = 600):
    """Distribution, counter and gauge samples on three nodes over 120 s."""
    Sample = mod(pkg, "monitor.recorder").Sample
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = T0 + float(rng.uniform(0, 120))
        node = str(int(rng.integers(1, 4)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(dist_sample(pkg, "storage.read.latency_us", ts,
                                   float(rng.lognormal(6, 1.2)),
                                   {"node": node}))
        elif kind == 1:
            n_ops = int(rng.integers(1, 50))
            out.append(Sample("serving.peer_hits", ts, {"node": node},
                              value=float(n_ops), count=n_ops))
        else:
            out.append(Sample("memory.rss_kb", ts, {"node": node},
                              value=float(rng.integers(1000, 9000)),
                              count=1))
    return out


def _rows(pkg, rows):
    serde = mod(pkg, "rpc.serde")
    return [serde.serialize(r) for r in rows]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_and_aggregator_rows_equal(seed):
    got = {}
    for pkg in PKGS:
        agg_mod = mod(pkg, "monitor.agg")
        rng = np.random.default_rng(seed)
        d, half, rest = (agg_mod.FixedDigest() for _ in range(3))
        for i, v in enumerate(rng.lognormal(8.0, 1.5, 2000)):
            d.add(float(v))
            (half if i % 2 else rest).add(float(v))
        half.merge(rest)
        qs = [(d.quantile(q), half.quantile(q)) for q in (0.5, 0.9, 0.99)]
        agg = agg_mod.WindowedAggregator(bucket_s=2.0, slots=40,
                                         max_series=6)
        agg.ingest(seeded_samples(pkg, seed))
        queries = [
            agg.query("storage.read.latency_us", None, 60.0, until=T0 + 120),
            agg.query("serving.", {"node": "2"}, 30.0, until=T0 + 100,
                      prefix=True),
            agg.query("", None, 200.0, until=T0 + 130),
            agg.query("memory.rss_kb", None, 10.0, until=T0 + 60),
        ]
        got[pkg] = (qs, [_rows(pkg, q) for q in queries], agg.stats())
    assert got["tpu3fs_torch"] == got["tpu3fs"]
    assert any(got["tpu3fs"][1])


GOOD = ("rule=a,metric=x.y,agg=p99,max=5,fast_s=5,slow_s=20,for_s=2,"
        "severity=critical,node=101;rule=b,metric=x.y,absent_s=30;"
        "rule=c,metric=serving.peer_hits,agg=rate,min=1,fast_s=10,slow_s=30")
BAD = [
    "rule=a,metric=x.y",
    "rule=a,metric=bad-name,max=1",
    "rule=Bad!,metric=x.y,max=1",
    "rule=a,metric=x.y,agg=nope,max=1",
    "rule=a,metric=x.y,max=1,fast_s=10,slow_s=5",
    "rule=a,metric=x.y,max=1;rule=a,metric=x.y,max=2",
    "rule=a,metric=x.y,max=1,bogus=2",
    "rule=a,metric=x.y,max=1,severity=wat",
]


@pytest.mark.parametrize("spec", [GOOD] + BAD,
                         ids=["good"] + [f"bad{i}" for i in range(len(BAD))])
def test_parse_slo_spec_equal_rules_and_errors(spec):
    got = {}
    for pkg in PKGS:
        try:
            rules = mod(pkg, "monitor.slo").parse_slo_spec(spec)
        except ValueError as e:
            got[pkg] = ("error", str(e))
        else:
            got[pkg] = {name: vars(r) for name, r in rules.items()}
    assert got["tpu3fs_torch"] == got["tpu3fs"]
    assert (spec == GOOD) == isinstance(got["tpu3fs"], dict)


class _Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def _engine_walk(pkg: str) -> list:
    agg = mod(pkg, "monitor.agg").WindowedAggregator(bucket_s=1.0,
                                                     slots=600)
    clock = _Clock()
    eng = mod(pkg, "monitor.slo").SloEngine(agg, now_fn=clock)
    eng.configure("rule=lat,metric=storage.read.latency_us,agg=p99,max=1000,"
                  "fast_s=5,slow_s=20,for_s=2;rule=alive,metric=hb.n,"
                  "absent_s=10")
    fired = []
    eng.add_firing_callback(lambda st: fired.append(st.rule))
    serde = mod(pkg, "rpc.serde")
    states = []
    for step, (dt, value) in enumerate([(1, 100.0)] * 5 + [
            (0, 50_000.0), (3, 50_000.0), (6, 100.0), (21, 100.0),
            (1, 100.0)]):
        clock.t += dt
        agg.ingest([dist_sample(pkg, "storage.read.latency_us", clock.t,
                                value, {"node": "1"})])
        if step < 3:
            agg.ingest([mod(pkg, "monitor.recorder").Sample(
                "hb.n", clock.t, {}, value=1.0, count=1)])
        snap = eng.evaluate()
        states.append({k: serde.serialize(v) for k, v in sorted(
            snap.items())})
        states.append(eng.health()[0])
    return [states, [serde.serialize(t) for t in eng.transitions], fired]


def test_slo_engine_transitions_equal():
    got = {pkg: _engine_walk(pkg) for pkg in PKGS}
    assert got["tpu3fs_torch"] == got["tpu3fs"]
    assert got["tpu3fs"][2]  # a rule fired


class Collector:
    """One package's CollectorService (aggregator + SLO engine on a fake
    clock) on an RpcServer of that package."""

    def __init__(self, pkg: str, clock):
        self.agg = mod(pkg, "monitor.agg").WindowedAggregator(bucket_s=1.0,
                                                              slots=300)
        self.slo = mod(pkg, "monitor.slo").SloEngine(self.agg, now_fn=clock)
        self.slo.configure("rule=shed,metric=qos.shed,agg=rate,max=1,"
                           "fast_s=10,slow_s=20")
        col = mod(pkg, "monitor.collector")
        self.svc = col.CollectorService(
            mod(pkg, "monitor.recorder").MemorySink(), aggregator=self.agg,
            slo=self.slo)
        self.server = mod(pkg, "rpc.net").RpcServer(port=0)
        col.bind_collector_service(self.server, self.svc)
        self.server.start()
        self.addr = ("127.0.0.1", self.server.port)

    def stop(self):
        self.server.stop()


def _collector_calls(client_pkg: str, addr, clock) -> list:
    """write, aggQuery and sloStatus over RPC with ``client_pkg``'s types
    and client -> serialised replies."""
    col = mod(client_pkg, "monitor.collector")
    Sample = mod(client_pkg, "monitor.recorder").Sample
    serde = mod(client_pkg, "rpc.serde")
    cli = mod(client_pkg, "rpc.net").RpcClient()
    sid = col.COLLECTOR_SERVICE_ID
    out = []
    try:
        batch = col.SampleBatch(seeded_samples(client_pkg, 5, 200))
        out.append(cli.call(addr, sid, 1, batch, col.Ack))
        for req in (col.AggQueryReq(name="storage.read.latency_us",
                                    window_s=60.0, until=T0 + 120),
                    col.AggQueryReq(name="serving.", tags={"node": "1"},
                                    window_s=120.0, until=T0 + 120,
                                    prefix=True)):
            out.append(cli.call(addr, sid, 3, req, col.AggQueryRsp))
        out.append(cli.call(addr, sid, 4, col.SloStatusReq(),
                            col.SloStatusRsp))
        clock.t = T0 + 121
        out.append(cli.call(addr, sid, 1, col.SampleBatch([Sample(
            "qos.shed", T0 + 120.5, {"class": "fg"}, value=100.0,
            count=100)]), col.Ack))
        out.append(cli.call(addr, sid, 4, col.SloStatusReq(),
                            col.SloStatusRsp))
        out.append(cli.call(addr, sid, 1, col.SampleBatch([]), col.Ack))
    finally:
        cli.close()
    for rsp in out:
        if hasattr(rsp, "evaluated_ts"):
            rsp.evaluated_ts = 0.0
    return [serde.serialize(r) for r in out]


@pytest.mark.parametrize("client", PKGS, ids=["jax-client", "port-client"])
def test_collectors_answer_equal(client):
    got = {}
    for pkg in PKGS:
        clock = _Clock(T0 + 120)
        c = Collector(pkg, clock)
        try:
            got[pkg] = _collector_calls(client, c.addr, clock)
            got[pkg].append(c.svc.dump_epoch)
        finally:
            c.stop()
    assert got["tpu3fs_torch"] == got["tpu3fs"]
    assert got["tpu3fs"][-1] == 1   # the firing rule bumped the epoch


@pytest.mark.parametrize("gate_pkg,server_pkg", [("tpu3fs", "tpu3fs_torch"),
                                                 ("tpu3fs_torch", "tpu3fs")],
                         ids=["jax-gate-port-collector",
                              "port-gate-jax-collector"])
def test_slo_gate_reads_the_other_package(gate_pkg, server_pkg):
    clock = _Clock(T0 + 120)
    c = Collector(server_pkg, clock)
    try:
        slo = mod(gate_pkg, "monitor.slo")
        gate = slo.SloGate(f"127.0.0.1:{c.server.port}")
        assert "OK" in gate.assert_ok()
        Sample = mod(server_pkg, "monitor.recorder").Sample
        c.svc.write(mod(server_pkg, "monitor.collector").SampleBatch([Sample(
            "qos.shed", T0 + 119.5, {"class": "fg"}, value=100.0,
            count=100)]))
        with pytest.raises(slo.SloGateError, match="shed"):
            gate.assert_ok()
        assert gate.check(rules=["nope"])[0]
    finally:
        c.stop()
