"""The port's chaos search (``tpu3fs_torch/chaos/search.py``) against the
JAX package's, on the CPU (``device="cpu"``: the port's fabric runs the
plain versions of its kernels): every corpus seed of
``tests/chaos_seeds/`` replays green on the current tree and is caught
with its bug armed, and its ``RunReport`` (events applied and skipped,
writes, acks, reads, each checker's status and messages) equals the JAX
runner's; the oracle's admissible-CRC sets are equal for the CR, EC and
partition seeds; one schedule run twice gives one verdict; the planted
``commit_skip`` is found within the JAX test's budget and shrinks to the
same prefix; ``save_seed``/``replay_seed`` round-trip in a temporary
directory. Tolerance 0."""

import json
import os

import pytest

from tpu3fs.chaos import bugs as jbugs
from tpu3fs.chaos import schedule as jsched
from tpu3fs.chaos import search as jsearch
from tpu3fs.utils.fault_injection import plane as jplane
from tpu3fs_torch.chaos import bugs as tbugs
from tpu3fs_torch.chaos import schedule as tsched
from tpu3fs_torch.chaos import search as tsearch
from tpu3fs_torch.ops.crc32c import crc32c_py
from tpu3fs_torch.utils.fault_injection import plane as tplane

SMALL = dict(steps=20, events=6, storage_nodes=3, num_chains=2,
             num_replicas=2)
CORPUS = jsearch.load_corpus()
PACKAGES = {"jax": (jsched, jsearch, jbugs, {}),
            "torch": (tsched, tsearch, tbugs, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _clean_planes_and_bugs():
    env = os.environ.get("TPU3FS_EC_CHAIN_ENCODE")
    yield
    for pl, b in ((jplane, jbugs), (tplane, tbugs)):
        pl().clear()
        b.disarm()
    assert os.environ.get("TPU3FS_EC_CHAIN_ENCODE") == env


def _report(r) -> tuple:
    return (r.schedule.to_json(), r.events_applied, r.events_skipped,
            r.writes, r.acked, r.reads,
            [(o.checker, o.status, [str(v) for v in o.violations], o.note)
             for o in r.outcomes])


def _both(fn):
    """fn(schedule module, search module, bugs module, kwargs) run over
    the JAX package and the port -> (jax result, port result)."""
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["torch"])


def _corpus(name: str) -> str:
    return next(p for p in CORPUS if os.path.basename(p) == name)


def test_corpus_dir_is_the_repos_corpus():
    assert tsearch.corpus_dir() == jsearch.corpus_dir()
    assert tsearch.load_corpus() == CORPUS and len(CORPUS) == 6
    assert tsearch.corpus_dir("/x") == "/x"


@pytest.mark.parametrize("with_bug", [False, True], ids=["clean", "armed"])
@pytest.mark.parametrize("path", CORPUS, ids=lambda p: os.path.basename(p))
def test_corpus_seed_verdict_and_report_equal_the_jax_runner(path, with_bug):
    want, got = _both(lambda sc, se, b, kw: se.replay_seed(
        path, with_bug=with_bug, **kw))
    assert got[1] == want[1]
    assert _report(got[0]) == _report(want[0])
    report, obj = got
    if with_bug:
        assert set(obj["expect"]) <= set(report.violated_checkers), \
            report.summary()
    else:
        assert not report.violated, report.summary()
    assert report.events_applied + report.events_skipped == \
        len(report.schedule.events)
    assert [o.checker for o in report.outcomes] == \
        sorted(o.checker for o in report.outcomes)


def _oracle(sc, se, b, kw, path):
    with open(path) as f:
        sched = sc.Schedule.from_json(json.dumps(json.load(f)["schedule"]))
    runner = se.FabricRunner(sched, **kw)
    report = runner.run()
    return (runner.oracle, runner.sent, runner.writes_issued, runner.tag,
            _report(report))


@pytest.mark.parametrize("name", ["commit_skip_chain_ack.json",
                                  "chain_parity_skip_hop.json",
                                  "lease_fence_skip_seed100.json"],
                         ids=["cr", "ec", "partition"])
def test_oracle_admissible_sets_equal_the_jax_runner(name):
    path = _corpus(name)
    want, got = _both(lambda *a: _oracle(*a, path))
    assert got == want
    oracle, sent, issued, tag = got[:4]
    assert oracle and issued and sum(issued.values()) == got[4][3]
    # every CRC the port's oracle holds is the scalar CRC of a payload
    payloads = {crc32c_py(f"w{t:06d}".encode().ljust(tsearch.PAYLOAD_LEN,
                                                     b"."))
                for t in range(1, tag + 1)}
    assert set().union(*sent.values()) == payloads
    assert set().union(*oracle.values()) - {None} <= payloads


def test_same_schedule_twice_same_verdict():
    sched = tsched.generate_schedule(0, tsched.ScheduleSpec(**SMALL))
    a = tsearch.run_schedule(sched, device="cpu")
    b = tsearch.run_schedule(sched, device="cpu")
    assert _report(a) == _report(b)
    assert not a.violated and a.writes > 0 and a.reads > 0
    tbugs.arm("commit_skip")
    c = tsearch.run_schedule(sched, device="cpu")
    d = tsearch.run_schedule(sched, device="cpu")
    assert _report(c) == _report(d) and c.violated


def test_directed_events_report_equals_the_jax_runner():
    def run(sc, se, b, kw):
        spec = sc.ScheduleSpec(steps=10, events=0, storage_nodes=3,
                               num_chains=2, num_replicas=2,
                               allow_elastic=True)
        sched = sc.Schedule(0, spec, [
            sc.ChaosEvent(1, "fault_set",
                          {"spec": "point=storage.read,kind=delay_ms,arg=1",
                           "seed": 1, "node_idx": 0}),
            sc.ChaosEvent(2, "kill", {"role": "storage", "idx": 0}),
            sc.ChaosEvent(3, "restart", {"role": "storage", "idx": 0}),
            sc.ChaosEvent(4, "config_push",
                          {"section": "qos",
                           "spec": "resync.queue_share=0.5"}),
            sc.ChaosEvent(5, "config_push",
                          {"section": "tenants",
                           "spec": "tenant=t0,weight=4,bytes_per_s=8388608"}),
            sc.ChaosEvent(6, "join", {}),
            sc.ChaosEvent(7, "fault_clear", {}),
            sc.ChaosEvent(8, "kill", {"role": "meta", "idx": 0}),
        ])
        sched.validate()
        return _report(se.run_schedule(sched, **kw))

    want, got = _both(run)
    assert got == want
    assert got[1:3] == (7, 1)  # the meta kill: nothing to kill
    assert all(status != "violated" for _, status, _, _ in got[6])


@pytest.mark.parametrize("spec,seed", [
    (dict(steps=12, events=3, storage_nodes=4, num_chains=1,
          num_replicas=1, ec_k=2, ec_m=1, allow_kill=False), 2),
    (dict(steps=12, events=2, storage_nodes=3, num_chains=2,
          num_replicas=2, allow_kill=False, train_workload=True), 3),
], ids=["ec", "train"])
def test_generated_schedule_report_equals_the_jax_runner(spec, seed):
    want, got = _both(lambda sc, se, b, kw: _report(se.run_schedule(
        sc.generate_schedule(seed, sc.ScheduleSpec(**spec)), **kw)))
    if spec.get("train_workload"):
        # the loader's fetch thread draws from the fault plane's RNG
        # beside the workload, in both packages: which writes are acked
        # varies from run to run, the verdict does not
        def verdict(r):
            return r[:4] + r[5:6] + ([(c, s) for c, s, _, _ in r[6]],)

        assert verdict(got) == verdict(want)
    else:
        assert got == want
    statuses = {name: status for name, status, _, _ in got[6]}
    assert "violated" not in statuses.values()
    if spec.get("train_workload"):
        assert statuses["ckpt_atomicity"] == "passed"
        assert statuses["dataload_resume"] == "passed"
    else:
        assert statuses["stripe_versions"] == "passed"


def test_clean_small_search_green():
    report, tried = tsearch.search_violations(
        tsched.ScheduleSpec(**SMALL), base_seed=100, max_seeds=3,
        device="cpu")
    assert report is None and tried == 3


def test_planted_commit_skip_found_and_shrunk_as_the_jax_runner():
    def hunt(sc, se, b, kw):
        b.arm("commit_skip")
        try:
            report, tried = se.search_violations(
                sc.ScheduleSpec(**SMALL), base_seed=0, max_seeds=16, **kw)
            shrunk, replays = se.shrink_schedule(report.schedule, **kw)
            again = se.run_schedule(shrunk, **kw)
            smaller = se.run_schedule(
                shrunk.prefix(len(shrunk.events) - 1), **kw)
        finally:
            b.disarm()
        fixed = se.run_schedule(shrunk, **kw)
        return (tried, _report(report), shrunk.to_json(), replays,
                _report(again), smaller.violated, fixed.violated)

    want, got = _both(hunt)
    assert got == want
    tried, report, shrunk, replays, again, smaller, fixed = got
    assert tried <= 16
    assert {"replica_versions", "crc_oracle"} & {
        name for name, status, _, _ in report[6] if status == "violated"}
    assert len(json.loads(shrunk)["events"]) <= len(
        json.loads(report[0])["events"])
    assert any(status == "violated" for _, status, _, _ in again[6])
    assert not smaller and not fixed


def test_save_and_replay_round_trip(tmp_path):
    sched = tsched.Schedule.from_json(json.dumps(json.load(open(
        _corpus("commit_skip_chain_ack.json")))["schedule"]))
    path = tsearch.save_seed("roundtrip", sched, bug="commit_skip",
                             expect=["replica_versions", "crc_oracle"],
                             note="test", root=str(tmp_path / "t"))
    want = jsearch.save_seed("roundtrip", jsched.Schedule.from_json(
        sched.to_json()), bug="commit_skip",
        expect=["replica_versions", "crc_oracle"], note="test",
        root=str(tmp_path / "j"))
    assert open(path).read() == open(want).read()
    assert tsearch.load_corpus(str(tmp_path / "t")) == [path]
    r, obj = tsearch.replay_seed(path, with_bug=True, device="cpu")
    assert set(obj["expect"]) <= set(r.violated_checkers)
    assert not tbugs.armed("commit_skip")
    r2, _ = tsearch.replay_seed(path, with_bug=False, device="cpu")
    assert not r2.violated
    assert tsearch.load_corpus(str(tmp_path / "none")) == []


def test_replay_refuses_an_unknown_corpus_version(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99}))
    with pytest.raises(ValueError, match="unsupported corpus version"):
        tsearch.replay_seed(str(bad), device="cpu")


def test_runner_scopes_the_chain_encode_variable(monkeypatch):
    """The EC chain-encode lever is set for the run and restored after,
    to a value it had or to unset."""
    spec = tsched.ScheduleSpec(steps=2, events=0, storage_nodes=3,
                               num_chains=1, num_replicas=1, ec_k=2,
                               ec_m=1, ec_chain_encode=True)
    seen = []
    real = tsearch.FabricRunner._workload_op

    def spy(self, report):
        seen.append(os.environ.get("TPU3FS_EC_CHAIN_ENCODE"))
        return real(self, report)

    monkeypatch.setattr(tsearch.FabricRunner, "_workload_op", spy)
    for prev in (None, "0"):
        if prev is None:
            monkeypatch.delenv("TPU3FS_EC_CHAIN_ENCODE", raising=False)
        else:
            monkeypatch.setenv("TPU3FS_EC_CHAIN_ENCODE", prev)
        r = tsearch.run_schedule(tsched.Schedule(1, spec, []), device="cpu")
        assert not r.violated and r.acked > 0
        assert os.environ.get("TPU3FS_EC_CHAIN_ENCODE") == prev
    assert seen and set(seen) == {"1"}
