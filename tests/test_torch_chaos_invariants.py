"""The port's chaos checkers (``tpu3fs_torch/chaos/invariants.py``)
against the JAX package's, on the CPU: the same checker names, and on
hand-built contexts (corruption, an admissible suffix, a lost chunk,
bounded memory, a dataload resume, a checker that raises, stale serving
reads, divergent replicas and stripes, a double apply, checkpoint
atomicity, domain quorum, two-phase intents) the same statuses, the
same violation messages and the same report. The port's CRC checkers
run ``crc32c_many`` on ``ChaosContext.device`` (here the CPU, K2's plain
version). Tolerance 0."""

from types import SimpleNamespace

import pytest

from tpu3fs.chaos import invariants as jinv
from tpu3fs.ops.crc32c import crc32c as jcrc
from tpu3fs_torch.chaos import invariants as tinv
from tpu3fs_torch.ops import crc32c as tcrc


def _crc(data: bytes) -> int:
    return jcrc(data)


GOOD, EVIL, ACKED, UNACKED = b"x" * 16, b"y" * 16, b"a" * 8, b"b" * 8


def _boom(*_):
    raise RuntimeError("checker io died")


class _Mgr:
    """A checkpoint manager: steps 2 and 4 visible, step 4 unreadable."""

    def steps(self):
        return [2, 4]

    def restore(self, step):
        if step == 4:
            raise ValueError("shard crc mismatch")
        return {}


def _meta(fid, idx, ver, crc, length=64):
    return SimpleNamespace(chunk_id=SimpleNamespace(file_id=fid, index=idx),
                           committed_ver=ver,
                           checksum=SimpleNamespace(value=crc, length=length))


def _routing(ec: bool = False, domains=None):
    """Two chains over nodes 10-12 (targets 100-105): chain 1 on 10, 11;
    chain 2 on 11, 12 (EC(1,1) when ``ec``)."""
    nodes = {nid: SimpleNamespace(tags={"domain": domains[nid]}
                                  if domains else {})
             for nid in (10, 11, 12)}
    targets = {100 + i: SimpleNamespace(node_id=nid) for i, nid in
               enumerate((10, 11, 11, 12, 12, 10))}

    def chain(cid, tids, is_ec):
        return SimpleNamespace(
            chain_id=cid, is_ec=is_ec, ec_m=1,
            targets=[SimpleNamespace(target_id=t) for t in tids])

    chains = {1: chain(1, (100, 101), False), 2: chain(2, (102, 103), ec)}
    return SimpleNamespace(nodes=nodes, targets=targets, chains=chains)


# target id -> committed chunk metas the dump returns
DUMPS = {
    100: [_meta(7, 0, 2, 0xA), _meta(7, 1, 1, 0xB), _meta(7, 2, 0, 0)],
    101: [_meta(7, 0, 2, 0xA), _meta(7, 1, 1, 0xC)],
    102: [_meta(8, 0, 3, 0xD)],
    103: [_meta(8, 0, 2, 0xE)],
}


def _dump(node_id, target_id):
    return DUMPS.get(target_id, [])


CASES = {
    "empty": dict(),
    "corruption": dict(read_chunk=lambda c, f, i: EVIL,
                       oracle={(1, 2, 3): {_crc(GOOD)}}),
    "good_read": dict(read_chunk=lambda c, f, i: GOOD,
                      oracle={(1, 2, 3): {_crc(GOOD)}}),
    "admissible_suffix": dict(
        read_chunk=lambda c, f, i: UNACKED,
        oracle={(1, 1, 1): {_crc(ACKED), _crc(UNACKED)}}),
    "lost_chunk": dict(read_chunk=lambda c, f, i: None,
                       oracle={(1, 1, 1): {123}, (1, 1, 2): {None, 5},
                               (2, 1, 1): {_crc(GOOD)}}),
    "mixed_reads": dict(
        read_chunk=lambda c, f, i: (GOOD, None, EVIL, b"")[i % 4],
        oracle={(1, 5, i): {_crc(GOOD), None} for i in range(8)}),
    "bounded_memory": dict(memory_gauges={
        "kvcache.host_bytes": (lambda: 10.0, 100.0),
        "dataload.buffered_bytes": (lambda: 500.0, 100.0)}),
    "dataload_resume_equal": dict(resume_replay=lambda: ([1, 2, 3],
                                                         [1, 2, 3])),
    "dataload_resume_diverges": dict(resume_replay=lambda: ([1, 2, 3],
                                                            [1, 9, 3])),
    "dataload_resume_short": dict(resume_replay=lambda: ([1, 2, 3], [1])),
    "checker_raises": dict(read_chunk=_boom, oracle={(1, 1, 1): {1}}),
    "kvcache_stale": dict(serving_reads=[
        ("k0", {_crc(GOOD)}, GOOD), ("k1", {_crc(GOOD)}, None),
        ("k2", {_crc(GOOD)}, bytes(16)), ("k3", {_crc(GOOD)}, EVIL)]),
    "replica_crc": dict(native_write_replicas=[
        ("probe-1", True, (2, 0x10), (2, 0x10)),
        ("probe-2", True, (2, 0x10), (2, 0x11)),
        ("probe-3", False, (2, 0x10), (2, 0x12)),
        ("probe-4", True, (3, 0x10), (2, 0x13))]),
    "replicas_and_versions": dict(
        routing=lambda: _routing(), dump_chunkmeta=_dump,
        writes_issued={(1, 7, 0): 1, (1, 7, 1): 4, (2, 8, 0): 1}),
    "stripe_versions": dict(routing=lambda: _routing(ec=True),
                            dump_chunkmeta=_dump),
    "domain_quorum": dict(routing=lambda: _routing(
        domains={10: "d0", 11: "d0", 12: "d1"})),
    "ckpt_atomicity": dict(ckpt_manager=_Mgr(), ckpt_acked_steps=[2, 3],
                           ckpt_list_raw=lambda: ["2", "4", "4.tmp",
                                                  "5.tmp", "x.tmp"]),
    "meta_intents": dict(meta_audit=lambda: {
        "expected": {"/a": 1, "/b": 2, "/c": 3},
        "actual": {"/a": 1, "/b": None, "/c": 4}, "dangling": 2}),
}


def _outcomes(mod, case, **extra):
    ctx = mod.ChaosContext(**CASES[case], **extra)
    outs = mod.run_checkers(ctx)
    return ([(o.checker, o.status, [str(v) for v in o.violations], o.note)
             for o in outs], mod.format_report(outs))


def test_checker_names_are_equal():
    assert tinv.checker_names() == jinv.checker_names()
    assert len(tinv.checker_names()) == 11


@pytest.mark.parametrize("case", sorted(CASES))
def test_outcomes_and_report_equal_the_jax_checkers(case):
    want = _outcomes(jinv, case)
    got = _outcomes(tinv, case, device="cpu")
    assert got == want
    if case != "empty":
        assert any(status != "skipped" for _, status, _, _ in got[0])


def test_one_checker_by_name():
    want = jinv.run_checkers(jinv.ChaosContext(**CASES["corruption"]),
                             ["crc_oracle"])
    got = tinv.run_checkers(tinv.ChaosContext(**CASES["corruption"],
                                              device="cpu"), ["crc_oracle"])
    assert [(o.checker, o.status) for o in got] == \
        [(o.checker, o.status) for o in want] == [("crc_oracle", "violated")]
    with pytest.raises(KeyError):
        tinv.run_checkers(tinv.ChaosContext(device="cpu"), ["no_such"])


def test_crc_checkers_take_one_batched_call(monkeypatch):
    """The oracle's reads and the serving reads are checksummed with one
    ``crc32c_many`` call each on the context's device, equal to the
    scalar CRC."""
    calls = []
    real = tcrc.crc32c_many

    def spy(bufs, device=None):
        calls.append((len(bufs), str(device)))
        got = real(bufs, device)
        assert got == [tcrc.crc32c_py(b) for b in bufs]
        return got

    monkeypatch.setattr(tcrc, "crc32c_many", spy)
    tinv.run_checkers(tinv.ChaosContext(**CASES["mixed_reads"],
                                        device="cpu"), ["crc_oracle"])
    tinv.run_checkers(tinv.ChaosContext(**CASES["kvcache_stale"],
                                        device="cpu"), ["kvcache_stale"])
    assert calls == [(6, "cpu"), (3, "cpu")]


def test_register_refuses_a_duplicate_name():
    with pytest.raises(ValueError, match="duplicate checker"):
        tinv.register("crc_oracle")(lambda ctx: [])


def test_violation_str_equal():
    assert str(tinv.Violation("a", "b")) == str(jinv.Violation("a", "b"))
