"""The port's chaos schedules (``tpu3fs_torch/chaos/schedule.py``) against
the JAX package's, on the CPU: ``generate_schedule`` draws the same JSON
byte for byte for seeds 0-15 under every kind of spec (CR, EC with the
chain encode, the training, serving, metashard and native sidecars,
partitions), the corpus in ``tests/chaos_seeds/`` round-trips byte-equal
through both, ``validate()`` refuses what the JAX version refuses with
the same message, and every point of ``FAULT_POINTS`` resolves to a fire
site under ``tpu3fs_torch/`` as under ``tpu3fs/``. Tolerance 0."""

import functools
import json
import os

import pytest

import tools.check_fault_points as fault_check
from tpu3fs.chaos import schedule as jsched
from tpu3fs.chaos.search import load_corpus
from tpu3fs_torch.chaos import schedule as tsched
from tpu3fs_torch.utils.fault_injection import parse_spec

SPECS = {
    "cr": dict(steps=20, events=6, storage_nodes=3, num_chains=2,
               num_replicas=2),
    "ec_chain_encode": dict(steps=12, events=6, storage_nodes=4,
                            num_chains=2, num_replicas=2, ec_k=2, ec_m=1,
                            ec_chain_encode=True),
    "train": dict(steps=12, events=4, storage_nodes=3, num_chains=2,
                  num_replicas=2, train_workload=True, workers=1),
    "serving": dict(steps=12, events=4, storage_nodes=3, num_chains=2,
                    num_replicas=2, kv_serving=True, allow_kill=False,
                    allow_config_push=False, clients=2),
    "metashard": dict(steps=20, events=6, storage_nodes=2, num_chains=1,
                      meta_shard=True, meta_nodes=2, allow_kill=True,
                      allow_config_push=False, fault_prob_min=0.5),
    "native": dict(steps=8, events=3, storage_nodes=3, num_chains=1,
                   num_replicas=2, native_write=True, allow_kill=False,
                   allow_config_push=False, max_fault_rules=3),
    "partition": dict(storage_nodes=5, events=12, allow_partition=True,
                      allow_elastic=True),
}


@pytest.mark.parametrize("seed", range(16))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_generate_schedule_json_is_byte_equal(spec, seed):
    want = jsched.generate_schedule(seed, jsched.ScheduleSpec(**SPECS[spec]))
    got = tsched.generate_schedule(seed, tsched.ScheduleSpec(**SPECS[spec]))
    assert got.to_json() == want.to_json()
    assert got.to_json() == tsched.generate_schedule(
        seed, tsched.ScheduleSpec(**SPECS[spec])).to_json()
    assert tsched.Schedule.from_json(want.to_json()).to_json() == \
        want.to_json()


def test_the_specs_draw_every_event_kind():
    kinds = {e.kind for spec in SPECS.values() for seed in range(16)
             for e in tsched.generate_schedule(
                 seed, tsched.ScheduleSpec(**spec)).events}
    assert kinds == set(tsched.KINDS)


@pytest.mark.parametrize("path", load_corpus(),
                         ids=lambda p: os.path.basename(p))
def test_corpus_file_round_trips_byte_equal(path):
    with open(path) as f:
        text = f.read()
    obj = json.loads(text)
    body = json.dumps(obj["schedule"])
    got = tsched.Schedule.from_json(body)
    want = jsched.Schedule.from_json(body)
    assert got.to_json() == want.to_json()
    got.validate()
    # the file is canonical and its events come back as they were; its
    # spec may predate fields the generator added since (their defaults)
    assert json.dumps(obj, sort_keys=True, indent=1) + "\n" == text
    assert [e.to_obj() for e in got.events] == obj["schedule"]["events"]
    assert got.seed == obj["schedule"]["seed"]
    assert got.prefix(1).to_json() == want.prefix(1).to_json()


BAD_EVENTS = [
    ("explode", {}),
    ("fault_set", {"spec": "point=x,kind=bogus"}),  # fault-ok: parse only
    ("fault_set", {"spec": "point=storage.read,kind=error,prob=1.0",
                   "seed": 1, "node_idx": -1}),
    ("fault_set", {"spec": "point=rpc.send,kind=drop,prob=0.5",
                   "seed": 1, "node_idx": -1}),
    ("kill", {"role": "toaster", "idx": 0}),
    ("restart", {"idx": 0}),
    ("config_push", {"section": "dns", "spec": ""}),
    ("partition", {"a": [0], "b": [0, 1], "heal_after": 3}),
    ("partition", {"a": [], "b": [1], "heal_after": 3}),
    ("partition", {"a": [0], "b": [1], "heal_after": 0}),
    ("partition", {"a": [0], "b": [1]}),
    ("partition", {"a": [0, -1], "b": [], "heal_after": 2}),
    ("partition", {"a": "0", "b": [], "heal_after": 2}),
    ("partition", {"a": [0], "b": "1", "heal_after": 2}),
]


@pytest.mark.parametrize("kind,args", BAD_EVENTS,
                         ids=[f"{i}-{k}" for i, (k, _) in enumerate(BAD_EVENTS)])
def test_validate_refuses_what_the_jax_version_refuses(kind, args):
    errors = []
    for mod in (jsched, tsched):
        sched = mod.Schedule(0, mod.ScheduleSpec(),
                             [mod.ChaosEvent(0, kind, dict(args))])
        with pytest.raises(ValueError) as e:
            sched.validate()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_from_obj_refuses_what_the_jax_version_refuses():
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="unknown chaos event kind"):
            mod.ChaosEvent.from_obj({"step": 0, "kind": "explode"})
        with pytest.raises(ValueError, match="unknown ScheduleSpec field"):
            mod.ScheduleSpec.from_obj({"bogus": 1})
        with pytest.raises(ValueError, match="unsupported schedule version"):
            mod.Schedule.from_json(json.dumps({"version": 99}))


def test_good_events_validate_in_both():
    events = [(0, "partition", {"a": [0], "b": [1, 2], "heal_after": 4}),
              (1, "fault_set", {"spec": "point=storage.read,kind=error,"
                                        "prob=1.0,times=5;point=rpc.send,"
                                        "kind=drop,prob=0.5,times=3",
                                "seed": 1, "node_idx": -1}),
              (2, "fault_set", {"spec": "point=rpc.dispatch,kind=delay_ms,"
                                        "prob=0.3,arg=20",
                                "seed": 1, "node_idx": 0}),
              (3, "kill", {"role": "meta", "idx": 0}),
              (4, "config_push", {"section": "slo", "spec": ""})]
    for mod in (jsched, tsched):
        mod.Schedule(0, mod.ScheduleSpec(), [
            mod.ChaosEvent(s, k, a) for s, k, a in events]).validate()


def test_menus_are_equal():
    assert tsched.FAULT_POINTS == jsched.FAULT_POINTS
    assert tsched.KINDS == jsched.KINDS
    assert tsched.ROLES == jsched.ROLES
    assert tsched._FAULT_KINDS == jsched._FAULT_KINDS
    assert tsched.SCHEDULE_VERSION == jsched.SCHEDULE_VERSION
    assert tsched.ScheduleSpec().to_obj() == jsched.ScheduleSpec().to_obj()
    for p in tsched.FAULT_POINTS:
        assert parse_spec(f"point={p}")[0].point == p  # fault-ok: parse only


@functools.lru_cache(maxsize=None)
def _fire_sites(root: str):
    """(static points, dynamic prefixes) fired under ``root``."""
    saved = fault_check.FIRE_DIRS
    fault_check.FIRE_DIRS = (root,)
    try:
        static, dynamic, errors = fault_check.fire_points()
    finally:
        fault_check.FIRE_DIRS = saved
    assert errors == []
    return frozenset(static), frozenset(dynamic)


def test_fault_points_resolve_to_fire_sites_in_the_port():
    static, dynamic = _fire_sites("tpu3fs_torch")
    for p in tsched.FAULT_POINTS:
        assert fault_check.resolves(p, static, dynamic), p
    # the port fires every point and prefix the JAX package fires
    assert (static, dynamic) == _fire_sites("tpu3fs")


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_generated_rules_resolve_in_the_port(spec):
    static, dynamic = _fire_sites("tpu3fs_torch")
    for seed in range(16):
        sched = tsched.generate_schedule(seed, tsched.ScheduleSpec(**SPECS[spec]))
        for e in sched.events:
            if e.kind != "fault_set":
                continue
            for rule in parse_spec(e.args["spec"]):
                assert fault_check.resolves(rule.point, static, dynamic)
                if rule.kind in ("error", "drop"):
                    assert rule.times >= 0


def test_event_recorder_counts():
    before = tsched._rec_events._value
    tsched.record_event_applied(3)
    assert tsched._rec_events._value == before + 3
    assert tsched._rec_events.name == jsched._rec_events.name
