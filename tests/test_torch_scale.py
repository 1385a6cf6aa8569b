"""The port's scale fabric (``tpu3fs_torch/scale/``) against the JAX
package's, on the CPU (``device="cpu"``: the placement solver's plain
version): at 30 nodes in 3 domains (domain-aware and blind), 12 nodes
with META nodes and partitions, an EC(4,2) layout and 1,000 nodes in 10
domains, the incidence matrix byte for byte, the chain ids and
``domain_violations``, the routing snapshot's bytes, ``quorum_report``
after a whole-domain kill, the restart and the resync,
``meta_assignment`` after a META kill and its rejoin, the routing
fan-out's byte totals cold and warm, and ``kv_footprint`` are equal.
Tolerance 0."""

import numpy as np
import pytest

from tpu3fs.rpc.serde import serialize as jserialize
from tpu3fs.rpc.services import RoutingRsp as JRoutingRsp
from tpu3fs.scale import ScaleConfig as JConfig
from tpu3fs.scale import ScaleFabric as JFabric
from tpu3fs_torch.rpc.serde import serialize as tserialize
from tpu3fs_torch.rpc.services import RoutingRsp as TRoutingRsp
from tpu3fs_torch.scale import ScaleConfig as TConfig
from tpu3fs_torch.scale import ScaleFabric as TFabric

CONFIGS = {
    "30x3": dict(num_nodes=30, num_domains=3),
    "30x3_blind": dict(num_nodes=30, num_domains=3, domain_aware=False),
    "12x3_meta": dict(num_nodes=12, num_domains=3, meta_nodes=3,
                      meta_partitions=16),
    "36x6_ec": dict(num_nodes=36, num_domains=6, group_size=6,
                    targets_per_node=1, ec_k=4, ec_m=2),
    "1000x10": dict(num_nodes=1000, num_domains=10),
}


def _pair(name: str):
    return (JFabric(JConfig(**CONFIGS[name])),
            TFabric(TConfig(**CONFIGS[name]), device="cpu"))


def _routing_bytes(jf, tf):
    return (jserialize(JRoutingRsp(changed=True,
                                   routing=jf.mgmtd.get_routing_info(-1))),
            tserialize(TRoutingRsp(changed=True,
                                   routing=tf.mgmtd.get_routing_info(-1))))


def _state(sf) -> tuple:
    return (sf.quorum_report(), sf.domain_violations(), sf.kv_footprint(),
            sf.meta_assignment())


def _same(jf, tf) -> tuple:
    want, got = _state(jf), _state(tf)
    assert got == want
    a, b = _routing_bytes(jf, tf)
    assert b == a
    return got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_boot_lays_the_same_table(name):
    jf, tf = _pair(name)
    want = np.asarray(jf.incidence)
    assert tf.incidence.dtype == want.dtype
    assert tf.incidence.shape == want.shape
    assert tf.incidence.tobytes() == want.tobytes()
    assert tf.chain_ids == jf.chain_ids
    assert len(tf.chain_ids) == tf.cfg.num_chains
    assert tf.meta_node_ids == jf.meta_node_ids
    assert {n: (s.domain, s.hb_version, dict(s.local_states))
            for n, s in tf.nodes.items()} == \
        {n: (s.domain, s.hb_version, dict(s.local_states))
         for n, s in jf.nodes.items()}
    _, violations, _, _ = _same(jf, tf)
    assert (violations == []) == tf.cfg.domain_aware
    assert tf.boot_s > 0 and tf.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_domain_kill_restart_and_resync(name):
    jf, tf = _pair(name)
    assert tf.kill_domain("d0") == jf.kill_domain("d0")
    quorum, _, _, _ = _same(jf, tf)
    if tf.cfg.domain_aware:
        assert quorum["broken"] == 0 and quorum["ok"] == len(tf.chain_ids)
    else:
        assert quorum["broken"] > 0  # the A/B: blind placement breaks
    jf.restart_domain("d0")
    tf.restart_domain("d0")
    _same(jf, tf)
    jf.complete_resync("d0")
    tf.complete_resync("d0")
    quorum, _, _, _ = _same(jf, tf)
    assert quorum["broken"] == 0


@pytest.mark.parametrize("name", ["30x3", "12x3_meta", "36x6_ec"])
def test_routing_fanout_bytes_cold_and_warm(name):
    jf, tf = _pair(name)
    for up_to_date in (False, True):
        want, _ = jf.routing_fanout(up_to_date=up_to_date)
        got, secs = tf.routing_fanout(up_to_date=up_to_date)
        assert got == want and secs >= 0
    cold, _ = tf.routing_fanout(up_to_date=False)
    warm, _ = tf.routing_fanout(up_to_date=True)
    assert warm * 10 < cold


def test_warm_fanout_at_a_thousand_nodes():
    jf, tf = _pair("1000x10")
    want, _ = jf.routing_fanout(up_to_date=True)
    got, _ = tf.routing_fanout(up_to_date=True)
    assert got == want
    # a cold poll replies with the whole snapshot: the fleet's 1,000 warm
    # replies together are smaller than one of it
    a, b = _routing_bytes(jf, tf)
    assert b == a and got < len(b)


def test_heartbeats_keep_the_kv_bounded():
    jf, tf = _pair("1000x10")
    for sf in (jf, tf):
        assert len(sf.heartbeat_round()) == 1000
    f1 = tf.kv_footprint()
    for _ in range(3):
        jf.heartbeat_round()
        tf.heartbeat_round()
    f4 = _same(jf, tf)[2]
    assert f4["keys"] == f1["keys"]
    assert f4["history"] <= f1["history"] * 1.5 + 64


def test_meta_kill_moves_only_its_rows():
    jf, tf = _pair("12x3_meta")
    before = tf.meta_assignment()
    assert before == jf.meta_assignment() and len(before) == 16
    victim = tf.meta_node_ids[0]
    jf.kill_meta_node(victim)
    tf.kill_meta_node(victim)
    after = _same(jf, tf)[3]
    moved = {pid for pid in before if before[pid] != after[pid]}
    assert moved and all(before[p][0] == victim != after[p][0]
                         for p in moved)
    jf.restart_meta_node(victim)
    tf.restart_meta_node(victim)
    loads: dict = {}
    for nid, _epoch in _same(jf, tf)[3].values():
        loads[nid] = loads.get(nid, 0) + 1
    assert max(loads.values()) - min(loads.values()) <= 1


def test_config_errors_match():
    for bad in (dict(num_nodes=2, group_size=3),
                dict(num_nodes=10, targets_per_node=1, group_size=3)):
        for cfg in (JConfig, TConfig):
            with pytest.raises(ValueError):
                cfg(**bad)
    assert TConfig(ec_k=4, ec_m=2).domain_cap == JConfig(
        ec_k=4, ec_m=2).domain_cap == 2


@pytest.mark.slow
def test_cold_fanout_at_a_thousand_nodes():
    jf, tf = _pair("1000x10")
    want, _ = jf.routing_fanout(up_to_date=False)
    got, _ = tf.routing_fanout(up_to_date=False)
    assert got == want
    warm, _ = tf.routing_fanout(up_to_date=True)
    assert warm * 1000 < got
