"""The port's chain-table placement (tpu3fs_torch.placement, the plain
versions of kernel K5's full-Gram and swap scorers, entry.gen_chain_table)
against tpu3fs.placement and the JAX CLI, on the CPU. Tolerance 0: every
score, matrix, plan and command line equal. The kernels themselves are
held against their plain versions by tests/test_torch_gpu_kernels.py, on
a card; the swap scorer against the JAX scorer by
tests/test_torch_swap_score.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3fs.placement as jax_placement
import tpu3fs.placement.solver as jax_solver
import tpu3fs_torch.placement as port_placement
import tpu3fs_torch.placement.solver as port_solver
from tpu3fs import cli as jax_cli
from tpu3fs.mgmtd import types as jax_types
from tpu3fs_torch import entry
from tpu3fs_torch.mgmtd import types as port_types
from tpu3fs_torch.ops.placement_score import (score_batch,
                                              score_batch_plain)
from tpu3fs_torch.ops.swap_score import swap_score_plain


def _incidences(P, b, v, seed):
    """(P, b, v) int8 0/1 matrices from a seed."""
    return (np.random.default_rng(seed).random((P, b, v)) < 0.4).astype(np.int8)


def _domains(v, n_dom, seed):
    return np.random.default_rng(seed).integers(0, n_dom, v).astype(np.int32)


def _jax_scores(Ms, dom, cap):
    """tpu3fs/placement/solver.py:210-220, the closure score_batch."""
    Ms = jnp.asarray(Ms)
    v = Ms.shape[2]
    C = jnp.einsum("pbv,pbw->pvw", Ms, Ms, preferred_element_type=jnp.int32)
    off = C * (1 - jnp.eye(v, dtype=jnp.int32))
    mx = off.max(axis=(1, 2))
    if dom is None:
        over = jnp.zeros_like(mx)
    else:
        onehot = jnp.asarray(np.eye(int(dom.max()) + 1, dtype=np.int8)[dom])
        counts = jnp.einsum("pbv,vd->pbd", Ms, onehot,
                            preferred_element_type=jnp.int32)
        over = jnp.maximum(counts - cap, 0).sum(axis=(1, 2))
    return [np.asarray(x) for x in (over, mx, (off * off).sum(axis=(1, 2)))]


SCORE_CASES = [(5, 24, 13, None), (5, 24, 13, 4), (3, 37, 7, None),
               (3, 37, 7, 3)]


@pytest.mark.parametrize("P,b,v,n_dom", SCORE_CASES)
def test_score_batch_plain_matches_jax(P, b, v, n_dom):
    Ms = _incidences(P, b, v, seed=P * b + v)
    dom = _domains(v, n_dom, seed=v) if n_dom else None
    cap = 1
    want = _jax_scores(Ms, dom, cap)
    got = score_batch_plain(torch.from_numpy(Ms),
                            None if dom is None else torch.from_numpy(dom), cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (P,)
        assert np.array_equal(g.numpy(), w)
    if n_dom:
        assert want[0].any()  # the overflow term is exercised


def test_score_batch_on_cpu_takes_the_plain_version():
    Ms = torch.from_numpy(_incidences(2, 6, 5, seed=1))
    calls, launches = score_batch_plain.calls, score_batch.launches
    got = score_batch(Ms)
    assert score_batch_plain.calls == calls + 1
    assert score_batch.launches == launches
    for g, w in zip(got, score_batch_plain(Ms)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("P,b,v", [(0, 4, 3), (2, 0, 3), (2, 4, 0)])
def test_score_batch_zero_size(P, b, v):
    got = score_batch(torch.zeros((P, b, v), dtype=torch.int8))
    for g in got:
        assert g.shape == (P,) and g.dtype == torch.int32 and not g.any()


def test_score_batch_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        score_batch(torch.zeros((2, 3, 4), dtype=torch.uint8))
    with pytest.raises(TypeError):
        score_batch(torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(TypeError):
        score_batch(torch.zeros((2, 3, 4), dtype=torch.int8),
                    torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="< 0"):
        score_batch(torch.zeros((2, 3, 4), dtype=torch.int8),
                    torch.tensor([0, 1, -1, 0], dtype=torch.int32))


def _contiguous_domains(v, n_dom):
    return [f"rack{i * n_dom // v}" for i in range(v)]


# (problem kwargs, solve kwargs): the problems of tests/test_placement.py,
# an EC table with failure domains, one with a peer-traffic bound and one
# whose domain cap most swaps break
SOLVE_CASES = {
    "6_3_3": (dict(num_nodes=6, group_size=3, targets_per_node=3),
              dict(steps=200, seed=0)),
    "7_3_3_p256": (dict(num_nodes=7, group_size=3, targets_per_node=3),
                   dict(steps=600, proposals_per_step=256, seed=1)),
    "12_6_3": (dict(num_nodes=12, group_size=6, targets_per_node=3),
               dict(steps=200, seed=2)),
    "8_2_7": (dict(num_nodes=8, group_size=2, targets_per_node=7),
              dict(steps=400, seed=3)),
    "ec_domains": (dict(num_nodes=20, group_size=5, targets_per_node=4,
                        chain_table_type="EC",
                        domains=_contiguous_domains(20, 5),
                        max_per_domain=2),
                   dict(steps=300, seed=4)),
    "peer_traffic": (dict(num_nodes=10, group_size=3, targets_per_node=6),
                     dict(steps=300, seed=5, max_peer_traffic=2.0)),
    # one member per rack and 4 proposals a step: often every proposal
    # breaks the cap, so the accept draw's short-circuit decides the stream
    "tight_domains": (dict(num_nodes=15, group_size=3, targets_per_node=3,
                           domains=_contiguous_domains(15, 5),
                           max_per_domain=1),
                      dict(steps=300, seed=3, proposals_per_step=4)),
}


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_placement_matches_jax(name):
    pkw, skw = SOLVE_CASES[name]
    jp = jax_placement.PlacementProblem(**pkw)
    tp = port_placement.PlacementProblem(**pkw)
    want = jax_placement.solve_placement(jp, **skw)
    got = port_placement.solve_placement(tp, device="cpu", **skw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    traffic = skw.get("max_peer_traffic")
    assert port_placement.check_solution(got, tp, max_peer_traffic=traffic)
    assert jax_placement.check_solution(got, jp, max_peer_traffic=traffic)
    assert (port_solver.domain_overflow(got, tp)
            == jax_solver.domain_overflow(want, jp))


def test_solve_placement_runs_the_annealer_through_the_scorer():
    """30 nodes, width 3, 6 targets each: round robin gives λ = 6 against
    a lower bound of 1, far from reach in 5 steps, so every step calls the
    swap scorer once, and never the full-Gram scorer."""
    p = port_placement.PlacementProblem(num_nodes=30, group_size=3,
                                        targets_per_node=6)
    calls, full = swap_score_plain.calls, score_batch_plain.calls
    port_placement.solve_placement(p, device="cpu", steps=5, seed=1)
    assert swap_score_plain.calls == calls + 5
    assert score_batch_plain.calls == full


@pytest.mark.parametrize("kw", [
    dict(num_nodes=5, group_size=3, targets_per_node=1),
    dict(num_nodes=2, group_size=3, targets_per_node=3),
    dict(num_nodes=6, group_size=3, targets_per_node=3,
         chain_table_type="XX"),
    dict(num_nodes=6, group_size=3, targets_per_node=3, domains=["a"] * 6),
    dict(num_nodes=6, group_size=3, targets_per_node=3, domains=["a"] * 5,
         max_per_domain=1),
    dict(num_nodes=6, group_size=3, targets_per_node=3, domains=["a"] * 6,
         max_per_domain=0),
    dict(num_nodes=6, group_size=3, targets_per_node=3,
         domains=["a"] * 4 + ["b"] * 2, max_per_domain=1),
    dict(num_nodes=6, group_size=3, targets_per_node=3,
         domains=["a"] * 4 + ["b", "c"], max_per_domain=1),
])
def test_problem_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_placement.PlacementProblem(**kw)
    with pytest.raises(ValueError) as got:
        port_placement.PlacementProblem(**kw)
    assert str(got.value) == str(want.value)


def test_problem_properties_match_jax():
    for kw in (dict(num_nodes=180, group_size=3, targets_per_node=96),
               dict(num_nodes=180, group_size=16, targets_per_node=16,
                    chain_table_type="EC")):
        jp = jax_placement.PlacementProblem(**kw)
        tp = port_placement.PlacementProblem(**kw)
        for prop in ("num_groups", "recovery_traffic_factor",
                     "max_recovery_traffic_on_peer", "lambda_lower_bound"):
            assert getattr(tp, prop) == getattr(jp, prop), prop


@pytest.mark.parametrize("ec", [(0, 0), (2, 1)])
def test_gen_chain_table_commands_match_jax(ec):
    p = jax_placement.PlacementProblem(num_nodes=6, group_size=3,
                                       targets_per_node=3)
    M = jax_placement.solve_placement(p, steps=50, seed=7)
    kw = dict(ec_k=ec[0], ec_m=ec[1], first_target_id=500,
              node_ids=[100 + i for i in range(6)])
    assert (port_placement.gen_chain_table_commands(M, **kw)
            == jax_placement.gen_chain_table_commands(M, **kw))
    with pytest.raises(ValueError) as want:
        jax_placement.gen_chain_table_commands(M, ec_k=2, ec_m=2)
    with pytest.raises(ValueError) as got:
        port_placement.gen_chain_table_commands(M, ec_k=2, ec_m=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["CR", "EC"])
def test_peer_recovery_traffic_matches_jax(kind):
    kw = dict(num_nodes=8, group_size=4, targets_per_node=3,
              chain_table_type=kind)
    jp = jax_placement.PlacementProblem(**kw)
    tp = port_placement.PlacementProblem(**kw)
    M = jax_placement.solve_placement(jp, steps=100, seed=2)
    for node in range(8):
        got = port_solver.peer_recovery_traffic(M, tp, node)
        want = jax_solver.peer_recovery_traffic(M, jp, node)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(port_solver.recovery_traffic_factor(M, node),
                              jax_solver.recovery_traffic_factor(M, node))


def _cli_lines(args):
    return jax_cli.AdminCli(None).cmd_solve_placement(args).split("\n")


@pytest.mark.parametrize("args,kw", [
    (["--nodes", "7", "--group-size", "3", "--targets-per-node", "3"], {}),
    (["--nodes", "12", "--group-size", "6", "--targets-per-node", "3",
      "--steps", "50", "--ec-k", "4", "--ec-m", "2"],
     dict(steps=50, ec_k=4, ec_m=2)),
    (["--nodes", "10", "--group-size", "3", "--targets-per-node", "6",
      "--max-peer-traffic", "2"], dict(max_peer_traffic=2.0)),
])
def test_gen_chain_table_matches_the_jax_cli(args, kw):
    nodes, width, r = (int(args[i]) for i in (1, 3, 5))
    got = entry.gen_chain_table(nodes, width, r, device="cpu", **kw)
    assert got == _cli_lines(args)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    p = port_placement.PlacementProblem(num_nodes=7, group_size=3,
                                        targets_per_node=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_placement.solve_placement(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.gen_chain_table(7, 3, 3)


# -- the rebalance planner over the same RoutingInfo in both packages -------

def _routing(types, n_nodes, chains, *, ec=(0, 0), joined=(), draining=(),
             dead=(), syncing=(), domain_of=None):
    """RoutingInfo of storage nodes 1..n_nodes plus ``joined`` (connected,
    hosting nothing); ``chains``: chain_id -> [(target_id, node_id)]."""
    ri = types.RoutingInfo(version=3)
    for n in list(range(1, n_nodes + 1)) + list(joined):
        tags = {}
        if n in draining:
            tags["draining"] = "1"
        if domain_of:
            tags["domain"] = domain_of(n)
        status = (types.NodeStatus.HEARTBEAT_FAILED if n in dead
                  else types.NodeStatus.HEARTBEAT_CONNECTED)
        ri.nodes[n] = types.NodeInfo(node_id=n, type=types.NodeType.STORAGE,
                                     status=status, tags=tags)
    ri.nodes[99] = types.NodeInfo(node_id=99, type=types.NodeType.META)
    for cid, members in chains.items():
        targets = []
        for tid, node in members:
            state = (types.PublicTargetState.SYNCING if tid in syncing
                     else types.PublicTargetState.SERVING)
            targets.append(types.ChainTarget(target_id=tid, public_state=state))
            ri.targets[tid] = types.TargetInfo(
                target_id=tid, node_id=node, chain_id=cid, public_state=state)
        ri.chains[cid] = types.ChainInfo(
            chain_id=cid, targets=targets,
            preferred_order=[t for t, _ in members], ec_k=ec[0], ec_m=ec[1])
    return ri


def _round_robin(n_nodes, n_chains, width):
    chains, tid = {}, 100
    for c in range(n_chains):
        members = []
        for i in range(width):
            members.append((tid, (c * width + i) % n_nodes + 1))
            tid += 1
        chains[1000 + c] = members
    return chains


def _plan_view(plan):
    return ([dataclasses.astuple(m) for m in plan.moves],
            dataclasses.asdict(plan.before), dataclasses.asdict(plan.after),
            plan.deferred_chains)


REBALANCE_CASES = {
    "cr_join": dict(n_nodes=4, chains=_round_robin(4, 12, 2), joined=(5,)),
    "cr_drain": dict(n_nodes=6, chains=_round_robin(6, 12, 3),
                     draining=(2,)),
    "cr_drain_domains": dict(n_nodes=6, chains=_round_robin(6, 12, 3),
                             draining=(4,), joined=(7,),
                             domain_of=lambda n: f"rack{n % 3}"),
    "ec_join_and_drain": dict(n_nodes=6, chains=_round_robin(6, 8, 3),
                              ec=(2, 1), joined=(7,), draining=(1,)),
    "cr_dead_with_syncing": dict(n_nodes=5, chains=_round_robin(5, 10, 2),
                                 dead=(3,), syncing=(101, 104)),
}


@pytest.mark.parametrize("name", sorted(REBALANCE_CASES))
def test_plan_rebalance_and_check_plan_match_jax(name):
    kw = REBALANCE_CASES[name]
    jr = _routing(jax_types, **kw)
    tr = _routing(port_types, **kw)
    jdelta = jax_placement.TopologyDelta.from_routing(jr)
    tdelta = port_placement.TopologyDelta.from_routing(tr)
    assert dataclasses.astuple(tdelta) == dataclasses.astuple(jdelta)
    assert not tdelta.empty
    jplan = jax_placement.plan_rebalance(jr, jdelta)
    tplan = port_placement.plan_rebalance(tr, tdelta)
    assert _plan_view(tplan) == _plan_view(jplan)
    assert tplan.moves
    assert (port_placement.check_plan(tr, tplan, tdelta)
            == jax_placement.check_plan(jr, jplan, jdelta))
    nodes = list(range(1, kw["n_nodes"] + 1)) + list(kw.get("joined", ()))
    assert np.array_equal(port_placement.incidence_of_routing(tr, nodes),
                          jax_placement.incidence_of_routing(jr, nodes))
    fill = port_placement.plan_rebalance(tr, tdelta, fill_joined=False)
    assert _plan_view(fill) == _plan_view(
        jax_placement.plan_rebalance(jr, jdelta, fill_joined=False))


def test_check_plan_flags_what_the_jax_planner_flags():
    """A plan replayed onto a routing where the copy sources died: both
    packages refuse the same moves with the same words."""
    kw = REBALANCE_CASES["cr_drain"]
    jr, tr = _routing(jax_types, **kw), _routing(port_types, **kw)
    plan = port_placement.plan_rebalance(tr)
    dead = port_placement.TopologyDelta(
        dead=sorted({n for _, n in kw["chains"][plan.moves[0].chain_id]}))
    jdead = jax_placement.TopologyDelta(dead=dead.dead)
    got = port_placement.check_plan(tr, plan, dead)
    want = jax_placement.check_plan(jr, jax_placement.plan_rebalance(jr),
                                    jdead)
    assert got and got == want


def test_noop_delta_plans_nothing():
    kw = REBALANCE_CASES["cr_join"]
    tr = _routing(port_types, n_nodes=4, chains=kw["chains"])
    plan = port_placement.plan_rebalance(tr, port_placement.TopologyDelta())
    assert plan.empty and not plan.deferred_chains
