"""Chain-table placement: the BIBD integer program, solved on the card.

The port's own copy of ``tpu3fs/placement/solver.py``. Only the scorer
changed. The JAX package materialises each step's P proposals and takes
the full Gram of each in a jitted einsum; here the table, its Gram, the
histogram of the Gram's values and the domain counts stay on the device
(``ops.swap_score.SwapState``), each step sends only its P moves, and
``ops.swap_score.swap_score`` scores every proposal from its swap (kernel
K5 on the card, its plain version on the CPU); an accepted move is applied
there by ``swap_apply``. The draws are host numpy from the same generator
in the same order, so a seed gives the same incidence matrix, byte for
byte, as the JAX package.

Re-expresses deploy/data_placement/src/model/data_placement.py (a Pyomo MILP
solved with HiGHS): choose an incidence of v nodes into b chain groups of
size k, each node serving in exactly r groups, such that the pairwise
co-occurrence λ[i,j] (how many groups nodes i and j share) is balanced —
λ bounds the recovery traffic any single peer absorbs when a node fails
(docs/design_notes.md "Balanced traffic during recovery"; the solver's
`recovery_traffic_factor` distinguishes "CR" chain-replication from "EC"
tables, data_placement.py:30,~92).

Instead of a branch-and-bound MILP, the search is a batched annealer: at each
step a batch of candidate swap moves is scored in parallel on the device
and the best accepted — the classic simulated-annealing reformulation of
BIBD construction (scores are changes of the v x v Gram). Falls back to greedy
round-robin whenever the annealer cannot beat it.

check_solution mirrors the reference's validation; gen_chain_table_commands
emits the admin command file like deploy/data_placement/src/setup/
gen_chain_table.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.ops.swap_score import (gram_np, swap_apply, swap_score,
                                         swap_state)


@dataclasses.dataclass
class PlacementProblem:
    num_nodes: int           # v
    group_size: int          # k (= replication factor / EC group width k+m)
    targets_per_node: int    # r
    # "CR" chain replication vs "EC" erasure-coded chain tables: EC recovery
    # reads from EVERY surviving group member (factor k-1), CR full-chunk-
    # replace streams one copy (factor 1) — ref data_placement.py:91-92
    chain_table_type: str = "CR"
    # failure domains: domains[i] labels node i (rack/zone/pod), and no
    # group may put more than max_per_domain members under one label —
    # the loss budget a whole-domain kill must fit inside (width-1 for
    # CR quorum survival, ec_m for EC). None = domain-blind (legacy).
    domains: Optional[List[str]] = None
    max_per_domain: Optional[int] = None

    def __post_init__(self):
        v, k, r = self.num_nodes, self.group_size, self.targets_per_node
        if k > v:
            raise ValueError(f"group size {k} > nodes {v}")
        if (v * r) % k != 0:
            raise ValueError(f"v*r={v*r} not divisible by group size {k}")
        if self.chain_table_type not in ("CR", "EC"):
            raise ValueError(f"chain_table_type {self.chain_table_type!r}")
        if (self.domains is None) != (self.max_per_domain is None):
            raise ValueError("domains and max_per_domain go together")
        if self.domains is not None:
            if len(self.domains) != v:
                raise ValueError(
                    f"{len(self.domains)} domain labels for {v} nodes")
            cap = int(self.max_per_domain)
            if cap < 1:
                raise ValueError(f"max_per_domain {cap} < 1")
            from collections import Counter

            counts = Counter(self.domains)
            if sum(min(n, cap) for n in counts.values()) < k:
                raise ValueError(
                    f"infeasible: no {k}-group can respect "
                    f"max_per_domain={cap} over domains {dict(counts)}")
            b = self.num_groups
            for d, n in sorted(counts.items()):
                if n * r > b * cap:
                    raise ValueError(
                        f"infeasible: domain {d!r} holds {n} nodes "
                        f"needing {n * r} group slots, but {b} groups "
                        f"x cap {cap} allow only {b * cap}")

    @property
    def num_groups(self) -> int:  # b
        return self.num_nodes * self.targets_per_node // self.group_size

    @property
    def recovery_traffic_factor(self) -> int:
        """Traffic units a failed target's group emits during recovery
        (ref data_placement.py:91-92)."""
        return self.group_size - 1 if self.chain_table_type == "EC" else 1

    @property
    def max_recovery_traffic_on_peer(self) -> int:
        """Ideal (balanced) per-peer recovery traffic ceiling
        (ref data_placement.py:94-100)."""
        import math

        total = self.targets_per_node * self.recovery_traffic_factor
        return math.ceil(total / max(self.num_nodes - 1, 1))

    @property
    def lambda_lower_bound(self) -> int:
        """ceil of average pairwise co-occurrence: b*k*(k-1) / (v*(v-1))."""
        v, k, b = self.num_nodes, self.group_size, self.num_groups
        num = b * k * (k - 1)
        den = v * (v - 1)
        return -(-num // den)


def _greedy_incidence(problem: PlacementProblem) -> np.ndarray:
    """Round-robin start: group g holds the k consecutive nodes from a
    rolling cursor (mod v) — k <= v guarantees distinct members. With
    domains, the cursor walks a domain-INTERLEAVED ordering (rank within
    domain, then domain) so consecutive windows straddle domains — the
    annealer then only has to repair the remainder windows."""
    v, k, b = problem.num_nodes, problem.group_size, problem.num_groups
    order = np.arange(v)
    if problem.domains is not None:
        buckets: dict = {}
        for i, d in enumerate(problem.domains):
            buckets.setdefault(d, []).append(i)
        depth = max(len(m) for m in buckets.values())
        order = np.array(
            [m[rank] for rank in range(depth)
             for _d, m in sorted(buckets.items()) if rank < len(m)],
            dtype=int)
    M = np.zeros((b, v), dtype=np.int8)
    pos = 0
    for g in range(b):
        for i in range(k):
            M[g, order[(pos + i) % v]] = 1
        pos += k
    return M


def _domain_index(problem: PlacementProblem) -> Optional[np.ndarray]:
    """(v,) int32 index of each node's domain among the sorted labels,
    None when domain-blind."""
    if problem.domains is None:
        return None
    labels = sorted(set(problem.domains))
    return np.array([labels.index(d) for d in problem.domains],
                    dtype=np.int32)


def _domain_onehot(problem: PlacementProblem) -> Optional[np.ndarray]:
    """(v, D) one-hot node->domain incidence, None when domain-blind."""
    idx = _domain_index(problem)
    if idx is None:
        return None
    return np.eye(int(idx.max()) + 1, dtype=np.int8)[idx]


def domain_overflow(M: np.ndarray, problem: PlacementProblem) -> int:
    """Total members-over-cap across all (group, domain) cells: 0 iff
    every group respects max_per_domain."""
    onehot = _domain_onehot(problem)
    if onehot is None:
        return 0
    counts = np.asarray(M, dtype=np.int32) @ onehot.astype(np.int32)
    return int(np.maximum(counts - int(problem.max_per_domain), 0).sum())


class Moves(NamedTuple):
    """One step's P swap moves, each (P,): row g1 gives node a to row g2
    and takes node c from it; ``valid`` is False where g1 and g2 have no
    exchangeable members."""
    g1: np.ndarray
    g2: np.ndarray
    a: np.ndarray
    c: np.ndarray
    valid: np.ndarray


def _propose_moves(M: np.ndarray, rng: np.random.Generator, P: int) -> Moves:
    """P swap moves of the table, FULLY VECTORIZED: for each proposal pick
    two distinct groups (g1, g2) and exchange one member a ∈ g1∖g2 with one
    c ∈ g2∖g1 — preserving both row sums (k) and column sums (r). Member
    selection is a weighted argmax over the difference masks; proposals
    whose groups have no exchangeable members (identical membership) are
    not valid and score as the current table. Draws integers, integers,
    then random((P, v)) twice: the JAX package's order."""
    b, v = M.shape
    g1 = rng.integers(0, b, P)
    g2 = (g1 + rng.integers(1, b, P)) % b   # distinct by construction
    rows1 = M[g1].astype(bool)              # (P, v)
    rows2 = M[g2].astype(bool)
    only1 = rows1 & ~rows2
    only2 = rows2 & ~rows1
    valid = only1.any(axis=1) & only2.any(axis=1)
    # random member pick inside each mask: argmax of uniform noise
    # restricted to the mask (masked-out entries score -1)
    noise_a = np.where(only1, rng.random((P, v)), -1.0)
    noise_c = np.where(only2, rng.random((P, v)), -1.0)
    return Moves(g1, g2, noise_a.argmax(axis=1), noise_c.argmax(axis=1),
                 valid)


def _materialise(M: np.ndarray, moves: Moves) -> np.ndarray:
    """The proposals' tables, (P, b, v) int8: copies of M with each valid
    move applied; an invalid one stays a copy of M."""
    cand = np.repeat(M[None, :, :], len(moves.valid), axis=0)
    pi = np.nonzero(moves.valid)[0]
    g1, g2, a, c = (x[pi] for x in moves[:4])
    cand[pi, g1, a] = 0
    cand[pi, g1, c] = 1
    cand[pi, g2, c] = 0
    cand[pi, g2, a] = 1
    return cand


def _propose(M: np.ndarray, rng: np.random.Generator, P: int) -> np.ndarray:
    """P materialised swap proposals, (P, b, v) int8: the JAX package's
    proposals, from the same draws."""
    return _materialise(M, _propose_moves(M, rng, P))


def _off_diagonal_score(C: np.ndarray) -> Tuple[int, int]:
    """(max, sum of squares) of a Gram matrix off its diagonal, exact."""
    off = C - np.diag(np.diag(C))
    return int(off.max()), int((off * off).sum())


def _score_np(M: np.ndarray) -> Tuple[int, int]:
    return _off_diagonal_score(gram_np(M))


def solve_placement(
    problem: PlacementProblem,
    *,
    steps: int = 300,
    proposals_per_step: int = 128,
    seed: int = 0,
    target_lambda: Optional[int] = None,
    max_peer_traffic: Optional[float] = None,
    device=None,
) -> np.ndarray:
    """-> incidence matrix (b, v) with row sums k and column sums r.

    target_lambda bounds raw co-occurrence; max_peer_traffic bounds
    recovery traffic in the chain-table type's units (EC-vs-CR weighted,
    ref data_placement.py:91-100) — it is converted to the equivalent
    co-occurrence bound, which the annealer minimizes. The proposals are
    scored on ``device``: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    v, k, b, r = (
        problem.num_nodes,
        problem.group_size,
        problem.num_groups,
        problem.targets_per_node,
    )
    M = _greedy_incidence(problem).astype(np.int8)
    if max_peer_traffic is not None and k > 1:
        # traffic per co-occurrence = factor / (k-1); k=1 groups have no
        # peer traffic at all, so any bound is trivially satisfied
        per_cooc = problem.recovery_traffic_factor / (k - 1)
        traffic_tgt = int(max_peer_traffic / per_cooc)
        target_lambda = (min(target_lambda, traffic_tgt)
                         if target_lambda is not None else traffic_tgt)
    tgt = target_lambda if target_lambda is not None else problem.lambda_lower_bound
    gram = gram_np(M)
    best_max, best_ssq = _off_diagonal_score(gram)
    best_over = domain_overflow(M, problem)
    if (best_over == 0 and best_max <= tgt) or b < 2:
        return M  # already optimal, or a single group has no swap moves

    P = proposals_per_step
    labels = _domain_index(problem)
    cap = int(problem.max_per_domain) if labels is not None else 0
    # the table, its Gram, the Gram's histogram and the domain counts live
    # on the device from here on; each step sends only its moves
    state = swap_state(M, labels, cap, dev, gram=gram)
    # a step's traffic, the moves in and the scores back, staged in pinned
    # host memory on the card: faster than pageable copies on the H100
    # (PERF.md section 5)
    pin = dev.type == "cuda"
    moves_host = torch.empty((len(Moves._fields), P), dtype=torch.int32,
                             pin_memory=pin)
    scores_host = torch.empty((3, P), dtype=torch.int32, pin_memory=pin)

    rng = np.random.default_rng(seed)
    temperature = 1.0
    for _step in range(steps):
        moves = _propose_moves(M, rng, P)
        moves_host.numpy()[:] = np.stack(moves)
        moves_dev = moves_host.to(dev, non_blocking=True)
        # overflow leads the lexicographic objective: the domain cap is a
        # constraint, λ a preference
        scores_host.copy_(swap_score(state, moves_dev), non_blocking=True)
        if pin:  # the scores have landed; moves_host may be refilled
            torch.cuda.current_stream(dev).synchronize()
        overs, maxs, ssqs = scores_host.numpy()
        order = np.lexsort((ssqs, maxs, overs))
        bi = order[0]
        # exploration never regresses the hard domain constraint
        accept = (
            (overs[bi], maxs[bi], ssqs[bi]) < (best_over, best_max, best_ssq)
            or (overs[bi] <= best_over
                and rng.random() < 0.02 * temperature)
        )
        if accept:
            swap_apply(state, moves_dev, int(bi))
            if moves.valid[bi]:  # an invalid proposal is M itself
                g1, g2, a, c = (int(x[bi]) for x in moves[:4])
                M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
            best_over, best_max, best_ssq = (
                int(overs[bi]), int(maxs[bi]), int(ssqs[bi]))
        temperature *= 0.99
        if best_over == 0 and best_max <= tgt:
            break
    return M


def check_solution(
    M: np.ndarray,
    problem: PlacementProblem,
    lambda_max: Optional[int] = None,
    max_peer_traffic: Optional[float] = None,
) -> bool:
    """Validate structure + balanced peer recovery traffic (ref
    check_solution in data_placement.py)."""
    v, k, b, r = (
        problem.num_nodes,
        problem.group_size,
        problem.num_groups,
        problem.targets_per_node,
    )
    M = np.asarray(M)
    if M.shape != (b, v):
        return False
    if not ((M == 0) | (M == 1)).all():
        return False
    if not (M.sum(axis=1) == k).all():
        return False
    if not (M.sum(axis=0) == r).all():
        return False
    if domain_overflow(M, problem) > 0:
        return False
    if lambda_max is not None:
        mx, _ = _score_np(M)
        if mx > lambda_max:
            return False
    if max_peer_traffic is not None:
        # worst per-peer traffic over every single-node failure, in the
        # chain-table type's units (ref check_solution peer traffic)
        worst = max(
            float(peer_recovery_traffic(M, problem, n).max())
            for n in range(v)
        )
        if worst > max_peer_traffic + 1e-9:
            return False
    return True


def recovery_traffic_factor(M: np.ndarray, node: int) -> np.ndarray:
    """Per-peer share of traffic when `node` fails: co-occurrence row
    (how many of the failed node's groups each peer serves)."""
    M = np.asarray(M, dtype=np.int32)
    C = M.T @ M
    row = C[node].copy()
    row[node] = 0
    return row


def peer_recovery_traffic(
    M: np.ndarray, problem: PlacementProblem, node: int
) -> np.ndarray:
    """Per-peer recovery traffic in TRAFFIC UNITS when `node` fails:
    co-occurrence scaled by the chain-table type's recovery factor —
    the quantity the reference's peer_traffic_map reports
    (data_placement.py:296-300). For EC every surviving group member
    streams its shard (factor (k-1)/(k-1) = 1 per co-occurrence); for CR
    one full-chunk copy spreads over the k-1 peers (1/(k-1) each)."""
    row = recovery_traffic_factor(M, node).astype(np.float64)
    # group_size=1 has no peers inside a group: factor is 0, traffic is 0
    return (row * problem.recovery_traffic_factor
            / max(problem.group_size - 1, 1))


def gen_chain_table_commands(
    M: np.ndarray,
    *,
    first_target_id: int = 1000,
    first_chain_id: int = 900_001,
    table_id: int = 1,
    node_ids: Optional[List[int]] = None,
    ec_k: int = 0,
    ec_m: int = 0,
) -> List[str]:
    """Admin command lines (create-target / upload-chains / upload-chain-table)
    like the reference's generated command files. With ec_k/ec_m the chains
    are emitted as EC(k, m) chain tables (group width must be k+m)."""
    M = np.asarray(M)
    b, v = M.shape
    if ec_k:
        width = int(M[0].sum())
        if ec_k + ec_m != width:
            raise ValueError(
                f"EC({ec_k},{ec_m}) needs group width {ec_k + ec_m}, "
                f"placement has {width}")
    node_ids = node_ids or [10 + i for i in range(v)]
    lines: List[str] = []
    chains: List[List[int]] = []
    tid = first_target_id
    for g in range(b):
        members = np.nonzero(M[g])[0]
        targets = []
        for n in members:
            lines.append(
                f"create-target --target-id {tid} --node-id {node_ids[n]} "
                f"--chain-id {first_chain_id + g}"
            )
            targets.append(tid)
            tid += 1
        chains.append(targets)
    ec_suffix = f" --ec-k {ec_k} --ec-m {ec_m}" if ec_k else ""
    for g, targets in enumerate(chains):
        lines.append(
            f"upload-chain --chain-id {first_chain_id + g} --targets "
            + ",".join(map(str, targets)) + ec_suffix
        )
    lines.append(
        f"upload-chain-table --table-id {table_id} --chains "
        + ",".join(str(first_chain_id + g) for g in range(b))
    )
    return lines
