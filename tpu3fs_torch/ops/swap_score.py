"""Kernel K5, redesigned: the annealer's proposals scored from their swaps.

Counterpart of ``score_batch`` in ``tpu3fs/placement/solver.py`` (a jitted
closure there), which takes the full Gram of every materialised proposal.
Here the table stays on the device as a ``SwapState``: the incidence M
(b, v) int8, its Gram G = M^T M (v, v) int32 with a zero diagonal, the
histogram of G's values over the unordered node pairs i < j, the
per-(group, domain) member counts and the current scores (overflow, max,
sum of squares), int64. A step sends only its moves, an int32 (5, P)
tensor with rows g1, g2, a, c, valid: row g1 gives node a to row g2 and
takes node c from it, as ``placement/solver.py:_propose_moves`` draws
them. A swap changes only rows and columns a and c of G, each changed pair
by 1 (see ``csrc/swap_score.cu``), so a proposal's score needs two rows of
M and two of G.

``swap_score`` returns, like ``score_batch``, int32 (3, P) rows overflow,
max off the diagonal and sum of squares off the diagonal (wrapped to int32
as XLA's sum), an invalid move scoring as M. ``swap_apply`` applies one
move to the state. Each launches its kernel for a state on the card and
runs its plain version only for a state on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu3fs_torch import kernels
from tpu3fs_torch.device import resolve_device

MOVE_ROWS = 5  # g1, g2, a, c, valid


def gram_np(M: np.ndarray) -> np.ndarray:
    """M^T M as int64, diagonal included. float64 BLAS then round: numpy's
    integer matmul has no BLAS path and is ~100x slower on 10k-group
    tables; the counts are << 2^53."""
    Mf = np.asarray(M).astype(np.float64)
    return (Mf.T @ Mf).astype(np.int64)


@dataclasses.dataclass
class SwapState:
    """The table and what the scorer keeps of it, on one device."""
    M: torch.Tensor                 # (b, v) int8, 0/1
    G: torch.Tensor                 # (v, v) int32, zero diagonal
    hist: torch.Tensor              # (L,) int32: unordered pairs per value
    counts: Optional[torch.Tensor]  # (b, D) int32, None without domains
    dom: Optional[torch.Tensor]     # (v,) int32 domain of each node
    cap: int                        # members a group may have per domain
    score: torch.Tensor             # (3,) int64: overflow, max, ssq (exact)

    @property
    def device(self) -> torch.device:
        return self.M.device


def swap_state(M: np.ndarray, domain_of_node: Optional[np.ndarray] = None,
               cap: int = 0, device=None,
               gram: Optional[np.ndarray] = None) -> SwapState:
    """Build the state of a 0/1 int8 table ``M`` (b, v) on the host and copy
    it to ``device`` (``None`` -> ``cuda``, raising without a card; the CPU
    tests pass ``"cpu"``). ``gram`` is ``gram_np(M)`` where the caller has
    it; ``domain_of_node`` an int (v,) index of each node's domain, or
    None."""
    M = np.asarray(M)
    if M.dtype != np.int8 or M.ndim != 2:
        raise TypeError(f"swap_state takes int8 (b, v), got {M.dtype} "
                        f"{M.shape}")
    if not ((M == 0) | (M == 1)).all():
        raise ValueError("swap_state takes a 0/1 incidence matrix")
    device = resolve_device(device)
    b, v = M.shape
    C = gram_np(M) if gram is None else np.asarray(gram, dtype=np.int64)
    off = C - np.diag(np.diag(C))
    # every value of G is at most the largest column sum, which a swap keeps
    L = int(np.diag(C).max(initial=0)) + 2
    hist = np.bincount(off[np.triu_indices(v, 1)], minlength=L)
    over, counts, dom = 0, None, None
    if domain_of_node is not None:
        dom = np.asarray(domain_of_node, dtype=np.int32)
        if dom.shape != (v,) or (v and dom.min() < 0):
            raise ValueError(f"domain_of_node must be ({v},) indices >= 0")
        onehot = np.eye(int(dom.max(initial=0)) + 1)[dom]
        counts = (M.astype(np.float64) @ onehot).astype(np.int32)
        over = int(np.maximum(counts - int(cap), 0).sum())
    score = np.array([over, int(off.max(initial=0)), int((off * off).sum())],
                     dtype=np.int64)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device).clone()

    return SwapState(M=put(M), G=put(off.astype(np.int32)),
                     hist=put(hist.astype(np.int32)), counts=put(counts),
                     dom=put(dom), cap=int(cap), score=put(score))


def _check(state: SwapState, moves: torch.Tensor) -> None:
    if (moves.dtype != torch.int32 or moves.ndim != 2
            or moves.shape[0] != MOVE_ROWS):
        raise TypeError(f"moves must be int32 ({MOVE_ROWS}, P), got "
                        f"{moves.dtype} {tuple(moves.shape)}")
    if moves.device != state.device:
        raise ValueError(f"moves on {moves.device}, state on {state.device}")
    b, v = state.M.shape
    want = {"M": (torch.int8, (b, v)), "G": (torch.int32, (v, v)),
            "score": (torch.int64, (3,))}
    if state.counts is not None:
        want["counts"] = (torch.int32, (b, state.counts.shape[1]))
        want["dom"] = (torch.int32, (v,))
    elif state.dom is not None:
        raise ValueError("state has a domain index but no counts")
    for name, (dtype, shape) in want.items():
        t = getattr(state, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"state.{name} must be {dtype} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != state.device or not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous on "
                             f"{state.device}")
    if (state.hist.dtype != torch.int32 or state.hist.ndim != 1
            or state.hist.device != state.device):
        raise TypeError("state.hist must be int32 (L,) on the state's device")


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _excess(n: torch.Tensor, cap: int) -> torch.Tensor:
    return (n - cap).clamp_min(0)


def _overflow_delta(state: SwapState, g1, g2, a, c) -> torch.Tensor:
    """The change of the domain overflow each move makes (int64)."""
    if state.counts is None:
        return torch.zeros_like(g1)
    da, dc = state.dom[a].long(), state.dom[c].long()
    cnt = state.counts.long()
    c1a, c1c, c2a, c2c = cnt[g1, da], cnt[g1, dc], cnt[g2, da], cnt[g2, dc]
    cap = state.cap
    delta = (_excess(c1a - 1, cap) - _excess(c1a, cap)
             + _excess(c1c + 1, cap) - _excess(c1c, cap)
             + _excess(c2c - 1, cap) - _excess(c2c, cap)
             + _excess(c2a + 1, cap) - _excess(c2a, cap))
    return torch.where(da != dc, delta, 0)


def _row_changes(state: SwapState, g1, g2, a, c):
    """d (P, v) = M[g2] - M[g1], 0 at a and c; rows a and c of G; int64."""
    v = state.M.shape[1]
    x = torch.arange(v, device=state.device)
    d = state.M[g2].long() - state.M[g1].long()
    d = torch.where((x == a[:, None]) | (x == c[:, None]), 0, d)
    return d, state.G[a].long(), state.G[c].long()


def swap_score_plain(state: SwapState, moves: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, gathers and index arithmetic in int64.
    ``swap_score_plain.calls`` counts its calls."""
    _check(state, moves)
    kernels.count(swap_score_plain, "calls")
    g1, g2, a, c, valid = moves.long()
    d, ga, gc = _row_changes(state, g1, g2, a, c)
    over0, mx, ssq0 = state.score
    na, nc = ga + d, gc - d
    ch = d != 0
    up = (ch & ((na == mx + 1) | (nc == mx + 1))).any(dim=1)
    leave = (ch & (ga == mx)).sum(dim=1) + (ch & (gc == mx)).sum(dim=1)
    arrive = (ch & (na == mx)).sum(dim=1) + (ch & (nc == mx)).sum(dim=1)
    at_max = state.hist.long()[mx] - leave + arrive
    best = torch.where(up, mx + 1, torch.where(at_max > 0, mx, mx - 1))
    ssq = ssq0 + 2 * (2 * d * (ga - gc) + 2 * d * d).sum(dim=1)
    over = over0 + _overflow_delta(state, g1, g2, a, c)
    keep = valid == 0
    out = torch.stack([torch.where(keep, over0, over),
                       torch.where(keep, mx, best),
                       torch.where(keep, ssq0, ssq)])
    return torch.stack([out[0].to(torch.int32), out[1].to(torch.int32),
                        _wrap_int32(out[2])])


swap_score_plain.calls = 0


def swap_score(state: SwapState, moves: torch.Tensor) -> torch.Tensor:
    """(overflow, max, ssq) of each move's table, int32 (3, P), ``moves``
    int32 (5, P) on the state's device.

    A CPU state goes to the plain version; a CUDA state to the kernel (a
    failed launch raises). ``swap_score.launches`` counts kernel launches;
    P = 0 returns without one. The wrapper reads no device value, so a
    step can be captured in a CUDA graph."""
    _check(state, moves)
    if state.device.type == "cpu":
        return swap_score_plain(state, moves)
    moves = moves.contiguous()
    P = moves.shape[1]
    out = torch.empty((3, P), dtype=torch.int32, device=state.device)
    if P == 0:
        return out
    v = state.M.shape[1]
    D = 0 if state.counts is None else state.counts.shape[1]
    kernels.launch("tpu3fs_swap_score", state.device, state.M, state.G,
                   state.hist, state.counts, state.dom, state.score, moves,
                   out, P, v, D, state.cap)
    kernels.count(swap_score)
    return out


swap_score.launches = 0


def swap_apply_plain(state: SwapState, moves: torch.Tensor, p: int) -> None:
    """Plain PyTorch version of ``swap_apply``, in place.
    ``swap_apply_plain.calls`` counts its calls."""
    _check(state, moves)
    kernels.count(swap_apply_plain, "calls")
    g1, g2, a, c, valid = (int(x) for x in moves[:, p].tolist())
    M, G, hist = state.M, state.G, state.hist
    if not valid or [int(M[g1, a]), int(M[g2, a]), int(M[g1, c]),
                     int(M[g2, c])] != [1, 0, 0, 1]:
        return  # a move that does not fit M leaves the state alone
    idx = torch.tensor([g1, g2, a, c], device=state.device)
    d, ga, gc = (t[0] for t in _row_changes(state, *idx[:, None]))
    na, nc = ga + d, gc - d
    ch = d != 0
    for old, new in ((ga, na), (gc, nc)):
        one = torch.ones(int(ch.sum()), dtype=hist.dtype, device=hist.device)
        hist.index_add_(0, old[ch], -one)
        hist.index_add_(0, new[ch], one)
    dover = _overflow_delta(state, *idx[:, None])[0]
    if state.counts is not None:
        da, dc = int(state.dom[a]), int(state.dom[c])
        if da != dc:
            state.counts[g1, da] -= 1
            state.counts[g1, dc] += 1
            state.counts[g2, dc] -= 1
            state.counts[g2, da] += 1
    G[a], G[:, a] = na.to(G.dtype), na.to(G.dtype)
    G[c], G[:, c] = nc.to(G.dtype), nc.to(G.dtype)
    M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
    mx = int(state.score[1])
    state.score[0] += dover
    state.score[1] = (mx + 1 if int(hist[mx + 1]) > 0
                      else mx if int(hist[mx]) > 0 else mx - 1)
    state.score[2] += 2 * (2 * d * (ga - gc) + 2 * d * d).sum()


swap_apply_plain.calls = 0


def swap_apply(state: SwapState, moves: torch.Tensor, p: int) -> None:
    """Apply move ``p`` of ``moves`` to the state, in place: 4 entries of M,
    rows and columns a and c of G, hist, 4 cells of the counts and the
    scores. An invalid move, or one that does not fit M (its entries at
    (g1, a), (g2, a), (g1, c), (g2, c) not 1, 0, 0, 1), changes nothing.

    A CPU state goes to the plain version; a CUDA state to the one-block
    kernel on the current stream, with no synchronise.
    ``swap_apply.launches`` counts kernel launches."""
    _check(state, moves)
    P = moves.shape[1]
    if not 0 <= p < P:
        raise IndexError(f"move {p} of {P}")
    if state.device.type == "cpu":
        return swap_apply_plain(state, moves, p)
    v = state.M.shape[1]
    D = 0 if state.counts is None else state.counts.shape[1]
    kernels.launch("tpu3fs_swap_apply", state.device, state.M, state.G,
                   state.hist, state.counts, state.dom, state.score,
                   moves.contiguous(), P, int(p), v, D, state.cap)
    kernels.count(swap_apply)


swap_apply.launches = 0
