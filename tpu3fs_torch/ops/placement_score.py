"""Kernel K5: the placement annealer's proposal scorer.

Counterpart of ``score_batch`` in ``tpu3fs/placement/solver.py`` (a jitted
closure there). For each of P candidate incidence matrices, int8
(P, b, v), it returns three int32 (P,) tensors, in this order:

- the domain overflow ``sum(max(M[p] @ onehot - cap, 0))`` over every
  (group, domain) cell, 0 without a domain index;
- the maximum of the Gram matrix ``M[p]^T M[p]`` off its diagonal;
- the sum of squares of the Gram matrix off its diagonal,

with XLA's int32 arithmetic. ``score_batch`` launches
``csrc/placement_score.cu`` for a CUDA tensor (the Gram taken in int8
tensor-core products, reduced in registers, never written out) and runs
``score_batch_plain`` only for a tensor on the CPU. The annealer scores
its proposals from their swaps (``ops/swap_score.py``); this full-Gram
scorer of the materialised proposals is that scorer's check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu3fs_torch import kernels

#: the kernel counts each warp's group row per domain in 48 KB of shared
#: memory: 8 warps x MAX_DOMAINS int32 counters
MAX_DOMAINS = 1536
# float32 holds every integer below 2**24: a sum of b products of 0/1
_F32_EXACT = 1 << 24

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(Ms: torch.Tensor, domain_of_node: Optional[torch.Tensor]) -> None:
    if Ms.dtype != torch.int8 or Ms.ndim != 3:
        raise TypeError(f"score_batch takes int8 (P, b, v), got {Ms.dtype} "
                        f"{tuple(Ms.shape)}")
    if domain_of_node is None:
        return
    if (domain_of_node.dtype != torch.int32
            or tuple(domain_of_node.shape) != (Ms.shape[2],)):
        raise TypeError(f"domain_of_node must be int32 ({Ms.shape[2]},), got "
                        f"{domain_of_node.dtype} "
                        f"{tuple(domain_of_node.shape)}")
    if domain_of_node.device != Ms.device:
        raise ValueError(f"domain_of_node on {domain_of_node.device}, "
                         f"proposals on {Ms.device}")


def _num_domains(domain_of_node: torch.Tensor) -> int:
    lo, hi = (int(x) for x in domain_of_node.aminmax())
    if lo < 0:
        raise ValueError(f"domain index {lo} < 0")
    return hi + 1


def _zeros(P: int, device) -> Scores:
    out = torch.zeros((3, P), dtype=torch.int32, device=device)
    return out[0], out[1], out[2]


def score_batch_plain(Ms: torch.Tensor,
                      domain_of_node: Optional[torch.Tensor] = None,
                      cap: int = 0) -> Scores:
    """Plain PyTorch version. The Gram and the domain counts are float32
    products, exact for 0/1 incidence matrices while b < 2**24; the rest
    is integer arithmetic, wrapped to int32 as XLA's. ``.calls`` counts
    its calls."""
    _check(Ms, domain_of_node)
    kernels.count(score_batch_plain, "calls")
    P, b, v = Ms.shape
    if b >= _F32_EXACT:
        raise ValueError(f"b = {b} groups: float32 sums are exact below 2**24")
    if P * b * v == 0:
        return _zeros(P, Ms.device)
    Mf = Ms.to(torch.float32)
    gram = torch.bmm(Mf.transpose(1, 2), Mf).to(torch.int64)
    off = gram * (1 - torch.eye(v, dtype=torch.int64, device=Ms.device))
    mx = off.amax(dim=(1, 2))
    ssq = (off * off).sum(dim=(1, 2))
    if domain_of_node is None:
        over = torch.zeros_like(mx)
    else:
        onehot = torch.nn.functional.one_hot(
            domain_of_node.to(torch.int64),
            _num_domains(domain_of_node)).to(torch.float32)
        counts = torch.matmul(Mf, onehot).to(torch.int64)
        over = (counts - cap).clamp_min(0).sum(dim=(1, 2))
    return over.to(torch.int32), mx.to(torch.int32), ssq.to(torch.int32)


score_batch_plain.calls = 0


def score_batch(Ms: torch.Tensor,
                domain_of_node: Optional[torch.Tensor] = None,
                cap: int = 0) -> Scores:
    """(overflow, max off-diagonal, sum of squares off-diagonal), each
    int32 (P,), of int8 proposals (P, b, v); ``domain_of_node`` is an int32
    (v,) index of each node's failure domain, on the proposals' device.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel (a
    failed launch raises). ``score_batch.launches`` counts kernel launches;
    zero-size work returns without one."""
    _check(Ms, domain_of_node)
    if Ms.device.type == "cpu":
        return score_batch_plain(Ms, domain_of_node, cap)
    x = Ms.contiguous()
    P, b, v = x.shape
    if P * b * v == 0:
        return _zeros(P, x.device)
    D = 0
    if domain_of_node is not None:
        D = _num_domains(domain_of_node)
        if D > MAX_DOMAINS:
            raise ValueError(f"{D} domains: the kernel takes at most "
                             f"{MAX_DOMAINS}")
        domain_of_node = domain_of_node.contiguous()
    out = torch.empty((3, P), dtype=torch.int32, device=x.device)
    kernels.launch("tpu3fs_placement_score", x.device, x, domain_of_node,
                   out, P, b, v, D, int(cap))
    kernels.count(score_batch)
    return out[0], out[1], out[2]


score_batch.launches = 0
