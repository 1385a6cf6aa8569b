"""Metashard observability — the SINGLE declaration site for every
``meta.partition_*`` recorder (docs/observability.md):

The port's own copy of ``tpu3fs/metashard/metrics.py``,
unchanged but for its imports.

- ``meta.partition_op_us`` (distribution, tag kind=p<pid>): per-partition
  meta op latency, the series the SLO engine judges per-partition p99 on
  (the partition dimension rides the ``kind`` tag — SLO tag keys are a
  fixed vocabulary).
- ``meta.partition_wrong`` (counter): ops fenced with
  META_WRONG_PARTITION — a sustained rate means clients hold stale
  partition tables (routing refresh lag, mid-reassignment churn).
- ``meta.partition_intents_resolved`` (counter): dangling two-phase
  records the crash resolver converged — nonzero after a coordinator
  death, should return to zero at rest.
- ``meta.tenant_mismatch`` (counter): wire-declared tenants that did not
  match the authenticated user's binding (rejected in enforce mode,
  counted-through in permissive compat mode).
"""

from __future__ import annotations

import threading
from typing import Dict

from tpu3fs_torch.monitor.recorder import CounterRecorder, DistributionRecorder

_lock = threading.Lock()
_op_us: Dict[int, DistributionRecorder] = {}

#: ops rejected by the ownership fence (stale client routing)
wrong_partition = CounterRecorder("meta.partition_wrong")
#: two-phase records converged by the crash resolver
intents_resolved = CounterRecorder("meta.partition_intents_resolved")
#: declared-vs-bound tenant mismatches seen by the meta auth layer
tenant_mismatch = CounterRecorder("meta.tenant_mismatch")


def partition_op_us(pid: int) -> DistributionRecorder:
    """The per-partition latency recorder (created once per pid — the
    recorder registry is weak, so holders keep these alive here)."""
    with _lock:
        rec = _op_us.get(pid)
        if rec is None:
            rec = DistributionRecorder("meta.partition_op_us",
                                       {"kind": f"p{pid}"})
            _op_us[pid] = rec
        return rec
