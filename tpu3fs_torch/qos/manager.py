"""QosManager: one service's QoS bundle (admission + policy + recorders).

The port's own copy of ``tpu3fs/qos/manager.py``,
unchanged but for its imports.

The storage binary (and the test fabric) hand a QosManager to
StorageService; it carries

- the ``AdmissionController`` consulted at read/write entry (shared with
  the RPC server when both enforce, so tokens are charged once),
- the ``WfqPolicy`` every per-target update worker schedules by,
- per-class monitor recorders: queue-depth gauges and a queue-wait
  distribution on top of the controller's admit/shed counters,

all driven by ONE ``QosConfig`` tree so a single mgmtd config push
retunes admission, scheduling and shedding together, live.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from tpu3fs_torch.qos.core import (
    CLASS_ATTRS,
    AdmissionController,
    QosConfig,
    TrafficClass,
)
from tpu3fs_torch.qos.scheduler import WfqPolicy


class _ManagedPolicy(WfqPolicy):
    """WfqPolicy that feeds the manager's queue-wait recorder."""

    def __init__(self, config: QosConfig, manager: "QosManager"):
        super().__init__(config)
        self._manager = manager

    def record_wait(self, tclass: TrafficClass, wait_s: float) -> None:
        self._manager.record_wait(tclass, wait_s)


class QosManager:
    def __init__(self, config: Optional[QosConfig] = None,
                 tags: Optional[Dict[str, str]] = None,
                 admission: Optional[AdmissionController] = None):
        from tpu3fs_torch.monitor.recorder import (
            DistributionRecorder,
            ValueRecorder,
        )

        if admission is not None:
            # share the binary's RPC-dispatch controller: tokens for one
            # op are charged once, wherever the op entered
            self.admission = admission
            self.config = config if config is not None else admission.config
        else:
            self.config = config if config is not None else QosConfig()
            self.admission = AdmissionController(self.config, tags)
        self.policy = _ManagedPolicy(self.config, self)
        base = dict(tags or {})
        self._lock = threading.Lock()
        self._depth_gauges: Dict[TrafficClass, ValueRecorder] = {}
        self._wait_recs: Dict[TrafficClass, DistributionRecorder] = {}
        for tc, attr in CLASS_ATTRS.items():
            ctags = {**base, "class": attr}
            self._depth_gauges[tc] = ValueRecorder("qos.queue_depth", ctags)
            self._wait_recs[tc] = DistributionRecorder("qos.queue_wait_us",
                                                       ctags)

    # -- service-entry admission -----------------------------------------
    def try_admit(self, service: str, method: str,
                  tclass: Optional[TrafficClass], cost: float = 1.0,
                  *, tenant: Optional[str] = None):
        """(lease, None) | (None, retry_after_ms); see
        AdmissionController.try_admit."""
        return self.admission.try_admit(service, method, tclass, cost,
                                        tenant=tenant)

    # -- scheduler plumbing ----------------------------------------------
    def record_wait(self, tclass: TrafficClass, wait_s: float) -> None:
        rec = self._wait_recs.get(tclass)
        if rec is not None:
            rec.record(wait_s * 1e6)

    def record_depths(self, depths: Dict[TrafficClass, int]) -> None:
        """Fold one queue's per-class depths into the gauges (called by
        the service on its snapshot path; gauges report last-set)."""
        for tc, gauge in self._depth_gauges.items():
            gauge.set(float(depths.get(tc, 0)))

    def snapshot(self) -> dict:
        return {
            "enabled": bool(self.config.enabled),
            "classes": self.admission.snapshot(),
        }
