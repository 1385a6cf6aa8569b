"""Weighted-fair scheduling of storage IO by traffic class, with

The port's own copy of ``tpu3fs/qos/scheduler.py``,
unchanged but for its imports.

NESTED per-tenant fairness inside each class.

``WeightedFairQueue`` replaces the single FIFO inside each per-target
update worker (storage/update_worker.py) with a two-level stride
scheduler:

1. ACROSS CLASSES (unchanged semantics): each class carries a virtual
   time advancing by cost/weight per pop, and the nonempty class with
   the smallest virtual time runs next — foreground read/write
   (weight 8) outweighs resync/EC-rebuild (2) and migration/GC (1)
   exactly in proportion, work-conserving.
2. WITHIN A CLASS (tpu3fs/tenant): each class holds one FIFO LANE per
   tenant, drained by the same stride rule with the TENANT's weight
   (quota table, tenant/quota.py). Two ``fg`` tenants therefore share
   the class's capacity weight:weight instead of FIFO luck — the greedy
   client that used to starve its same-class peers now only starves
   itself.

Ordering: within one (class, tenant) lane order stays FIFO, so a
client's own writes to one chunk apply in arrival order exactly as
before (a single writer is a single tenant). CROSS-tenant writes to one
chunk carry no ordering promise — they are concurrent clients, ordered
by the engine's version algebra like cross-class writes always were.

Shedding happens at push: a full queue sheds any class, and a
share-bounded class (every background class plus the foreground-weighted
``dataload``/``kvcache``, qos.core.SHARE_BOUNDED_CLASSES) is shed
earlier when it already occupies its configured share of the queue — the
bounded-queue-depth property the overload stress test asserts. A shed
returns the retry-after hint for the OVERLOADED reply.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

from tpu3fs_torch.qos.core import (
    CLASS_ATTRS,
    SHARE_BOUNDED_CLASSES,
    QosConfig,
    TrafficClass,
)
from tpu3fs_torch.tenant.identity import DEFAULT_TENANT


class WfqPolicy:
    """Live view of scheduler knobs over a (hot-updated) QosConfig.

    Reads go straight to the config attributes, so a mgmtd config push
    changes weights/shares/hints for every queue sharing the policy
    without rebuilding anything. Tenant weights come from the process
    tenant registry (tenant/quota.py) — the same hot push that retunes
    quotas retunes lane weights."""

    def __init__(self, config: Optional[QosConfig] = None):
        self.config = config if config is not None else QosConfig()

    def enabled(self) -> bool:
        return bool(self.config.enabled)

    def weight(self, tclass: TrafficClass) -> int:
        return max(1, int(getattr(self.config, CLASS_ATTRS[tclass]).weight))

    def tenant_weight(self, tenant: str) -> int:
        from tpu3fs_torch.tenant.quota import registry

        return registry().weight(tenant or DEFAULT_TENANT)

    def queue_share(self, tclass: TrafficClass) -> float:
        return float(getattr(self.config, CLASS_ATTRS[tclass]).queue_share)

    def retry_after_ms(self) -> int:
        return int(self.config.shed_retry_after_ms)

    # observation hook: the QosManager overrides this to feed the
    # queue-wait distribution recorder; the default is free
    def record_wait(self, tclass: TrafficClass, wait_s: float) -> None:
        pass


class _ClassQueue:
    """One class's nested tenant lanes: FIFO per tenant + per-tenant
    stride state. Not locked — the WeightedFairQueue's owner serializes
    (see below)."""

    __slots__ = ("lanes", "vtime", "depth")

    def __init__(self):
        self.lanes: Dict[str, collections.deque] = {}
        self.vtime: Dict[str, float] = {}
        self.depth = 0

    def push(self, item, tenant: str) -> None:
        lane = self.lanes.get(tenant)
        if lane is None:
            lane = self.lanes[tenant] = collections.deque()
        if tenant not in self.vtime:
            # a newly-active lane starts at the current minimum virtual
            # time among active lanes: no banked credit from idling
            self.vtime[tenant] = min(
                (self.vtime[t] for t, q in self.lanes.items()
                 if q and t in self.vtime), default=0.0)
        lane.append(item)
        self.depth += 1

    def next_tenant(self) -> Optional[str]:
        """The nonempty lane with least virtual time (stride pick)."""
        best = None
        for tenant, lane in self.lanes.items():
            if not lane:
                continue
            vt = self.vtime.get(tenant, 0.0)
            if best is None or vt < best[1]:
                best = (tenant, vt)
        return best[0] if best is not None else None

    def tenants_by_vtime(self):
        active = [(self.vtime.get(t, 0.0), t)
                  for t, q in self.lanes.items() if q]
        active.sort()
        return [t for _, t in active]

    def pop_lane(self, tenant: str, tenant_weight: int):
        lane = self.lanes[tenant]
        item = lane.popleft()
        self.depth -= 1
        cost = getattr(item, "cost", 1)
        self.vtime[tenant] = (self.vtime.get(tenant, 0.0)
                              + cost / max(1, tenant_weight))
        return item


class WeightedFairQueue:
    """Per-class tenant-laned FIFOs + two-level stride-scheduling pop.
    NOT internally locked — the owning update worker already serializes
    access under its condition variable, exactly like the deque it
    replaces."""

    def __init__(self, policy: Optional[WfqPolicy] = None,
                 cap: int = 512):
        self.policy = policy or WfqPolicy()
        self.cap = cap
        self._queues: Dict[TrafficClass, _ClassQueue] = {}
        self._vtime: Dict[TrafficClass, float] = {}
        self._depth = 0

    def __len__(self) -> int:
        return self._depth

    def class_depths(self) -> Dict[TrafficClass, int]:
        return {tc: q.depth for tc, q in self._queues.items() if q.depth}

    def tenant_depths(self) -> Dict[Tuple[TrafficClass, str], int]:
        """Live (class, tenant) -> queued jobs (observability)."""
        out: Dict[Tuple[TrafficClass, str], int] = {}
        for tc, q in self._queues.items():
            for tenant, lane in q.lanes.items():
                if lane:
                    out[(tc, tenant)] = len(lane)
        return out

    def try_push(self, item, tclass: TrafficClass,
                 tenant: str = DEFAULT_TENANT) -> Optional[int]:
        """Append `item` to its (class, tenant) lane; -> None when
        accepted, else the retry-after hint (ms) for the shed reply."""
        base = self.policy.retry_after_ms()
        if self._depth >= self.cap:
            # full queue: scale the hint by how oversubscribed we are so
            # a deep backlog spreads retries wider than a grazing overflow
            return base * 2
        q = self._queues.get(tclass)
        if tclass in SHARE_BOUNDED_CLASSES:
            share = max(1, int(self.cap * self.policy.queue_share(tclass)))
            if q is not None and q.depth >= share:
                return base
        if q is None:
            q = self._queues[tclass] = _ClassQueue()
        if tclass not in self._vtime:
            # a newly-active class starts at the current minimum virtual
            # time: no banked credit from its idle period
            self._vtime[tclass] = min(
                (self._vtime[c] for c, qq in self._queues.items()
                 if qq.depth and c in self._vtime), default=0.0)
        q.push(item, tenant or DEFAULT_TENANT)
        self._depth += 1
        return None

    def _advance_class(self, tclass: TrafficClass, item) -> None:
        cost = getattr(item, "cost", 1)
        self._vtime[tclass] = (self._vtime.get(tclass, 0.0)
                               + cost / self.policy.weight(tclass))

    def pop(self) -> Optional[Tuple[object, TrafficClass]]:
        """Pop the head of the stride-picked tenant lane of the nonempty
        class with least virtual time."""
        best = None
        for tc, q in self._queues.items():
            if not q.depth:
                continue
            vt = self._vtime.get(tc, 0.0)
            if best is None or vt < best[1]:
                best = (tc, vt)
        if best is None:
            return None
        tc, _vt = best
        q = self._queues[tc]
        tenant = q.next_tenant()
        assert tenant is not None
        item = q.pop_lane(tenant, self.policy.tenant_weight(tenant))
        self._depth -= 1
        self._advance_class(tc, item)
        return item, tc

    def pop_matching(self, tclass: TrafficClass, pred) -> Optional[object]:
        """Pop a lane-HEAD job of this class if pred(head) — the
        coalescing probe. Lanes are tried in virtual-time order, so the
        stride-preferred tenant coalesces first; only lane heads are
        eligible, so per-(class, tenant) FIFO order is untouched."""
        q = self._queues.get(tclass)
        if q is None or not q.depth:
            return None
        for tenant in q.tenants_by_vtime():
            lane = q.lanes[tenant]
            if lane and pred(lane[0]):
                item = q.pop_lane(tenant,
                                  self.policy.tenant_weight(tenant))
                self._depth -= 1
                self._advance_class(tclass, item)
                return item
        return None

    def drain(self):
        """Pop everything (stop path); class order, FIFO within lane."""
        out = []
        for q in self._queues.values():
            for lane in q.lanes.values():
                while lane:
                    out.append(lane.popleft())
            q.depth = 0
        self._depth = 0
        return out
