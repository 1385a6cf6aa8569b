"""Distributed tenant quotas: a hot-configurable table of per-tenant

The port's own copy of ``tpu3fs/tenant/quota.py``,
unchanged but for its imports.

token-bucket limits, enforced at admission.

The table is ONE spec string riding the existing mgmtd config machinery
(``[tenants] spec=...`` — the fault-plane pattern), so a single config
push retunes every node's quota enforcement live, no restart. Each node
enforces its own buckets: for N storage nodes a tenant's cluster-wide
throughput caps at ~N x its per-node rate, exactly like the reference's
per-node admission — the operator sets per-node rates, the placement
layer spreads tenants, and the monitor's per-tenant recorders
(``tenant.*``) verify the aggregate.

Spec grammar — entries separated by ``;``, fields by ``,``::

    tenant=default,weight=1;
    tenant=alice,weight=4,bytes_per_s=8388608,iops=500,kvcache_bytes=1073741824

- ``weight``: the tenant's share inside its traffic class's nested WFQ
  lane (qos/scheduler.py) — two ``fg`` tenants split the class's
  capacity weight:weight instead of FIFO luck;
- ``bytes_per_s`` / ``iops``: token-bucket rates (0 = unlimited; burst =
  ``burst_s`` seconds of rate). Sheds answer the retryable
  ``Code.TENANT_THROTTLED`` with a retry-after hint the client ladders
  honor (client/storage_client.py);
- ``kvcache_bytes``: resident-bytes budget for the inference KV-cache
  tier — writers shed once their tenant's measured resident gauge
  exceeds it, and the kvcache GC daemon's capacity pass evicts back
  under it (bin/kvcache_gc_main.py);
- ``tenant=default`` overrides the limits applied to every tenant
  WITHOUT an explicit row (including untenanted legacy traffic).

Background classes (resync/EC-rebuild/migration/GC/ckpt) are exempt from
tenant buckets: recovery is the system's own work, already metered by
its class limits — throttling it under a client's quota would turn one
tenant's flood into everyone's durability problem.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from tpu3fs_torch.tenant.identity import DEFAULT_TENANT, valid_tenant
from tpu3fs_torch.utils.config import Config, ConfigItem


@dataclass
class TenantQuota:
    """One tenant's limits; 0 anywhere = unlimited on that axis."""

    weight: int = 1          # nested-WFQ share inside the traffic class
    bytes_per_s: float = 0.0
    iops: float = 0.0
    kvcache_bytes: int = 0   # resident-bytes budget (kvcache tier)
    burst_s: float = 1.0     # bucket depth, seconds of rate


def parse_spec(spec: str) -> Dict[str, TenantQuota]:
    """Parse a quota-table spec; malformed entries raise ValueError (a
    config push must reject bad specs atomically, ConfigBase rules)."""
    out: Dict[str, TenantQuota] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields: Dict[str, str] = {}
        for part in entry.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"tenant spec field without '=': {part!r}")
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
        name = fields.pop("tenant", "")
        if not valid_tenant(name):
            raise ValueError(f"tenant spec entry with bad tenant=: {entry!r}")
        try:
            q = TenantQuota(
                weight=int(fields.pop("weight", 1)),
                bytes_per_s=float(fields.pop("bytes_per_s", 0.0)),
                iops=float(fields.pop("iops", 0.0)),
                kvcache_bytes=int(fields.pop("kvcache_bytes", 0)),
                burst_s=float(fields.pop("burst_s", 1.0)),
            )
        except ValueError as e:
            raise ValueError(f"tenant spec entry {entry!r}: {e}")
        if fields:
            raise ValueError(
                f"tenant spec entry {entry!r}: unknown fields "
                f"{sorted(fields)}")
        if q.weight < 1 or q.bytes_per_s < 0 or q.iops < 0 \
                or q.kvcache_bytes < 0 or q.burst_s <= 0:
            raise ValueError(f"tenant spec entry {entry!r}: out of range")
        if name in out:
            raise ValueError(f"tenant {name!r} listed twice")
        out[name] = q
    return out


def _check_spec(spec: str) -> bool:
    try:
        parse_spec(spec)
        return True
    except ValueError:
        return False


class TenantConfig(Config):
    """The hot-updatable ``[tenants]`` section every service binary
    carries. An empty spec = no quotas (weights default to 1, buckets
    unlimited) — tenancy still ATTRIBUTES (recorders, spans, nested WFQ
    lanes) even before an operator configures enforcement."""

    enabled = ConfigItem(True, hot=True)
    spec = ConfigItem("", hot=True, checker=_check_spec,
                      doc="semicolon-separated tenant quota rows; see "
                          "docs/tenancy.md")
    shed_retry_after_ms = ConfigItem(50, hot=True, checker=lambda v: v >= 1)


class _Bucket:
    """Minimal token bucket (qos.core.TokenBucket shape, kept local so
    the tenant plane has no import cycle with qos). rate <= 0 =
    unlimited; try_acquire returns 0.0 or the refill horizon seconds."""

    __slots__ = ("_lock", "_rate", "_burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float):
        self._lock = threading.Lock()
        self._rate = float(rate)
        self._burst = max(1.0, float(burst))
        self._tokens = self._burst
        self._last = time.monotonic()

    def configure(self, rate: float, burst: float) -> None:
        with self._lock:
            self._refill()
            was_unlimited = self._rate <= 0
            self._rate = float(rate)
            self._burst = max(1.0, float(burst))
            if was_unlimited:
                # the unlimited period kept the bucket conceptually full:
                # a freshly-introduced rate starts from its whole burst
                self._tokens = self._burst
            self._tokens = min(self._tokens, self._burst)

    def _refill(self) -> None:
        now = time.monotonic()
        if self._rate > 0:
            self._tokens = min(
                self._burst, self._tokens + (now - self._last) * self._rate)
        else:
            # an unlimited bucket stays FULL: when a config push later
            # introduces a rate, the tenant starts with its whole burst
            # instead of whatever residue the unlimited period left
            self._tokens = self._burst
        self._last = now

    def try_acquire(self, cost: float) -> float:
        if self._rate <= 0:
            return 0.0
        with self._lock:
            self._refill()
            if self._tokens >= cost:
                self._tokens -= cost
                return 0.0
            return (cost - self._tokens) / self._rate


class TenantRegistry:
    """Process-global tenant state: the quota table, per-tenant buckets,
    kvcache resident gauges and the ``tenant.*`` recorders.

    One registry per process (``registry()``), bound to the binary's
    ``[tenants]`` config section by ``apply_tenant_config`` so hot pushes
    reconfigure buckets in place (in-flight references stay valid, the
    AdmissionController.reload discipline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = True
        self.retry_after_ms = 50
        self._table: Dict[str, TenantQuota] = {}
        self._default = TenantQuota()
        # (tenant, axis) -> bucket; axis in {"bytes", "iops"}
        self._buckets: Dict[Tuple[str, str], _Bucket] = {}
        # tenant -> measured kvcache resident bytes (set by the GC
        # daemon's scans / charged incrementally by writers)
        self._kv_resident: Dict[str, float] = {}
        # recorder caches (lazy per tenant; see _recs)
        self._rec_admitted: Dict[str, object] = {}
        self._rec_bytes: Dict[str, object] = {}
        self._rec_shed: Dict[Tuple[str, str], object] = {}
        self._rec_wait: Dict[str, object] = {}
        self._rec_kv: Dict[str, object] = {}
        # process-lifetime totals (tests/drives; monitor counters reset
        # every collection window, these never do)
        self._totals: Dict[str, Dict[str, float]] = {}
        # reload hooks: fired after every configure() so mirrors of the
        # quota table (the native transport's C-side tenant gate,
        # rpc/native_net.py) re-sync on hot pushes — the same discipline
        # as AdmissionController.add_reload_hook
        self._reload_hooks: list = []

    def add_reload_hook(self, fn) -> None:
        self._reload_hooks.append(fn)
        try:
            fn(self)
        except Exception:
            pass

    def table_snapshot(self) -> Dict[str, TenantQuota]:
        """The configured rows (copy) — mirrors push exactly what an
        operator configured, never the lazily-minted per-tenant state."""
        with self._lock:
            return dict(self._table)

    # -- configuration ----------------------------------------------------
    def configure(self, spec: str, *, enabled: bool = True,
                  retry_after_ms: int = 50) -> None:
        """Install a quota table (atomic: a bad spec raises and leaves
        the previous table live). Existing buckets are reconfigured in
        place; tenants dropped from the table fall back to default."""
        table = parse_spec(spec)
        with self._lock:
            self._table = table
            self._default = table.get(DEFAULT_TENANT, TenantQuota())
            self.enabled = bool(enabled)
            self.retry_after_ms = int(retry_after_ms)
            for (tenant, axis), b in self._buckets.items():
                q = table.get(tenant, self._default)
                rate = q.bytes_per_s if axis == "bytes" else q.iops
                b.configure(rate, max(1.0, rate * q.burst_s))
        for fn in list(self._reload_hooks):
            try:
                fn(self)
            except Exception:
                pass

    def clear(self) -> None:
        """Tests/drives: back to the permissive boot state."""
        self.configure("")

    def quota(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._table.get(tenant, self._default)

    def weight(self, tenant: str) -> int:
        return max(1, int(self.quota(tenant).weight))

    def kvcache_budget(self, tenant: str) -> int:
        return int(self.quota(tenant).kvcache_bytes)

    # -- recorders --------------------------------------------------------
    # ONE declaration site per tenant.* name (recorder-registry rule);
    # instances are minted lazily per tenant and held strongly here.
    def _admitted_rec(self, tenant: str):
        rec = self._rec_admitted.get(tenant)
        if rec is None:
            from tpu3fs_torch.monitor.recorder import CounterRecorder

            tags = {"tenant": tenant}
            rec = CounterRecorder("tenant.admitted", tags)
            self._rec_admitted[tenant] = rec
        return rec

    def _bytes_rec(self, tenant: str):
        rec = self._rec_bytes.get(tenant)
        if rec is None:
            from tpu3fs_torch.monitor.recorder import CounterRecorder

            tags = {"tenant": tenant}
            rec = CounterRecorder("tenant.bytes", tags)
            self._rec_bytes[tenant] = rec
        return rec

    def _shed_rec(self, tenant: str, kind: str):
        rec = self._rec_shed.get((tenant, kind))
        if rec is None:
            from tpu3fs_torch.monitor.recorder import CounterRecorder

            tags = {"tenant": tenant, "kind": kind}
            rec = CounterRecorder("tenant.shed", tags)
            self._rec_shed[(tenant, kind)] = rec
        return rec

    def _wait_rec(self, tenant: str):
        rec = self._rec_wait.get(tenant)
        if rec is None:
            from tpu3fs_torch.monitor.recorder import DistributionRecorder

            tags = {"tenant": tenant}
            rec = DistributionRecorder("tenant.queue_wait_us", tags)
            self._rec_wait[tenant] = rec
        return rec

    def _kv_rec(self, tenant: str):
        rec = self._rec_kv.get(tenant)
        if rec is None:
            from tpu3fs_torch.monitor.recorder import ValueRecorder

            tags = {"tenant": tenant}
            rec = ValueRecorder("tenant.kvcache_bytes", tags)
            self._rec_kv[tenant] = rec
        return rec

    def _count(self, tenant: str, key: str, n: float = 1.0) -> None:
        with self._lock:
            t = self._totals.setdefault(tenant, {})
            t[key] = t.get(key, 0.0) + n

    # -- accounting (AdmissionController hook) ----------------------------
    def account_admit(self, tenant: str) -> None:
        """Per-tenant attribution of a CLASS-admission admit (called by
        qos.core.AdmissionController so `tenant.admitted` mirrors
        `qos.admitted` with a tenant tag)."""
        self._admitted_rec(tenant).add()
        self._count(tenant, "admitted")

    def account_shed(self, tenant: str) -> None:
        """Class-level shed attributed to its tenant (kind=class: the op
        was shed by its CLASS's limits, not the tenant's own quota)."""
        self._shed_rec(tenant, "class").add()
        self._count(tenant, "shed_class")

    def record_queue_wait(self, tenant: str, wait_s: float) -> None:
        self._wait_rec(tenant).record(wait_s * 1e6)

    # -- quota enforcement ------------------------------------------------
    def _bucket(self, tenant: str, axis: str) -> _Bucket:
        key = (tenant, axis)
        b = self._buckets.get(key)
        if b is None:
            with self._lock:
                b = self._buckets.get(key)
                if b is None:
                    q = self._table.get(tenant, self._default)
                    rate = q.bytes_per_s if axis == "bytes" else q.iops
                    b = _Bucket(rate, max(1.0, rate * q.burst_s))
                    self._buckets[key] = b
        return b

    def try_admit(self, tenant: str, *, ops: float = 1.0, nbytes: int = 0,
                  kv_charge: bool = False) -> Optional[int]:
        """Charge one op (or batch) against the tenant's quota buckets.
        -> None when admitted, else the retry-after hint (ms) for the
        TENANT_THROTTLED reply. Order: iops, then bytes, then the kvcache
        resident gate (cheapest refusal first); an iops take that then
        sheds on bytes is deliberately not refunded — the partial charge
        biases AGAINST a tenant already over one axis."""
        if not self.enabled:
            return None
        base = self.retry_after_ms
        wait = self._bucket(tenant, "iops").try_acquire(max(1.0, ops))
        if wait > 0.0:
            self._shed_rec(tenant, "iops").add(int(max(1, ops)))
            self._count(tenant, "shed_iops", max(1, ops))
            return max(base, int(wait * 1000) + 1)
        if nbytes > 0:
            wait = self._bucket(tenant, "bytes").try_acquire(float(nbytes))
            if wait > 0.0:
                self._shed_rec(tenant, "bytes").add(int(max(1, ops)))
                self._count(tenant, "shed_bytes", max(1, ops))
                return max(base, int(wait * 1000) + 1)
            self._bytes_rec(tenant).add(nbytes)
            self._count(tenant, "bytes", nbytes)
        if kv_charge:
            budget = self.kvcache_budget(tenant)
            if budget > 0 and self._kv_resident.get(tenant, 0.0) > budget:
                self._shed_rec(tenant, "kvcache").add(int(max(1, ops)))
                self._count(tenant, "shed_kvcache", max(1, ops))
                return base
        return None

    def shed_kvcache(self, tenant: str, n: int = 1) -> None:
        """Count a writer-side kvcache-budget shed (kvcache/cache.py)."""
        self._shed_rec(tenant, "kvcache").add(n)
        self._count(tenant, "shed_kvcache", n)

    # -- kvcache resident gauge -------------------------------------------
    def charge_kvcache(self, tenant: str, delta: int) -> None:
        """Incremental resident-bytes estimate from the writer's side
        (authoritative numbers come from set_kvcache_resident scans)."""
        with self._lock:
            v = max(0.0, self._kv_resident.get(tenant, 0.0) + delta)
            self._kv_resident[tenant] = v
        self._kv_rec(tenant).set(v)

    def set_kvcache_resident(self, tenant: str, nbytes: int) -> None:
        """Authoritative per-tenant resident bytes from a GC scan."""
        with self._lock:
            self._kv_resident[tenant] = float(max(0, nbytes))
        self._kv_rec(tenant).set(float(max(0, nbytes)))

    def kvcache_resident(self, tenant: str) -> int:
        with self._lock:
            return int(self._kv_resident.get(tenant, 0.0))

    def kvcache_over(self, tenant: str) -> bool:
        budget = self.kvcache_budget(tenant)
        return budget > 0 and self.kvcache_resident(tenant) > budget

    # -- views ------------------------------------------------------------
    def totals(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {t: dict(v) for t, v in self._totals.items()}

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant quota + live totals for the admin CLI."""
        with self._lock:
            names = set(self._table) | set(self._totals) \
                | {t for t, _ in self._buckets} | {DEFAULT_TENANT}
            out: Dict[str, dict] = {}
            for name in sorted(names):
                q = self._table.get(name, self._default)
                tot = self._totals.get(name, {})
                out[name] = {
                    "weight": q.weight,
                    "bytes_per_s": q.bytes_per_s,
                    "iops": q.iops,
                    "kvcache_bytes": q.kvcache_bytes,
                    "explicit": name in self._table,
                    "kv_resident": int(self._kv_resident.get(name, 0.0)),
                    "admitted": int(tot.get("admitted", 0)),
                    "bytes": int(tot.get("bytes", 0)),
                    "shed": int(tot.get("shed_iops", 0)
                                + tot.get("shed_bytes", 0)
                                + tot.get("shed_kvcache", 0)),
                    "shed_class": int(tot.get("shed_class", 0)),
                }
            return out

    def shed_total(self, tenant: str) -> int:
        """Quota sheds (all axes) for one tenant, process lifetime."""
        with self._lock:
            t = self._totals.get(tenant, {})
            return int(t.get("shed_iops", 0) + t.get("shed_bytes", 0)
                       + t.get("shed_kvcache", 0))


_REGISTRY = TenantRegistry()


def registry() -> TenantRegistry:
    return _REGISTRY


def apply_tenant_config(cfg: TenantConfig,
                        target: Optional[TenantRegistry] = None) -> None:
    """Bind a ``[tenants]`` config section to a registry and follow its
    hot updates (service binaries call this once at boot)."""
    reg = target if target is not None else _REGISTRY

    def _apply(_node=None):
        try:
            reg.configure(cfg.spec, enabled=bool(cfg.enabled),
                          retry_after_ms=int(cfg.shed_retry_after_ms))
        except ValueError:
            pass  # checker already rejected; belt and braces

    _apply()
    cfg.add_callback(_apply)
