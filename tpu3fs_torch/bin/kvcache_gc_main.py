"""kvcache_gc: standalone KV-cache garbage-collection daemon.

The inference-side twin of ckpt_gc (bin/ckpt_gc_main.py): connects to a
live cluster like admin_cli (``--connect HOST:PORT``) and periodically
runs the two KVCacheGC passes over a cache root —

- TTL pass: cursor-scanned shard sweeps removing entries older than
  ``--ttl`` (never more than ``--max-shards`` leaf dirs per tick, so the
  sweep can never monopolize the metadata service);
- CAPACITY pass: oldest-touched LRU eviction down to a bytes budget —

both lease-respecting (an inference session's pinned prefix blocks are
never evicted mid-decode, kvcache/leases.py).

MULTI-TENANT (tpu3fs_torch/tenant, docs/tenancy.md): with ``--per-tenant``,
first-level subdirectories of the root whose names are valid tenant ids
are treated as per-tenant stores (the ``KVCacheClient(root=f"{root}/
{tenant}")`` layout). Each tick then runs a capacity pass PER TENANT
with that tenant's ``kvcache_bytes`` quota as the budget (falling back
to ``--capacity-bytes`` when the quota table has no row), and publishes
the measured per-tenant resident bytes to the tenant registry
(``tenant.kvcache_bytes`` gauge) — the authoritative figure behind the
writer-side resident-budget gate (kvcache/cache.py).

HOT CONFIG: each tick the daemon re-fetches the STORAGE config template
from mgmtd and re-applies its ``[tenants] spec`` to the local registry,
so a single ``admin_cli tenant-quota set`` push retunes the eviction
budgets of the running daemon — no restart, the same config plane every
service binary follows.

    python -m tpu3fs_torch.bin.kvcache_gc_main --connect HOST:PORT \
        [--root /kvcache] [--ttl 3600] [--capacity-bytes 0] \
        [--max-shards 64] [--per-tenant] [--interval 60] [--once]

Tests drive run_loop() directly against an in-process Fabric.

The port's own copy of ``tpu3fs/bin/kvcache_gc_main.py``. ``--device``
(default ``cuda``, raising without a card) is the device of the tool's
storage client, like every tool of the port; the passes themselves
remove entries through meta and move no chunk bytes. Its reports print
to the ``sys.stdout`` of the moment (``out=None``), so a caller that
redirects stdout around ``main`` gets them.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

from tpu3fs_torch.kvcache.cache import KVCacheGC
from tpu3fs_torch.tenant.identity import valid_tenant
from tpu3fs_torch.tenant.quota import registry
from tpu3fs_torch.utils.result import FsError


def _refresh_quota_table(fabric, *, out=None) -> None:
    """Pull the storage config template's [tenants] spec into the local
    registry (best-effort: a cluster without a pushed table keeps the
    daemon's current — default-permissive — state)."""
    try:
        from tpu3fs_torch.mgmtd.types import NodeType
        from tpu3fs_torch.utils.config import tomllib

        blob = fabric.mgmtd.get_config(NodeType.STORAGE)
        if blob is None or not blob.content or tomllib is None:
            return
        data = tomllib.loads(blob.content)
        sec = data.get("tenants")
        if isinstance(sec, dict) and "spec" in sec:
            registry().configure(
                str(sec.get("spec", "")),
                enabled=bool(sec.get("enabled", True)),
                retry_after_ms=int(sec.get("shed_retry_after_ms", 50)))
    except (FsError, ValueError, AttributeError) as e:
        print(f"kvcache-gc: config refresh skipped ({e!r})", file=out)


def tenant_roots(meta, root: str) -> Dict[str, str]:
    """First-level subdirs of `root` whose names are valid tenant ids ->
    their paths (the per-tenant store layout); {} when none."""
    out: Dict[str, str] = {}
    try:
        for e in meta.list_dir(root):
            if valid_tenant(e.name):
                out[e.name] = f"{root.rstrip('/')}/{e.name}"
    except FsError:
        pass
    return out


def build_gc(meta, root: str, args: argparse.Namespace) -> KVCacheGC:
    return KVCacheGC(
        meta,
        root=root,
        ttl_s=args.ttl,
        max_shards=args.max_shards,
        capacity_bytes=args.capacity_bytes or None,
        client_id="kvcache-gc",
    )


def run_once(fabric, args: argparse.Namespace, *,
             gcs: Dict[str, KVCacheGC], out=None) -> Dict[str, int]:
    """One tick: quota refresh, TTL + capacity passes (global or
    per-tenant), resident-gauge publish. Returns counters."""
    meta = fabric.meta
    stats = {"removed_ttl": 0, "removed_capacity": 0, "tenants": 0}
    _refresh_quota_table(fabric, out=out)
    roots: Dict[str, str] = {}
    if args.per_tenant:
        roots = tenant_roots(meta, args.root)
    if not roots:
        roots = {"": args.root}
    for tenant, root in sorted(roots.items()):
        gc = gcs.get(root)
        if gc is None:
            gc = gcs[root] = build_gc(meta, root, args)
        stats["removed_ttl"] += gc.run_once()
        budget = args.capacity_bytes or None
        if tenant:
            stats["tenants"] += 1
            quota_budget = registry().kvcache_budget(tenant)
            if quota_budget > 0:
                budget = quota_budget
        if budget:
            stats["removed_capacity"] += gc.capacity_pass(
                capacity_bytes=budget)
        if tenant:
            # authoritative resident figure AFTER eviction: one scan,
            # published to the registry gauge the writer-side budget
            # gate consults (kvcache/cache.py _check_resident_budget)
            resident = sum(length for _, length, _, _
                           in gc.scan_entries())
            registry().set_kvcache_resident(tenant, resident)
            print(f"kvcache-gc: tenant={tenant} resident={resident} "
                  f"budget={budget or 0}", file=out)
    return stats


def run_loop(fabric, args: argparse.Namespace, *, out=None) -> int:
    """Sweep until stopped (or once); returns total entries removed."""
    gcs: Dict[str, KVCacheGC] = {}
    total = 0
    while True:
        stats = run_once(fabric, args, gcs=gcs, out=out)
        total += stats["removed_ttl"] + stats["removed_capacity"]
        print(f"kvcache-gc: root={args.root} "
              f"ttl_removed={stats['removed_ttl']} "
              f"capacity_removed={stats['removed_capacity']} "
              f"tenants={stats['tenants']}", file=out)
        if args.once:
            return total
        time.sleep(args.interval)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="kvcache_gc", description=__doc__)
    p.add_argument("--connect", metavar="HOST:PORT",
                   help="mgmtd address of a live cluster")
    p.add_argument("--token", default="", help="bearer token (auth mode)")
    p.add_argument("--root", default="/kvcache")
    p.add_argument("--ttl", type=float, default=3600.0,
                   help="seconds since last touch before an entry is "
                        "TTL-evictable")
    p.add_argument("--capacity-bytes", type=int, default=0,
                   help="global bytes budget for the capacity pass "
                        "(0 = TTL only; per-tenant quotas override)")
    p.add_argument("--max-shards", type=int, default=64,
                   help="leaf dirs visited per TTL tick")
    p.add_argument("--per-tenant", action="store_true",
                   help="treat <root>/<tenant> subdirs as per-tenant "
                        "stores budgeted by their kvcache_bytes quota")
    p.add_argument("--interval", type=float, default=60.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("--device", default=None,
                   help="device of the tool's storage client (default "
                        "cuda; raises without a card unless cpu)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.connect:
        print("kvcache_gc: --connect HOST:PORT is required",
              file=sys.stderr)
        return 2
    from tpu3fs_torch.cli import RpcFabricView

    host, port_s = args.connect.rsplit(":", 1)
    fabric = RpcFabricView((host, int(port_s)), token=args.token,
                           client_id="kvcache-gc", device=args.device)
    try:
        run_loop(fabric, args)
    finally:
        fabric.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
