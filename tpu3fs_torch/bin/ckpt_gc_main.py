"""ckpt_gc: standalone checkpoint-retention daemon.

The training-side twin of the trash cleaner (src/client/trash_cleaner):
connects to a live cluster like admin_cli (--connect HOST:PORT), then
periodically runs the retention sweep over one checkpoint root —
keep-last-N / keep-every-K eviction through the trash subsystem plus
stale ``.tmp`` reaping — under the ``ckpt`` QoS class so sweeps schedule
behind foreground IO.

With ``--archive-after N`` each tick ALSO auto-archives: committed steps
older than the newest N re-encode onto an erasure-coded layout
(CheckpointGC.archive_pass) — cold checkpoints stop paying replication's
capacity overhead without an operator ever issuing explicit archive
calls. The EC chains come from the cluster's routing table (filtered by
``--archive-ec-k/-m`` when given); already-EC steps are skipped, so the
sweep is idempotent.

    python -m tpu3fs_torch.bin.ckpt_gc_main --connect HOST:PORT \
        [--root /ckpt] [--keep-last 3] [--keep-every 0] \
        [--trash-keep 86400] [--interval 300] [--once] \
        [--archive-after N] [--archive-ec-k K] [--archive-ec-m M] \
        [--archive-chunk-size BYTES]

Tests drive run_loop() directly against an in-process Fabric.

The port's own copy of ``tpu3fs/bin/ckpt_gc_main.py``. ``--device``
(default ``cuda``, raising without a card) is the device of the tool's
storage client: an archive pass's EC re-encode (K1 at k = 12) and its
shard CRCs (K2) run there. Its reports print to the ``sys.stdout`` of
the moment (``out=None``), so a caller that redirects stdout around
``main`` gets them.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from tpu3fs_torch.ckpt.retention import CheckpointGC, RetentionPolicy


def build_gc(fabric, args: argparse.Namespace) -> CheckpointGC:
    return CheckpointGC(
        fabric.meta,
        fabric.file_client(),
        root=args.root,
        policy=RetentionPolicy(keep_last=args.keep_last,
                               keep_every=args.keep_every),
        trash_keep_s=args.trash_keep,
        tmp_ttl_s=args.tmp_ttl,
    )


def ec_archive_layout(fabric, args: argparse.Namespace):
    """EC layout for auto-archival, from the live routing table: every
    SERVING EC chain (optionally filtered to EC(k, m)). None when the
    cluster has no matching EC chains — archival is then skipped, not an
    error, so one daemon config works across clusters."""
    from tpu3fs_torch.meta.types import Layout

    routing = fabric.routing()
    chains = []
    for c in routing.chains.values():
        if not c.is_ec:
            continue
        if args.archive_ec_k and c.ec_k != args.archive_ec_k:
            continue
        if args.archive_ec_m and c.ec_m != args.archive_ec_m:
            continue
        chains.append(c.chain_id)
    if not chains:
        return None
    return Layout(table_id=1, chains=sorted(chains),
                  chunk_size=args.archive_chunk_size, seed=1)


def run_loop(fabric, args: argparse.Namespace, *, out=None) -> int:
    """Sweep until stopped (or once); returns total steps evicted."""
    gc = build_gc(fabric, args)
    total = 0
    while True:
        removed = gc.run_once()
        total += removed
        archived = 0
        if args.archive_after > 0:
            layout = ec_archive_layout(fabric, args)
            if layout is None:
                print("ckpt-gc: no EC chains in routing; archive pass "
                      "skipped", file=out)
            else:
                archived = gc.archive_pass(
                    layout, keep_replicated=args.archive_after)
        print(f"ckpt-gc: root={gc.root} evicted={removed} "
              f"archived={archived} steps_left={len(gc.steps())}",
              file=out)
        if args.once:
            return total
        time.sleep(args.interval)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="ckpt_gc", description=__doc__)
    p.add_argument("--connect", metavar="HOST:PORT",
                   help="mgmtd address of a live cluster")
    p.add_argument("--token", default="", help="bearer token (auth mode)")
    p.add_argument("--root", default="/ckpt")
    p.add_argument("--keep-last", type=int, default=3)
    p.add_argument("--keep-every", type=int, default=0)
    p.add_argument("--trash-keep", type=int, default=86400,
                   help="seconds an evicted step stays recoverable")
    p.add_argument("--tmp-ttl", type=float, default=3600.0,
                   help="age before a crashed save's .tmp dir is reaped")
    p.add_argument("--interval", type=float, default=300.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("--archive-after", type=int, default=0,
                   help="auto-archive steps older than the newest N onto "
                        "EC chains each tick (0 = off)")
    p.add_argument("--archive-ec-k", type=int, default=0,
                   help="only use EC chains with this k (0 = any)")
    p.add_argument("--archive-ec-m", type=int, default=0,
                   help="only use EC chains with this m (0 = any)")
    p.add_argument("--archive-chunk-size", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="device of the tool's storage client (default "
                        "cuda; raises without a card unless cpu)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.connect:
        print("ckpt_gc: --connect HOST:PORT is required", file=sys.stderr)
        return 2
    from tpu3fs_torch.cli import RpcFabricView

    host, port_s = args.connect.rsplit(":", 1)
    fabric = RpcFabricView((host, int(port_s)), token=args.token,
                           client_id="ckpt-gc", device=args.device)
    try:
        run_loop(fabric, args)
    finally:
        fabric.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
