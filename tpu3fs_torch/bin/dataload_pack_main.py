"""dataload_pack: pack local sample files into a tpu3fs record file.

The FFRecord-style ingest tool (the reference ships a companion packer
for exactly this): each input file becomes one record of a packed
record file (tpu3fs_torch/dataload/recordio.py) — fixed header, per-record
offset index + CRC32C, atomic ``.tmp`` → rename commit — written into a
live cluster through the striped client write path.

    python -m tpu3fs_torch.bin.dataload_pack_main --connect HOST:PORT \
        --out /data/train.rec SAMPLE_FILE... [--from-dir DIR]

    python -m tpu3fs_torch.bin.dataload_pack_main --connect HOST:PORT \
        --inspect /data/train.rec

Tests drive run() directly against an in-process Fabric.

The port's own copy of ``tpu3fs/bin/dataload_pack_main.py``.
``--device`` (default ``cuda``, raising without a card) is the device of
the tool's storage client: the writer's record CRCs (one K2 launch a
flushed run) and the stripe encode of the packed file run there. Its
reports print to the ``sys.stdout`` of the moment (``out=None``), so a
caller that redirects stdout around ``main`` gets them.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from tpu3fs_torch.utils.result import Code, FsError


def _inputs(args: argparse.Namespace) -> List[str]:
    paths = list(args.files)
    if args.from_dir:
        paths.extend(
            os.path.join(args.from_dir, name)
            for name in sorted(os.listdir(args.from_dir))
            if os.path.isfile(os.path.join(args.from_dir, name)))
    return paths


def run(fabric, args: argparse.Namespace, *, out=None) -> int:
    """Pack (or inspect) against any fabric-shaped object; returns an
    exit code."""
    from tpu3fs_torch.dataload.recordio import RecordFile, RecordFileWriter

    fio = fabric.file_client()
    if args.inspect:
        rf = RecordFile.open(fabric.meta, fio, args.inspect)
        for k, v in rf.summary().items():
            print(f"{k}: {v}", file=out)
        return 0

    paths = _inputs(args)
    if not paths:
        print("dataload_pack: no input files", file=sys.stderr)
        return 2
    parent = args.out.rsplit("/", 1)[0]
    if parent:
        try:
            fabric.meta.mkdirs(parent, recursive=True)
        except FsError as e:
            if e.code != Code.META_EXISTS:
                raise
    writer = RecordFileWriter(fabric.meta, fio, args.out,
                              num_records=len(paths))
    total = 0
    try:
        for p in paths:
            with open(p, "rb") as f:
                payload = f.read()
            writer.append(payload)
            total += len(payload)
    except BaseException:
        writer.abort()
        raise
    rf = writer.commit()
    print(f"packed {rf.num_records} records, {total} payload bytes "
          f"-> {args.out}", file=out)
    return 0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="dataload_pack", description=__doc__)
    p.add_argument("--connect", metavar="HOST:PORT",
                   help="mgmtd address of a live cluster")
    p.add_argument("--token", default="", help="bearer token (auth mode)")
    p.add_argument("--out", default="",
                   help="destination record file path in the FS")
    p.add_argument("--from-dir", default="",
                   help="pack every regular file under DIR (sorted)")
    p.add_argument("--inspect", default="",
                   help="print a packed file's summary instead of packing")
    p.add_argument("--device", default=None,
                   help="device of the tool's storage client (default "
                        "cuda; raises without a card unless cpu)")
    p.add_argument("files", nargs="*", help="local sample files to pack")
    args = p.parse_args(argv)
    if not args.inspect and not args.out:
        p.error("--out (or --inspect) is required")
    return args


def main(argv: Optional[List[str]] = None) -> int:  # pragma: no cover
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.connect:
        print("dataload_pack: --connect HOST:PORT is required",
              file=sys.stderr)
        return 2
    from tpu3fs_torch.cli import RpcFabricView

    host, port_s = args.connect.rsplit(":", 1)
    fabric = RpcFabricView((host, int(port_s)), token=args.token,
                           client_id="dataload-pack", device=args.device)
    try:
        return run(fabric, args)
    finally:
        fabric.close()


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
