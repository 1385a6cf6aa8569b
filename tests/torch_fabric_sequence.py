"""One seeded file sequence through an in-process fabric, for the fabric
parity tests: the same calls drive ``tpu3fs.fabric.Fabric`` and the port's
``tpu3fs_torch.fabric.Fabric``, and ``run_sequence`` returns a record of
everything a user or an operator could observe. This module imports
neither package: the caller hands it a booted fabric.

Two sources of the fabric's state are not seeded by the fabric itself: an
EC stripe version carries a writer nonce from ``os.urandom``, and a file's
layout seed comes from ``time.time_ns``. ``deterministic`` draws both from
a seed for the length of one run, so two runs store the same versions and
place chunks on the same chains."""

from __future__ import annotations

import contextlib
import itertools
from unittest import mock

import numpy as np

# meta's open flags (the same values in both packages)
WRITE, CREATE = 2, 4

SHAPES = {
    "ec_4_2": dict(num_storage_nodes=6, num_chains=2, chunk_size=16 << 10,
                   ec_k=4, ec_m=2),
    "ec_12_4": dict(num_storage_nodes=4, num_chains=2, chunk_size=48 << 10,
                    ec_k=12, ec_m=4),
    "cr_2": dict(num_storage_nodes=3, num_chains=2, num_replicas=2,
                 chunk_size=16 << 10),
}


@contextlib.contextmanager
def deterministic(seed: int = 0):
    """``os.urandom`` and ``time.time_ns`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ns = itertools.count(1_700_000_000_000_000_000, 1_000_003)
    with mock.patch("os.urandom", lambda n: rng.bytes(n)), \
            mock.patch("time.time_ns", lambda: next(ns)):
        yield


def stored(fab) -> dict:
    """target id -> [(chunk id, committed and pending versions, length,
    CRC, pending length and CRC, aux, committed bytes)] of every target."""
    out = {}
    for node in fab.nodes.values():
        for target in node.service.targets():
            eng = target.engine
            out[target.target_id] = sorted(
                ((m.chunk_id.file_id, m.chunk_id.index), m.committed_ver,
                 m.pending_ver, m.length, m.checksum.value,
                 m.pending_length, m.pending_checksum.value, m.aux,
                 eng.read(m.chunk_id) if m.committed_ver else b"")
                for m in eng.all_metadata())
    return out


def routing_state(fab) -> tuple:
    """(routing version, {chain: (chain version, [(target, public state)])})"""
    r = fab.routing()
    return (r.version, {cid: (c.chain_version,
                              [(t.target_id, t.public_state.name)
                               for t in c.targets])
                        for cid, c in sorted(r.chains.items())})


def _write_file(fab, fio, path: str, body: bytes):
    res = fab.meta.create(path, flags=WRITE | CREATE, client_id="seq")
    fio.write(res.inode, 0, body)
    return fab.meta.close(res.inode.id, res.session_id)


def run_sequence(fab, setenv, fresh_engine, seed: int = 0,
                 stripes: int = 5) -> dict:
    """Drive ``fab`` through the sequence and return its record. Every
    byte read back is checked against what was written.

    1. create ``/a`` and write ``stripes`` full chunks and a partial tail
       (full stripes through ``write_stripes``, the tail through the
       stripe read-modify-write); read it all and a sub-range;
    2. overwrite 777 bytes inside chunk 1 (the delta-parity RMW on EC);
    3. fail the first storage node; read the file back degraded; write
       ``/d`` while it is down;
    4. give its targets empty engines (``fresh_engine()``: a replaced
       disk), restart it and ``resync_all(rounds=6)`` (the EC rebuild, the
       CR resync); read both files again;
    5. with ``TPU3FS_EC_CHAIN_ENCODE=1`` (``setenv``) write ``/b`` and read
       it (the chain-encode hops on EC);
    6. write ``/c``, remove it and ``run_gc``.
    """
    cs = fab.cfg.chunk_size
    rng = np.random.default_rng(seed)

    def u8(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    fio = fab.file_client()
    rec = {"reads": []}

    def read(inode, want: bytes, off: int = 0):
        got = fio.read(inode, off, len(want))
        assert got == want, f"read of inode {inode.id} at {off} differs"
        rec["reads"].append(got)

    body = bytearray(u8(stripes * cs + cs // 3 + 5))
    a = _write_file(fab, fio, "/a", bytes(body))
    read(a, bytes(body))
    read(a, bytes(body[cs - 50:cs + 150]), cs - 50)
    patch = u8(777)
    fio.write(a, cs + 100, patch)
    body[cs + 100:cs + 100 + len(patch)] = patch
    read(a, bytes(body))

    victim = sorted(fab.nodes)[0]
    fab.fail_node(victim)
    rec["failed"] = routing_state(fab)
    read(a, bytes(body))
    d_body = u8(2 * cs + 17)
    d = _write_file(fab, fio, "/d", d_body)
    read(d, d_body)
    for target in fab.nodes[victim].service.targets():
        target.engine = fresh_engine()
    fab.restart_node(victim)
    rec["moved"] = fab.resync_all(rounds=6)
    read(a, bytes(body))
    read(d, d_body)

    setenv("TPU3FS_EC_CHAIN_ENCODE", "1")
    b_body = u8(stripes * cs)
    b = _write_file(fab, fio, "/b", b_body)
    setenv("TPU3FS_EC_CHAIN_ENCODE", "0")
    read(b, b_body)

    _write_file(fab, fio, "/c", u8(cs + 3))
    fab.meta.remove("/c")
    rec["gc"] = fab.run_gc()
    rec["lengths"] = {p: fab.meta.stat(p).length for p in ("/a", "/b", "/d")}
    rec["routing"] = routing_state(fab)
    rec["stored"] = stored(fab)
    client = fio.storage
    rec["ec_paths"] = {name: getattr(client, f"_ec_{name}")._value for name in
                       ("parity_rmw", "rmw_fallback", "degraded",
                        "chain_stripes", "chain_fallback")}
    return rec
