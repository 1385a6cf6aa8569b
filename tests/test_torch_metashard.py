"""The port's partitioned metadata plane (``tpu3fs_torch.metashard.store``)
and meta distributor (``meta.distributor``) against the JAX package's.

One seeded op sequence runs through a JAX ``ShardedMetaStore`` and a port
one, each with 4 partitions over its package's in-memory KV and a second
store over the same KV whose owner view holds only some partitions:
mkdirs, creates (single and batched) into directories on different
partitions, by-path and by-inode ops, ``META_WRONG_PARTITION`` fences,
cross-partition renames and hardlinks through two-phase, a rename crashed
after its prepare and rolled forward by the resolver, removes, and the
per-partition op counts. The clock, session uuids and two-phase txn ids
are drawn from a seed, so replies (serialised), error codes, inode ids
(with their partition tag) and the KV contents must be equal. The
``Distributor`` and ``rendezvous_owner`` on seeded server ids must agree
too. Tolerance 0."""

import contextlib
import dataclasses
import importlib
import itertools
import uuid
from unittest import mock

import numpy as np
import pytest

PKGS = ("tpu3fs", "tpu3fs_torch")
NPARTS = 4


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def deterministic(seed: int):
    """``time.time``, ``time.time_ns``, ``uuid.uuid4`` and
    ``secrets.token_hex`` drawn from ``seed``: inode times, layout seeds,
    session ids and two-phase txn ids."""
    rng = np.random.default_rng(seed)
    clock = itertools.count(1_700_000_000.0, 0.25)
    ns = itertools.count(1_700_000_000_000_000_000, 1_000_003)
    with mock.patch("time.time", lambda: next(clock)), \
            mock.patch("time.time_ns", lambda: next(ns)), \
            mock.patch("uuid.uuid4",
                       lambda: uuid.UUID(bytes=rng.bytes(16), version=4)), \
            mock.patch("secrets.token_hex",
                       lambda n=32: rng.bytes(n).hex()):
        yield


def _rec(pkg: str, x):
    """A reply as comparable data: dataclasses serialised by the package's
    own serde, containers element by element."""
    serde = mod(pkg, "rpc.serde")
    if dataclasses.is_dataclass(x):
        return serde.serialize(x)
    if isinstance(x, (list, tuple)):
        return [_rec(pkg, v) for v in x]
    if isinstance(x, dict):
        return {k: _rec(pkg, v) for k, v in sorted(x.items())}
    if isinstance(x, BaseException):
        return ("error", int(getattr(x, "code", -1)))
    return x


def run_sequence(pkg: str, seed: int) -> dict:
    store_mod = mod(pkg, "metashard.store")
    meta = mod(pkg, "meta.store")
    mem = mod(pkg, "kv.mem")
    result = mod(pkg, "utils.result")
    plane = mod(pkg, "utils.fault_injection").plane
    twophase = mod(pkg, "metashard.twophase")
    root = meta.ROOT_USER
    rng = np.random.default_rng(seed)
    out = []

    def step(name, fn):
        try:
            got = fn()
        except result.FsError as e:
            got = e
        out.append((name, _rec(pkg, got)))
        return got

    with deterministic(seed):
        eng = mem.MemKVEngine()
        st = store_mod.ShardedMetaStore(
            eng, meta.ChainAllocator(1, [901, 902]), nparts=NPARTS)
        dirs = [f"/d{i}" for i in range(8)]
        for d in dirs:
            step(f"mkdirs {d}", lambda d=d: st.mkdirs(d, root,
                                                      recursive=True))
        pids = {d: st.pid_of_dir(d) for d in dirs}
        out.append(("pids", pids))
        files = []
        for i in range(24):
            d = dirs[int(rng.integers(0, len(dirs)))]
            path = f"{d}/f{i}"
            res = step(f"create {path}", lambda p=path: st.create(
                p, root, flags=meta.OpenFlags.WRITE, client_id="seq"))
            if not isinstance(res, BaseException):
                files.append((path, res))
        items = [meta.BatchCreateItem(path=f"{dirs[j % 8]}/b{j}",
                                      client_id="seq") for j in range(10)]
        step("batch_create", lambda: st.batch_create(items, root))
        ids = [r.inode.id for _, r in files]
        out.append(("inode pids", [(i, st.pid_of_inode(i)) for i in ids]))
        step("batch_stat", lambda: st.batch_stat(ids[:12]))
        for path, res in files[:8]:
            step(f"close {path}", lambda r=res: st.close(
                r.inode.id, r.session_id, length_hint=int(rng.integers(
                    0, 1 << 20)), client_id="seq"))
            step(f"stat {path}", lambda p=path: st.stat(p, root))
        step("set_attr", lambda: st.set_attr(files[0][0], root, perm=0o600))
        step("list_dir", lambda: st.list_dir(dirs[0], root))
        step("symlink", lambda: st.symlink(f"{dirs[1]}/ln", files[1][0],
                                           root))
        # renames: within one directory, then across partitions
        a, b = dirs[0], next(d for d in dirs if pids[d] != pids[dirs[0]])
        step("rename local", lambda: st.rename(files[2][0],
                                               f"{files[2][0]}.r", root))
        src = next(p for p, _ in files if p.startswith(a + "/")
                   and p != files[2][0])
        step("rename cross", lambda: st.rename(src, f"{b}/moved", root))
        step("stat moved", lambda: st.stat(f"{b}/moved", root))
        step("hard_link cross", lambda: st.hard_link(
            files[3][0], f"{b}/hl", root))
        # a coordinator crash after the prepare, rolled forward
        victim = files[4][0]
        dst = next(d for d in dirs if pids[d] != st.pid_of_path(victim))
        plane().configure("point=meta.twophase.prepared,kind=error,times=1")
        try:
            step("rename crashed", lambda: st.rename(victim, f"{dst}/rf",
                                                     root))
        finally:
            plane().clear()
        out.append(("dangling", len(twophase.list_intents(eng)),
                    len(twophase.list_prepares(eng))))
        step("resolve", lambda: st.resolve_intents(force=True))
        step("stat rolled", lambda: st.stat(f"{dst}/rf", root))
        step("remove", lambda: st.remove(files[5][0], root))
        step("remove missing", lambda: st.remove(files[5][0], root))
        # a store over the same KV owning two partitions: fenced elsewhere
        owned = {pids[a], pids[b]}
        fenced = store_mod.ShardedMetaStore(
            eng, meta.ChainAllocator(1, [901, 902]), nparts=NPARTS,
            owner_view=lambda: owned)
        for d in dirs:
            step(f"fenced create {d}", lambda d=d: fenced.create(
                f"{d}/x", root, client_id="fence"))
            step(f"fenced stat {d}", lambda d=d: fenced.stat(d, root))
        for i in ids[:6]:
            step(f"fenced by-inode {i}", lambda i=i: fenced.batch_stat([i]))
        out.append(("loads", st.snapshot_loads(), fenced.snapshot_loads()))
        out.append(("kv", eng.dump_at(eng.version)))
    return {"steps": out, "ids": ids}


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_meta_sequence_equal(seed):
    jax_run, port_run = (run_sequence(pkg, seed) for pkg in PKGS)
    assert port_run["ids"] == jax_run["ids"]
    # the files' inode ids carry more than one partition's tag
    pids = {pid for _, pid in next(
        s[1] for s in jax_run["steps"] if s[0] == "inode pids")}
    assert len(pids) > 1
    codes = [s[1] for s in jax_run["steps"] if s[0].startswith("fenced")
             and isinstance(s[1], tuple)]
    wrong = int(mod("tpu3fs", "utils.result").Code.META_WRONG_PARTITION)
    assert ("error", wrong) in codes
    for i, (j, p) in enumerate(zip(jax_run["steps"], port_run["steps"])):
        assert p == j, f"step {i} ({j[0]}) differs"


@pytest.mark.parametrize("seed", [3, 4])
def test_distributor_and_rendezvous_owner_equal(seed):
    rng = np.random.default_rng(seed)
    servers = sorted({int(s) for s in rng.integers(1, 1 << 40, 7)})
    inodes = [int(i) for i in rng.integers(0, 1 << 62, 64)]
    owners = {}
    for pkg in PKGS:
        dist = mod(pkg, "meta.distributor")
        mem = mod(pkg, "kv.mem")
        owners[pkg] = [dist.rendezvous_owner(servers, i) for i in inodes]
        eng = mem.MemKVEngine()
        now = [100.0]
        members = [dist.Distributor(eng, s, timeout_s=30.0,
                                    clock=lambda: now[0]) for s in servers]
        for m in members:
            m.heartbeat()
        now[0] = 120.0
        members[0].heartbeat()          # the others age past 30 s later
        members[1].leave()
        got = [members[0].active_servers()]
        got.append([members[0].owner(i) for i in inodes])
        now[0] = 140.0
        got.append(members[0].active_servers())
        got.append([members[2].is_owner(i) for i in inodes])
        got.append(eng.dump_at(eng.version))
        owners[pkg] = (owners[pkg], got)
    assert owners["tpu3fs_torch"] == owners["tpu3fs"]
    assert len(set(owners["tpu3fs"][0])) > 1
