"""One seeded checkpoint sequence through an in-process fabric, for the
checkpoint parity tests: the same calls drive the JAX package's
``tpu3fs.ckpt`` over its ``Fabric`` and the port's ``tpu3fs_torch.ckpt``
over its ``Fabric(cfg, device="cpu")``, and ``run_sequence`` returns a
record of everything a user or an operator could observe. This module
imports neither package: the caller hands it a booted fabric, the
package's modules and how to make and read its arrays.

The steps:

1. save step 1 (sync); restore it verified (``like=None`` and with array
   templates) and byte-range exact (``verify=False``);
2. ``save_async`` step 2 and wait for its commit;
3. fail the first storage node; save step 3 while it is down; restore
   steps 3 and 1 degraded; restart the node and ``resync_all``;
4. retention GC keep-last-2: step 1 goes to the trash;
5. archive step 2 onto an erasure-coded chain added for it, and restore
   it in both read modes.

What the fabric does not seed itself is drawn from a seed
(``deterministic``): EC writer nonces (``os.urandom``), save-session ids
(``uuid.uuid4``), layout seeds (``time.time_ns``) and the wall clock of
meta's inode times; the manager reads the same step clock.
"""

from __future__ import annotations

import contextlib
import uuid
from unittest import mock

import numpy as np

from torch_fabric_sequence import stored
from torch_kvcache_sequence import deterministic as _deterministic

SHAPES = {
    "ec_4_2": dict(num_storage_nodes=6, num_chains=2, chunk_size=4096,
                   ec_k=4, ec_m=2),
    "cr_2": dict(num_storage_nodes=3, num_chains=2, num_replicas=2,
                 chunk_size=4096),
}
#: (k, m) of the erasure-coded chain each shape archives onto
ARCHIVE_EC = {"ec_4_2": (3, 1), "cr_2": (2, 1)}
ARCHIVE_CHAIN = 990_001


@contextlib.contextmanager
def deterministic(clock_modules, seed: int = 0):
    """``os.urandom`` per draw size and ``uuid.uuid4`` from ``seed``; the
    modules' ``time`` replaced by one step clock, which is yielded."""
    ids = np.random.default_rng([seed, 4])
    with _deterministic(clock_modules, seed) as clock, \
            mock.patch("uuid.uuid4",
                       lambda: uuid.UUID(bytes=ids.bytes(16), version=4)):
        yield clock


def tree_arrays(seed: int = 0) -> dict:
    """The checkpointed pytree's values as numpy: float32 weights of 2
    chunks and a partial one, a bias, an int32 optimizer slot and two
    scalars."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((48, 40)).astype(np.float32),
                   "b": rng.standard_normal((40,)).astype(np.float32)},
        "opt": [np.arange(12, dtype=np.int32).reshape(3, 4),
                (np.float64(0.125),)],
        "step_count": np.int64(7),
    }


def tree_of(values: dict, make) -> dict:
    """The pytree with its float32 leaves made by ``make`` (the package's
    device arrays) and the rest left numpy."""
    return {"params": {k: make(v) for k, v in values["params"].items()},
            "opt": values["opt"], "step_count": values["step_count"]}


def flat(tree, to_host) -> list:
    """(keypath, dtype, shape, bytes) of every leaf, in tree order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            arr = np.asarray(to_host(node))
            out.append(("/".join(path), arr.dtype.str, arr.shape,
                        arr.tobytes()))

    walk(tree, [])
    return out


def add_ec_chain(fab, pkg, k: int, m: int, target_kw) -> object:
    """One EC(k, m) chain of fresh mem targets over the first k + m nodes
    (round robin), and a layout on it: the archive's target."""
    node_ids = sorted(fab.nodes)
    tids = []
    for i in range(k + m):
        tid = 5000 + i
        nid = node_ids[i % len(node_ids)]
        fab.mgmtd.create_target(tid, node_id=nid)
        fab.nodes[nid].service.add_target(pkg.StorageTarget(
            tid, ARCHIVE_CHAIN, engine="mem",
            chunk_size=pkg.shard_size_of(fab.cfg.chunk_size, k),
            **target_kw))
        tids.append(tid)
    fab.mgmtd.upload_chain(ARCHIVE_CHAIN, tids, ec_k=k, ec_m=m)
    fab.heartbeat_all()
    fab.tick()
    return pkg.Layout(table_id=1, chains=[ARCHIVE_CHAIN],
                      chunk_size=fab.cfg.chunk_size, seed=1)


def run_sequence(fab, pkg, clock, shape: str, make, to_host,
                 target_kw=None) -> dict:
    """Drive steps 1-5 (module docstring) on ``fab`` and return the
    record. ``pkg`` gives ``ckpt``, ``trash``, ``StorageTarget``,
    ``shard_size_of`` and ``Layout``; ``make`` turns a float32 numpy
    array into the package's array (also the templates' leaves);
    ``to_host`` turns a restored leaf into numpy. Every restore is
    checked against the saved values."""
    values = tree_arrays()
    want = flat(values, np.asarray)
    tree = tree_of(values, make)
    like = tree_of({"params": {k: np.zeros_like(v)
                               for k, v in values["params"].items()},
                    "opt": values["opt"],
                    "step_count": values["step_count"]}, make)
    mgr = pkg.ckpt.CheckpointManager(
        fab.meta, fab.file_client(), kv=fab.kv, clock=clock.time,
        policy=pkg.ckpt.RetentionPolicy(keep_last=2))
    rec = {"manifests": {}, "restores": {}}

    def restore(name, step, **kw):
        got = flat(mgr.restore(step, **kw), to_host)
        assert got == want, f"{name}: restored leaves differ"
        rec["restores"][name] = got

    def manifest(step):
        rec["manifests"][step] = mgr.manifest(step).encode()

    # 1: sync save, verified and byte-range-exact restores
    clock.advance()
    mgr.save(tree, 1)
    manifest(1)
    restore("verified", 1)
    restore("verified_like", 1, like=like)
    restore("ranged_like", 1, like=like, verify=False)
    # 2: async save, its commit barrier
    clock.advance()
    rec["async"] = mgr.save_async(tree, 2).result(60.0)
    manifest(2)
    # 3: a node down: a save and degraded restores; restart and resync
    clock.advance()
    victim = sorted(fab.nodes)[0]
    fab.fail_node(victim)
    mgr.save(tree, 3)
    manifest(3)
    restore("degraded_3", 3, like=like)
    restore("degraded_1", 1, verify=False)
    fab.restart_node(victim)
    rec["resynced"] = fab.resync_all(rounds=6)
    rec["stored_saved"] = stored(fab)
    # 4: keep-last-2 retention through the trash
    clock.advance()
    rec["gc_removed"] = mgr.run_gc()
    rec["steps"] = mgr.steps()
    rec["trash"] = sorted((e.orig_name, e.create_ts, e.keep_s)
                          for e in pkg.trash.list_trash(fab.meta))
    # 5: archive step 2 onto an EC chain; restores read its stripes
    clock.advance()
    k, m = ARCHIVE_EC[shape]
    layout = add_ec_chain(fab, pkg, k, m, target_kw or {})
    rec["archived"] = mgr.archive(2, layout).encode()
    rec["archived_chains"] = fab.meta.stat(
        f"{mgr.root}/2/l0.s0").layout.chains
    restore("archived", 2)
    restore("archived_ranged", 2, like=like, verify=False)
    rec["stored"] = stored(fab)
    return rec
