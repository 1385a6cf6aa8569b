"""State carried across from the JAX package: ``convert.fabric_from_dump``
loads a plain dump of a JAX fabric (its KV pairs and every target's
chunks) into the port's ``Fabric`` on the CPU, and the port's file client
reads back every file the JAX fabric wrote. Tolerance 0."""

import numpy as np
import pytest

import tpu3fs.fabric as jax_fabric
from torch_fabric_sequence import (CREATE, SHAPES, WRITE, deterministic,
                                         routing_state, stored)
from tpu3fs_torch import convert


def _dump(fab) -> dict:
    targets = {}
    for node in fab.nodes.values():
        for t in node.service.targets():
            eng = t.engine
            targets[t.target_id] = [
                {"chunk_id": (m.chunk_id.file_id, m.chunk_id.index),
                 "committed_ver": m.committed_ver, "chain_ver": m.chain_ver,
                 "data": eng.read(m.chunk_id), "crc": m.checksum.value,
                 "length": m.length, "aux": m.aux}
                for m in eng.all_metadata() if m.committed_ver]
    return {"kv": fab.kv.dump_at(fab.kv.version), "clock": fab.clock(),
            "targets": targets}


def _files(fab) -> dict:
    return {e.name: fab.meta.stat("/" + e.name)
            for e in fab.meta.list_dir("/")}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fabric_from_jax_dump(shape):
    cfg = SHAPES[shape]
    cs = cfg["chunk_size"]
    rng = np.random.default_rng(3)
    bodies = {f"f{i}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for i, n in enumerate([3 * cs, cs // 2 + 1, 2 * cs + 99, 0])}
    with deterministic(seed=2):
        jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**cfg))
        jio = jfab.file_client()
        for name, body in bodies.items():
            res = jfab.meta.create("/" + name, flags=WRITE | CREATE)
            jio.write(res.inode, 0, body)
            jfab.meta.close(res.inode.id, res.session_id)
        jio.write(jfab.meta.stat("/f0"), cs + 5, b"\x07" * 300)
        dump = _dump(jfab)

    from tpu3fs_torch.fabric import SystemSetupConfig

    fab = convert.fabric_from_dump(dump, SystemSetupConfig(**cfg),
                                   device="cpu")
    assert routing_state(fab)[1] == routing_state(jfab)[1]
    assert stored(fab) == stored(jfab)
    files = _files(fab)
    assert {n: i.length for n, i in files.items()} == \
        {n: i.length for n, i in _files(jfab).items()}
    fio = fab.file_client()
    for name, inode in files.items():
        assert fio.read(inode, 0, inode.length) == \
            jio.read(jfab.meta.stat("/" + name), 0, inode.length)
    # the loaded fabric keeps serving: a new file, then a node failure
    res = fab.meta.create("/new", flags=WRITE | CREATE)
    body = rng.integers(0, 256, cs + 7, dtype=np.uint8).tobytes()
    fio.write(res.inode, 0, body)
    new = fab.meta.close(res.inode.id, res.session_id)
    assert new.id not in {i.id for i in files.values()}
    fab.fail_node(sorted(fab.nodes)[-1])
    assert fio.read(new, 0, len(body)) == body
    assert fio.read(files["f0"], 0, files["f0"].length) == \
        jio.read(jfab.meta.stat("/f0"), 0, files["f0"].length)


def test_fabric_from_dump_refuses_another_layout():
    with deterministic(seed=2):
        jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**SHAPES["cr_2"]))
        dump = _dump(jfab)
    from tpu3fs_torch.fabric import SystemSetupConfig

    with pytest.raises(ValueError, match="targets"):
        convert.fabric_from_dump(
            dump, SystemSetupConfig(**dict(SHAPES["cr_2"], num_chains=3)),
            device="cpu")
