"""The port's serving stack against the JAX package's, tolerance 0.

One seeded file sequence (``tests/torch_fabric_sequence.py``: meta create,
full and partial stripe writes, reads, the delta-parity overwrite, a node
failure, the degraded read and a write while it is down, an empty-disk
restart and ``resync_all``, a chain-encoded
file, remove and ``run_gc``) runs through ``tpu3fs.fabric.Fabric`` and
``tpu3fs_torch.fabric.Fabric(cfg, device="cpu")`` with the same client
seed, at RS(4,2) on 6 nodes, RS(12,4) on 4 nodes and a CR fabric of two
replicas on 3 nodes. The two must read the same bytes, store the same
chunks (bytes, versions, CRCs), reach the same routing version and target
states, and give the same file lengths. Which replica served a read is not
compared."""

import pytest

import tpu3fs.fabric as jax_fabric
import tpu3fs_torch.fabric as port_fabric
from torch_fabric_sequence import SHAPES, deterministic, run_sequence
from tpu3fs.storage.engine import MemChunkEngine as JaxEngine
from tpu3fs_torch.storage.engine import MemChunkEngine as PortEngine


def _run(pkg, shape: str, monkeypatch, **kw) -> dict:
    monkeypatch.setenv("TPU3FS_EC_CHAIN_ENCODE", "0")
    fresh = (JaxEngine if pkg is jax_fabric
             else lambda: PortEngine(device=kw["device"]))
    with deterministic(seed=5):
        fab = pkg.Fabric(pkg.SystemSetupConfig(**SHAPES[shape]), **kw)
        return run_sequence(fab, monkeypatch.setenv, fresh, seed=9)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fabric_sequence_matches_jax(shape, monkeypatch):
    want = _run(jax_fabric, shape, monkeypatch)
    got = _run(port_fabric, shape, monkeypatch, device="cpu")
    assert got["reads"] == want["reads"]
    assert got["lengths"] == want["lengths"]
    assert got["failed"] == want["failed"]
    assert got["routing"] == want["routing"]
    assert (got["moved"], got["gc"]) == (want["moved"], want["gc"])
    assert got["stored"].keys() == want["stored"].keys()
    for tid, rows in want["stored"].items():
        assert got["stored"][tid] == rows, f"target {tid}"


@pytest.mark.parametrize("shape", ["ec_4_2", "ec_12_4"])
def test_fabric_sequence_exercises_every_ec_path(shape, monkeypatch):
    """The sequence reaches what it is meant to hold, through the port's
    codec on the CPU: the client encode, the delta-parity RMW, degraded
    reads, the rebuild of every shard of the replaced disk and the chain
    encode. The delta path falls back only for the three fresh partial
    tails (of ``/a``, ``/d`` and ``/c``), which have no stripe to patch."""
    from tpu3fs_torch.ops.crc32c import BatchCrc32c
    from tpu3fs_torch.ops.gf2_matmul import gf2_matmul_plain

    k1, k2 = gf2_matmul_plain.calls, BatchCrc32c.compute.calls
    rec = _run(port_fabric, shape, monkeypatch, device="cpu")
    assert gf2_matmul_plain.calls > k1 and BatchCrc32c.compute.calls > k2
    paths = rec["ec_paths"]
    assert paths["parity_rmw"] >= 1 and paths["degraded"] >= 1
    assert paths["chain_stripes"] == 5 and paths["chain_fallback"] == 0
    assert paths["rmw_fallback"] == 3
    assert rec["moved"] >= 1 and rec["gc"] == 1
    assert all(state == "SERVING" for _, (_, ts) in rec["routing"][1].items()
               for _, state in ts)
