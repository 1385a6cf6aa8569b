"""The checkpoint and data-loading slice on a CUDA card against the same
calls on the CPU: a verified restore (one K2 launch over the restore's
pieces), a restore onto ``cuda`` templates (tensors on the card), and a
packed record file's bytes and ``read_batch`` (one K2 launch a batch).
Tolerance 0.

Every test carries the ``gpu`` marker and skips without a card. The file
imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_train.py
"""

import numpy as np
import pytest
import torch

from tpu3fs_torch.ckpt import CheckpointManager
from tpu3fs_torch.dataload import RecordFileWriter
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.ops.crc32c import BatchCrc32c, crc32c_blocks

CFG = dict(num_storage_nodes=6, num_chains=2, chunk_size=64 << 10, ec_k=4,
           ec_m=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tree():
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((256, 300)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "n": np.int64(9)}


def _saved(device):
    fab = Fabric(SystemSetupConfig(**CFG), device=device)
    mgr = CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                            clock=lambda: 7.0)
    manifest = mgr.save(_tree(), 1)
    return fab, mgr, manifest


@pytest.mark.gpu
def test_verified_restore_on_the_card_matches_the_cpu(cuda_device):
    card, mgr, manifest = _saved(cuda_device)
    cpu, cpu_mgr, cpu_manifest = _saved("cpu")
    try:
        assert [s.crc for s in manifest.shards] == \
            [s.crc for s in cpu_manifest.shards]
        k2, plain = crc32c_blocks.launches, BatchCrc32c.compute.calls
        got = mgr.restore(1)
        assert BatchCrc32c.compute.calls == plain
        assert crc32c_blocks.launches > k2
        want = cpu_mgr.restore(1)
        for key, arr in _tree().items():
            assert np.array_equal(got[key], want[key])
            assert np.array_equal(got[key], arr)
    finally:
        card.close()
        cpu.close()


@pytest.mark.gpu
def test_restore_onto_cuda_templates_lands_on_the_card(cuda_device):
    fab, mgr, _ = _saved(cuda_device)
    try:
        tree = _tree()
        like = {"w": torch.empty((256, 300), device=cuda_device),
                "b": torch.empty((300,), device=cuda_device),
                "n": np.int64(0)}
        for verify in (True, False):
            got = mgr.restore(1, like=like, verify=verify)
            for key in ("w", "b"):
                assert got[key].device.type == "cuda"
                assert torch.equal(got[key].cpu(),
                                   torch.from_numpy(tree[key]))
            assert int(got["n"]) == 9
    finally:
        fab.close()


def _packed(device, recs):
    fab = Fabric(SystemSetupConfig(**CFG), device=device)
    w = RecordFileWriter(fab.meta, fab.file_client(), "/r.rec",
                         num_records=len(recs), buffer_bytes=1 << 16)
    for r in recs:
        w.append(r)
    return fab, w.commit()


@pytest.mark.gpu
def test_read_batch_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(6)
    recs = [rng.integers(0, 128_256, 2048, dtype=np.int32).tobytes()
            for _ in range(48)]
    card, rf = _packed(cuda_device, recs)
    cpu, cpu_rf = _packed("cpu", recs)
    try:
        fio, cpu_fio = card.file_client(), cpu.file_client()
        assert fio.read(rf.inode, 0, rf.inode.length) == \
            cpu_fio.read(cpu_rf.inode, 0, cpu_rf.inode.length)
        idx = [int(i) for i in rng.permutation(48)[:20]]
        k2, plain = crc32c_blocks.launches, BatchCrc32c.compute.calls
        got = [bytes(r) for r in rf.read_batch(idx)]
        assert BatchCrc32c.compute.calls == plain
        assert crc32c_blocks.launches > k2
        assert got == [bytes(r) for r in cpu_rf.read_batch(idx)]
        assert got == [recs[i] for i in idx]
    finally:
        card.close()
        cpu.close()
