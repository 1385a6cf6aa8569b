"""The client's stripe read hands each stripe's range to the file client
as parts (shard reply buffers, decoded shards, zero padding), which the
call joins once; on the card a degraded stripe's survivors are staged in
page-locked memory reused across stripes.

An RS(12,4) file over the in-process fabric, with the node of data shard
0 down and with every node up: ``read()``, ``read_into()``,
``batch_read_files()`` and a readahead ``read()`` return exactly the bytes
written, for whole stripes, a range that starts and ends mid-shard, a
short last stripe, and a hole; the public ``read_stripe`` and
``batch_read`` still reply with ``bytes``. On the CPU ``ec.decode_pinned``
stays 0 and two threads decoding through one client both read exactly.

The test marked ``gpu`` runs the degraded read on a CUDA card and skips
without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_stripe_parts.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.client.prefetch import PrefetchConfig
from tpu3fs_torch.client.storage_client import ReadReq
from tpu3fs_torch.fabric.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.storage.types import ChunkId
from tpu3fs_torch.utils.result import Code

K, M, S = 12, 4, 4096
STRIPE = K * S
# the short last stripe lies inside data shard 0, the shard the failed
# node holds: its length comes only from trimming the rebuilt shard
SHORT = S // 2 + 3


def _file_bytes(seed):
    data = np.random.default_rng(seed).integers(
        0, 256, 3 * STRIPE + SHORT, dtype=np.uint8)
    data[-1] = 0xA5  # the last byte is not zero: trimming finds the end
    return data.tobytes()


def _write(fab, path, pieces, length):
    res = fab.meta.create(path, flags=OpenFlags.WRITE | OpenFlags.CREATE,
                          client_id="t")
    fio = fab.file_client()
    for off, blob in pieces:
        fio.write(res.inode, off, blob)
    fab.meta.close(res.inode.id, res.session_id, length_hint=length,
                   wrote=True)
    fio.close()
    return fab.meta.stat(path)


def _cluster(device, down, seed=23):
    """One RS(12,4) chain of 16 nodes: ``/f`` holds three whole stripes
    and a short fourth, ``/hole`` stripes 0 and 2 with none written at 1.
    ``down``: the node of data shard 0 fails, so every stripe decodes."""
    fab = Fabric(SystemSetupConfig(num_storage_nodes=K + M, num_chains=1,
                                   chunk_size=STRIPE, ec_k=K, ec_m=M,
                                   engine="mem"), device=device)
    data = _file_bytes(seed)
    hole = data[:STRIPE] + bytes(STRIPE) + data[STRIPE:2 * STRIPE]
    files = {
        "/f": (_write(fab, "/f", [(0, data)], len(data)), data),
        "/hole": (_write(fab, "/hole", [(0, hole[:STRIPE]),
                                        (2 * STRIPE, hole[2 * STRIPE:])],
                         len(hole)), hole),
    }
    if down:
        chain = fab.routing().chains[fab.chain_ids[0]]
        fab.fail_node(fab.routing().node_of_target(
            chain.target_of_shard(0).target_id).node_id)
    return fab, files


@pytest.fixture(scope="module", params=[True, False],
                ids=["node_down", "healthy"])
def cluster(request):
    fab, files = _cluster("cpu", request.param)
    yield fab, files, request.param
    fab.close()


def _untagged(sc):
    """Shards read back as if stored without the logical-length tag (a
    writer that predates it): the stripe's length is inferred from the
    shards' extents, a decoded shard's by ``trim_rebuilt_shard``."""
    issue = sc._issue_wire_reads

    def reads(wire):
        return [dataclasses.replace(r, logical_len=0) for r in issue(wire)]

    sc._issue_wire_reads = reads
    return sc


CASES = {
    "whole_stripes": ("/f", 0, 3 * STRIPE),
    "mid_shard": ("/f", S + 5, STRIPE + 3 * S + 100),
    "short_last_stripe": ("/f", 3 * STRIPE - S // 3, STRIPE),
    "hole": ("/hole", S // 2, 3 * STRIPE),
}


@pytest.mark.parametrize("case", list(CASES))
def test_file_reads_return_exactly_the_bytes_written(cluster, case):
    fab, files, down = cluster
    path, off, size = CASES[case]
    inode, written = files[path]
    want = written[off:off + size]  # clamped at EOF, as a read is
    assert len(want) == min(size, len(written) - off) > 0
    fio = FileIoClient(_untagged(fab.storage_client()))
    pf = FileIoClient(_untagged(fab.storage_client()),
                      prefetch=PrefetchConfig(window_bytes=STRIPE, min_run=2))
    try:
        got = fio.read(inode, off, size)
        assert type(got) is bytes and got == want
        dest = memoryview(bytearray(size + 7))
        assert fio.read_into(inode, off, size, dest) == len(want)
        assert bytes(dest[:len(want)]) == want
        got = fio.batch_read_files([(inode, off, size), (inode, 0, STRIPE)])
        assert [type(b) for b in got] == [bytes, bytes]
        assert got == [want, written[:STRIPE]]
        # readahead: three sequential pieces arm and use the window
        cuts = [off + len(want) * i // 3 for i in range(4)]
        got = [pf.read(inode, a, b - a) for a, b in zip(cuts, cuts[1:])]
        assert all(type(b) is bytes for b in got)
        assert b"".join(got) == want

        # the public replies: bytes, the range of each stripe
        sc = fio.storage
        degraded_before = sc._ec_degraded.total
        segs = FileIoClient._split(inode.layout, off, len(want))
        reqs = [ReadReq(chain, ChunkId(inode.id, idx), in_off, n,
                        chunk_size=STRIPE) for idx, chain, in_off, n in segs]
        singles = [sc.read_stripe(r.chain_id, r.chunk_id, r.offset, r.length,
                                  chunk_size=STRIPE) for r in reqs]
        for (idx, _, in_off, n), single, batched in zip(
                segs, singles, sc.batch_read(reqs)):
            stripe = written[idx * STRIPE:(idx + 1) * STRIPE]
            for r in (single, batched):
                if path == "/hole" and idx == 1:
                    assert r.code == Code.CHUNK_NOT_FOUND
                    continue
                assert r.ok and type(r.data) is bytes
                assert r.data == stripe[in_off:in_off + n].ljust(n, b"\x00")
        if case == "short_last_stripe":
            last = sc.read_stripe(reqs[-1].chain_id, reqs[-1].chunk_id, 0,
                                  STRIPE, chunk_size=STRIPE)
            assert last.logical_len == SHORT
            assert last.data == written[3 * STRIPE:].ljust(STRIPE, b"\x00")
        assert (sc._ec_degraded.total > degraded_before) == down
    finally:
        fio.close()
        pf.close()


# -- the survivors' staging ------------------------------------------------------
@pytest.fixture(scope="module")
def degraded_cpu():
    fab, files = _cluster("cpu", True, seed=24)
    yield fab, files
    fab.close()


def test_cpu_device_stages_no_survivors_in_pinned_memory(degraded_cpu):
    fab, files = degraded_cpu
    inode, written = files["/f"]
    fio = fab.file_client()
    try:
        assert fio.read(inode, 0, len(written)) == written
        assert fio.batch_read_files([(inode, 0, len(written))]) == [written]
        sc = fio.storage
        assert sc._ec_degraded.total == 8
        assert sc._ec_decode_pinned.total == 0
        assert getattr(sc._pinned, "tensor", None) is None
    finally:
        fio.close()


def _read_in_threads(fio, inode, written, rounds=10):
    """Two threads read different degraded stripes through one client at
    once, ``rounds`` times each; -> each thread's reads and the staging
    tensor it decoded through (None where none was made)."""
    barrier = threading.Barrier(2)
    out = {}

    def reader(idx):
        barrier.wait(timeout=30)
        got = [fio.read(inode, idx * STRIPE, STRIPE) for _ in range(rounds)]
        out[idx] = (got, getattr(fio.storage._pinned, "tensor", None))

    threads = [threading.Thread(target=reader, args=(idx,)) for idx in (0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for idx in (0, 2):
        want = written[idx * STRIPE:(idx + 1) * STRIPE]
        assert all(b == want for b in out[idx][0]), idx
    return out


def test_two_threads_decode_through_one_client_exactly(degraded_cpu):
    fab, files = degraded_cpu
    inode, written = files["/f"]
    fio = fab.file_client()
    try:
        _read_in_threads(fio, inode, written)
        assert fio.storage._ec_degraded.total == 20
    finally:
        fio.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned staging serves the "
                    "card's decode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_stages_survivors_in_reused_pinned_memory(cuda_device):
    fab, files = _cluster("cuda", True, seed=25)
    inode, written = files["/f"]
    fio = fab.file_client()
    try:
        sc = fio.storage
        assert fio.read(inode, 0, len(written)) == written
        staged = sc._pinned.tensor
        assert staged.is_pinned() and staged.numel() == K * S
        assert sc._ec_decode_pinned.total == sc._ec_degraded.total == 4
        assert fio.batch_read_files([(inode, 0, len(written))]) == [written]
        assert sc._pinned.tensor.data_ptr() == staged.data_ptr()
        assert sc._ec_decode_pinned.total == sc._ec_degraded.total == 8
        # each thread stages in a buffer of its own
        out = _read_in_threads(fio, inode, written)
        ptrs = {idx: t.data_ptr() for idx, (_, t) in out.items()}
        assert len(set(ptrs.values()) | {staged.data_ptr()}) == 3
        assert sc._ec_decode_pinned.total == sc._ec_degraded.total == 28
    finally:
        fio.close()
        fab.close()
