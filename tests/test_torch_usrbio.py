"""The USRBIO shared-memory data plane in the port, on the CPU, against the
JAX package's. Tolerance 0: bytes, replies and CRCs must be equal.

Each case of ``tests/test_usrbio.py`` runs over both packages (the JAX
package's ``tpu3fs.usrbio`` and the port's ``tpu3fs_torch.usrbio``): the
ring ABI, backpressure, counter wraparound, tokens and class flags, torn
headers, wrong versions, owner-pid reaping, traversal and symlink
refusals, the agent end to end on each package's ``Fabric`` (the port's
on ``device="cpu"``) and ``read_into`` with holes; the agent sequence's
completions and stored bytes are then held against the JAX package's.
The ABI across the packages: layouts packed by one package are
byte-identical to the other's, and a ring created by one package is
opened, submitted to and reaped by the other, semaphores included. The
ring transport: a storage service of either package hosts rings and a
client of either package rides them (rings shown established, replies
equal to a socket client's), with tenant, QoS and deadline sheds through
the ring, the fallback to sockets, a forked client and the reaper. Every
case leaves no thread of its own and no ``/dev/shm`` segment or named
semaphore that it created."""

import importlib
import os
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_socket_sequence import threads_left

PACKAGES = ["tpu3fs", "tpu3fs_torch"]
SHM = "/dev/shm"


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("usrbio", "usrbio"), ("ring", "usrbio.ring"),
        ("transport", "usrbio.transport"), ("server", "usrbio.server"),
        ("sem", "usrbio.sem"), ("result", "utils.result"),
        ("qos", "qos.core"), ("deadline", "rpc.deadline"),
        ("tenant", "tenant.identity"), ("fabric", "fabric"),
        ("store", "meta.store"))}
    return SimpleNamespace(root=root, **mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _fabric(pkg, **cfg):
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(**cfg),
                            **({"device": "cpu"}
                               if pkg.root == "tpu3fs_torch" else {}))
    return fab


@pytest.fixture(autouse=True)
def shm_guard(monkeypatch):
    """Every segment a case creates (through either package's
    ``_map_shm``), its named semaphores and this process's handshake
    nonce files are gone when the case ends."""
    made = []
    for root in PACKAGES:
        ring = importlib.import_module(f"{root}.usrbio.ring")
        real = ring._map_shm

        def spy(path, size, *, create, _real=real):
            buf = _real(path, size, create=create)
            if create:
                made.append(os.path.basename(path))
            return buf
        monkeypatch.setattr(ring, "_map_shm", spy)
    nonces = set(n for n in os.listdir(SHM)
                 if n.startswith(f"tpu3fs-hs-{os.getpid()}-"))
    yield made
    left = [n for n in made if os.path.exists(os.path.join(SHM, n))]
    left += [f"sem.{n}-{q}" for n in made if n.startswith("tpu3fs-ior-")
             for q in ("sq", "cq")
             if os.path.exists(os.path.join(SHM, f"sem.{n}-{q}"))]
    left += [n for n in os.listdir(SHM)
             if n.startswith(f"tpu3fs-hs-{os.getpid()}-")
             and n not in nonces]
    assert not left, f"shm left behind: {left}"


# -- the ring ABI, in each package ----------------------------------------------
def test_sqe_cqe_roundtrip(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        assert ring.prep_io(0, 100, 4096, 5, read=True, userdata=42) == 0
        assert ring.prep_io(128, 50, 0, 5, read=False, userdata=43) == 1
        sqes = ring.drain_sqes()
        assert len(sqes) == 2
        assert sqes[0].is_read and sqes[0].length == 100
        assert sqes[0].file_offset == 4096 and sqes[0].userdata == 42
        assert not sqes[1].is_read
        ring.push_cqe(100, 42)
        assert ring.wait_for_ios(1, timeout=1) == [(100, 42)]
    finally:
        ring.close(unlink=True)


def test_ring_full_until_reaped(pkg):
    ring = pkg.ring.IoRing(2, create=True)
    try:
        assert ring.prep_io(0, 1, 0, 1, read=True) == 0
        assert ring.prep_io(0, 1, 0, 1, read=True) == 1
        assert ring.prep_io(0, 1, 0, 1, read=True) == -1
        for sqe in ring.drain_sqes():
            ring.push_cqe(1, sqe.userdata)
        # agent progress alone frees nothing: completions must be reaped
        assert ring.prep_io(0, 1, 0, 1, read=True) == -1
        assert len(ring.reap()) == 2
        assert ring.prep_io(0, 1, 0, 1, read=True) == 0
    finally:
        ring.close(unlink=True)


def test_shm_visible_across_opens(pkg):
    iov = pkg.ring.Iov(4096, create=True)
    try:
        iov.write(100, b"cross-mapping")
        other = pkg.ring.Iov(4096, name=iov.name, create=False)
        assert other.read(100, 13) == b"cross-mapping"
        other.close()
    finally:
        iov.close(unlink=True)


def test_unreaped_cqes_never_overwritten(pkg):
    ring = pkg.ring.IoRing(4, create=True)
    try:
        for i in range(4):
            assert ring.prep_io(0, 1, 0, 1, read=True, userdata=100 + i) >= 0
        for sqe in ring.drain_sqes():
            ring.push_cqe(7, sqe.userdata)
        assert ring.prep_io(0, 1, 0, 1, read=True, userdata=200) == -1
        assert sorted(ud for _, ud in ring.reap()) == [100, 101, 102, 103]
        assert ring.prep_io(0, 1, 0, 1, read=True, userdata=200) >= 0
    finally:
        ring.close(unlink=True)


def test_counter_wraparound(pkg):
    ring = pkg.ring.IoRing(4, create=True)
    try:
        for round_no in range(5):
            for k in range(4):
                assert ring.prep_io(0, 1, 0, 1, read=True,
                                    userdata=round_no * 10 + k) >= 0
            sqes = ring.drain_sqes()
            assert [s.userdata for s in sqes] == [
                round_no * 10 + k for k in range(4)]
            for s in sqes:
                ring.push_cqe(1, s.userdata)
            assert sorted(ud for _, ud in ring.reap()) == [
                round_no * 10 + k for k in range(4)]
    finally:
        ring.close()


def test_token_and_class_flags_roundtrip(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        tok = "t1.0123456789abcdef.fedcba9876543210.1.d1.abc123.u1.alice"
        ring.prep_io(0, 100, 0, 5, read=True, token=tok,
                     class_flags=pkg.qos.class_to_flags(
                         pkg.qos.TrafficClass.KVCACHE))
        sqe = ring.drain_sqes()[0]
        assert sqe.token == tok
        assert pkg.qos.class_from_flags(sqe.flags) == \
            pkg.qos.TrafficClass.KVCACHE
        assert pkg.tenant.decode_tenant(sqe.token) == "alice"
        assert pkg.deadline.decode_deadline(sqe.token) is not None
    finally:
        ring.close()


def test_oversized_token_refused(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        with pytest.raises(pkg.result.FsError) as ei:
            ring.prep_io(0, 1, 0, 1, read=True, token="u1." + "x" * 200)
        assert ei.value.code == pkg.result.Code.USRBIO_BAD_IOV
    finally:
        ring.close()


def test_rpc_sqe_roundtrip(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        assert ring.prep_rpc(3, 11, 256, 1024, 2048, 8192, userdata=7,
                             token="u1.bob", bulk=True) == 0
        sqe = ring.drain_sqes()[0]
        assert sqe.is_rpc and sqe.has_bulk and not sqe.is_read
        assert (sqe.service_id, sqe.method_id) == (3, 11)
        assert (sqe.iov_offset, sqe.length) == (256, 1024)
        assert (sqe.rsp_offset, sqe.rsp_capacity) == (2048, 8192)
        assert sqe.token == "u1.bob"
    finally:
        ring.close()


def test_torn_header_detected(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        ring.buf[0:4] = struct.pack("<I", 0xDEAD)
        with pytest.raises(pkg.result.FsError) as ei:
            ring.drain_sqes()
        assert ei.value.code == pkg.result.Code.USRBIO_TORN_RING
    finally:
        ring.buf[0:4] = struct.pack("<I", 0x3F5B10)
        ring.close()


def test_open_refuses_wrong_version(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        ring.buf[40:44] = struct.pack("<I", 1)  # claim ABI v1
        with pytest.raises(pkg.result.FsError) as ei:
            pkg.ring.IoRing(8, name=ring.name, create=False)
        assert ei.value.code == pkg.result.Code.USRBIO_TORN_RING
    finally:
        ring.close()


def _dead_pid() -> int:
    pid = os.fork()
    if pid == 0:
        os._exit(0)
    os.waitpid(pid, 0)
    return pid


def test_owner_pid_stamped_and_reaped(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        assert ring.owner_pid == os.getpid()
        assert ring.name not in pkg.ring.reap_stale_shm()  # a live owner
        ring.buf[44:48] = struct.pack("<I", _dead_pid())
        assert ring.name in pkg.ring.reap_stale_shm()
        assert not os.path.exists(ring.path)
        assert not os.path.exists(os.path.join(SHM, f"sem.{ring.name}-sq"))
    finally:
        ring.close()


def test_orphan_iov_age_reap(pkg):
    iov = pkg.ring.Iov(4096, create=True)
    try:
        old = time.time() - 7200
        os.utime(iov.path, (old, old))
        assert iov.name not in pkg.ring.reap_stale_shm(keep={iov.name})
        assert os.path.exists(iov.path)
        assert iov.name in pkg.ring.reap_stale_shm()
    finally:
        iov.close()


def test_unlink_on_close_default(pkg):
    iov = pkg.ring.Iov(4096, create=True)
    ring = pkg.ring.IoRing(8, create=True)
    mapped = pkg.ring.Iov(4096, name=iov.name, create=False)
    mapped.close()  # a mapper never unlinks
    assert os.path.exists(iov.path)
    iov.close()
    ring.close()
    assert not os.path.exists(iov.path) and not os.path.exists(ring.path)


def test_traversal_and_bad_prefix_names_rejected(pkg):
    for bad in ("../../../etc/passwd", "tpu3fs-iov-../x", "tpu3fs-iov-a/b",
                "not-ours-abc"):
        with pytest.raises(pkg.result.FsError) as ei:
            pkg.ring.Iov(4096, name=bad, create=False)
        assert ei.value.code == pkg.result.Code.USRBIO_BAD_IOV
    with pytest.raises(pkg.result.FsError):
        pkg.ring.IoRing(8, name="tpu3fs-ior-..", create=False)


def test_register_rejects_traversal_names(pkg):
    host = pkg.server.UsrbioRpcHost(server=None)
    try:
        req = pkg.transport.UsrbioRegisterReq
        rsp = host.register(req(ring_name="tpu3fs-ior-../../etc/cron.d/x",
                                iov_name="tpu3fs-iov-ok1", entries=8,
                                iov_size=4096, nonce=host._nonce))
        assert not rsp.ok and "bad shm segment name" in rsp.message
        rsp = host.register(req(ring_name="tpu3fs-ior-ok1",
                                iov_name="../../etc/shadow", entries=8,
                                iov_size=4096, nonce=host._nonce))
        assert not rsp.ok and "bad shm segment name" in rsp.message
        rsp = host.register(req(ring_name="tpu3fs-ior-ok1",
                                iov_name="tpu3fs-iov-ok1", entries=8,
                                iov_size=4096, nonce="0" * 32))
        assert not rsp.ok and "nonce mismatch" in rsp.message
    finally:
        host.stop()


def test_symlinked_segment_refused(pkg, tmp_path):
    target = tmp_path / "victim"
    target.write_bytes(b"\0" * 8192)
    name = f"tpu3fs-iov-symlink{os.getpid()}{pkg.root[-5:]}"
    link = os.path.join(SHM, name)
    os.symlink(target, link)
    try:
        with pytest.raises(OSError):
            pkg.ring.Iov(4096, name=name, create=False)
    finally:
        os.unlink(link)


def test_undersized_segment_refused(pkg):
    iov = pkg.ring.Iov(4096, create=True)
    try:
        with pytest.raises(pkg.result.FsError) as ei:
            pkg.ring.Iov(1 << 20, name=iov.name, create=False)
        assert ei.value.code == pkg.result.Code.USRBIO_BAD_IOV
        with pytest.raises(pkg.result.FsError):
            pkg.ring.IoRing(8, name=iov.name, create=False)
    finally:
        iov.close(unlink=True)


def test_live_v2_ring_never_age_reaped(pkg):
    ring = pkg.ring.IoRing(8, create=True)
    try:
        old = time.time() - 7200
        os.utime(ring.path, (old, old))
        assert ring.name not in pkg.ring.reap_stale_shm(iov_max_age_s=3600)
        assert os.path.exists(ring.path)
    finally:
        ring.close(unlink=True)


# -- the agent end to end ---------------------------------------------------
def _agent_sequence(pkg) -> dict:
    """``tests/test_usrbio.py``'s agent cases in one seeded run on the
    package's fabric (CR, 2 nodes, 4 KiB chunks) -> every completion and
    the bytes stored, for the JAX twin's comparison."""
    fab = _fabric(pkg, num_storage_nodes=2, num_chains=2, num_replicas=2,
                  chunk_size=4096)
    agent = pkg.usrbio.UsrbioAgent(fab.meta, fab.file_client())
    client = pkg.usrbio.UsrbioClient(agent)
    Code = pkg.result.Code
    rec = {}
    try:
        # batched writes staged in one iov, read back through a read ring
        iov = client.iovcreate(1 << 20)
        ring = client.iorcreate(32, [iov], for_read=False)
        fd = client.reg_fd("/data.bin", write=True)
        blob = np.random.default_rng(0).integers(
            0, 256, 40_000).astype("u1").tobytes()
        step = 10_000
        for i in range(4):
            iov.write(i * step, blob[i * step:(i + 1) * step])
            client.prep_io(ring, iov, i * step, step, fd, i * step,
                           read=False, userdata=i)
        client.submit_ios(ring)
        rec["writes"] = sorted(client.wait_for_ios(ring, 4, timeout=10))
        assert rec["writes"] == [(step, i) for i in range(4)]
        client.dereg_fd(fd, length_hint=len(blob))
        fd = client.reg_fd("/data.bin")
        rring = client.iorcreate(32, [iov], for_read=True)
        for i in range(4):
            client.prep_io(rring, iov, 512 * 1024 + i * step, step, fd,
                           i * step, read=True, userdata=10 + i)
        client.submit_ios(rring)
        rec["reads"] = sorted(client.wait_for_ios(rring, 4, timeout=10))
        assert iov.read(512 * 1024, len(blob)) == blob
        client.dereg_fd(fd)
        # a short read at EOF
        fd = client.reg_fd("/small", write=True)
        iov.write(0, b"tiny")
        client.prep_io(ring, iov, 0, 4, fd, 0, read=False)
        client.submit_ios(ring)
        client.wait_for_ios(ring, 1, timeout=5)
        client.prep_io(rring, iov, 1024, 4096, fd, 0, read=True, userdata=9)
        client.submit_ios(rring)
        rec["eof"] = client.wait_for_ios(rring, 1, timeout=5)
        assert rec["eof"] == [(4, 9)] and iov.read(1024, 4) == b"tiny"
        client.dereg_fd(fd, length_hint=4)
        # mtime moves after a write session only
        fd = client.reg_fd("/mt.bin", write=True)
        client.prep_io(ring, iov, 0, 4, fd, 0, read=False)
        client.submit_ios(ring)
        client.wait_for_ios(ring, 1, timeout=5)
        client.dereg_fd(fd, length_hint=4)
        m1 = fab.meta.stat("/mt.bin").mtime
        time.sleep(0.02)
        client.dereg_fd(client.reg_fd("/mt.bin"))
        assert fab.meta.stat("/mt.bin").mtime == m1
        time.sleep(0.02)
        fd = client.reg_fd("/mt.bin", write=True)
        client.prep_io(ring, iov, 0, 4, fd, 4, read=False)
        client.submit_ios(ring)
        client.wait_for_ios(ring, 1, timeout=5)
        client.dereg_fd(fd, length_hint=8)
        assert fab.meta.stat("/mt.bin").mtime > m1
        # a bad fd and an iov region out of bounds: error CQEs
        client.prep_io(rring, iov, 0, 10, 9999, 0, read=True, userdata=1)
        client.submit_ios(rring)
        rec["bad_fd"] = client.wait_for_ios(rring, 1, timeout=5)
        assert rec["bad_fd"] == [(-int(Code.META_NOT_FOUND), 1)]
        fd = client.reg_fd("/x", write=True)
        client.prep_io(ring, iov, (1 << 20) - 96, 1000, fd, 0, read=False,
                       userdata=2)
        client.submit_ios(ring)
        rec["oob"] = client.wait_for_ios(ring, 1, timeout=5)
        assert rec["oob"] == [(-int(Code.INVALID_ARG), 2)]
        client.dereg_fd(fd)
        # 16 submitters on one single-producer ring, serialised
        fd = client.reg_fd("/conc", write=True)
        lock = threading.Lock()

        def submit(i):
            with lock:
                iov.write(i * 100, bytes([i]) * 100)
                client.prep_io(ring, iov, i * 100, 100, fd, i * 100,
                               read=False, userdata=i)
                client.submit_ios(ring)
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rec["concurrent"] = sorted(client.wait_for_ios(ring, 16, timeout=10))
        assert rec["concurrent"] == [(100, i) for i in range(16)]
        client.dereg_fd(fd, length_hint=1600)
        fio = fab.file_client()
        rec["files"] = {p: bytes(fio.read(fab.meta.stat(p), 0,
                                          fab.meta.stat(p).length))
                        for p in ("/data.bin", "/small", "/mt.bin", "/conc")}
        rec["lengths"] = {p: fab.meta.stat(p).length for p in rec["files"]}
        client.iordestroy(ring)
        client.iordestroy(rring)
        client.iovdestroy(iov)
    finally:
        agent.stop()
        _close(fab)
    return rec


def _close(fab) -> None:
    for node in fab.nodes.values():
        node.service.stop_workers()
    fab.close()


def _read_into(pkg) -> list:
    out = []
    fab = _fabric(pkg, num_chains=2, chunk_size=4096)
    fio = fab.file_client()
    res = fab.meta.create("/ri", flags=pkg.store.OpenFlags.WRITE,
                          client_id="c")
    fio.write(res.inode, 0, b"A" * 4096)    # chunk 1 a hole, chunk 2 short
    fio.write(res.inode, 8192, b"B" * 100)
    inode = fab.meta.stat("/ri")
    want = fio.read(inode, 0, 3 * 4096)
    buf = bytearray(3 * 4096)
    n = fio.read_into(inode, 0, 3 * 4096, memoryview(buf))
    assert bytes(buf[:n]) == want
    out.append(bytes(buf[:n]))
    _close(fab)
    fab2 = _fabric(pkg, num_storage_nodes=4, num_chains=1,
                   chunk_size=12 << 10, ec_k=3, ec_m=1)
    fio2 = fab2.file_client()
    res2 = fab2.meta.create("/ri2", flags=pkg.store.OpenFlags.WRITE,
                            client_id="c")
    payload = bytes(range(256)) * 96      # 2 stripes
    fio2.write(res2.inode, 0, payload)
    buf2 = bytearray(len(payload))
    n2 = fio2.read_into(fab2.meta.stat("/ri2"), 0, len(payload),
                        memoryview(buf2))
    assert n2 == len(payload) and bytes(buf2) == payload
    out.append(bytes(buf2))
    _close(fab2)
    return out


@pytest.fixture(scope="module")
def jax_agent_run():
    return _agent_sequence(_pkg("tpu3fs")), _read_into(_pkg("tpu3fs"))


def test_agent_end_to_end(pkg):
    before = threading.enumerate()
    rec = _agent_sequence(pkg)
    assert rec["files"]["/conc"] == b"".join(bytes([i]) * 100
                                             for i in range(16))
    assert rec["lengths"]["/mt.bin"] == 8
    assert not threads_left(before)


def test_read_into_matches_read_with_holes(pkg):
    assert len(_read_into(pkg)) == 2


def test_port_agent_matches_jax(jax_agent_run):
    want_agent, want_into = jax_agent_run
    port = _pkg("tpu3fs_torch")
    assert _agent_sequence(port) == want_agent
    assert _read_into(port) == want_into


# -- the ABI across the packages -----------------------------------------------
def test_layouts_byte_identical():
    jr, pr = _pkg("tpu3fs").ring, _pkg("tpu3fs_torch").ring
    for attr in ("_HDR", "_SQE", "_CQE", "RSP_HDR"):
        assert getattr(jr, attr).format == getattr(pr, attr).format
    for attr in ("MAGIC", "VERSION", "HDR_SIZE", "SQE_SIZE", "CQE_SIZE",
                 "TOKEN_CAP", "SQE_FLAG_READ", "SQE_FLAG_RPC",
                 "SQE_FLAG_BULK", "HS_PREFIX", "SHM_DIR"):
        assert getattr(jr, attr) == getattr(pr, attr), attr
    assert jr._shm_name_prefixes() == pr._shm_name_prefixes()
    jt, pt = _pkg("tpu3fs").transport, _pkg("tpu3fs_torch").transport
    assert jt.RING_METHODS == pt.RING_METHODS
    assert jt.USRBIO_SERVICE_ID == pt.USRBIO_SERVICE_ID
    assert jt.HANDSHAKE_PREFIX == pt.HANDSHAKE_PREFIX
    assert ({c.name for c in jt.TRANSPORT_CODES}
            == {c.name for c in pt.TRANSPORT_CODES})
    assert {c.name for c in jt.FATAL_CODES} == {c.name for c in pt.FATAL_CODES}
    # the same preps in both packages leave the same bytes behind the
    # header's counters and pid
    rings = [jr.IoRing(8, create=True), pr.IoRing(8, create=True)]
    try:
        for ring in rings:
            ring.prep_io(64, 100, 4096, 7, read=True, userdata=1,
                         token="u1.alice", class_flags=0x300)
            ring.prep_rpc(3, 12, 128, 4000, 8192, 1 << 16, userdata=2,
                          token="d1.abc", bulk=True)
            for sqe in ring.drain_sqes():
                ring.push_cqe(-1202, sqe.userdata)
        a, b = (bytes(r.buf) for r in rings)
        assert a == b and len(a) == jr.HDR_SIZE + 8 * (224 + 24)
    finally:
        for ring in rings:
            ring.close()


@pytest.mark.parametrize("maker,user", [("tpu3fs", "tpu3fs_torch"),
                                        ("tpu3fs_torch", "tpu3fs")],
                         ids=["jax-creates-port-serves",
                              "port-creates-jax-serves"])
def test_ring_across_packages(maker, user):
    """One package's client creates the iov and the ring and submits an
    RPC-mode SQE; the other maps both by name, drains, writes the reply
    with its framing and posts the completion semaphore; the client wakes
    on it and parses the reply."""
    mk, us = _pkg(maker), _pkg(user)
    iov = mk.ring.Iov(1 << 16, create=True)
    ring = mk.ring.IoRing(16, create=True)
    theirs_iov = us.ring.Iov(1 << 16, name=iov.name, create=False)
    theirs = us.ring.IoRing(16, name=ring.name, create=False)
    try:
        n = mk.transport.stage_request(iov, 0, b"payload",
                                       [b"seg-one", b"", b"seg-three"])
        ring.prep_rpc(3, 11, 0, n, 4096, 8192, userdata=77, token="u1.bob",
                      bulk=True)
        ring.submit()
        assert theirs.submit_sem.wait(timeout=5)
        (sqe,) = theirs.drain_sqes()
        assert (sqe.userdata, sqe.token, sqe.has_bulk) == (77, "u1.bob", True)
        payload, bulk = us.transport.parse_request(
            theirs_iov.view(sqe.iov_offset, sqe.length), sqe.has_bulk)
        assert payload == b"payload"
        assert [bytes(s) for s in bulk] == [b"seg-one", b"", b"seg-three"]
        total = us.transport.write_reply(
            theirs_iov, sqe.rsp_offset, sqe.rsp_capacity, 0, "fine",
            b"reply-bytes", [b"data" * 100])
        theirs.push_cqe(total, sqe.userdata)
        assert ring.wait_for_ios(1, timeout=5) == [(total, 77)]
        status, msg, body, segs = mk.transport.parse_reply(
            iov.view(4096, 8192), total)
        assert (status, msg, body) == (0, "fine", b"reply-bytes")
        assert [bytes(s) for s in segs] == [b"data" * 100]
        del segs
        # an over-capacity reply is refused, not truncated
        assert us.transport.write_reply(theirs_iov, 0, 64, 0, "", b"x" * 64,
                                        None) == -1
    finally:
        theirs.close()
        theirs_iov.close()
        ring.close()
        iov.close()


# -- the ring transport over a live socket cluster ----------------------------
class RingCluster:
    """mgmtd and two storage services of package ``server`` over real TCP,
    each hosting the Usrbio control service and ring agent, with the QoS
    and tenant admission stack installed (``tests/test_usrbio.py``'s
    ``ring_cluster``, built from either package)."""

    CHAIN = 910_001

    def __init__(self, server: str):
        self.pkg = p = SimpleNamespace(**{n: importlib.import_module(
            f"{server}.{m}") for n, m in (
            ("kv", "kv"), ("mgmtd", "mgmtd.service"),
            ("gtypes", "mgmtd.types"), ("qcore", "qos.core"),
            ("qman", "qos.manager"), ("net", "rpc.net"),
            ("svc", "rpc.services"), ("craq", "storage.craq"),
            ("target", "storage.target"), ("server", "usrbio.server"),
            ("quota", "tenant.quota"))})
        kw = {"device": "cpu"} if server == "tpu3fs_torch" else {}
        mgmtd = self.mgmtd = p.mgmtd.Mgmtd(1, p.kv.MemKVEngine())
        mgmtd.extend_lease()
        self.servers, self.hosts, self.services = [], [], {}
        self.client = p.net.RpcClient()
        try:
            ms = p.net.RpcServer()
            p.svc.bind_mgmtd_service(ms, mgmtd)
            ms.start()
            self.servers.append(ms)
            self.maddr = ms.address
            for node_id, target_id in ((10, 1000), (11, 1001)):
                mcli = p.svc.MgmtdRpcClient(self.maddr, self.client)
                svc = p.craq.StorageService(node_id, mcli.refresh_routing,
                                            **kw)
                svc.set_messenger(p.svc.RpcMessenger(mcli.refresh_routing,
                                                     self.client))
                svc.add_target(p.target.StorageTarget(
                    target_id, self.CHAIN, chunk_size=4096, **kw))
                svc.set_qos(p.qman.QosManager(p.qcore.QosConfig(),
                                              tags={"node": str(node_id)}))
                server = p.net.RpcServer()
                p.svc.bind_storage_service(server, svc)
                host = p.server.UsrbioRpcHost(server)
                p.server.bind_usrbio_service(server, host)
                server.start()
                self.servers.append(server)
                self.hosts.append(host)
                self.services[node_id] = svc
                mgmtd.register_node(node_id, p.gtypes.NodeType.STORAGE,
                                    host=server.host, port=server.port)
                mgmtd.create_target(target_id, node_id=node_id)
            mgmtd.upload_chain(self.CHAIN, [1000, 1001])
            mgmtd.upload_chain_table(1, [self.CHAIN])
            up = p.gtypes.LocalTargetState.UPTODATE
            mgmtd.heartbeat(10, 1, {1000: up})
            mgmtd.heartbeat(11, 1, {1001: up})
            p.quota.registry().clear()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        self.pkg.quota.registry().clear()
        for h in self.hosts:
            h.stop()
        for svc in self.services.values():
            svc._messenger.close_rings()
            stop = getattr(svc, "stop_workers", None)
            if stop is not None:
                stop()
        for s in self.servers:
            s.stop()
        self.client.close()


class Client:
    """A storage client of package ``pkg`` over its RpcMessenger."""

    def __init__(self, pkg: str, cluster: RingCluster, cid: str = "rc"):
        mod = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
        self.svc, self.sc_mod = mod("rpc.services"), mod("client.storage_client")
        self.types = mod("storage.types")
        self.ReadReq = self.sc_mod.ReadReq
        mcli = self.svc.MgmtdRpcClient(cluster.maddr, cluster.client)
        self.messenger = self.svc.RpcMessenger(mcli.refresh_routing,
                                               cluster.client)
        kw = {"device": "cpu"} if pkg == "tpu3fs_torch" else {}
        self.sc = self.sc_mod.StorageClient(
            cid, mcli.refresh_routing, self.messenger,
            retry=self.sc_mod.RetryOptions(max_retries=0,
                                           backoff_base_s=0.001,
                                           hedge_reads=False), **kw)

    def rings(self) -> dict:
        return {n: r for n, r in self.messenger._usrbio_rings.items()
                if r is not None}

    def close(self) -> None:
        self.sc.close()


@pytest.fixture
def ring_pair(request, monkeypatch):
    """(cluster of the server package, client of the client package)."""
    server, client = request.param
    monkeypatch.delenv("TPU3FS_USRBIO", raising=False)
    before = threading.enumerate()
    cluster = RingCluster(server)
    c = None
    try:
        c = Client(client, cluster)
        yield cluster, c
    finally:
        if c is not None:
            c.close()
        cluster.close()
    assert not threads_left(before)


PAIRS = [("tpu3fs", "tpu3fs_torch"), ("tpu3fs_torch", "tpu3fs"),
         ("tpu3fs_torch", "tpu3fs_torch")]
PAIR_IDS = ["port-client-jax-host", "jax-client-port-host",
            "port-client-port-host"]


@pytest.mark.parametrize("ring_pair", PAIRS, ids=PAIR_IDS, indirect=True)
def test_ring_selected_and_io_equivalence(ring_pair, monkeypatch):
    cluster, c = ring_pair
    cid = c.types.ChunkId
    writes = [(cluster.CHAIN, cid(1, i), 0, bytes([i + 1]) * 700)
              for i in range(8)]
    assert all(r.ok for r in c.sc.batch_write(writes, chunk_size=4096))
    assert c.rings(), "no USRBIO ring established on a same-host cluster"
    got = c.sc.batch_read([c.ReadReq(cluster.CHAIN, cid(1, i), 0, -1)
                           for i in range(8)])
    assert [bytes(r.data) for r in got] == [bytes([i + 1]) * 700
                                            for i in range(8)]
    blob = bytes(range(256)) * 16   # one chunk exactly, single ops
    assert c.sc.write_chunk(cluster.CHAIN, cid(3, 0), 0, blob,
                            chunk_size=4096).ok
    one = c.sc.read_chunk(cluster.CHAIN, cid(3, 0))
    assert one.ok and bytes(one.data) == blob
    calls = getattr(c.messenger, "transport_calls", None)
    if calls is not None:  # the port's counters: every call on a ring
        assert calls and all(t == "ring" for t, _, _ in calls)
    monkeypatch.setenv("TPU3FS_USRBIO", "0")
    sock = Client(c.svc.__name__.split(".")[0], cluster, "rc-sock")
    try:
        again = sock.sc.batch_read([c.ReadReq(cluster.CHAIN, cid(1, i), 0, -1)
                                    for i in range(8)])
        assert [bytes(r.data) for r in again] == [bytes(r.data) for r in got]
        assert not sock.messenger._usrbio_rings
    finally:
        sock.close()


@pytest.mark.parametrize("ring_pair", PAIRS, ids=PAIR_IDS, indirect=True)
def test_deadline_shed_at_ring_dequeue(ring_pair):
    cluster, c = ring_pair
    cid = c.types.ChunkId
    assert c.sc.write_chunk(cluster.CHAIN, cid(6, 0), 0, b"d" * 128,
                            chunk_size=4096).ok
    assert c.sc.read_chunk(cluster.CHAIN, cid(6, 0)).ok
    node_id = next(iter(c.rings()))
    dl = importlib.import_module(c.svc.__name__.replace(
        "rpc.services", "rpc.deadline"))
    fs = importlib.import_module(c.svc.__name__.replace(
        "rpc.services", "utils.result"))
    with dl.deadline_scope(time.time() - 0.5):
        with pytest.raises(fs.FsError) as ei:
            c.messenger(node_id, "batch_read",
                        [c.ReadReq(cluster.CHAIN, cid(6, 0), 0, -1)])
    assert ei.value.code == fs.Code.DEADLINE_EXCEEDED


@pytest.mark.parametrize("ring_pair", [("tpu3fs_torch", "tpu3fs_torch")],
                         ids=["port-client-port-host"], indirect=True)
def test_tenant_flood_sheds_through_ring(ring_pair):
    from tpu3fs_torch.tenant import tenant_scope
    from tpu3fs_torch.tenant.quota import registry
    from tpu3fs_torch.utils.result import Code

    cluster, c = ring_pair
    cid = c.types.ChunkId
    assert c.sc.write_chunk(cluster.CHAIN, cid(4, 0), 0, b"q" * 2000,
                            chunk_size=4096).ok
    registry().configure("tenant=flood,iops=2,burst_s=1")
    reqs = [c.ReadReq(cluster.CHAIN, cid(4, 0), 0, -1)]
    with tenant_scope("flood"):
        replies = [c.sc.batch_read(reqs)[0] for _ in range(12)]
    shed = [r for r in replies if r.code == Code.TENANT_THROTTLED]
    assert shed and all(r.retry_after_ms > 0 for r in shed)
    assert c.rings()
    assert all(t == "ring" for t, _, _ in c.messenger.transport_calls)
    assert c.sc.batch_read(reqs)[0].ok


@pytest.mark.parametrize("ring_pair", [("tpu3fs_torch", "tpu3fs_torch")],
                         ids=["port-client-port-host"], indirect=True)
def test_qos_class_shed_through_ring(ring_pair):
    from tpu3fs_torch.qos.core import TrafficClass, tagged
    from tpu3fs_torch.utils.result import Code

    cluster, c = ring_pair
    cid = c.types.ChunkId
    assert c.sc.write_chunk(cluster.CHAIN, cid(5, 0), 0, b"c" * 512,
                            chunk_size=4096).ok
    for svc in cluster.services.values():
        svc.qos.config.resync.rate = 0.001
        svc.qos.config.resync.burst = 1.0
        svc.qos.admission.reload()
    reqs = [c.ReadReq(cluster.CHAIN, cid(5, 0), 0, -1)]
    with tagged(TrafficClass.RESYNC):
        replies = [c.sc.batch_read(reqs)[0] for _ in range(8)]
    assert any(r.code == Code.OVERLOADED for r in replies), \
        "class bits never reached admission through the ring SQE"
    assert c.sc.batch_read(reqs)[0].ok


@pytest.mark.parametrize("ring_pair", PAIRS, ids=PAIR_IDS, indirect=True)
def test_fallback_when_host_stops(ring_pair):
    """The hosts stop under the client: reads go on over sockets and never
    surface a USRBIO error. The host lives in this process, so the client
    learns only at its ring call timeout (cut here to 1 s from 30 s)."""
    cluster, c = ring_pair
    cid = c.types.ChunkId
    assert c.sc.write_chunk(cluster.CHAIN, cid(7, 0), 0, b"f" * 900,
                            chunk_size=4096).ok
    assert c.sc.read_chunk(cluster.CHAIN, cid(7, 0)).ok
    for ring in c.rings().values():
        ring._call_timeout = 1.0
    for h in cluster.hosts:
        h.stop()
    for _ in range(3):
        got = c.sc.batch_read([c.ReadReq(cluster.CHAIN, cid(7, 0), 0, -1)])
        assert got[0].ok and bytes(got[0].data) == b"f" * 900
    calls = getattr(c.messenger, "transport_calls", None)
    if calls is not None:
        assert any(t == "socket" for t, _, _ in calls)


@pytest.mark.parametrize("ring_pair", [("tpu3fs", "tpu3fs_torch"),
                                       ("tpu3fs_torch", "tpu3fs_torch")],
                         ids=["port-client-jax-host", "port-client-port-host"],
                         indirect=True)
def test_client_counts_agree_with_the_hosts_recorders(ring_pair):
    """The port's ring client counts its completions and the bytes the
    agent moved for them exactly as the host's ``usrbio.completed`` and
    ``usrbio.bytes`` recorders do (reads only: a write's chain forward
    rides the services' own rings)."""
    cluster, c = ring_pair
    cid = c.types.ChunkId
    writes = [(cluster.CHAIN, cid(2, i), 0, bytes([i]) * (300 + 500 * i))
              for i in range(6)]
    assert all(r.ok for r in c.sc.batch_write(writes, chunk_size=4096))
    recs = importlib.import_module(
        f"{cluster.pkg.server.__name__.split('.')[0]}.usrbio.transport"
    ).recorders()

    def host():
        return recs["completed"]._value, recs["bytes"]._value

    def mine():
        return tuple(sum(getattr(r, k) for r in c.rings().values())
                     for k in ("completions", "bytes_moved"))

    # a host counts a completion just after it posts the CQE: start from
    # counts that stayed put for 0.3 s, and give the last ones 5 s
    h0, quiet = host(), 0
    while quiet < 3:
        time.sleep(0.1)
        h, h0 = h0, host()
        quiet = quiet + 1 if h == h0 else 0
    m0 = mine()
    got = c.sc.batch_read([c.ReadReq(cluster.CHAIN, cid(2, i), 0, -1)
                           for i in range(6)])
    assert [bytes(r.data) for r in got] == [w[3] for w in writes]
    for i in range(6):
        assert c.sc.read_chunk(cluster.CHAIN, cid(2, i)).ok
    del got
    m1 = mine()
    want = (m1[0] - m0[0], m1[1] - m0[1])
    deadline = time.monotonic() + 5.0
    while True:
        h1 = host()
        if (h1[0] - h0[0], h1[1] - h0[1]) == want \
                or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert want[0] >= 7
    assert (h1[0] - h0[0], h1[1] - h0[1]) == want


def test_dead_agent_fails_at_once_and_rehandshakes(monkeypatch):
    """The port's addition: a ring whose serving process has exited fails
    with the fatal USRBIO_AGENT_GONE at once (not at the call timeout),
    and a node that now registers another address gets a new ring."""
    from tpu3fs_torch.usrbio.transport import RingClient
    from tpu3fs_torch.utils.result import Code, FsError

    ring = RingClient(entries=8, iov_bytes=1 << 16)
    try:
        ring.agent_pid = _dead_pid()
        t0 = time.monotonic()
        with pytest.raises(FsError) as ei:
            ring.call(3, 3, b"", bytes)
        assert ei.value.code == Code.USRBIO_AGENT_GONE
        assert time.monotonic() - t0 < 1.0
    finally:
        ring.close()
    monkeypatch.delenv("TPU3FS_USRBIO", raising=False)
    before = threading.enumerate()
    cluster = RingCluster("tpu3fs_torch")
    c = None
    try:
        c = Client("tpu3fs_torch", cluster)
        cid = c.types.ChunkId
        assert c.sc.write_chunk(cluster.CHAIN, cid(8, 0), 0, b"r" * 300,
                                chunk_size=4096).ok
        req = c.ReadReq(cluster.CHAIN, cid(8, 0), 0, -1)
        assert bytes(c.messenger(11, "read", req).data) == b"r" * 300
        first = c.rings()[11]
        # node 11 moves: a new server (and host) on another port
        from tpu3fs_torch.rpc.net import RpcServer
        from tpu3fs_torch.rpc.services import bind_storage_service
        from tpu3fs_torch.usrbio.server import (UsrbioRpcHost,
                                                bind_usrbio_service)
        server = RpcServer()
        bind_storage_service(server, cluster.services[11])
        host = UsrbioRpcHost(server)
        bind_usrbio_service(server, host)
        server.start()
        cluster.servers.append(server)
        cluster.hosts.append(host)
        from tpu3fs_torch.mgmtd.types import NodeType
        cluster.mgmtd.register_node(11, NodeType.STORAGE, host=server.host,
                                    port=server.port)
        assert bytes(c.messenger(11, "read", req).data) == b"r" * 300
        now = c.rings()[11]
        assert now is not first and first.closed
        assert now.agent_addr == (server.host, server.port)
        assert all(t == "ring" for t, _, _ in c.messenger.transport_calls)
    finally:
        if c is not None:
            c.close()
        cluster.close()
    assert not threads_left(before)


# -- cross-process rings over a real fork ---------------------------------------
def _fork_child_io(pkg, addr, chain, q):
    try:
        mod = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
        sc_mod, svc = mod("client.storage_client"), mod("rpc.services")
        mcli = svc.MgmtdRpcClient(addr, mod("rpc.net").RpcClient())
        m = svc.RpcMessenger(mcli.refresh_routing)
        kw = {"device": "cpu"} if pkg == "tpu3fs_torch" else {}
        sc = sc_mod.StorageClient("forked", mcli.refresh_routing, m,
                                  retry=sc_mod.RetryOptions(
                                      max_retries=0, backoff_base_s=0.001,
                                      hedge_reads=False), **kw)
        cid = mod("storage.types").ChunkId
        ok = sc.write_chunk(chain, cid(9, 0), 0, b"forked-bytes" * 50,
                            chunk_size=4096).ok
        used = any(v is not None for v in m._usrbio_rings.values())
        r = sc.read_chunk(chain, cid(9, 0))
        q.put((bool(ok), bool(used), bytes(r.data)))
        sc.close()
    except Exception as e:  # the child's failure, to the parent
        q.put(("err", repr(e), b""))


def _fork_child_crash(pkg, addr, chain, q):
    """Establish a ring, report its shm names, die without cleanup."""
    mod = lambda n: importlib.import_module(f"{pkg}.{n}")  # noqa: E731
    sc_mod, svc = mod("client.storage_client"), mod("rpc.services")
    mcli = svc.MgmtdRpcClient(addr, mod("rpc.net").RpcClient())
    m = svc.RpcMessenger(mcli.refresh_routing)
    kw = {"device": "cpu"} if pkg == "tpu3fs_torch" else {}
    sc = sc_mod.StorageClient("crasher", mcli.refresh_routing, m,
                              retry=sc_mod.RetryOptions(
                                  max_retries=0, backoff_base_s=0.001,
                                  hedge_reads=False), **kw)
    sc.read_chunk(chain, mod("storage.types").ChunkId(9, 0))
    names = []
    for ring in m._usrbio_rings.values():
        if ring is not None:
            names += [ring.ring.name, ring.iov.name]
    q.put(names)
    q.close()
    q.join_thread()
    os._exit(1)


@pytest.mark.parametrize("ring_pair", PAIRS, ids=PAIR_IDS, indirect=True)
def test_forked_client_rides_its_own_ring_and_crash_is_reaped(ring_pair):
    import multiprocessing as mp

    cluster, c = ring_pair
    pkg = c.svc.__name__.split(".")[0]
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_fork_child_io,
                    args=(pkg, cluster.maddr, cluster.CHAIN, q))
    p.start()
    ok, used, data = q.get(timeout=60)
    p.join(30)
    assert ok is True and used, (ok, used, data)
    assert data == b"forked-bytes" * 50
    got = c.sc.read_chunk(cluster.CHAIN, c.types.ChunkId(9, 0))
    assert bytes(got.data) == b"forked-bytes" * 50
    q = ctx.Queue()
    p = ctx.Process(target=_fork_child_crash,
                    args=(pkg, cluster.maddr, cluster.CHAIN, q))
    p.start()
    names = q.get(timeout=60)
    p.join(30)
    assert p.exitcode == 1 and names
    assert any(os.path.exists(os.path.join(SHM, n)) for n in names)
    for host in cluster.hosts:
        host.reap_pass(iov_max_age_s=3600.0)
    for n in names:
        assert not os.path.exists(os.path.join(SHM, n)), f"left {n}"
