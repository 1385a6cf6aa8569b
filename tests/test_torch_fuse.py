"""The FUSE client in the port, on the CPU, against the JAX package's.
Tolerance 0: replies, errnos and stored file bytes must be equal.

Each case of ``tests/test_fuse.py``'s ``TestFuseOps``, ``TestXattrs`` and
``TestReaddirplus`` runs over both packages (the JAX package's
``tpu3fs.fuse`` on its ``Fabric()``, the port's ``tpu3fs_torch.fuse`` on
``Fabric(cfg, device="cpu")``), the readdirplus race included. One seeded
op sequence (getattr, readdirplus, create, write, truncate, rename,
unlink, xattrs, ``3fs-virt`` symlinks) goes through both packages'
``FuseOps``: replies with times masked, errnos and stored bytes equal.
Where this host lets root mount (``/dev/fuse`` and ``libfuse.so.2``, the
condition of ``tests/test_fuse.py``), the port's ``FuseMount`` mounts a
kernel filesystem end to end; the port's ``usrbio_loadgen``, built from
``hostsrc/`` by ``hostbuild``, runs the foreign-process ``3fs-virt``
handshake through it; and ``python -m tpu3fs_torch.bin.fuse_main --device
cpu`` mounts over a port cluster, a file written through its mount
reading back through a port client. Every mount waits at most 15 s, is
unmounted lazily in a ``finally`` and every child has a timeout.
Without a card, ``FuseApp()`` with no device raises."""

import errno
import importlib
import json
import os
import signal
import stat
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("fabric", "fabric.fabric"), ("ops", "fuse.ops"),
        ("agent", "usrbio.agent"), ("ring", "usrbio.ring"),
        ("result", "utils.result"), ("store", "meta.store"))}
    return SimpleNamespace(root=root, **mods)


def _fabric(p):
    return p.fabric.Fabric(
        **({"device": "cpu"} if p.root == "tpu3fs_torch" else {}))


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def fuse_ops(pkg):
    fab = _fabric(pkg)
    fio = fab.file_client()
    ops = pkg.ops.FuseOps(fab.meta, fio, pkg.agent.UsrbioAgent(fab.meta, fio))
    yield ops
    ops.destroy()


def _errno(pkg, excinfo) -> int:
    return pkg.ops.fs_errno(excinfo.value)


class TestFuseOps:
    def test_create_write_read_release(self, fuse_ops):
        o = fuse_ops
        o.mkdir("/d", 0o750)
        fh = o.create("/d/f", 0o640)
        data = b"kernel-visible bytes " * 1000
        assert o.write(fh, 0, data) == len(data)
        assert o.read(fh, 0, len(data)) == data
        o.release(fh)
        attr = o.getattr("/d/f")
        assert attr.size == len(data)
        assert stat.S_ISREG(attr.mode)
        assert attr.mode & 0o7777 == 0o640

    def test_read_after_write_same_handle_extends_past_meta_length(
            self, fuse_ops):
        o = fuse_ops
        fh = o.create("/raw", 0o644)
        o.write(fh, 0, b"0123456789")
        o.release(fh)
        fh2 = o.open("/raw", os.O_RDWR)
        o.write(fh2, 10, b"abcdefghij")
        assert o.read(fh2, 0, 20) == b"0123456789abcdefghij"
        o.release(fh2)

    def test_statfs_reports_free_space_and_inodes(self, fuse_ops):
        o = fuse_ops
        fh = o.create("/sf", 0o644)
        o.write(fh, 0, b"x" * 1024)
        o.release(fh)
        sf = o.statfs()
        assert sf["f_bfree"] > 0 and sf["f_files"] >= 1

    def test_readdir_includes_virt_root(self, pkg, fuse_ops):
        VIRT_DIR = pkg.ops.VIRT_DIR
        assert VIRT_DIR in [n for n, _ in fuse_ops.readdir("/")]
        virt = [n for n, _ in fuse_ops.readdir("/" + VIRT_DIR)]
        assert sorted(virt) == ["fds", "iors", "iovs"]

    def test_namespace_ops(self, pkg, fuse_ops):
        o = fuse_ops
        o.mkdir("/a", 0o755)
        fh = o.create("/a/x", 0o644)
        o.write(fh, 0, b"payload")
        o.release(fh)
        o.link("/a/x", "/a/y")
        assert o.getattr("/a/y").size == 7
        o.rename("/a/y", "/a/z")
        o.symlink("/a/z", "/a/sym")
        assert o.readlink("/a/sym") == "/a/z"
        o.unlink("/a/sym")
        with pytest.raises(pkg.result.FsError) as ei:
            o.getattr("/a/sym")
        assert _errno(pkg, ei) == errno.ENOENT
        o.unlink("/a/z")
        o.unlink("/a/x")
        o.rmdir("/a")

    def test_open_trunc_and_setattr(self, fuse_ops):
        o = fuse_ops
        fh = o.create("/t", 0o644)
        o.write(fh, 0, b"0123456789")
        o.release(fh)
        o.truncate("/t", 4)
        assert o.getattr("/t").size == 4
        o.release(o.open("/t", os.O_RDWR | os.O_TRUNC))
        assert o.getattr("/t").size == 0
        o.chmod("/t", 0o600)
        assert o.getattr("/t").mode & 0o7777 == 0o600
        o.chown("/t", 12, 34)
        a = o.getattr("/t")
        assert (a.uid, a.gid) == (12, 34)
        o.utimens("/t", 100.0, 200.0)
        a = o.getattr("/t")
        assert (round(a.atime), round(a.mtime)) == (100, 200)

    def test_truncate_not_resurrected_by_close(self, fuse_ops):
        o = fuse_ops
        fh = o.create("/shrink", 0o644)
        o.write(fh, 0, b"0123456789")
        o.truncate("/shrink", 4)
        o.release(fh)
        assert o.getattr("/shrink").size == 4

    def test_utimens_omit_leaves_field(self, fuse_ops):
        o = fuse_ops
        o.release(o.create("/times", 0o644))
        o.utimens("/times", 100.0, 200.0)
        o.utimens("/times", None, 300.0)
        a = o.getattr("/times")
        assert (round(a.atime), round(a.mtime)) == (100, 300)

    def test_write_on_readonly_fh_rejected(self, pkg, fuse_ops):
        o = fuse_ops
        o.release(o.create("/ro", 0o644))
        fh2 = o.open("/ro", os.O_RDONLY)
        with pytest.raises(pkg.result.FsError) as ei:
            o.write(fh2, 0, b"x")
        assert _errno(pkg, ei) == errno.EACCES
        o.release(fh2)

    def test_virt_iov_ring_registration(self, pkg, fuse_ops):
        o = fuse_ops
        VIRT_DIR = pkg.ops.VIRT_DIR
        iov = pkg.ring.Iov(1 << 16, create=True)
        ring = pkg.ring.IoRing(16, create=True, for_read=False)
        try:
            o.symlink(iov.name, f"/{VIRT_DIR}/iovs/v0")
            o.symlink(f"{ring.name}?entries=16&rw=w&prio=1&iov=v0",
                      f"/{VIRT_DIR}/iors/r0")
            assert "v0" in [n for n, _ in o.readdir(f"/{VIRT_DIR}/iovs")]
            o.release(o.create("/ub.dat", 0o644))
            agent_fd = o._agent.open("/ub.dat", write=True)
            iov.write(0, b"ring-write!")
            ring.prep_io(0, 11, 0, agent_fd, read=False, userdata=5)
            ring.submit()
            assert ring.wait_for_ios(1, timeout=10) == [(11, 5)]
            assert o.read(o.open("/ub.dat", os.O_RDONLY), 0, 11) \
                == b"ring-write!"
            o.unlink(f"/{VIRT_DIR}/iors/r0")
            o.unlink(f"/{VIRT_DIR}/iovs/v0")
        finally:
            ring.close(unlink=True)
            iov.close(unlink=True)

    def test_statfs(self, fuse_ops):
        assert fuse_ops.statfs()["f_bsize"] > 0


class TestXattrs:
    def test_meta_xattr_roundtrip(self, pkg):
        fab = _fabric(pkg)
        fab.meta.create("/xf", client_id="c")
        fab.meta.set_xattr("/xf", "user.color", b"blue")
        fab.meta.set_xattr("/xf", "user.size", b"42")
        assert fab.meta.get_xattr("/xf", "user.color") == b"blue"
        assert fab.meta.list_xattrs("/xf") == ["user.color", "user.size"]
        fab.meta.remove_xattr("/xf", "user.color")
        assert fab.meta.list_xattrs("/xf") == ["user.size"]
        with pytest.raises(pkg.result.FsError) as ei:
            fab.meta.get_xattr("/xf", "user.color")
        assert ei.value.code == pkg.result.Code.META_NO_XATTR

    def test_fuse_ops_xattr_and_ioctl(self, pkg):
        fab = _fabric(pkg)
        ops = pkg.ops.FuseOps(fab.meta, fab.file_client())
        fab.meta.create("/g", client_id="c")
        ops.setxattr("/g", "user.tag", b"v1")
        assert ops.getxattr("/g", "user.tag") == b"v1"
        assert ops.listxattr("/g") == ["user.tag"]
        ops.removexattr("/g", "user.tag")
        assert ops.listxattr("/g") == []
        assert ops.ioctl("/g", pkg.ops.FuseOps.IOC_GET_INODE_ID) \
            == fab.meta.stat("/g").id

    def test_xattr_create_replace_flags(self, pkg):
        MetaStore, Code = pkg.store.MetaStore, pkg.result.Code
        fab = _fabric(pkg)
        fab.meta.create("/fl", client_id="c")
        ops = pkg.ops.FuseOps(fab.meta, fab.file_client())
        ops.setxattr("/fl", "user.k", b"v1", MetaStore.XATTR_CREATE)
        with pytest.raises(pkg.result.FsError) as ei:
            ops.setxattr("/fl", "user.k", b"v2", MetaStore.XATTR_CREATE)
        assert ei.value.code == Code.META_EXISTS
        ops.setxattr("/fl", "user.k", b"v2", MetaStore.XATTR_REPLACE)
        assert ops.getxattr("/fl", "user.k") == b"v2"
        with pytest.raises(pkg.result.FsError) as ei:
            ops.setxattr("/fl", "user.nope", b"x", MetaStore.XATTR_REPLACE)
        assert ei.value.code == Code.META_NO_XATTR


class TestReaddirplus:
    def test_entries_carry_full_attrs(self, fuse_ops):
        o = fuse_ops
        o.mkdir("/plus", 0o755)
        fh = o.create("/plus/a", 0o644)
        o.write(fh, 0, b"x" * 1234)
        o.release(fh)
        o.mkdir("/plus/sub", 0o700)
        entries = dict(o.readdirplus("/plus"))
        assert entries["a"].size == 1234
        assert entries["a"].nlink >= 1 and entries["a"].mode
        assert entries["sub"].mode & 0o170000

    def test_getattr_storm_served_from_cache(self, fuse_ops):
        o = fuse_ops
        o.mkdir("/storm", 0o755)
        for i in range(5):
            o.release(o.create(f"/storm/f{i}", 0o644))
        calls = []
        real_stat = o._meta.stat

        def counting_stat(path, **kw):
            calls.append(path)
            return real_stat(path, **kw)

        o._meta.stat = counting_stat
        try:
            listed = dict(o.readdirplus("/storm"))
            for name in listed:
                assert o.getattr(f"/storm/{name}").ino == listed[name].ino
            assert calls == [], f"getattr after readdirplus hit meta: {calls}"
        finally:
            o._meta.stat = real_stat

    def test_racing_readdirplus_cannot_pin_pre_mutation_attrs(self,
                                                              fuse_ops):
        o = fuse_ops
        o.mkdir("/race", 0o755)
        fh = o.create("/race/f", 0o644)
        o.write(fh, 0, b"old!")
        o.release(fh)
        stale = o.getattr("/race/f")
        real_set_attr = o._meta.set_attr

        def racing_set_attr(path, **kw):
            out = real_set_attr(path, **kw)
            o._attr_cache["/race/f"] = (time.time(), stale)
            return out

        o._meta.set_attr = racing_set_attr
        try:
            o.chmod("/race/f", 0o600)
        finally:
            o._meta.set_attr = real_set_attr
        assert o.getattr("/race/f").mode & 0o7777 == 0o600

    def test_mutation_drops_cache(self, pkg, fuse_ops):
        o = fuse_ops
        o.mkdir("/mut", 0o755)
        o.release(o.create("/mut/f", 0o644))
        o.readdirplus("/mut")
        assert o._attr_cache
        o.unlink("/mut/f")
        assert not o._attr_cache
        with pytest.raises(pkg.result.FsError):
            o.getattr("/mut/f")

    def test_length_settle_and_trunc_not_served_stale(self, fuse_ops):
        o = fuse_ops
        o.mkdir("/settle", 0o755)
        fh = o.create("/settle/f", 0o644)
        o.write(fh, 0, b"y" * 2048)
        o.release(fh)
        o.readdirplus("/settle")
        o.truncate("/settle/f", 0)
        assert o.getattr("/settle/f").size == 0
        fh2 = o.create("/settle/g", 0o644)
        o.readdirplus("/settle")
        o.write(fh2, 0, b"z" * 999)
        o.release(fh2)
        assert o.getattr("/settle/g").size == 999


# -- one seeded op sequence through both packages ---------------------------
def _attr_row(a) -> tuple:
    """An Attr without its times (each package's clock)."""
    return (a.ino, a.mode, a.nlink, a.uid, a.gid, a.size, a.blksize)


def _op_sequence(p) -> list:
    """Seeded getattr/readdirplus/create/write/truncate/rename/unlink/
    xattr/``3fs-virt`` steps; -> each step's reply or errno, then every
    file's stored bytes read back through a fresh file client."""
    from torch_fabric_sequence import deterministic

    rng = np.random.default_rng(16)
    out = []
    with deterministic(16):
        fab = _fabric(p)
        fio = fab.file_client()
        o = p.ops.FuseOps(fab.meta, fio, p.agent.UsrbioAgent(fab.meta, fio))
        V = p.ops.VIRT_DIR

        def step(name, fn):
            try:
                got = fn()
            except p.result.FsError as e:
                got = ("errno", p.ops.fs_errno(e))
            if isinstance(got, p.ops.Attr):
                got = _attr_row(got)
            elif isinstance(got, list):
                got = [(n, _attr_row(a)) if isinstance(a, p.ops.Attr)
                       else (n, a) for n, a in got] \
                    if got and isinstance(got[0], tuple) else got
            out.append((name, got))

        step("mkdir", lambda: o.mkdir("/s", 0o755))
        step("mkdir-sub", lambda: o.mkdir("/s/sub", 0o700))
        fhs = {}
        bodies = {}
        for i in range(4):
            path = f"/s/f{i}"
            fhs[path] = o.create(path, 0o644 if i % 2 else 0o600)
            n = int(rng.integers(1, 200_000))
            bodies[path] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            step(f"write {path}", lambda p_=path: o.write(
                fhs[p_], 0, bodies[p_]))
        off = int(rng.integers(0, 1000))
        patch = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
        step("overwrite f1", lambda: o.write(fhs["/s/f1"], off, patch))
        step("read f1", lambda: o.read(fhs["/s/f1"], 0, off + 5000))
        for path, fh in fhs.items():
            step(f"release {path}", lambda fh_=fh: o.release(fh_))
        step("getattr f0", lambda: o.getattr("/s/f0"))
        step("readdirplus /s", lambda: sorted(o.readdirplus("/s")))
        step("truncate f2", lambda: o.truncate("/s/f2", 777))
        step("getattr f2", lambda: o.getattr("/s/f2"))
        step("rename f3", lambda: o.rename("/s/f3", "/s/sub/g"))
        step("rename missing", lambda: o.rename("/s/nope", "/s/x"))
        step("unlink f0", lambda: o.unlink("/s/f0"))
        step("getattr f0 gone", lambda: o.getattr("/s/f0"))
        step("rmdir non-empty", lambda: o.rmdir("/s"))
        step("setxattr", lambda: o.setxattr("/s/f1", "user.k", b"v"))
        step("getxattr", lambda: o.getxattr("/s/f1", "user.k"))
        step("listxattr", lambda: o.listxattr("/s/f1"))
        step("getxattr missing", lambda: o.getxattr("/s/f1", "user.no"))
        step("removexattr", lambda: o.removexattr("/s/f1", "user.k"))
        step("symlink", lambda: o.symlink("/s/f1", "/s/ln"))
        step("readlink", lambda: o.readlink("/s/ln"))
        step("virt fd", lambda: o.symlink("/s/f1?rw=r", f"/{V}/fds/a"))
        step("virt fd readlink", lambda: o.readlink(f"/{V}/fds/a"))
        step("virt readdir", lambda: sorted(
            n for n, _ in o.readdirplus(f"/{V}/fds")))
        step("virt unlink", lambda: o.unlink(f"/{V}/fds/a"))
        step("virt unlink again", lambda: o.unlink(f"/{V}/fds/a"))
        step("readdirplus /", lambda: sorted(n for n, _ in
                                             o.readdirplus("/")))
        step("open trunc", lambda: o.release(o.open("/s/f1",
                                                    os.O_RDWR | os.O_TRUNC)))
        step("getattr f1", lambda: o.getattr("/s/f1"))
        reader = fab.file_client()
        for path in ("/s/f2", "/s/sub/g", "/s/f1"):
            inode = fab.meta.stat(path)
            out.append((f"stored {path}", reader.read(inode, 0,
                                                      inode.length)))
        o.destroy()
    return out


def test_op_sequence_replies_and_bytes_equal():
    want = _op_sequence(_pkg("tpu3fs"))
    got = _op_sequence(_pkg("tpu3fs_torch"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a == b, name
    assert len(dict(got)["stored /s/f2"]) == 777


# -- kernel mounts ------------------------------------------------------------
def _can_mount() -> bool:
    if not os.path.exists("/dev/fuse"):
        return False
    try:
        import ctypes

        ctypes.CDLL("libfuse.so.2")
    except OSError:
        return False
    return True


needs_mount = pytest.mark.skipif(not _can_mount(),
                                 reason="no /dev/fuse or libfuse2")


def _lazy_unmount(mnt) -> None:
    subprocess.run(["fusermount", "-u", "-z", str(mnt)], check=False,
                   capture_output=True, timeout=30)


def _port_mount():
    from tpu3fs_torch.fuse.mount import FuseMount

    p = _pkg("tpu3fs_torch")
    fab = _fabric(p)
    ops = p.ops.FuseOps(fab.meta, fab.file_client(),
                        p.agent.UsrbioAgent(fab.meta, fab.file_client()))
    mnt = tempfile.mkdtemp(prefix="tpu3fs-torch-mnt-")
    m = FuseMount(ops, mnt)
    m.mount()
    if not m.wait_mounted(timeout=15):
        _lazy_unmount(mnt)
        pytest.skip(f"kernel mount failed (exit {m.exit_code}); "
                    "environment forbids FUSE mounts")
    return fab, m, mnt


@needs_mount
def test_kernel_mount_end_to_end():
    fab, m, mnt = _port_mount()
    try:
        os.makedirs(f"{mnt}/dir/sub")
        body = np.random.default_rng(5).integers(
            0, 256, 300_001, dtype=np.uint8).tobytes()
        with open(f"{mnt}/dir/sub/file.bin", "wb") as f:
            f.write(body)
        with open(f"{mnt}/dir/sub/file.bin", "rb") as f:
            assert f.read() == body
        assert os.path.getsize(f"{mnt}/dir/sub/file.bin") == len(body)
        with open(f"{mnt}/dir/sub/file.bin", "r+b") as f:
            f.seek(1000)
            f.write(b"X" * 4096)
        want = body[:1000] + b"X" * 4096 + body[5096:]
        os.rename(f"{mnt}/dir/sub/file.bin", f"{mnt}/dir/moved.bin")
        assert sorted(os.listdir(f"{mnt}/dir")) == ["moved.bin", "sub"]
        os.truncate(f"{mnt}/dir/moved.bin", 200_000)
        with open(f"{mnt}/dir/moved.bin", "rb") as f:
            assert f.read() == want[:200_000]
        inode = fab.meta.stat("/dir/moved.bin")
        assert fab.file_client().read(inode, 0, inode.length) \
            == want[:200_000]
        os.symlink("moved.bin", f"{mnt}/dir/ln")
        assert os.readlink(f"{mnt}/dir/ln") == "moved.bin"
        os.setxattr(f"{mnt}/dir/moved.bin", "user.a", b"one")
        assert os.listxattr(f"{mnt}/dir/moved.bin") == ["user.a"]
        assert os.statvfs(mnt).f_bsize > 0
        assert os.path.isdir(f"{mnt}/3fs-virt/iovs")
        os.remove(f"{mnt}/dir/ln")
        os.remove(f"{mnt}/dir/moved.bin")
        with pytest.raises(FileNotFoundError):
            os.stat(f"{mnt}/dir/moved.bin")
    finally:
        m.unmount()
        _lazy_unmount(mnt)


@needs_mount
def test_loadgen_from_hostsrc_through_a_port_mount():
    """The foreign-process USRBIO handshake: ``hostsrc/usrbio_loadgen.cpp``
    built by ``hostbuild`` (never ``native/``), its write and read through
    the ring registered by symlinks under the port's mount, every byte
    verified, and no registration left."""
    from tpu3fs_torch import hostbuild

    binary = hostbuild.executable("usrbio_loadgen")
    assert binary.parent == hostbuild.BUILD_DIR
    fab, m, mnt = _port_mount()
    try:
        out = subprocess.run([str(binary), mnt, "4", "128", "8", "2"],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (out.stdout, out.stderr)
        rows = {r["metric"]: r for r in map(
            json.loads, out.stdout.strip().splitlines())}
        assert rows["usrbio_loadgen_read"]["verified"] is True
        assert rows["usrbio_loadgen_write"]["value"] > 0
        assert os.listdir(f"{mnt}/3fs-virt/iors") == []
        assert os.listdir(f"{mnt}/3fs-virt/fds") == []
    finally:
        m.unmount()
        _lazy_unmount(mnt)


def test_loadgen_source_is_the_jax_packages():
    """``hostsrc/usrbio_loadgen.cpp`` is a byte-equal copy of
    ``native/usrbio_loadgen.cpp``, and its build lands in ``_build/``
    under a name that carries the source's digest."""
    from tpu3fs_torch import hostbuild

    assert (ROOT / "tpu3fs_torch/hostsrc/usrbio_loadgen.cpp").read_bytes() \
        == (ROOT / "native/usrbio_loadgen.cpp").read_bytes()
    path = hostbuild.library_path("usrbio_loadgen")
    assert path.parent == hostbuild.BUILD_DIR
    assert path.name.startswith("tpu3fs_torch_usrbio_loadgen_")


def test_loadgen_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises with the compiler's output; there is no
    fallback binary."""
    from tpu3fs_torch import hostbuild

    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(hostbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here"):
        hostbuild.executable("usrbio_loadgen")
    with pytest.raises(ValueError):
        hostbuild.executable("chunk_engine")


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _mounted(mnt) -> bool:
    with open("/proc/mounts") as f:
        return any(f" {mnt} " in line for line in f)


@needs_mount
def test_fuse_main_process_over_a_port_cluster(tmp_path):
    """``python -m tpu3fs_torch.bin.fuse_main --device cpu`` over a port
    cluster (mgmtd, two storage apps, meta): a file written through its
    kernel mount reads back through a port client; SIGTERM unmounts and
    exits 0 within 20 s, the process's kernel launches in its log."""
    from torch_socket_sequence import AppCluster

    cluster = AppCluster("tpu3fs_torch", dict(nodes=2, chains=2, replicas=2,
                                              chunk_size=1 << 16),
                         app_kw={"device": "cpu"},
                         client_kw={"device": "cpu"})
    mnt = tmp_path / "mnt"
    log = tmp_path / "fuse.log"
    proc = None
    try:
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu3fs_torch.bin.fuse_main",
                 "--device", "cpu", "--node-id", "301",
                 "--mgmtd", "%s:%d" % cluster.maddr,
                 "--heartbeat_interval", "0.5", "--mountpoint", str(mnt),
                 "--log_file", str(tmp_path / "fuse.xlog")],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(ROOT),
                     "TPU3FS_USRBIO": "0"})
        _wait(lambda: _mounted(mnt) or proc.poll() is not None, 60.0,
              "the fuse process to mount")
        assert proc.poll() is None, log.read_text()
        body = np.random.default_rng(9).integers(
            0, 256, 200_000, dtype=np.uint8).tobytes()
        with open(mnt / "via-mount.bin", "wb") as f:
            f.write(body)
        with open(mnt / "via-mount.bin", "rb") as f:
            assert f.read() == body
        inode = cluster.meta.stat("/via-mount.bin")
        assert inode.length == len(body)
        assert cluster.file_client().read(inode, 0, inode.length) == body
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0, log.read_text()
        assert not _mounted(mnt)
        xlog = (tmp_path / "fuse.xlog").read_text()
        assert "fuse mounted at" in xlog and "fuse kernel launches" in xlog
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        _lazy_unmount(mnt)
        cluster.close()


def test_fuse_app_without_a_card_or_a_device_raises():
    from tpu3fs_torch.bin.fuse_main import FuseApp

    assert FuseApp(["--device", "cpu"]).device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FuseApp([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FuseApp(["--device", "cuda"])


def test_fuse_mount_without_libfuse_raises(monkeypatch, tmp_path):
    """No silent substitute: a host whose ``libfuse.so.2`` does not load
    makes ``FuseMount`` raise at construction."""
    from tpu3fs_torch.fuse import mount as mount_mod

    p = _pkg("tpu3fs_torch")
    fab = _fabric(p)
    ops = p.ops.FuseOps(fab.meta, fab.file_client())

    def no_lib(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(mount_mod.ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libfuse.so.2"):
        mount_mod.FuseMount(ops, str(tmp_path / "mnt"))


def test_lazy_unmount_without_fusermount_detaches(monkeypatch):
    """Where the host has no ``fusermount``, ``unmount`` detaches with
    ``umount2(MNT_DETACH)`` (as root)."""
    import shutil

    from tpu3fs_torch.fuse import mount as mount_mod

    calls = []

    class Libc:
        def umount2(self, path, flags):
            calls.append((path, flags))
            return 0

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(mount_mod.ctypes, "CDLL", lambda *a, **kw: Libc())
    mount_mod.lazy_unmount("/mnt/x")
    assert calls == [(b"/mnt/x", mount_mod.MNT_DETACH)]


def test_launch_recorder_reports_each_kernels_growth():
    """The FUSE process's ``kernel.launches`` samples: each collection
    reports how much each counter grew since the last, tagged by kernel
    and node, and nothing when none did."""
    from tpu3fs_torch import kernels
    from tpu3fs_torch.ops.crc32c import crc32c_many

    rec = kernels.launch_recorder({"node": "401"})
    assert rec.collect(0.0) == []
    crc32c_many([b"abc", b"defg"], device="cpu")  # one plain-version call
    got = rec.collect(1.0)
    assert [(s.name, s.tags, s.value) for s in got] == [
        ("kernel.launches", {"node": "401", "kernel": "crc32c_plain"}, 1.0)]
    assert rec.collect(2.0) == []
    assert set(kernels.counts()) == set(kernels.COUNTERS)
