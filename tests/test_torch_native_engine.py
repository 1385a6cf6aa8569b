"""The port's C++ chunk engine (``tpu3fs_torch/storage/native_engine.py``
over ``tpu3fs_torch/hostsrc/chunk_engine.cpp``) against the JAX package's
(``tpu3fs/storage/native_engine.py`` over ``native/``).

One seeded op sequence (updates, commits, partial and validated installs,
the batch ops, query, truncate, remove, compact) runs through both engines
and must give equal replies, metas and bytes (tolerance 0). A data dir
written by either package reopens in the other with the same metas and
bytes; the WAL replays, and a garbage suffix is dropped; the io_uring and
the sync read paths give the same bytes. The port's library is built by
``hostbuild`` into ``_build/`` under a name that carries its source's
digest: a changed source builds a new library, and nothing under
``native/`` is written."""

import importlib
import os
from pathlib import Path

import numpy as np
import pytest

PKGS = ("tpu3fs", "tpu3fs_torch")
REPO = Path(__file__).resolve().parents[1]
CS = 1 << 16


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def engine(pkg: str, path, **kw):
    cls = mod(pkg, "storage.native_engine").NativeChunkEngine
    if pkg == "tpu3fs_torch":
        kw["device"] = "cpu"
    return cls(str(path), **kw)


def meta_row(m):
    if m is None:
        return None
    return (m.chunk_id.file_id, m.chunk_id.index, m.chain_ver,
            m.committed_ver, m.pending_ver, m.length, m.checksum.value,
            m.pending_length, m.pending_checksum.value, m.aux)


def state(pkg: str, e) -> list:
    """Every meta the engine holds and its committed bytes."""
    out = []
    for m in sorted(e.all_metadata(), key=lambda m: m.chunk_id.to_bytes()):
        data = e.read(m.chunk_id) if m.committed_ver else None
        out.append((meta_row(m), data))
    return out


def result(fn):
    """fn() -> its value, or the FsError's code, so both packages' errors
    compare by code."""
    try:
        return fn()
    except Exception as e:  # FsError of either package
        code = getattr(e, "code", None)
        if code is None:
            raise
        return ("error", int(code))


def op_sequence(pkg: str, path, seed: int) -> list:
    """One seeded sequence over every engine entry; -> its record."""
    types = mod(pkg, "storage.types")
    eng_mod = mod(pkg, "storage.engine")
    ChunkId, Op = types.ChunkId, eng_mod.EngineUpdateOp
    crc32c = mod(pkg, "ops.crc32c").crc32c_py if pkg == "tpu3fs_torch" \
        else mod(pkg, "ops.crc32c").crc32c
    rng = np.random.default_rng(seed)
    blob = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    e = engine(pkg, path)
    rec = []
    try:
        # single updates and commits, a COW partial overwrite, version
        # taxonomy (stale, missing, advance)
        for i in range(6):
            cid = ChunkId(1, i)
            rec.append(meta_row(e.update(cid, 1, 1, blob(100 + 917 * i), 0,
                                         chunk_size=CS)))
            rec.append(meta_row(e.commit(cid, 1, 1)))
        rec.append(meta_row(e.update(ChunkId(1, 2), 2, 1, blob(333), 77,
                                     chunk_size=CS)))
        rec.append(meta_row(e.commit(ChunkId(1, 2), 2, 1)))
        for ver in (1, 5):
            rec.append(result(lambda: meta_row(e.update(
                ChunkId(1, 3), ver, 1, b"x", 0, chunk_size=CS))))
        rec.append(result(lambda: meta_row(e.update(
            ChunkId(1, 3), 2, 1, b"y" * (CS + 1), 0, chunk_size=CS))))
        # full replace and the EC two-phase stage, a validated install
        # (good and bad CRC) with an aux tag
        rec.append(meta_row(e.update(ChunkId(1, 4), 7, 2, blob(2048), 0,
                                     full_replace=True, chunk_size=CS)))
        payload = blob(4000)
        rec.append(meta_row(e.update(ChunkId(2, 0), 3, 1, payload, 0,
                                     stage_replace=True, chunk_size=CS,
                                     aux=3999)))
        rec.append(e.pending_content(ChunkId(2, 0)))
        rec.append(sorted(meta_row(m) for m in e.pending_metas()))
        rec.append(meta_row(e.commit(ChunkId(2, 0), 3, 1)))
        good = blob(1500)
        rec.append(meta_row(e.update(ChunkId(2, 1), 1, 1, good, 0,
                                     full_replace=True, chunk_size=CS,
                                     expected_crc=crc32c(good))))
        rec.append(result(lambda: meta_row(e.update(
            ChunkId(2, 2), 1, 1, good, 0, full_replace=True, chunk_size=CS,
            expected_crc=crc32c(good) ^ 1))))
        rec.append(meta_row(e.get_meta(ChunkId(2, 2))))
        # the batch ops: update (fresh, merge, stale), commit, read and
        # read_views (whole, ranged, missing, over the cap)
        ops = [Op(ChunkId(3, i), blob(64 + 512 * i), 0, update_ver=0,
                  chunk_size=CS) for i in range(8)]
        ops.append(Op(ChunkId(1, 0), blob(50), 10, update_ver=2,
                      chunk_size=CS))
        ops.append(Op(ChunkId(1, 1), blob(50), 0, update_ver=1,
                      chunk_size=CS))
        rec.append([(int(r.code), r.ver, r.length, r.crc)
                    for r in e.batch_update(ops, 1)])
        rec.append([(int(r.code), r.ver, r.length, r.crc)
                    for r in e.batch_commit(
                        [(ChunkId(3, i), 1) for i in range(8)]
                        + [(ChunkId(1, 0), 2), (ChunkId(9, 9), 1)], 1)])
        items = ([(ChunkId(3, i), 0, -1) for i in range(8)]
                 + [(ChunkId(1, 2), 40, 300), (ChunkId(8, 8), 0, -1),
                    (ChunkId(3, 7), 3000, -1)])
        for read in (e.batch_read, e.batch_read_views):
            rec.append([(int(c), bytes(d), v, crc, aux)
                        for c, d, v, crc, aux in read(items, 2048)])
        rec.append(e.read_verified(ChunkId(1, 2), 5, 100))
        rec.append(e.read(ChunkId(1, 5), 1000, 2000))
        # query by prefix, truncate, remove, compact
        rec.append(sorted(meta_row(m) for m in e.query(
            ChunkId(3, 0).to_bytes()[:8])))
        rec.append(meta_row(e.truncate(ChunkId(1, 5), 777, 1)))
        rec.append(meta_row(e.truncate(ChunkId(1, 4), 4096, 2)))
        rec.append([e.remove(ChunkId(3, i)) for i in (1, 3, 5)]
                   + [e.remove(ChunkId(7, 7))])
        e.compact()
        rec.append(e.used_size())
        rec.append(state(pkg, e))
    finally:
        e.close()
    return rec


@pytest.mark.parametrize("seed", [15, 1515])
def test_op_sequence_equal_across_packages(tmp_path, seed):
    jax_rec = op_sequence("tpu3fs", tmp_path / "jax", seed)
    port_rec = op_sequence("tpu3fs_torch", tmp_path / "port", seed)
    assert len(port_rec) == len(jax_rec)
    for i, (a, b) in enumerate(zip(jax_rec, port_rec)):
        assert a == b, f"record {i} differs"


@pytest.mark.parametrize("writer,reader", [
    ("tpu3fs", "tpu3fs_torch"), ("tpu3fs_torch", "tpu3fs")],
    ids=["jax-writes", "port-writes"])
def test_data_dir_reopens_in_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "eng"
    op_sequence(writer, path, 7)
    e = engine(writer, path)
    want = state(writer, e)
    e.close()
    e = engine(reader, path)
    try:
        assert state(reader, e) == want
        # the reader appends, and the writer reopens what it appended
        ChunkId = mod(reader, "storage.types").ChunkId
        e.update(ChunkId(11, 0), 1, 1, b"appended", 0, chunk_size=CS)
        e.commit(ChunkId(11, 0), 1, 1)
        want = state(reader, e)
    finally:
        e.close()
    e = engine(writer, path)
    try:
        assert state(writer, e) == want
    finally:
        e.close()


@pytest.mark.parametrize("garbage", [b"", b"\xde\xad\xbe\xef" * 10,
                                     b"\x01\x02torn-garbage"],
                         ids=["clean", "garbage", "torn"])
def test_wal_replay_and_a_garbage_suffix(tmp_path, garbage):
    """Reopen without close (the WAL as a SIGKILL leaves it) and after a
    garbage suffix: the port replays what the JAX package replays, and a
    write after the recovery survives the next open."""
    ChunkId = mod("tpu3fs_torch", "storage.types").ChunkId
    d = tmp_path / "eng"
    e = engine("tpu3fs_torch", d)
    for i in range(5):
        e.update(ChunkId(1, i), 1, 1, bytes([i + 1]) * (300 * i + 1), 0,
                 chunk_size=CS)
        e.commit(ChunkId(1, i), 1, 1)
    e.update(ChunkId(1, 2), 2, 1, b"pending", 0, chunk_size=CS)
    want = state("tpu3fs_torch", e)
    pending = meta_row(e.get_meta(ChunkId(1, 2)))
    # no close: the WAL holds what a killed process wrote
    with open(d / "wal.log", "ab") as f:
        f.write(garbage)
    got = {}
    for pkg in PKGS:
        r = engine(pkg, d)
        try:
            got[pkg] = (state(pkg, r), meta_row(r.get_meta(
                mod(pkg, "storage.types").ChunkId(1, 2))))
        finally:
            r.close()
    assert got["tpu3fs"] == got["tpu3fs_torch"] == (want, pending)
    e = engine("tpu3fs_torch", d)
    e.update(ChunkId(1, 9), 1, 1, b"after", 0, chunk_size=CS)
    e.commit(ChunkId(1, 9), 1, 1)
    e.close()
    e = engine("tpu3fs_torch", d)
    try:
        assert e.read(ChunkId(1, 9)) == b"after"
        assert e.read(ChunkId(1, 4)) == bytes([5]) * 1201
    finally:
        e.close()


def _uring_items(pkg):
    ChunkId = mod(pkg, "storage.types").ChunkId
    return ([(ChunkId(9, i), 0, -1) for i in range(24)]
            + [(ChunkId(9, i), 11, 222) for i in range(24)])


def _uring_engine(pkg, path):
    ChunkId = mod(pkg, "storage.types").ChunkId
    e = engine(pkg, path)
    for i in range(24):
        e.update(ChunkId(9, i), 1, 1, bytes([i + 1]) * (1000 + 313 * i), 0,
                 chunk_size=CS)
        e.commit(ChunkId(9, i), 1, 1)
    return e


@pytest.mark.parametrize("pkg", PKGS)
def test_uring_and_sync_read_paths_give_the_same_bytes(tmp_path, pkg,
                                                       monkeypatch):
    """The io_uring batch path and the pread fallback (TPU3FS_NO_URING,
    read when an engine first reads), in either package, return equal
    results; ``read_path`` names the path each took."""
    ne = mod("tpu3fs_torch", "storage.native_engine")
    outs = {}
    for mode in ("pread", "ring"):
        if mode == "pread":
            monkeypatch.setenv("TPU3FS_NO_URING", "1")
        else:
            monkeypatch.delenv("TPU3FS_NO_URING", raising=False)
        path = tmp_path / mode
        e = _uring_engine(pkg, path)
        try:
            outs[mode] = [(int(c), bytes(d), v, crc, aux) for c, d, v, crc,
                          aux in e.batch_read(_uring_items(pkg), CS)]
        finally:
            e.close()
        assert ne.read_path(str(path)) in (
            ("pread",) if mode == "pread" else ("io_uring", "pread", "mmap"))
    assert outs["pread"] == outs["ring"]
    for i in range(24):
        assert outs["pread"][i][1] == bytes([i + 1]) * (1000 + 313 * i)
        assert outs["pread"][24 + i][1] == (bytes([i + 1]) * 1000)[11:233]


def test_read_path_follows_the_engine_rules(tmp_path, monkeypatch):
    ne = mod("tpu3fs_torch", "storage.native_engine")
    monkeypatch.delenv("TPU3FS_NO_URING", raising=False)
    monkeypatch.delenv("TPU3FS_MMAP", raising=False)
    assert ne.read_path(str(tmp_path)) in ("io_uring", "pread", "mmap")
    monkeypatch.setenv("TPU3FS_MMAP", "1")
    assert ne.read_path(str(tmp_path)) == "mmap"
    monkeypatch.setenv("TPU3FS_MMAP", "0")
    monkeypatch.setenv("TPU3FS_NO_URING", "1")
    assert ne.read_path(str(tmp_path)) == "pread"
    if os.path.isdir("/dev/shm"):
        monkeypatch.delenv("TPU3FS_MMAP")
        assert ne.read_path("/dev/shm") == "mmap"
        assert ne.FS_TYPES[ne.fs_type("/dev/shm")] == "tmpfs"


def test_refetch_error_maps_to_its_code(tmp_path, monkeypatch):
    """An op whose chunk outgrew its slot is re-read alone; a failure of
    that re-read answers its code (the JAX package's copy names FsError
    without importing it, so it raises NameError there)."""
    types = mod("tpu3fs_torch", "storage.types")
    result_mod = mod("tpu3fs_torch", "utils.result")
    e = engine("tpu3fs_torch", tmp_path / "eng")
    try:
        cid = types.ChunkId(2, 0)
        e.update(cid, 1, 1, b"z" * 5000, 0, chunk_size=CS)
        e.commit(cid, 1, 1)

        def gone(*a, **k):
            raise result_mod.err(result_mod.Code.CHUNK_NOT_FOUND, "gone")

        monkeypatch.setattr(e, "read_verified", gone)
        for read in (e.batch_read, e.batch_read_views):
            (code, data, *_), = read([(cid, 0, -1)], 1024)
            assert code == result_mod.Code.CHUNK_NOT_FOUND and data == b""
    finally:
        e.close()


def test_make_engine_kinds(tmp_path):
    target = mod("tpu3fs_torch", "storage.target")
    ne = mod("tpu3fs_torch", "storage.native_engine")
    for kind in ("native", "auto"):
        t = target.StorageTarget(1, 1, engine=kind, path=str(tmp_path / kind),
                                 device="cpu")
        try:
            assert isinstance(t.engine, ne.NativeChunkEngine)
            assert t.device.type == "cpu"
            info = t.space_info()
            st = os.statvfs(tmp_path)
            assert info.capacity == st.f_frsize * st.f_blocks
        finally:
            t.engine.close()
    with pytest.raises(ValueError, match="unknown chunk engine"):
        target.make_engine("bogus")


def test_auto_falls_back_to_mem_only_when_the_library_fails(tmp_path,
                                                            monkeypatch):
    target = mod("tpu3fs_torch", "storage.target")
    ne = mod("tpu3fs_torch", "storage.native_engine")
    engine_mod = mod("tpu3fs_torch", "storage.engine")

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(ne, "_load_lib", broken)
    assert isinstance(target.make_engine("auto", str(tmp_path), "cpu"),
                      engine_mod.MemChunkEngine)
    with pytest.raises(RuntimeError, match="g"):
        target.make_engine("native", str(tmp_path), "cpu")


def _mtimes(root: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in sorted(root.rglob("*"))}


def test_library_is_rebuilt_when_its_source_changes(tmp_path, monkeypatch):
    """``hostbuild`` names a library by its source's digest: an edited
    source builds and loads a new library beside the old one; loading
    the real libraries writes nothing under ``native/``."""
    hostbuild = mod("tpu3fs_torch", "hostbuild")
    native_before = _mtimes(REPO / "native")
    for name in hostbuild.SOURCES:
        hostbuild.load(name)
        path = hostbuild.library_path(name)
        assert path.parent == hostbuild.BUILD_DIR and path.exists()
    assert _mtimes(REPO / "native") == native_before

    src, build = tmp_path / "src", tmp_path / "build"
    src.mkdir()
    monkeypatch.setattr(hostbuild, "SRC_DIR", src)
    monkeypatch.setattr(hostbuild, "BUILD_DIR", build)
    monkeypatch.setattr(hostbuild, "SOURCES", ("probe",))
    monkeypatch.setattr(hostbuild, "_loaded", {})
    paths = []
    for value in (1, 2):
        (src / "probe.cpp").write_text(
            f'extern "C" int probe() {{ return {value}; }}\n')
        hostbuild._loaded.clear()
        assert hostbuild.load("probe").probe() == value
        paths.append(hostbuild.library_path("probe"))
    assert paths[0] != paths[1] and all(p.exists() for p in paths)
    (src / "probe.cpp").write_text("int broken(\n")
    hostbuild._loaded.clear()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for probe.cpp"):
        hostbuild.load("probe")


def test_sources_equal_the_jax_packages_apart_from_comments():
    """The port's copies carry the JAX package's code: the same C ABI,
    ABI tag and wire (only comments differ)."""
    import re

    def code(path: Path) -> str:
        text = re.sub(r"//[^\n]*", "", path.read_text())
        return "\n".join(ln.rstrip() for ln in text.splitlines()
                         if ln.strip())

    for name in ("chunk_engine.cpp", "rpc_net.cpp"):
        assert code(REPO / "tpu3fs_torch" / "hostsrc" / name) == \
            code(REPO / "native" / name), name
    from tpu3fs_torch.storage import native_engine

    assert f'"{native_engine._ABI_TAG.decode()}"' in code(
        REPO / "tpu3fs_torch" / "hostsrc" / "chunk_engine.cpp")
