"""FUSE operation table over the meta/storage clients.

Re-expresses src/fuse/FuseOps.cc (the fuse_lowlevel_ops table at
FuseOps.cc:2580-2613) as transport-agnostic path operations: the ctypes
libfuse binding (tpu3fs_torch.fuse.mount) calls these from kernel callbacks, and
tests drive them directly. Covered semantics:

- open-file table with write sessions; release closes the session with a
  precise length hint (ref RcInode::beginWrite/finishWrite FuseOps.cc:
  2617-2660 + design_notes "Dynamic file attributes").
- the ``3fs-virt`` virtual directory: creating a symlink under
  ``3fs-virt/iovs/`` registers the client's shm buffer with the USRBIO
  agent, under ``3fs-virt/iors/`` creates a ring served by agent workers;
  unlink deregisters (ref symlink interception in FuseOps + IovTable.h:
  10-39, IoRing.h:43-264).
- errors surface as FsError; the binding maps codes to negative errnos.

The port's own copy of ``tpu3fs/fuse/ops.py``, unchanged but for its
imports. The table does no device work itself: its ``fio`` (the port's
``FileIoClient``) encodes, checksums and decodes on the device its
``StorageClient`` was given, the card in ``bin/fuse_main``.
"""

from __future__ import annotations

import errno
import os
import stat as stat_mod
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.meta.types import Inode, InodeType
from tpu3fs_torch.utils.result import Code, FsError, Status

VIRT_DIR = "3fs-virt"
_VIRT_SUBDIRS = ("iovs", "iors", "fds")

# FsError code -> errno (subset; everything else maps to EIO)
_CODE_ERRNO = {
    Code.META_NOT_FOUND: errno.ENOENT,
    Code.META_EXISTS: errno.EEXIST,
    Code.META_NOT_DIRECTORY: errno.ENOTDIR,
    Code.META_IS_DIRECTORY: errno.EISDIR,
    Code.META_NOT_EMPTY: errno.ENOTEMPTY,
    Code.META_NO_PERMISSION: errno.EACCES,
    Code.META_TOO_MANY_SYMLINKS: errno.ELOOP,
    Code.META_LOOP: errno.EINVAL,
    Code.META_NAME_TOO_LONG: errno.ENAMETOOLONG,
    Code.META_INVALID_PATH: errno.EINVAL,
    Code.META_NOT_FILE: errno.EINVAL,
    Code.INVALID_ARG: errno.EINVAL,
    Code.META_BUSY: errno.EBUSY,
    Code.META_NO_XATTR: errno.ENODATA,
}


def fs_errno(e: FsError) -> int:
    return _CODE_ERRNO.get(e.code, errno.EIO)


@dataclass
class OpenFile:
    inode: Inode
    session_id: str = ""
    flags: int = 0
    # highest offset written through this handle (precise-length hint)
    max_written: int = -1
    dirty: bool = False


@dataclass
class Attr:
    """What the binding turns into ``struct stat``."""

    ino: int
    mode: int
    nlink: int
    uid: int
    gid: int
    size: int
    atime: float
    mtime: float
    ctime: float
    blksize: int = 512 * 1024


class FuseOps:
    """Path-based operation table (the libfuse high-level model; the
    reference uses lowlevel inode ops — same capability surface, FuseOps.cc
    table order kept in the method order below)."""

    def __init__(self, meta, fio, agent=None, *, uid: int = 0, gid: int = 0):
        self._meta = meta
        self._fio = fio
        self._agent = agent  # UsrbioAgent for 3fs-virt registration
        self._uid = uid
        self._gid = gid
        self._files: Dict[int, OpenFile] = {}
        self._next_fh = 10
        self._lock = threading.Lock()
        # 3fs-virt registrations: name -> symlink target
        self._virt: Dict[str, Dict[str, str]] = {d: {} for d in _VIRT_SUBDIRS}
        self._virt_iovs: Dict[str, object] = {}
        # readdirplus attr cache: the `ls -l` pattern is one readdir
        # followed by a getattr per entry — readdirplus (ref FuseOps.cc's
        # fuse_lowlevel readdirplus, :2580-2613) returns attrs WITH the
        # entries; this cache lets the follow-up getattr storm hit memory
        # instead of one meta batch_stat turning into N meta stats. Any
        # mutating op clears it wholesale (cheap, and exactly matches the
        # pattern's interleaving-free window); entries also expire by TTL.
        self._attr_cache: Dict[str, Tuple[float, Attr]] = {}
        self._attr_cache_ttl = 1.0
        # every mutating entry point drops the cache wholesale BEFORE
        # running AND AFTER it completes (instance-level wrap: one list to
        # keep current, and a forgotten future mutator fails loudly in
        # tests rather than serving stale attrs from a path we forgot to
        # hand-invalidate). The clear-after matters for the race it
        # closes: a readdirplus interleaving with the
        # mutation can re-insert PRE-mutation attrs after the leading
        # clear, and with only that clear a following getattr would serve
        # the stale size/mode for up to the TTL. The trailing clear (in a
        # finally, so failed mutations that changed partial state are
        # covered too) bounds the stale window to the mutation's own
        # duration. Metadata mutated OUTSIDE this mount (another client,
        # admin CLI) is still visible up to `_attr_cache_ttl` late — the
        # documented staleness contract of the readdirplus cache.
        # open/release/fsync/flush belong here too: open(O_TRUNC) cuts the
        # file and release/fsync/flush settle its length at meta — all
        # change the attrs a cached entry would go on serving
        for _name in ("chmod", "chown", "utimens", "truncate", "mkdir",
                      "rmdir", "unlink", "rename", "symlink", "link",
                      "create", "write", "setxattr", "removexattr",
                      "open", "release", "fsync", "flush"):
            _orig = getattr(self, _name)

            def _wrapped(*a, __orig=_orig, **kw):
                self._attr_cache_clear()
                try:
                    return __orig(*a, **kw)
                finally:
                    self._attr_cache_clear()

            setattr(self, _name, _wrapped)

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _virt_parts(path: str) -> Optional[Tuple[str, str]]:
        parts = [p for p in path.split("/") if p]
        if len(parts) >= 1 and parts[0] == VIRT_DIR:
            if len(parts) == 1:
                return ("", "")
            if len(parts) == 2 and parts[1] in _VIRT_SUBDIRS:
                return (parts[1], "")
            if len(parts) == 3 and parts[1] in _VIRT_SUBDIRS:
                return (parts[1], parts[2])
        return None

    def _attr_of(self, inode: Inode) -> Attr:
        if inode.type == InodeType.DIRECTORY:
            mode = stat_mod.S_IFDIR | inode.acl.perm
            size = 4096
        elif inode.type == InodeType.SYMLINK:
            mode = stat_mod.S_IFLNK | 0o777
            size = len(inode.symlink_target)
        else:
            mode = stat_mod.S_IFREG | inode.acl.perm
            size = inode.length
        return Attr(
            ino=inode.id, mode=mode, nlink=inode.nlink,
            uid=inode.acl.uid, gid=inode.acl.gid, size=size,
            atime=inode.atime, mtime=inode.mtime, ctime=inode.ctime,
        )

    def _virt_attr(self, kind: str, name: str) -> Attr:
        now = time.time()
        if not name:
            return Attr(ino=2, mode=stat_mod.S_IFDIR | 0o755, nlink=2,
                        uid=self._uid, gid=self._gid, size=4096,
                        atime=now, mtime=now, ctime=now)
        target = self._virt[kind].get(name)
        if target is None:
            raise FsError(Status(Code.META_NOT_FOUND, f"{kind}/{name}"))
        return Attr(ino=3, mode=stat_mod.S_IFLNK | 0o777, nlink=1,
                    uid=self._uid, gid=self._gid, size=len(target),
                    atime=now, mtime=now, ctime=now)

    def _attr_cache_clear(self) -> None:
        if self._attr_cache:
            self._attr_cache.clear()

    # -- attr ops (ref fuse lookup/getattr/setattr) --------------------------
    def getattr(self, path: str) -> Attr:
        v = self._virt_parts(path)
        if v is not None:
            return self._virt_attr(*v)
        hit = self._attr_cache.get(path)
        if hit is not None:
            ts, attr = hit
            if time.time() - ts <= self._attr_cache_ttl:
                return attr
            self._attr_cache.pop(path, None)
        return self._attr_of(self._meta.stat(path, follow=False))

    def readlink(self, path: str) -> str:
        v = self._virt_parts(path)
        if v is not None and v[1]:
            return self._virt[v[0]][v[1]]
        inode = self._meta.stat(path, follow=False)
        if inode.type != InodeType.SYMLINK:
            raise FsError(Status(Code.INVALID_ARG, "not a symlink"))
        return inode.symlink_target

    def chmod(self, path: str, mode: int) -> None:
        self._meta.set_attr(path, perm=mode & 0o7777)

    def chown(self, path: str, uid: int, gid: int) -> None:
        kw = {}
        if uid != 0xFFFFFFFF and uid != -1:
            kw["uid"] = uid
        if gid != 0xFFFFFFFF and gid != -1:
            kw["gid"] = gid
        if kw:
            self._meta.set_attr(path, **kw)

    def utimens(self, path: str, atime: Optional[float],
                mtime: Optional[float]) -> None:
        """None leaves the corresponding timestamp untouched (UTIME_OMIT)."""
        self._meta.set_attr(path, atime=atime, mtime=mtime)

    def truncate(self, path: str, length: int) -> None:
        inode = self._meta.truncate(path, length)
        # the truncate's chunk drop ran through the META service's own
        # storage client, not this mount's — drop our readahead windows
        # explicitly or a sequential reader could be served pre-truncate
        # bytes from the prefetch cache
        if hasattr(self._fio, "invalidate_prefetch"):
            self._fio.invalidate_prefetch(inode.id)
        # clamp open handles' high-water marks or close()'s length hint
        # would resurrect the pre-truncate length (MetaStore.close applies
        # max(length, hint))
        with self._lock:
            for f in self._files.values():
                if f.inode.id == inode.id and f.max_written > length:
                    f.max_written = length

    # -- namespace ops -------------------------------------------------------
    def mkdir(self, path: str, mode: int) -> None:
        self._meta.mkdirs(path)
        if mode & 0o7777 != 0o755:
            self._meta.set_attr(path, perm=mode & 0o7777)

    def rmdir(self, path: str) -> None:
        self._meta.remove(path)

    def unlink(self, path: str) -> None:
        v = self._virt_parts(path)
        if v is not None and v[1]:
            self._virt_unregister(*v)
            return
        if hasattr(self._fio, "invalidate_prefetch"):
            # inode id reuse after remove+create must never serve the old
            # file's readahead windows
            try:
                ino = self._meta.stat(path, follow=False)
                self._fio.invalidate_prefetch(ino.id)
            except FsError:
                pass
        self._meta.remove(path)

    def rename(self, src: str, dst: str) -> None:
        self._meta.rename(src, dst)

    def symlink(self, target: str, link_path: str) -> None:
        v = self._virt_parts(link_path)
        if v is not None and v[1]:
            self._virt_register(v[0], v[1], target)
            return
        self._meta.symlink(link_path, target)

    def link(self, src: str, dst: str) -> None:
        self._meta.hard_link(src, dst)

    def readdir(self, path: str) -> List[Tuple[str, Attr]]:
        return self.readdirplus(path)

    def readdirplus(self, path: str) -> List[Tuple[str, Attr]]:
        """List entries WITH full attributes in one pass (one list_dir +
        one batch_stat), priming the attr cache so the per-entry getattr
        storm that follows (ls -l) is served from memory — the property
        the reference gets from fuse_lowlevel readdirplus
        (src/fuse/FuseOps.cc:2580-2613)."""
        v = self._virt_parts(path)
        if v is not None:
            kind, name = v
            if name:
                raise FsError(Status(Code.META_NOT_DIRECTORY, path))
            if not kind:
                return [(d, self._virt_attr(d, "")) for d in _VIRT_SUBDIRS]
            return [(n, self._virt_attr(kind, n)) for n in self._virt[kind]]
        entries = []
        if path in ("/", ""):
            entries.append((VIRT_DIR, self._virt_attr("", "")))
        ents = self._meta.list_dir(path)
        children = self._meta.batch_stat([e.inode_id for e in ents])
        now = time.time()
        if len(self._attr_cache) > 65536:
            # bound memory under read-only crawls (find/backup scans):
            # TTL alone never evicts, and no mutation may ever run
            self._attr_cache.clear()
        base = path.rstrip("/")
        for ent, child in zip(ents, children):
            if child is not None:
                attr = self._attr_of(child)
                entries.append((ent.name, attr))
                self._attr_cache[f"{base}/{ent.name}"] = (now, attr)
        return entries

    # -- extended attributes (ref FuseOps.cc xattr entries, :2580-2613) -----
    def setxattr(self, path: str, name: str, value: bytes,
                 flags: int = 0) -> None:
        self._meta.set_xattr(path, name, value, flags=flags)

    def getxattr(self, path: str, name: str) -> bytes:
        return self._meta.get_xattr(path, name)

    def listxattr(self, path: str) -> List[str]:
        return self._meta.list_xattrs(path)

    def removexattr(self, path: str, name: str) -> None:
        self._meta.remove_xattr(path, name)

    # -- ioctl (ref FuseOps.cc hf3fs ioctls: inode-id/layout queries) --------
    IOC_GET_INODE_ID = 0x80087001   # _IOR('p', 1, u64)

    def ioctl(self, path: str, cmd: int) -> Optional[int]:
        if cmd == self.IOC_GET_INODE_ID:
            return self._meta.stat(path).id
        raise FsError(Status(Code.INVALID_ARG, f"ioctl {cmd:#x}"))

    def statfs(self) -> dict:
        sf = self._meta.stat_fs()
        return {
            "f_bsize": 512 * 1024,
            "f_blocks": max(1, sf.capacity // (512 * 1024)),
            "f_bfree": max(0, (sf.capacity - sf.used) // (512 * 1024)),
            "f_files": sf.files,
        }

    # -- file ops ------------------------------------------------------------
    def create(self, path: str, mode: int) -> int:
        res = self._meta.create(
            path, flags=OpenFlags.READ | OpenFlags.WRITE | OpenFlags.CREATE,
        )
        if mode & 0o7777 != 0o644:
            try:
                self._meta.set_attr(path, perm=mode & 0o7777)
            except FsError:
                pass
        return self._new_fh(res.inode, res.session_id,
                            OpenFlags.READ | OpenFlags.WRITE)

    def open(self, path: str, os_flags: int) -> int:
        accmode = os_flags & os.O_ACCMODE
        flags = OpenFlags.READ
        if accmode in (os.O_WRONLY, os.O_RDWR):
            flags |= OpenFlags.WRITE
        if os_flags & os.O_TRUNC:
            flags |= OpenFlags.TRUNC
        res = self._meta.open(path, flags=flags)
        return self._new_fh(res.inode, res.session_id, flags)

    def _new_fh(self, inode: Inode, session_id: str, flags: int) -> int:
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._files[fh] = OpenFile(inode, session_id, flags)
        return fh

    def _file(self, fh: int) -> OpenFile:
        f = self._files.get(fh)
        if f is None:
            raise FsError(Status(Code.INVALID_ARG, f"bad fh {fh}"))
        return f

    def read(self, fh: int, offset: int, size: int) -> bytes:
        f = self._file(fh)
        # refresh length only when the request crosses the cached EOF —
        # the sole case where a stale length could wrongly clamp; keeps the
        # hot sequential-read path at one storage round trip
        inode = f.inode
        if offset + size > inode.length:
            fresh = self._meta.batch_stat([inode.id])[0]
            if fresh is not None:
                f.inode = inode = fresh
        # meta's length only settles at sync/close; bytes written through
        # this handle may extend past it, so clamp to what we know we wrote
        if f.max_written > inode.length:
            inode = replace(inode, length=f.max_written)
        return self._fio.read(inode, offset, size)

    def write(self, fh: int, offset: int, data: bytes) -> int:
        f = self._file(fh)
        if not (f.flags & OpenFlags.WRITE):
            raise FsError(Status(Code.META_NO_PERMISSION, "read-only fh"))
        n = self._fio.write(f.inode, offset, data)
        end = offset + n
        if end > f.max_written:
            f.max_written = end
        f.dirty = True
        return n

    def fsync(self, fh: int) -> None:
        f = self._file(fh)
        if f.dirty:
            self._meta.sync(f.inode.id, length_hint=f.max_written)
            f.dirty = False

    def flush(self, fh: int) -> None:
        f = self._files.get(fh)
        if f is not None and f.dirty:
            self.fsync(fh)

    def release(self, fh: int) -> None:
        with self._lock:
            f = self._files.pop(fh, None)
        if f is None:
            return
        if f.session_id:
            hint = f.max_written if f.max_written >= 0 else None
            self._meta.close(f.inode.id, f.session_id, length_hint=hint,
                             wrote=f.dirty or f.max_written >= 0)

    # -- 3fs-virt registration (USRBIO handshake) ----------------------------
    def _virt_register(self, kind: str, name: str, target: str) -> None:
        if self._agent is None:
            raise FsError(Status(Code.INVALID_ARG, "no usrbio agent"))
        if kind == "iovs":
            # target = shm name; size read from the shm segment itself
            size = os.stat(os.path.join("/dev/shm", target)).st_size
            iov = self._agent.register_iov(target, size)
            self._virt_iovs[name] = iov
        elif kind == "fds":
            # foreign-process fd registration (hf3fs_reg_fd): target =
            # "<fs-path>?rw=r|w"; the agent assigns a virtual fd and the
            # client reads it back via readlink, which returns the stored
            # target with "&fd=N" appended — a pure symlink handshake, no
            # shared address space needed
            fs_path, _, qs = target.partition("?")
            params = dict(
                kv.split("=", 1) for kv in qs.split("&") if "=" in kv
            )
            rw = params.get("rw", "r")
            fd = self._agent.open(fs_path, write=rw == "w")
            # stored target is NORMALIZED to always carry the query string:
            # a bare-path registration ("somefile", default rw) must still
            # round-trip "?...&fd=N" so deregistration can find the fd
            self._virt[kind][name] = f"{fs_path}?rw={rw}&fd={fd}"
            return
        else:
            # target = "<ring-shm-name>?entries=N&rw=r|w&prio=P&iov=<names,>"
            ring_name, _, qs = target.partition("?")
            params = dict(
                kv.split("=", 1) for kv in qs.split("&") if "=" in kv
            )
            iov_names = [n for n in params.get("iov", "").split(",") if n]
            iovs = [self._virt_iovs[n] for n in iov_names]
            self._agent.register_ring(
                ring_name,
                int(params.get("entries", "64")),
                iovs,
                for_read=params.get("rw", "r") == "r",
                priority=int(params.get("prio", "1")),
            )
        self._virt[kind][name] = target

    def _virt_unregister(self, kind: str, name: str) -> None:
        target = self._virt[kind].pop(name, None)
        if target is None:
            raise FsError(Status(Code.META_NOT_FOUND, f"{kind}/{name}"))
        if self._agent is None:
            return
        if kind == "iors":
            ring_name = target.partition("?")[0]
            self._agent.deregister_ring(ring_name)
        elif kind == "fds":
            params = dict(
                kv.split("=", 1)
                for kv in target.partition("?")[2].split("&") if "=" in kv
            )
            if "fd" in params:
                self._agent.close_fd(int(params["fd"]))
        else:
            iov = self._virt_iovs.pop(name, None)
            if iov is not None:
                iov.close()

    def destroy(self) -> None:
        for fh in list(self._files):
            try:
                self.release(fh)
            except FsError:
                pass
        if self._agent is not None:
            self._agent.stop()
