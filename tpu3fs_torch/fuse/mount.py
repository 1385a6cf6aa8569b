"""ctypes binding to libfuse.so.2: mounts a FuseOps table as a real kernel
filesystem.

The reference links libfuse and registers fuse_lowlevel_ops
(src/fuse/FuseOps.cc:2580-2613); here the high-level (path-based) libfuse
API carries the same operation set into FuseOps. Struct layouts are the
x86-64 glibc/fuse-2.9 ABI; ``fuse_main_real`` receives sizeof(our struct)
so trailing operations we don't implement are simply absent.

The port's own copy of ``tpu3fs/fuse/mount.py``. One difference: the
mount asks for ``big_writes``, so a write reaches ``FuseOps.write`` in
pieces of up to 128 KiB instead of 4 KiB (each piece of an EC file is a
parity read-modify-write). A host without ``libfuse.so.2`` raises
``OSError`` at construction; there is no substitute mount. ``unmount``
detaches with ``umount2(MNT_DETACH)`` where the host has no
``fusermount`` (the JAX package's runs ``fusermount`` only).
"""

from __future__ import annotations

import ctypes
import errno
import os
import subprocess
import threading
from ctypes import (
    CFUNCTYPE,
    POINTER,
    Structure,
    c_byte,
    c_char_p,
    c_int,
    c_long,
    c_size_t,
    c_uint,
    c_uint64,
    c_ulong,
    c_void_p,
    cast,
    memset,
    pointer,
    sizeof,
)
from typing import List, Optional

from tpu3fs_torch.fuse.ops import FuseOps, fs_errno
from tpu3fs_torch.utils.result import FsError

c_mode_t = c_uint
c_uid_t = c_uint
c_gid_t = c_uint
c_dev_t = c_uint64
c_off_t = c_long
c_fsblkcnt_t = c_ulong
c_fsfilcnt_t = c_ulong

UTIME_NOW = (1 << 30) - 1
UTIME_OMIT = (1 << 30) - 2


class c_timespec(Structure):
    _fields_ = [("tv_sec", c_long), ("tv_nsec", c_long)]


class c_stat(Structure):  # x86-64 glibc layout
    _fields_ = [
        ("st_dev", c_dev_t),
        ("st_ino", c_uint64),
        ("st_nlink", c_ulong),
        ("st_mode", c_mode_t),
        ("st_uid", c_uid_t),
        ("st_gid", c_gid_t),
        ("__pad0", c_int),
        ("st_rdev", c_dev_t),
        ("st_size", c_off_t),
        ("st_blksize", c_long),
        ("st_blocks", c_long),
        ("st_atim", c_timespec),
        ("st_mtim", c_timespec),
        ("st_ctim", c_timespec),
        ("__glibc_reserved", c_long * 3),
    ]


class c_statvfs(Structure):
    _fields_ = [
        ("f_bsize", c_ulong),
        ("f_frsize", c_ulong),
        ("f_blocks", c_fsblkcnt_t),
        ("f_bfree", c_fsblkcnt_t),
        ("f_bavail", c_fsblkcnt_t),
        ("f_files", c_fsfilcnt_t),
        ("f_ffree", c_fsfilcnt_t),
        ("f_favail", c_fsfilcnt_t),
        ("f_fsid", c_ulong),
        ("f_flag", c_ulong),
        ("f_namemax", c_ulong),
        ("__f_spare", c_int * 6),
    ]


class fuse_file_info(Structure):  # fuse 2.9
    _fields_ = [
        ("flags", c_int),
        ("fh_old", c_ulong),
        ("writepage", c_int),
        ("fuse_flags", c_uint),  # direct_io/keep_cache/... bitfield block
        ("fh", c_uint64),
        ("lock_owner", c_uint64),
    ]


fuse_fill_dir_t = CFUNCTYPE(c_int, c_void_p, c_char_p, POINTER(c_stat), c_off_t)

_OP = {
    "getattr": CFUNCTYPE(c_int, c_char_p, POINTER(c_stat)),
    "readlink": CFUNCTYPE(c_int, c_char_p, POINTER(c_byte), c_size_t),
    "getdir": c_void_p,
    "mknod": CFUNCTYPE(c_int, c_char_p, c_mode_t, c_dev_t),
    "mkdir": CFUNCTYPE(c_int, c_char_p, c_mode_t),
    "unlink": CFUNCTYPE(c_int, c_char_p),
    "rmdir": CFUNCTYPE(c_int, c_char_p),
    "symlink": CFUNCTYPE(c_int, c_char_p, c_char_p),
    "rename": CFUNCTYPE(c_int, c_char_p, c_char_p),
    "link": CFUNCTYPE(c_int, c_char_p, c_char_p),
    "chmod": CFUNCTYPE(c_int, c_char_p, c_mode_t),
    "chown": CFUNCTYPE(c_int, c_char_p, c_uid_t, c_gid_t),
    "truncate": CFUNCTYPE(c_int, c_char_p, c_off_t),
    "utime": c_void_p,
    "open": CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info)),
    "read": CFUNCTYPE(c_int, c_char_p, POINTER(c_byte), c_size_t, c_off_t,
                      POINTER(fuse_file_info)),
    "write": CFUNCTYPE(c_int, c_char_p, POINTER(c_byte), c_size_t, c_off_t,
                       POINTER(fuse_file_info)),
    "statfs": CFUNCTYPE(c_int, c_char_p, POINTER(c_statvfs)),
    "flush": CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info)),
    "release": CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info)),
    "fsync": CFUNCTYPE(c_int, c_char_p, c_int, POINTER(fuse_file_info)),
    "setxattr": CFUNCTYPE(c_int, c_char_p, c_char_p, POINTER(c_byte),
                          c_size_t, c_int),
    "getxattr": CFUNCTYPE(c_int, c_char_p, c_char_p, POINTER(c_byte),
                          c_size_t),
    "listxattr": CFUNCTYPE(c_int, c_char_p, POINTER(c_byte), c_size_t),
    "removexattr": CFUNCTYPE(c_int, c_char_p, c_char_p),
    "opendir": CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info)),
    "readdir": CFUNCTYPE(c_int, c_char_p, c_void_p, fuse_fill_dir_t, c_off_t,
                         POINTER(fuse_file_info)),
    "releasedir": CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info)),
    "fsyncdir": c_void_p,
    "init": CFUNCTYPE(c_void_p, c_void_p),
    "destroy": CFUNCTYPE(None, c_void_p),
    "access": CFUNCTYPE(c_int, c_char_p, c_int),
    "create": CFUNCTYPE(c_int, c_char_p, c_mode_t, POINTER(fuse_file_info)),
    "ftruncate": CFUNCTYPE(c_int, c_char_p, c_off_t, POINTER(fuse_file_info)),
    "fgetattr": CFUNCTYPE(c_int, c_char_p, POINTER(c_stat),
                          POINTER(fuse_file_info)),
    "lock": c_void_p,
    "utimens": CFUNCTYPE(c_int, c_char_p, POINTER(c_timespec)),
    "bmap": c_void_p,
    # bit 0 flag_nullpath_ok, bit 1 flag_nopath, bit 2 flag_utime_omit_ok:
    # without utime_omit_ok libfuse2 silently drops partial (touch -m/-a)
    # time updates — it only calls utimens when both FATTR_ATIME|FATTR_MTIME
    # are present
    "flags_": c_uint,
    # libfuse 2.9 tail (order matters: fuse_main copies min(op_size, ...)):
    "ioctl": CFUNCTYPE(c_int, c_char_p, c_int, c_void_p,
                       POINTER(fuse_file_info), c_uint, c_void_p),
    "poll": c_void_p,
    "write_buf": c_void_p,
    "read_buf": c_void_p,
    "flock": c_void_p,
    "fallocate": c_void_p,
}

FLAG_UTIME_OMIT_OK = 1 << 2


class fuse_operations(Structure):
    _fields_ = [(name, typ) for name, typ in _OP.items()]


def _fill_stat(st: "POINTER(c_stat)", attr) -> None:
    memset(st, 0, sizeof(c_stat))
    s = st.contents
    s.st_ino = attr.ino
    s.st_mode = attr.mode
    s.st_nlink = attr.nlink
    s.st_uid = attr.uid
    s.st_gid = attr.gid
    s.st_size = attr.size
    s.st_blksize = attr.blksize
    s.st_blocks = (attr.size + 511) // 512
    for field, t in (("st_atim", attr.atime), ("st_mtim", attr.mtime),
                     ("st_ctim", attr.ctime)):
        ts = getattr(s, field)
        ts.tv_sec = int(t)
        ts.tv_nsec = int((t - int(t)) * 1e9)


class FuseMount:
    """Mount a FuseOps table; runs libfuse's loop on a thread."""

    def __init__(self, ops: FuseOps, mountpoint: str,
                 *, fsname: str = "tpu3fs", debug: bool = False,
                 allow_other: bool = False):
        self.ops = ops
        self.mountpoint = os.path.abspath(mountpoint)
        self._lib = ctypes.CDLL("libfuse.so.2", use_errno=True)
        self._fsname = fsname
        self._debug = debug
        self._allow_other = allow_other
        self._thread: Optional[threading.Thread] = None
        self._keep = []  # keep callback closures alive
        self._struct = self._build_operations()
        self.exit_code: Optional[int] = None

    # -- callback plumbing ---------------------------------------------------
    def _wrap(self, fn):
        def call(*args):
            try:
                return fn(*args) or 0
            except FsError as e:
                return -fs_errno(e)
            except OSError as e:
                return -(e.errno or errno.EIO)
            except Exception:
                return -errno.EIO
        return call

    def _build_operations(self) -> fuse_operations:
        o = self.ops
        p = os.fsdecode

        def getattr_(path, st):
            _fill_stat(st, o.getattr(p(path)))

        def fgetattr(path, st, fi):
            _fill_stat(st, o.getattr(p(path)))

        def readlink(path, buf, size):
            if size <= 0:
                return -errno.EINVAL
            data = o.readlink(p(path)).encode()[: size - 1] + b"\0"
            ctypes.memmove(buf, data, len(data))

        def mknod(path, mode, dev):
            import stat as stat_mod

            if not stat_mod.S_ISREG(mode):
                return -errno.EPERM  # no FIFOs/sockets/device nodes
            fh = o.create(p(path), mode)
            o.release(fh)

        def mkdir(path, mode):
            o.mkdir(p(path), mode)

        def unlink(path):
            o.unlink(p(path))

        def rmdir(path):
            o.rmdir(p(path))

        def symlink(target, link_path):
            o.symlink(p(target), p(link_path))

        def rename(src, dst):
            o.rename(p(src), p(dst))

        def link(src, dst):
            o.link(p(src), p(dst))

        def chmod(path, mode):
            o.chmod(p(path), mode)

        def chown(path, uid, gid):
            o.chown(p(path), uid, gid)

        def truncate(path, length):
            o.truncate(p(path), length)

        def ftruncate(path, length, fi):
            o.truncate(p(path), length)

        def open_(path, fi):
            fi.contents.fh = o.open(p(path), fi.contents.flags)

        def create(path, mode, fi):
            fi.contents.fh = o.create(p(path), mode)

        def read(path, buf, size, off, fi):
            data = o.read(fi.contents.fh, off, size)
            ctypes.memmove(buf, data, len(data))
            return len(data)

        def write(path, buf, size, off, fi):
            data = ctypes.string_at(buf, size)
            return o.write(fi.contents.fh, off, data)

        def statfs(path, sv):
            memset(sv, 0, sizeof(c_statvfs))
            info = o.statfs()
            s = sv.contents
            s.f_bsize = s.f_frsize = info["f_bsize"]
            s.f_blocks = info["f_blocks"]
            s.f_bfree = s.f_bavail = info["f_bfree"]
            s.f_files = info["f_files"]
            s.f_namemax = 255

        def flush(path, fi):
            o.flush(fi.contents.fh)

        def release(path, fi):
            o.release(fi.contents.fh)

        def fsync(path, datasync, fi):
            o.fsync(fi.contents.fh)

        def opendir(path, fi):
            return 0

        def readdir(path, buf, filler, off, fi):
            st = c_stat()
            for name in (".", ".."):
                filler(buf, name.encode(), None, 0)
            # readdirplus form: full attrs come back with the entries (and
            # prime FuseOps' attr cache for the getattr storm that follows)
            for name, attr in o.readdirplus(p(path)):
                _fill_stat(pointer(st), attr)
                filler(buf, name.encode(), pointer(st), 0)

        def releasedir(path, fi):
            return 0

        def access(path, mode):
            o.getattr(p(path))  # existence check; perms enforced by meta

        def utimens(path, tv):
            import time as _t

            now = _t.time()
            times = []
            if tv:
                for i in range(2):
                    spec = tv[i]
                    if spec.tv_nsec == UTIME_OMIT:
                        times.append(None)  # leave unchanged
                    elif spec.tv_nsec == UTIME_NOW:
                        times.append(now)
                    else:
                        times.append(spec.tv_sec + spec.tv_nsec / 1e9)
            else:
                times = [now, now]
            o.utimens(p(path), times[0], times[1])

        def destroy(_):
            o.destroy()

        def setxattr(path, name, value, size, flags):
            raw = ctypes.string_at(value, size) if size else b""
            o.setxattr(p(path), name.decode(), raw, flags)

        def getxattr(path, name, value, size):
            raw = o.getxattr(p(path), name.decode())
            if size == 0:
                return len(raw)          # size probe
            if size < len(raw):
                return -errno.ERANGE
            ctypes.memmove(value, raw, len(raw))
            return len(raw)

        def listxattr(path, buf, size):
            blob = b"".join(n.encode() + b"\0" for n in o.listxattr(p(path)))
            if size == 0:
                return len(blob)
            if size < len(blob):
                return -errno.ERANGE
            if blob:
                ctypes.memmove(buf, blob, len(blob))
            return len(blob)

        def removexattr(path, name):
            o.removexattr(p(path), name.decode())

        def ioctl(path, cmd, arg, fi, flags, data):
            out = o.ioctl(p(path), cmd & 0xFFFFFFFF)
            if out is not None and data:
                ctypes.memmove(data, int(out).to_bytes(8, "little"), 8)

        impls = dict(
            getattr=getattr_, fgetattr=fgetattr, readlink=readlink,
            mknod=mknod, mkdir=mkdir, unlink=unlink, rmdir=rmdir,
            symlink=symlink, rename=rename, link=link, chmod=chmod,
            chown=chown, truncate=truncate, ftruncate=ftruncate,
            open=open_, create=create, read=read, write=write,
            statfs=statfs, flush=flush, release=release, fsync=fsync,
            opendir=opendir, readdir=readdir, releasedir=releasedir,
            access=access, utimens=utimens, destroy=destroy,
            setxattr=setxattr, getxattr=getxattr, listxattr=listxattr,
            removexattr=removexattr, ioctl=ioctl,
        )
        st = fuse_operations()
        for name, fn in impls.items():
            typ = _OP[name]
            cb = typ(self._wrap(fn)) if name != "destroy" else typ(fn)
            self._keep.append(cb)
            setattr(st, name, cb)
        st.flags_ = FLAG_UTIME_OMIT_OK
        return st

    # -- mount lifecycle -----------------------------------------------------
    def mount(self) -> None:
        os.makedirs(self.mountpoint, exist_ok=True)
        # big_writes: the kernel sends a write(2) on in requests of up to
        # 128 KiB (libfuse 2.9's max_write), not one page each; on an EC
        # file every request is a read-modify-write of its stripe's parity
        opts = f"fsname={self._fsname},big_writes"
        if self._allow_other:
            # needs user_allow_other in /etc/fuse.conf for non-root mounts
            opts += ",allow_other"
        args: List[bytes] = [b"tpu3fs", self.mountpoint.encode(), b"-f",
                             b"-s", b"-o", opts.encode()]
        if self._debug:
            args.append(b"-d")
        argv = (c_char_p * len(args))(*args)

        def run():
            self.exit_code = self._lib.fuse_main_real(
                len(args), argv, pointer(self._struct),
                sizeof(self._struct), None,
            )

        self._thread = threading.Thread(target=run, name="fuse-loop",
                                        daemon=True)
        self._thread.start()

    def wait_mounted(self, timeout: float = 10.0) -> bool:
        import time as _t

        deadline = _t.time() + timeout
        while _t.time() < deadline:
            if self._thread is not None and not self._thread.is_alive():
                return False  # fuse_main failed fast
            with open("/proc/mounts") as f:
                if any(self.mountpoint in line and self._fsname in line
                       for line in f):
                    return True
            _t.sleep(0.05)
        return False

    def unmount(self, timeout: float = 10.0) -> None:
        lazy_unmount(self.mountpoint)
        if self._thread is not None:
            self._thread.join(timeout=timeout)


MNT_DETACH = 2


def lazy_unmount(mountpoint: str) -> None:
    """Detach the mount at ``mountpoint`` now, its open files released as
    they close: ``fusermount -u -z`` where the host has it, else, as root,
    ``umount2(MNT_DETACH)``. Nothing happens where nothing is mounted."""
    import shutil

    if shutil.which("fusermount"):
        subprocess.run(["fusermount", "-u", "-z", mountpoint],
                       check=False, capture_output=True, timeout=60)
        return
    libc = ctypes.CDLL(None, use_errno=True)
    libc.umount2(os.fsencode(mountpoint), MNT_DETACH)
