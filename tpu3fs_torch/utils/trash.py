"""Trash: delayed deletion with timestamped trash directories + cleaner.

Re-expresses the reference's two-piece trash machinery:
- hf3fs_utils/trash.py:11-18 — user-facing `rm` moves files into per-user
  trash directories whose names encode creation time and keep-duration
  (`{name}-{create}-{keep}`), so deletion is undoable until expiry;
- src/client/trash_cleaner/src/main.rs (Trash::clean :137) — a standalone
  cleaner scans trash directories and permanently removes entries whose
  keep-time has elapsed.

Both run against the MetaStore API only (rename + remove), exactly like the
reference drives them through the mounted filesystem.

The port's own copy of ``tpu3fs/utils/trash.py`` (host code only), for the
checkpoint retention's evictions.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from tpu3fs_torch.meta.store import MetaStore, ROOT_USER, User
from tpu3fs_torch.utils.result import Code, FsError

TRASH_ROOT = "/trash"

_NAME_RE = re.compile(r"^(?P<orig>.+)-(?P<create>\d+)-(?P<keep>\d+)$")


def trash_entry_name(orig_name: str, create_ts: float, keep_s: int) -> str:
    """`{name}-{create}-{keep}` naming (ref hf3fs_utils/trash.py:11-18)."""
    return f"{orig_name}-{int(create_ts)}-{int(keep_s)}"


def parse_trash_entry(name: str) -> Optional[tuple]:
    """Returns (orig_name, create_ts, keep_s) or None if not a trash name."""
    m = _NAME_RE.match(name)
    if m is None:
        return None
    return m.group("orig"), int(m.group("create")), int(m.group("keep"))


@dataclass
class TrashEntry:
    path: str
    orig_name: str
    create_ts: int
    keep_s: int

    @property
    def expire_ts(self) -> int:
        return self.create_ts + self.keep_s


def user_trash_dir(user: User) -> str:
    return f"{TRASH_ROOT}/{user.uid}"


def move_to_trash(
    meta: MetaStore,
    path: str,
    user: User = ROOT_USER,
    *,
    keep_s: int = 3 * 86400,
    clock: Callable[[], float] = time.time,
) -> str:
    """Move `path` into the caller's trash dir; returns the trash path."""
    now = clock()
    tdir = user_trash_dir(user)
    # the shared /trash root must be root-owned and world-writable, or the
    # first user to trash something would own it 0o755 and lock everyone
    # else out of creating their own per-user trash dir
    try:
        meta.mkdirs(TRASH_ROOT, user=ROOT_USER, perm=0o777)
    except FsError as e:
        if e.code != Code.META_EXISTS:
            raise
    try:
        meta.mkdirs(tdir, user=user)
    except FsError as e:
        if e.code != Code.META_EXISTS:
            raise
    name = path.rstrip("/").rsplit("/", 1)[-1]
    # rename overwrites an existing destination, which would permanently
    # destroy a same-named entry trashed in the same second — uniquify first
    base = name
    for n in range(1_000_000):
        dest = f"{tdir}/{trash_entry_name(base, now, keep_s)}"
        try:
            meta.stat(dest, user=user, follow=False)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                break
            raise
        base = f"{name}.{n + 1}"
    meta.rename(path, dest, user=user)
    return dest


def list_trash(meta: MetaStore, user: User = ROOT_USER) -> List[TrashEntry]:
    tdir = user_trash_dir(user)
    try:
        ents = meta.list_dir(tdir, user=user)
    except FsError as e:
        if e.code == Code.META_NOT_FOUND:
            return []
        raise
    out = []
    for ent in ents:
        parsed = parse_trash_entry(ent.name)
        if parsed is None:
            continue
        orig, create_ts, keep_s = parsed
        out.append(TrashEntry(f"{tdir}/{ent.name}", orig, create_ts, keep_s))
    return out


def restore_from_trash(
    meta: MetaStore, trash_path: str, dest: str, user: User = ROOT_USER
) -> None:
    meta.rename(trash_path, dest, user=user)


class TrashCleaner:
    """Scans every user's trash dir, purging expired entries
    (ref src/client/trash_cleaner/src/main.rs Trash::clean)."""

    def __init__(self, meta: MetaStore, *, clock: Callable[[], float] = time.time):
        self._meta = meta
        self._clock = clock

    def clean_once(self) -> int:
        now = self._clock()
        removed = 0
        try:
            user_dirs = self._meta.list_dir(TRASH_ROOT)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                return 0
            raise
        for udir in user_dirs:
            base = f"{TRASH_ROOT}/{udir.name}"
            for ent in self._meta.list_dir(base):
                parsed = parse_trash_entry(ent.name)
                if parsed is None:
                    continue
                _, create_ts, keep_s = parsed
                if create_ts + keep_s <= now:
                    self._meta.remove(f"{base}/{ent.name}", recursive=True)
                    removed += 1
        return removed
