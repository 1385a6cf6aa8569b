"""Logging: XLOG-style leveled logging with an async rotating file writer.

Re-expresses src/common/logging (folly XLOG with custom file writers,
rotation, async queue): a single background writer thread drains a bounded
queue to the target file, rotating at max_bytes into ``.1 .. .N`` suffixes.
``xlog("DFATAL", ...)`` mirrors the reference's invariant style: it logs and
raises in tests (or aborts the process when TPU3FS_DFATAL_ABORT is set),
instead of silently continuing past a broken invariant.

The port's own copy of ``tpu3fs/utils/logging.py``.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Optional

LEVELS = {"DBG": 0, "INFO": 1, "WARN": 2, "ERR": 3, "CRITICAL": 4, "DFATAL": 4}


class DFatalError(AssertionError):
    """Raised by xlog("DFATAL", ...) — a broken invariant."""


class AsyncFileWriter:
    """Bounded-queue async writer with size-based rotation
    (ref AsyncFileWriter + file rotation in src/common/logging)."""

    def __init__(self, path: str, *, max_bytes: int = 64 << 20,
                 max_files: int = 4, queue_size: int = 8192):
        self.path = path
        self.max_bytes = max_bytes
        self.max_files = max_files
        self._q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=queue_size)
        self.dropped = 0  # lines dropped when the queue is full
        self._f = open(path, "a", buffering=1)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="log-writer")
        self._thread.start()

    def write(self, line: str) -> None:
        try:
            self._q.put_nowait(line)
        except queue.Full:
            self.dropped += 1

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            dst = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        self._f = open(self.path, "a", buffering=1)

    def _loop(self) -> None:
        while True:
            line = self._q.get()
            if line is None:
                return
            try:
                self._f.write(line + "\n")
                if self._f.tell() >= self.max_bytes:
                    self._rotate()
            except (OSError, ValueError):
                pass

    def flush(self) -> None:
        """Drain pending lines (best effort) and fsync."""
        deadline = time.time() + 2.0
        while not self._q.empty() and time.time() < deadline:
            time.sleep(0.005)
        try:
            self._f.flush()
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join(timeout=2.0)
        try:
            self._f.close()
        except OSError:
            pass


class _LogState:
    level = LEVELS["INFO"]
    writer: Optional[AsyncFileWriter] = None
    to_stderr = False
    lock = threading.Lock()


_state = _LogState()


def init_logging(path: Optional[str] = None, level: str = "INFO",
                 *, stderr: bool = False, max_bytes: int = 64 << 20,
                 max_files: int = 4) -> None:
    with _state.lock:
        _state.level = LEVELS.get(level.upper(), LEVELS["INFO"])
        _state.to_stderr = stderr
        if _state.writer is not None:
            _state.writer.close()
            _state.writer = None
        if path:
            _state.writer = AsyncFileWriter(path, max_bytes=max_bytes,
                                            max_files=max_files)


def shutdown_logging() -> None:
    with _state.lock:
        if _state.writer is not None:
            _state.writer.close()
            _state.writer = None


def xlog(level: str, fmt: str, *args) -> None:
    """XLOGF-style: xlog("INFO", "node %d up", 3). DFATAL logs then raises
    (ref XLOGF(DFATAL, ...) invariant checks)."""
    lvl = LEVELS.get(level.upper(), LEVELS["INFO"])
    msg = (fmt % args) if args else fmt
    if lvl >= _state.level:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        line = f"{ts} [{level.upper():5s}] {threading.current_thread().name}: {msg}"
        if _state.writer is not None:
            _state.writer.write(line)
        if _state.to_stderr or (_state.writer is None and lvl >= LEVELS["WARN"]):
            print(line, file=sys.stderr)
    if level.upper() == "DFATAL":
        if os.environ.get("TPU3FS_DFATAL_ABORT"):
            os.abort()
        raise DFatalError(msg)
