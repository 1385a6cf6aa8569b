"""Bounded executors, concurrency limiters and periodic runners.

The thread-shaped re-design of the reference's coroutine toolkit
(src/common/utils/CoroutinesPool.h — one bounded queue + N consumers per
pool; src/common/utils/BackgroundRunner.h — named periodic tasks with
jittered intervals; folly Semaphore throttles). Consumers: the storage
client's per-node batch fan-out (WorkerPool), the service apps'
spawn_periodic background tasks (PeriodicRunner via app/application.py),
and the USRBIO agent's host-wide IO throttle (ConcurrencyLimiter).

CPython threads carry the GIL, but every pool consumer here spends its
time in blocking IO (sockets, engine syscalls, KV fsync) where the GIL is
released — the same reason the per-target UpdateWorker queues scale.

The port's own copy of ``tpu3fs/utils/executor.py``. Its consumers here:
the data loader's concurrent fetches (``dataload-fetch``), the file
client's readahead (``prefetch``) and the storage client's per-node
fan-out (``client-<id>``). A job that launches a kernel does so on its
worker thread's current CUDA stream, which is the device's default
stream: a new thread does not inherit the submitter's stream.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Any, Callable, List, Optional

from tpu3fs_torch.utils.result import Code, FsError, Status


class Future:
    """Minimal completion cell: set_result/set_exception once, get() waits."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise FsError(Status(Code.RPC_TIMEOUT, "future timeout"))
        if self._exc is not None:
            raise self._exc
        return self._value


class WorkerPool:
    """N workers draining one bounded FIFO (ref CoroutinesPool.h:24-56).

    submit() applies backpressure: when the queue is full it BLOCKS (the
    reference's bounded channel semantics) unless block=False, which
    raises instead — callers on a latency budget pick their poison.

    Each task runs inside a ``contextvars.copy_context()`` snapshot taken
    at submit time, so context-scoped request state — the QoS ``tagged()``
    traffic class and armed ``fault_injection`` — follows work into the
    pool instead of silently resetting: fanned-out IO stays classified
    and armed fault points keep firing (the reference's coroutine pools
    get this for free from coroutine-local state).
    """

    def __init__(self, name: str, num_workers: int = 4,
                 queue_cap: int = 256):
        assert num_workers >= 1 and queue_cap >= 1
        self.name = name
        self._cap = queue_cap
        self._queue: List = []
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._running = True
        self._workers = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"{name}-{i}")
            for i in range(num_workers)
        ]
        for w in self._workers:
            w.start()

    def submit(self, fn: Callable, *args, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        fut = Future()
        ctx = contextvars.copy_context()
        with self._mu:
            if not self._running:
                raise FsError(Status(Code.SHUTTING_DOWN, self.name))
            if len(self._queue) >= self._cap:
                if not block:
                    raise FsError(Status(
                        Code.CLIENT_BUSY,
                        f"{self.name} queue full ({self._cap})"))
                deadline = None if timeout is None else (
                    time.monotonic() + timeout)
                while len(self._queue) >= self._cap and self._running:
                    left = None if deadline is None else (
                        deadline - time.monotonic())
                    if left is not None and left <= 0:
                        raise FsError(Status(
                            Code.CLIENT_BUSY,
                            f"{self.name} backpressure timeout"))
                    self._not_full.wait(left)
                if not self._running:
                    raise FsError(Status(Code.SHUTTING_DOWN, self.name))
            self._queue.append((ctx, fn, args, fut))
            self._not_empty.notify()
        return fut

    def map(self, fn: Callable, items) -> List[Any]:
        """Submit fn(item) for every item; wait for all; first error wins
        (after every task finished, so partial work is never abandoned
        mid-flight)."""
        futs = [self.submit(fn, item) for item in items]
        out, first_exc = [], None
        for f in futs:
            try:
                out.append(f.get())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
                out.append(None)
        if first_exc is not None:
            raise first_exc
        return out

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def _run(self) -> None:
        while True:
            with self._mu:
                while self._running and not self._queue:
                    self._not_empty.wait()
                if not self._running and not self._queue:
                    return
                ctx, fn, args, fut = self._queue.pop(0)
                self._not_full.notify()
            try:
                fut.set_result(ctx.run(fn, *args))
            except BaseException as e:  # noqa: BLE001 — delivered via Future
                fut.set_exception(e)

    def shutdown(self, wait: bool = True) -> None:
        with self._mu:
            self._running = False
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if wait:
            for w in self._workers:
                w.join(timeout=10)


class ConcurrencyLimiter:
    """Counted gate over an arbitrary section (the folly::Semaphore role
    in the reference's read/write paths): at most `limit` holders; excess
    callers block (bounded) or fail fast."""

    def __init__(self, name: str, limit: int):
        self.name = name
        self._sem = threading.BoundedSemaphore(limit)

    def __enter__(self):
        self._sem.acquire()
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False

    def try_acquire(self, timeout: float = 0.0) -> bool:
        return self._sem.acquire(timeout=timeout)

    def release(self) -> None:
        self._sem.release()


class PeriodicRunner:
    """Named background task on a jittered interval (ref
    BackgroundRunner.h / the mgmtd background runners): start() spawns the
    loop, stop() joins it; errors are swallowed per tick (a failing
    background task must not die silently forever — it logs and retries
    next tick). interval_s may be a float or a zero-arg callable so
    hot-updatable config intervals re-read every tick (the service apps
    pass `lambda: config.get(...)`)."""

    def __init__(self, name: str, interval_s, fn: Callable[[], Any],
                 *, jitter: float = 0.1):
        self.name = name
        self.interval_s = interval_s
        self.fn = fn
        self.jitter = jitter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        assert self._thread is None, f"{self.name} already started"
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"runner-{self.name}")
        self._thread.start()

    def _loop(self) -> None:
        from tpu3fs_torch.utils.logging import xlog

        while not self._stop.is_set():
            # the interval callable is inside the try too: a transient
            # hot-config error must not silently kill the runner thread
            # (a dead mgmtd-tick runner would stop lease extension)
            try:
                base = (self.interval_s() if callable(self.interval_s)
                        else self.interval_s)
                delay = base * (
                    1.0 + random.uniform(-self.jitter, self.jitter))
                if self._stop.wait(max(0.0, delay)):
                    return
                self.fn()
            except Exception as e:  # noqa: BLE001 — retried next tick
                xlog("WARNING", "periodic %s failed: %r", self.name, e)
                if self._stop.wait(1.0):
                    return

    def request_stop(self) -> None:
        """Signal without joining (app shutdown paths that must not block)."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
