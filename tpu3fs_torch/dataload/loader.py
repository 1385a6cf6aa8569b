"""Pipelined training-batch loader: coalesced reads, device hand-off,
bounded prefetch, resumable cursor.

Per step the loader maps the global batch's permuted sample ids to record
extents, COALESCES them into large sorted spans per file (recordio.
plan_coalesced) and fetches all spans as ONE ``batch_read_files`` call —
which node-groups, pipelines and stripes the chunk reads underneath.
Records are sliced back out of the spans as views, CRC-verified, and
assembled into the batch array in a single copy; with a mesh the batch
lands as a global DTensor sharded over the ``dp`` axis.

A producer thread keeps ``depth`` batches decoded ahead of the training
loop, under BOUNDED-BYTE backpressure (``max_buffered_bytes``): the
pipeline absorbs storage jitter without ever holding more than the
configured budget of host memory, however large the records.

All IO runs under the ``dataload`` QoS class — foreground-weighted but
share-bounded (qos/core.py) — and an ``OVERLOADED`` shed that survives
the storage client's retry ladder pauses the producer for the server's
retry-after hint (self-throttling like the ckpt saver, never failing the
epoch). Recorders: ``dataload.batch_ms`` (fetch+assembly wall),
``dataload.stall_ms`` (time the consumer waited — the number training
actually feels), ``dataload.bytes``, ``dataload.crc_err``,
``dataload.batches``.

The iterator position is four integers (see state.py); ``state()``
snapshots the cursor AFTER the last consumed batch, so a restore neither
repeats nor skips a sample even with batches in flight.

The port's own copy of ``tpu3fs/dataload/loader.py``. With a
``DeviceMesh`` (one process is one rank) a batch lands as a DTensor of
shape (global_batch, *sample_shape), ``Shard(0)`` on the ``dp`` axis and
``Replicate`` on the others, built from this rank's microbatch copied to
its device. Concurrent fetch workers (``workers`` > 1) need
``utils/executor.py``, which the port has not taken yet: they raise.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpu3fs_torch.dataload.dataset import PackedDataset, dp_info
from tpu3fs_torch.dataload.state import DataloadState
from tpu3fs_torch.monitor.recorder import (
    CounterRecorder,
    DistributionRecorder,
    ValueRecorder,
)
from tpu3fs_torch.qos.core import TrafficClass, retry_after_ms_of, tagged
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err


@dataclass
class LoaderConfig:
    global_batch: int = 32
    seed: int = 0
    shuffle: bool = True
    # batches outstanding ahead of the consumer — delivered-but-unread
    # plus in flight (>=1); 1 = classic double buffering (fetch K+1
    # while training consumes K)
    depth: int = 2
    # fetch threads: up to min(workers, depth) batches fetch
    # CONCURRENTLY (delivery stays in order) — batch K+1's round trips
    # overlap K's. Default 1: on a single-host python transport the GIL
    # serializes the per-request work and extra threads only contend
    # (measured in dataload_bench); raise it when fetches are genuinely
    # wait-bound (many storage nodes, native transport)
    workers: int = 1
    max_buffered_bytes: int = 256 << 20
    verify_crc: bool = True
    # merge sorted record extents when the gap is below this: 64 KiB
    # measured best on the served read path (dataload_bench sweep —
    # over-read costs wire bytes faster than spans cost round trips
    # beyond that). <= 0 = ADAPTIVE: a GapController (autotune.py)
    # learns the gap online from observed dataload.batch_ms
    coalesce_gap: int = 64 << 10
    max_span_bytes: int = 8 << 20
    # fixed-size sample decode: "" leaves records as raw bytes views
    dtype: str = ""
    sample_shape: Tuple[int, ...] = ()
    # stop after this many epochs (None = run forever)
    epochs: Optional[int] = None
    max_overload_waits: int = 64
    # per-sample transform between fetch and assembly/device hand-off
    # (decode/augment: bytes-or-view in, bytes or ndarray out; with
    # dtype/sample_shape set, the result must still be `want` bytes or a
    # sample_shape-compatible array). Runs on the producer/fetch threads,
    # overlapped with training like the IO it follows. MUST be a pure
    # per-record function: the resume contract replays samples through it
    # again, so a stateful transform would break resume exactness.
    transform: Optional[Callable] = None
    # invoked on the producer as each epoch STARTS fetching (including
    # the resume epoch) — curriculum schedules flip transforms or
    # difficulty knobs here. Fires once per (loader, epoch); raising
    # fails the loader like a fetch error.
    epoch_callback: Optional[Callable[[int], None]] = None
    # owning tenant (tpu3fs/tenant): loader fetch IO runs under this
    # tenant scope so the envelope carries it, per-tenant quotas charge
    # it and the tenant.* recorders attribute it — a training job is a
    # tenant like any inference client. "" = untenanted (legacy).
    tenant: str = ""


def _rec_nbytes(rec) -> int:
    """Payload bytes of a record in either shape a transform may hand
    back (bytes/memoryview or ndarray)."""
    return rec.nbytes if hasattr(rec, "nbytes") else len(rec)


@dataclass
class Batch:
    epoch: int
    step: int
    ids: List[int]                 # global sample ids, row-major
    data: object                   # np.ndarray | DTensor | list of views
    nbytes: int = 0
    # dp rows this process fetched (mesh mode; [rank] otherwise)
    rows: List[int] = field(default_factory=list)


class DataLoader:
    """Iterator over dp-sharded, pipelined training batches.

    Two deployment shapes:

    - ``mesh=``: the loader serves this rank's dp replica row of a
      ``DeviceMesh`` and yields global DTensor batches sharded
      ``Shard(0)`` over its ``dp`` axis (requires ``dtype``/``sample_shape``).
    - ``dp_rank``/``dp_size``: one process = one replica; yields that
      replica's microbatch as a host array (or raw record views when no
      ``dtype`` is configured).
    """

    def __init__(self, dataset: PackedDataset,
                 config: Optional[LoaderConfig] = None, *,
                 mesh=None, dp_axis: str = "dp",
                 dp_rank: int = 0, dp_size: int = 1,
                 state: Optional[DataloadState] = None):
        self._ds = dataset
        self.config = config or LoaderConfig()
        cfg = self.config
        if cfg.global_batch <= 0:
            raise _err(Code.INVALID_ARG, "global_batch must be positive")
        if min(cfg.workers, max(1, cfg.depth)) > 1:
            raise NotImplementedError(
                "concurrent fetch workers need utils/executor.py, which the "
                "port has not taken yet (ROADMAP M6a); pass workers=1")
        self._mesh = mesh
        self._dp_axis = dp_axis
        if mesh is not None:
            if not cfg.dtype or not cfg.sample_shape:
                raise _err(Code.INVALID_ARG,
                           "mesh mode needs dtype + sample_shape "
                           "(device arrays are typed)")
            self._dp_size, rows = dp_info(mesh, dp_axis)
            self._rows = dict(sorted(rows.items()))
        else:
            if not 0 <= dp_rank < max(1, dp_size):
                raise _err(Code.INVALID_ARG,
                           f"dp_rank {dp_rank} outside dp_size {dp_size}")
            self._dp_size = max(1, dp_size)
            self._rows = {dp_rank: []}
        if cfg.global_batch % self._dp_size != 0:
            raise _err(Code.INVALID_ARG,
                       f"global_batch {cfg.global_batch} not divisible "
                       f"by dp_size {self._dp_size}")
        if dataset.steps_per_epoch(cfg.global_batch) == 0:
            raise _err(Code.INVALID_ARG,
                       f"global_batch {cfg.global_batch} exceeds dataset "
                       f"({dataset.num_samples} samples)")
        if state is not None:
            self._check_state(state)
            self._epoch, self._step = state.epoch, state.step
            # mid-epoch cursors past a shrunken epoch roll forward
            steps = dataset.steps_per_epoch(cfg.global_batch)
            if self._step >= steps:
                self._epoch, self._step = self._epoch + 1, 0
        else:
            self._epoch, self._step = 0, 0

        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._buf: List[Batch] = []
        self._buffered_bytes = 0
        self._error: Optional[BaseException] = None
        self._finished = False
        self._stop = threading.Event()
        self._batch_ms = DistributionRecorder("dataload.batch_ms")
        self._stall_ms = DistributionRecorder("dataload.stall_ms")
        self._bytes = CounterRecorder("dataload.bytes")
        self._crc_err = CounterRecorder("dataload.crc_err")
        self._batches = CounterRecorder("dataload.batches")
        # memory observability: decoded-ahead bytes (bounded by
        # max_buffered_bytes — the stalled-consumer tests assert it)
        self._buffered_gauge = ValueRecorder("dataload.buffered_bytes")
        # adaptive coalesce gap (cfg.coalesce_gap <= 0): learned online
        # from the batch_ms signal (dataload/autotune.py)
        self.gap_controller = None
        if cfg.coalesce_gap <= 0:
            from tpu3fs_torch.dataload.autotune import GapController

            self.gap_controller = GapController()
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="dataload-producer")
        self._thread.start()

    # -- state ------------------------------------------------------------
    def _check_state(self, st: DataloadState) -> None:
        cfg = self.config
        problems = []
        if st.global_batch != cfg.global_batch:
            problems.append(f"global_batch {st.global_batch} != "
                            f"{cfg.global_batch}")
        if st.num_samples != self._ds.num_samples:
            problems.append(f"num_samples {st.num_samples} != "
                            f"{self._ds.num_samples}")
        if st.seed != cfg.seed or st.shuffle != cfg.shuffle:
            problems.append("seed/shuffle differ from the saved epoch "
                            "order")
        if problems:
            # a mismatched domain would silently repeat/lose samples —
            # exactly what resumable state exists to prevent
            raise _err(Code.DATALOAD_STATE_MISMATCH, "; ".join(problems))

    def state(self) -> DataloadState:
        """Cursor AFTER the last batch ``__next__`` returned (prefetched
        but unconsumed batches are NOT counted — they will be refetched
        on resume, never skipped)."""
        with self._mu:
            return DataloadState(
                seed=self.config.seed, epoch=self._epoch, step=self._step,
                global_batch=self.config.global_batch,
                num_samples=self._ds.num_samples,
                shuffle=self.config.shuffle)

    def buffered_bytes(self) -> int:
        with self._mu:
            return self._buffered_bytes

    # -- iteration --------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        t0 = time.perf_counter()
        with self._cond:
            while not self._buf and self._error is None \
                    and not self._finished:
                self._cond.wait(0.5)
            if self._buf:
                batch = self._buf.pop(0)
                self._buffered_bytes -= batch.nbytes
                self._buffered_gauge.set(self._buffered_bytes)
                # consumed-cursor advance (the state() contract)
                steps = self._ds.steps_per_epoch(self.config.global_batch)
                self._epoch, self._step = (
                    (batch.epoch + 1, 0) if batch.step + 1 >= steps
                    else (batch.epoch, batch.step + 1))
                self._cond.notify_all()
            elif self._error is not None:
                raise self._error
            else:
                raise StopIteration
        self._stall_ms.record((time.perf_counter() - t0) * 1e3)
        return batch

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- producer ---------------------------------------------------------
    def _positions(self):
        cfg = self.config
        steps = self._ds.steps_per_epoch(cfg.global_batch)
        epoch, step = self._epoch, self._step
        while cfg.epochs is None or epoch < cfg.epochs:
            if cfg.epoch_callback is not None:
                # epoch boundary (incl. the resume epoch): no fetch of
                # THIS epoch has started yet (with depth>1, tail fetches
                # of the previous epoch may still be in flight)
                cfg.epoch_callback(epoch)
            perm = self._ds.permutation(cfg.seed, epoch,
                                        shuffle=cfg.shuffle)
            while step < steps:
                yield perm, epoch, step
                step += 1
            epoch, step = epoch + 1, 0

    def _produce(self) -> None:
        """Fetch window: keep up to ``depth`` batches outstanding
        (delivered + in flight), fetching one at a time; DELIVERY stays
        strictly in step order, so the consumer (and the resume cursor)
        never see reordering."""
        cfg = self.config
        try:
            gen = self._positions()
            pending: List[tuple] = []  # positions to fetch
            exhausted = False
            while not self._stop.is_set():
                while not exhausted and len(pending) < max(1, cfg.depth) \
                        and self.buffered_bytes() \
                        < cfg.max_buffered_bytes:
                    pos = next(gen, None)
                    if pos is None:
                        exhausted = True
                        break
                    pending.append(pos)
                    break  # fetch-push one at a time
                if not pending:
                    break
                if not self._push(self._fetch(*pending.pop(0))):
                    return
        except BaseException as e:  # delivered on the consumer's next()
            with self._cond:
                self._error = e
                self._cond.notify_all()
        else:
            with self._cond:
                self._finished = True
                self._cond.notify_all()

    def _push(self, batch: Batch) -> bool:
        """Bounded hand-off: at most ``depth`` batches AND (beyond the
        mandatory one) ``max_buffered_bytes`` decoded ahead."""
        cfg = self.config
        depth = max(1, cfg.depth)
        with self._cond:
            while not self._stop.is_set() and self._buf and (
                    len(self._buf) >= depth
                    or self._buffered_bytes + batch.nbytes
                    > cfg.max_buffered_bytes):
                self._cond.wait(0.5)
            if self._stop.is_set():
                return False
            self._buf.append(batch)
            self._buffered_bytes += batch.nbytes
            self._buffered_gauge.set(self._buffered_bytes)
            self._cond.notify_all()
        return True

    # -- fetch + assembly -------------------------------------------------
    def _fetch(self, perm, epoch: int, step: int) -> Batch:
        cfg = self.config
        t0 = time.perf_counter()
        rows = sorted(self._rows)
        ids: List[int] = []
        for r in rows:
            ids.extend(self._ds.batch_ids(perm, step, cfg.global_batch,
                                          dp_rank=r,
                                          dp_size=self._dp_size))
        gap = (self.gap_controller.next_gap()
               if self.gap_controller is not None else cfg.coalesce_gap)
        from tpu3fs_torch.analytics import spans as _spans

        with _spans.root_span("dataload.fetch"):
            recs = self._read_with_backoff(ids, gap)
        if cfg.transform is not None:
            # decode/augment between fetch and assembly — per record, on
            # the fetch thread (overlapped with training like the IO)
            recs = [cfg.transform(r) for r in recs]
        nbytes = sum(_rec_nbytes(r) for r in recs)
        if cfg.dtype:
            data = self._assemble_array(ids, recs)
        else:
            data = recs
        if self._mesh is not None:
            data = self._to_device(data)
        self._bytes.add(nbytes)
        self._batches.add()
        batch_ms = (time.perf_counter() - t0) * 1e3
        self._batch_ms.record(batch_ms)
        if self.gap_controller is not None:
            # feedback: the gap this batch used, its wall, its bytes
            self.gap_controller.observe(gap, batch_ms, nbytes)
        return Batch(epoch=epoch, step=step, ids=ids, data=data,
                     nbytes=nbytes, rows=rows)

    def _read_with_backoff(self, ids: List[int],
                           coalesce_gap: Optional[int] = None):
        cfg = self.config
        gap = coalesce_gap if coalesce_gap is not None else cfg.coalesce_gap
        from tpu3fs_torch.tenant.identity import tenant_scope

        with tagged(TrafficClass.DATALOAD), tenant_scope(cfg.tenant):
            for _ in range(cfg.max_overload_waits):
                try:
                    return self._ds.read_samples(
                        ids, verify=cfg.verify_crc,
                        coalesce_gap=gap,
                        max_span_bytes=cfg.max_span_bytes)
                except FsError as e:
                    if e.code == Code.DATALOAD_CORRUPT:
                        self._crc_err.add()
                        raise
                    if e.code not in (Code.OVERLOADED,
                                      Code.TENANT_THROTTLED):
                        raise
                    # shed past the client's own ladder: self-throttle
                    # for the server's hint instead of failing the epoch
                    hint = retry_after_ms_of(e.status.message) or 50
                    if self._stop.wait(hint / 1000.0):
                        raise
        raise _err(Code.CLIENT_RETRIES_EXHAUSTED,
                   f"dataload batch shed {cfg.max_overload_waits}x")

    def _assemble_array(self, ids: List[int], recs) -> np.ndarray:
        cfg = self.config
        dtype = np.dtype(cfg.dtype)
        shape = tuple(cfg.sample_shape)
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if shape else dtype.itemsize
        out = np.empty((len(ids),) + shape, dtype=dtype)
        for i, rec in enumerate(recs):
            if _rec_nbytes(rec) != want:
                raise _err(Code.DATALOAD_CORRUPT,
                           f"sample {ids[i]}: {_rec_nbytes(rec)} bytes, "
                           f"want {want} for {dtype}{shape}")
            if isinstance(rec, np.ndarray):
                # transformed record already decoded to an array
                out[i] = rec.reshape(shape)
            else:
                # frombuffer is a view; the assignment below is the
                # batch's ONE assembly copy
                out[i] = np.frombuffer(rec, dtype=dtype).reshape(shape)
        return out

    def _to_device(self, host: np.ndarray):
        """Global DTensor sharded ``Shard(0)`` on the dp axis: this rank's
        microbatch copied to its device (a blocking copy, so the batch is
        there when it is handed out)."""
        cfg = self.config
        gshape = (cfg.global_batch,) + tuple(cfg.sample_shape)
        (devices,) = self._rows.values()  # one rank, one dp row
        local = torch.from_numpy(host).to(devices[0], copy=True)
        names = [str(n) for n in self._mesh.mesh_dim_names]
        placements = [Shard(0) if n == self._dp_axis else Replicate()
                      for n in names]
        stride = [1] * len(gshape)
        for d in range(len(gshape) - 2, -1, -1):
            stride[d] = stride[d + 1] * gshape[d + 1]
        return DTensor.from_local(local, self._mesh, placements,
                                  run_check=False, shape=gshape,
                                  stride=tuple(stride))
