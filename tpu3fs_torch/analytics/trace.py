"""Structured trace log: stream typed event records to columnar files.

Re-expresses src/analytics — SerdeObjectWriter.h (any serde struct stream →
Parquet), SerdeObjectReader.h:2-53 (read back), StructuredTraceLog.h:18-40
(rotating trace sink plugged into the storage write path at
src/storage/service/StorageOperator.h:36). The reference rides Arrow/Parquet;
this build writes Parquet when pyarrow is importable and otherwise a
self-contained columnar NPZ container (schema JSON + one numpy array per
column) that needs nothing beyond numpy to read back. Dataclass events are
flattened (nested fields joined with '.') so every column is a flat scalar
array — the same property the serde→Arrow bridge guarantees.

The port's own copy of ``tpu3fs/analytics/trace.py``: the sink of the
span log (``spans.Tracer.configure(directory=...)``), of the storage
services' ``StorageEventTrace`` rows (``set_trace_log``), of
``meta/scan.MetaEventLog`` and of ``storage/workers.DumpWorker``. Both
formats read back through ``read_records`` as the same rows.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import os
import threading
import time
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

try:  # pragma: no cover - exercised only when pyarrow is installed
    import pyarrow as _pa
    import pyarrow.parquet as _pq
except ImportError:
    _pa = None
    _pq = None


# -- row flattening ----------------------------------------------------------

def _flatten(obj: Any, prefix: str = "") -> Dict[str, Any]:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            out.update(_flatten(getattr(obj, f.name),
                                f"{prefix}{f.name}."))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(obj, enum.Enum):
        obj = obj.value
    return {prefix[:-1]: obj}


def _rows_of(events: Sequence[Any]) -> List[Dict[str, Any]]:
    return [_flatten(e) if not isinstance(e, dict) else dict(e)
            for e in events]


# -- columnar write/read -----------------------------------------------------

def _ordered_keys(rows: List[Dict[str, Any]]) -> List[str]:
    """First-seen column order, union over all rows."""
    keys: List[str] = []
    for row in rows:
        for k in row:
            if k not in keys:
                keys.append(k)
    return keys


def _columns(rows: List[Dict[str, Any]]) -> "Tuple[Dict[str, np.ndarray], List[str]]":
    keys = _ordered_keys(rows)
    bytes_cols: List[str] = []
    cols: Dict[str, np.ndarray] = {}
    for k in keys:
        vals = [row.get(k) for row in rows]
        sample = next((v for v in vals if v is not None), 0)
        if isinstance(sample, bool):
            cols[k] = np.array([bool(v) for v in vals], dtype=np.bool_)
        elif isinstance(sample, int):
            cols[k] = np.array([int(v or 0) for v in vals], dtype=np.int64)
        elif isinstance(sample, float):
            cols[k] = np.array(
                [float(v) if v is not None else np.nan for v in vals],
                dtype=np.float64,
            )
        elif isinstance(sample, bytes):
            # hex-encoded; recorded in the schema so reads decode to bytes
            cols[k] = np.array([v.hex() if v else "" for v in vals])
            bytes_cols.append(k)
        else:
            cols[k] = np.array(["" if v is None else str(v) for v in vals])
    return cols, bytes_cols


def write_records(path_base: str, rows: Sequence[Dict[str, Any]]) -> str:
    """Write rows columnar; returns the actual path (.parquet or .npz)."""
    rows = list(rows)
    if _pq is not None:
        # normalize: from_pylist takes its schema from the first row, so a
        # key appearing later would silently drop its whole column
        keys = _ordered_keys(rows)
        norm = [{k: row.get(k) for k in keys} for row in rows]
        path = path_base + ".parquet"
        _pq.write_table(_pa.Table.from_pylist(norm), path)
        return path
    path = path_base + ".npz"
    cols, bytes_cols = _columns(rows)
    meta = json.dumps({"n": len(rows), "columns": list(cols),
                       "bytes_columns": bytes_cols})
    np.savez_compressed(path, __schema__=np.array(meta), **cols)
    # np.savez appends .npz only when missing; path already carries it
    return path


def read_records(path: str) -> List[Dict[str, Any]]:
    """Read rows back (either backend) as list-of-dicts."""
    if path.endswith(".parquet"):  # pragma: no cover - needs pyarrow
        if _pq is None:
            raise RuntimeError("pyarrow is required to read parquet traces")
        return _pq.read_table(path).to_pylist()
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__schema__"]))
        cols = {k: z[k] for k in meta["columns"]}
    bytes_cols = set(meta.get("bytes_columns", []))
    out = []
    for i in range(meta["n"]):
        row = {}
        for k, arr in cols.items():
            v = arr[i]
            if k in bytes_cols:
                row[k] = bytes.fromhex(str(v))
            else:
                row[k] = str(v) if arr.dtype.kind == "U" else v.item()
        out.append(row)
    return out


# -- serde object stream -----------------------------------------------------

class SerdeObjectWriter:
    """Buffered writer of one dataclass type to a columnar file
    (ref analytics::SerdeObjectWriter — one parquet row group per flush)."""

    def __init__(self, path_base: str, *, flush_rows: int = 4096):
        self._path_base = path_base
        self._flush_rows = flush_rows
        self._rows: List[Dict[str, Any]] = []
        self._part = 0
        self._lock = threading.Lock()
        self.paths: List[str] = []

    def write(self, event: Any) -> None:
        with self._lock:
            self._rows.append(_flatten(event))
            if len(self._rows) >= self._flush_rows:
                self._flush_locked()

    def write_row(self, row: Dict[str, Any]) -> None:
        """Append an already-flat row (no reflection walk — the span
        sink's hot path: SpanEvent is flat, its __dict__ IS the row)."""
        with self._lock:
            self._rows.append(row)
            if len(self._rows) >= self._flush_rows:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._rows:
            return
        path = write_records(f"{self._path_base}.{self._part:05d}",
                             self._rows)
        self.paths.append(path)
        self._part += 1
        self._rows = []

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        self.flush()


@functools.lru_cache(maxsize=None)
def _resolved_hints(cls: Type) -> Dict[str, Any]:
    """Field annotations may be strings under `from __future__ import
    annotations` — resolve once per class, not per row."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {}


class SerdeObjectReader:
    """Read a columnar stream back into dataclass instances
    (ref analytics::SerdeObjectReader). Nested dataclasses are rebuilt from
    the dotted column names."""

    def __init__(self, cls: Type):
        self._cls = cls

    def _build(self, cls: Type, row: Dict[str, Any], prefix: str) -> Any:
        hints = _resolved_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            key = f"{prefix}{f.name}"
            ftype = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(ftype) and isinstance(ftype, type):
                kwargs[f.name] = self._build(ftype, row, key + ".")
            elif key in row:
                v = row[key]
                if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
                    v = ftype(v)
                kwargs[f.name] = v
        return cls(**kwargs)

    def read(self, paths: Sequence[str]) -> List[Any]:
        out = []
        for path in paths:
            for row in read_records(path):
                out.append(self._build(self._cls, row, ""))
        return out


class StructuredTraceLog:
    """Rotating trace sink for hot paths (ref StructuredTraceLog.h:18-40):
    append() is lock-cheap; rows land in rotated columnar parts under dir."""

    def __init__(self, name: str, directory: str, *,
                 flush_rows: int = 4096, enabled: bool = True):
        self.name = name
        self.enabled = enabled
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self._writer = SerdeObjectWriter(
            os.path.join(directory, f"{name}-{stamp}"),
            flush_rows=flush_rows,
        )

    def append(self, event: Any) -> None:
        if self.enabled:
            self._writer.write(event)

    def append_row(self, row: Dict[str, Any]) -> None:
        if self.enabled:
            self._writer.write_row(row)

    def flush(self) -> None:
        self._writer.flush()

    @property
    def paths(self) -> List[str]:
        return self._writer.paths
