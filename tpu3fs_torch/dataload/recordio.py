"""Packed record-file format: fixed header, per-record index, CRC32C.

The on-FS twin of DeepSeek's FFRecord (the companion format the reference
ships for its training data loaders, SURVEY §0): many small samples packed
into one large file so batch reads become a handful of large extents
instead of millions of tiny files — exactly the shape distributed SSD
arrays want (PAPERS.md, online-EC SSD study: random small reads are the
cliff).

Layout (little-endian)::

    [0, 32)                 header: magic "TPRC", version u32,
                            nrecords u64, index_crc u32, 12 reserved bytes
    [32, 32 + 16*n)         index: per record (offset u64, length u32,
                            crc32c u32); offsets are absolute file offsets
    [data_start, ...)       record payloads, back to back, in index order

``index_crc`` covers the raw index bytes, so a truncated or bit-rotted
index fails loudly at open; each record carries its own CRC32C so payload
corruption fails at read (``Code.DATALOAD_CORRUPT``).

Commit protocol: writers stage everything under ``<path>.tmp`` and
publish with a single meta ``rename`` — the ckpt manifest protocol — so a
reader never observes a half-written record file and a crashed packer
leaves only a ``.tmp`` for cleanup.

All IO here is tagged ``TrafficClass.DATALOAD``.

The port's own copy of ``tpu3fs/dataload/recordio.py``. Every CRC runs on
the ``FileIoClient``'s storage device, one ``crc32c_pieces`` call (one K2
launch) a batch: a writer checksums its records per flushed run
(streaming) or at commit (buffered), and the index once; ``open`` checks
the index in one call and ``read_batch`` every record of a batch in one.
The bytes are the ones the JAX package writes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.meta.store import OpenFlags
from tpu3fs_torch.ops.crc32c import crc32c_pieces
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

MAGIC = b"TPRC"
FORMAT_VERSION = 1
TMP_SUFFIX = ".tmp"

_HEADER = struct.Struct("<4sIQI12x")   # magic, version, nrecords, index_crc
_ENTRY = struct.Struct("<QII")         # offset, length, crc32c
HEADER_SIZE = _HEADER.size            # 32
ENTRY_SIZE = _ENTRY.size              # 16

#: numpy view of the index region (offset, length, crc), zero-copy decode
_INDEX_DTYPE = np.dtype([("offset", "<u8"), ("length", "<u4"),
                         ("crc", "<u4")])


def data_start(nrecords: int) -> int:
    return HEADER_SIZE + nrecords * ENTRY_SIZE


class RecordFileWriter:
    """Stream records into ``<path>.tmp``; ``commit()`` publishes.

    With ``num_records`` declared up front, payloads stream straight to
    the staging file (buffered in ~``buffer_bytes`` runs through the
    striped write path) and only the header + index land at commit —
    constant host memory however large the file. Without it, payloads are
    buffered in host memory until commit (fine for small packs; the
    packer CLI always declares the count).
    """

    def __init__(self, meta, fio: FileIoClient, path: str, *,
                 num_records: Optional[int] = None,
                 client_id: str = "dataload-pack",
                 buffer_bytes: int = 4 << 20):
        self._meta = meta
        self._fio = fio
        self.path = path
        self._declared = num_records
        self._client_id = client_id
        self._buffer_cap = max(1, buffer_bytes)
        # offset, len, crc (None until the record's run is checksummed)
        self._entries: List[List[Optional[int]]] = []
        self._pending: List[bytes] = []  # buffered payload run
        self._pending_bytes = 0
        self._pos = 0 if num_records is None else data_start(num_records)
        self._open = None  # (inode, session_id), staged lazily
        self._done = False

    # -- staging ----------------------------------------------------------
    @property
    def tmp_path(self) -> str:
        return self.path + TMP_SUFFIX

    def _stage(self):
        if self._open is None:
            res = self._meta.create(
                self.tmp_path,
                flags=OpenFlags.WRITE | OpenFlags.CREATE | OpenFlags.TRUNC,
                client_id=self._client_id)
            self._open = (res.inode, res.session_id)
        return self._open

    def _crc_pending(self) -> None:
        """Checksum the buffered run's records: one call on the client's
        device (a no-op when they already have their CRCs)."""
        todo = self._entries[len(self._entries) - len(self._pending):]
        if not todo or todo[0][2] is not None:
            return
        crcs = crc32c_pieces(self._pending, device=self._fio.storage.device)
        for entry, crc in zip(todo, crcs):
            entry[2] = crc

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        self._crc_pending()
        inode, _ = self._stage()
        blob = b"".join(self._pending)
        off = self._pos - len(blob)
        self._fio.write(inode, off, blob)
        self._pending = []
        self._pending_bytes = 0

    def append(self, payload) -> int:
        """Add one record; returns its record index."""
        if self._done:
            raise _err(Code.INVALID_ARG, "writer already committed/aborted")
        if self._declared is not None and \
                len(self._entries) >= self._declared:
            raise _err(Code.INVALID_ARG,
                       f"more than the declared {self._declared} records")
        payload = bytes(payload)
        self._entries.append([self._pos, len(payload), None])
        self._pos += len(payload)
        self._pending.append(payload)
        self._pending_bytes += len(payload)
        if self._declared is not None and \
                self._pending_bytes >= self._buffer_cap:
            with tagged(TrafficClass.DATALOAD):
                self._flush_pending()
        return len(self._entries) - 1

    # -- commit / abort ---------------------------------------------------
    def commit(self) -> "RecordFile":
        """Write header + index, close the session, rename into place."""
        if self._done:
            raise _err(Code.INVALID_ARG, "writer already committed/aborted")
        if self._declared is not None and \
                len(self._entries) != self._declared:
            raise _err(Code.INVALID_ARG,
                       f"declared {self._declared} records, "
                       f"appended {len(self._entries)}")
        n = len(self._entries)
        shift = 0 if self._declared is not None else data_start(n)
        self._crc_pending()
        index = b"".join(
            _ENTRY.pack(off + shift, length, crc)
            for off, length, crc in self._entries)
        header = _HEADER.pack(MAGIC, FORMAT_VERSION, n, crc32c_pieces(
            [index], device=self._fio.storage.device)[0])
        with tagged(TrafficClass.DATALOAD):
            inode, session = self._stage()
            if self._declared is None:
                # buffered mode: everything lands in one pass, payload
                # already offset by the header+index it follows
                self._fio.write(inode, 0, header + index
                                + b"".join(self._pending))
                self._pending = []
                self._pending_bytes = 0
            else:
                self._flush_pending()
                self._fio.write(inode, 0, header + index)
            total = max(self._pos + shift, data_start(n))
            self._meta.close(inode.id, session, length_hint=total,
                             wrote=True)
            self._meta.rename(self.tmp_path, self.path)
        self._done = True
        return RecordFile.open(self._meta, self._fio, self.path)

    def abort(self) -> None:
        """Drop the staging file (crash cleanup is just removing .tmp)."""
        if self._done:
            return
        self._done = True
        if self._open is None:
            return
        inode, session = self._open
        with tagged(TrafficClass.DATALOAD):
            try:
                self._meta.close(inode.id, session)
            except FsError:
                pass
            try:
                self._fio.remove_chunks(inode)
                self._meta.remove(self.tmp_path)
            except FsError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.abort()
        return False


class RecordFile:
    """One opened packed record file: decoded index + batched reads."""

    def __init__(self, fio: FileIoClient, inode, path: str,
                 index: np.ndarray):
        self._fio = fio
        self.inode = inode
        self.path = path
        self._index = index

    @classmethod
    def open(cls, meta, fio: FileIoClient, path: str) -> "RecordFile":
        inode = meta.stat(path)
        with tagged(TrafficClass.DATALOAD):
            raw = fio.read(inode, 0, HEADER_SIZE)
        if len(raw) < HEADER_SIZE:
            raise _err(Code.DATALOAD_CORRUPT, f"{path}: short header")
        magic, version, nrec, index_crc = _HEADER.unpack(raw)
        if magic != MAGIC:
            raise _err(Code.DATALOAD_CORRUPT,
                       f"{path}: bad magic {magic!r}")
        if version > FORMAT_VERSION:
            raise _err(Code.DATALOAD_CORRUPT,
                       f"{path}: format {version} > {FORMAT_VERSION}")
        with tagged(TrafficClass.DATALOAD):
            raw_index = fio.read(inode, HEADER_SIZE, nrec * ENTRY_SIZE)
        if len(raw_index) != nrec * ENTRY_SIZE or crc32c_pieces(
                [raw_index], device=fio.storage.device)[0] != index_crc:
            raise _err(Code.DATALOAD_CORRUPT,
                       f"{path}: index CRC/length mismatch")
        index = np.frombuffer(raw_index, dtype=_INDEX_DTYPE)
        return cls(fio, inode, path, index)

    # -- index ------------------------------------------------------------
    @property
    def num_records(self) -> int:
        return len(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def extent(self, i: int) -> Tuple[int, int]:
        e = self._index[i]
        return int(e["offset"]), int(e["length"])

    def record_crc(self, i: int) -> int:
        return int(self._index[i]["crc"])

    def total_payload_bytes(self) -> int:
        return int(self._index["length"].sum()) if len(self._index) else 0

    # -- reads ------------------------------------------------------------
    def read(self, i: int, *, verify: bool = True) -> bytes:
        return bytes(self.read_batch([i], verify=verify)[0])

    def read_batch(self, indices: Sequence[int], *, verify: bool = True,
                   coalesce_gap: int = 64 << 10,
                   max_span_bytes: int = 8 << 20) -> List[bytes]:
        """Fetch many records as coalesced sorted extents (one
        node-grouped ``batch_read_files`` call), then slice each record
        back out as a zero-copy view of its span."""
        extents = [self.extent(i) for i in indices]
        spans, places = plan_coalesced(extents, gap=coalesce_gap,
                                       max_span=max_span_bytes)
        with tagged(TrafficClass.DATALOAD):
            blobs = self._fio.batch_read_files(
                [(self.inode, off, n) for off, n in spans])
        out: List[bytes] = []
        for idx, (si, rel) in zip(indices, places):
            length = int(self._index[idx]["length"])
            out.append(memoryview(blobs[si])[rel:rel + length])
        # every record of the batch in one call on the client's device
        crcs = (crc32c_pieces(out, device=self._fio.storage.device)
                if verify else [None] * len(out))
        for idx, rec, crc in zip(indices, out, crcs):
            if len(rec) != int(self._index[idx]["length"]):
                raise _err(Code.DATALOAD_CORRUPT,
                           f"{self.path}[{idx}]: short record")
            if verify and crc != int(self._index[idx]["crc"]):
                raise _err(Code.DATALOAD_CORRUPT,
                           f"{self.path}[{idx}]: record CRC mismatch")
        return out  # memoryviews; callers copy only if retaining

    def summary(self) -> Dict[str, object]:
        """Inspect view (admin_cli dataload-inspect)."""
        lengths = self._index["length"]
        return {
            "path": self.path,
            "records": int(len(self._index)),
            "payload_bytes": self.total_payload_bytes(),
            "file_bytes": int(self.inode.length),
            "min_record": int(lengths.min()) if len(lengths) else 0,
            "max_record": int(lengths.max()) if len(lengths) else 0,
            "data_start": data_start(len(self._index)),
        }


def plan_coalesced(extents: Sequence[Tuple[int, int]], *,
                   gap: int = 64 << 10, max_span: int = 8 << 20
                   ) -> Tuple[List[Tuple[int, int]],
                              List[Tuple[int, int]]]:
    """Merge record extents into large sorted read spans.

    -> (spans, places): ``spans`` is the sorted, merged [(offset, length)]
    to fetch; ``places[k] = (span index, offset inside span)`` locates
    input extent k in the fetched spans. Two extents merge when the gap
    between them is at most ``gap`` (over-read is cheaper than another
    IOP until the gap outgrows the seek it saves) and the merged span
    stays within ``max_span`` (bounds both over-read waste and the
    single-reply buffer size). Overlapping/duplicate extents share one
    span.
    """
    if not extents:
        return [], []
    order = sorted(range(len(extents)), key=lambda k: extents[k][0])
    spans: List[List[int]] = []      # [start, end) being built
    places: List[Optional[Tuple[int, int]]] = [None] * len(extents)
    for k in order:
        off, n = extents[k]
        if spans:
            cur = spans[-1]
            new_end = max(cur[1], off + n)
            if off - cur[1] <= gap and new_end - cur[0] <= max_span:
                cur[1] = new_end
                places[k] = (len(spans) - 1, off - cur[0])
                continue
        spans.append([off, off + n])
        places[k] = (len(spans) - 1, off - spans[-1][0])
    return ([(s, e - s) for s, e in spans],
            places)  # type: ignore[return-value]


def encode_record_file(payloads: Sequence[bytes], *,
                       device=None) -> bytes:
    """The complete file image for a payload list — for callers writing
    through a raw data path (benches over meta-less RPC clusters) and as
    the format oracle in tests. Byte-identical to what
    ``RecordFileWriter`` commits. Its CRCs run on ``device`` (the card
    unless the caller asks for the CPU), there being no client here."""
    n = len(payloads)
    pos = data_start(n)
    entries = []
    for p, crc in zip(payloads, crc32c_pieces(payloads, device=device)):
        entries.append(_ENTRY.pack(pos, len(p), crc))
        pos += len(p)
    index = b"".join(entries)
    header = _HEADER.pack(MAGIC, FORMAT_VERSION, n,
                          crc32c_pieces([index], device=device)[0])
    return header + index + b"".join(payloads)


def pack_records(meta, fio: FileIoClient, path: str,
                 records: Iterable[bytes],
                 *, num_records: Optional[int] = None,
                 client_id: str = "dataload-pack") -> "RecordFile":
    """Pack an iterable of payloads into one committed record file."""
    if num_records is None and hasattr(records, "__len__"):
        num_records = len(records)  # type: ignore[arg-type]
    writer = RecordFileWriter(meta, fio, path, num_records=num_records,
                              client_id=client_id)
    try:
        for payload in records:
            writer.append(payload)
    except BaseException:
        writer.abort()
        raise
    return writer.commit()
