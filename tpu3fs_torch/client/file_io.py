"""File-level IO: byte ranges -> per-chunk chain ops against a file's layout.

The client-side equivalent of the FUSE daemon's PioV (src/fuse/PioV.cc):
split a file-offset range into per-chunk ReadIO/WriteIOs routed by
Layout.chain_of_chunk, issue them through the StorageClient, and reassemble.
Also provides the precise-length callback used by meta close/fsync
(ref src/meta/components/FileHelper.cc queryLastChunk).

The port's own copy of ``tpu3fs/client/file_io.py``. Its stripes run
through the ``StorageClient``'s device. Readahead (``prefetch=``) runs on
the port's ``client/prefetch.py``: its windows are fetched on worker
threads, where a degraded window's decodes are K1 launches on the card.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.client.storage_client import StorageClient
from tpu3fs_torch.meta.types import Inode, Layout
from tpu3fs_torch.ops.crc32c import combine_spans
from tpu3fs_torch.storage.types import Checksum, ChunkId
from tpu3fs_torch.utils.result import Code, FsError, Status


def _reply_parts(reply) -> list:
    """A read reply's bytes as buffers in file order: an EC stripe read
    through the storage client's ``*_parts`` entries carries a list of
    them, any other reply one buffer."""
    data = reply.data
    return data if isinstance(data, list) else [data]


def _byte_view(data) -> memoryview:
    """A flat byte view of any caller buffer (bytes / bytearray /
    memoryview / C-contiguous ndarray) — the no-copy gather entry of the
    write path. Non-contiguous buffers take one owned copy (they cannot
    be scattered into iovecs)."""
    mv = memoryview(data)
    if mv.format != "B" or mv.ndim != 1:
        try:
            mv = mv.cast("B")
        except TypeError:
            mv = memoryview(bytes(mv))  # copy-ok: non-contiguous source
    return mv


class FileIoClient:
    def __init__(self, storage: StorageClient, *, prefetch=False):
        """prefetch: False (off), True (default readahead config), or a
        PrefetchConfig. When on, sequential reads arm an async readahead
        window (client/prefetch.py) that read/read_into/batch_read_files
        serve from; THIS client's write/truncate/remove invalidate it.
        Consistency is client-local — multi-writer workflows sharing a
        file across clients should leave prefetch off (the default)."""
        self._storage = storage
        self._prefetch = None
        if prefetch:
            from tpu3fs_torch.client.prefetch import (
                PrefetchConfig,
                ReadaheadPrefetcher,
            )

            cfg = prefetch if isinstance(prefetch, PrefetchConfig) else None
            self._prefetch = ReadaheadPrefetcher(self._fetch_window, cfg)

    @property
    def storage(self) -> StorageClient:
        return self._storage

    @property
    def prefetcher(self):
        return self._prefetch

    def invalidate_prefetch(self, inode_id: Optional[int] = None) -> None:
        """Drop readahead windows (one inode, or all with None) — for
        callers that mutate files through a DIFFERENT path than this
        client (e.g. FUSE truncate going through the meta service)."""
        if self._prefetch is not None:
            if inode_id is None:
                self._prefetch.invalidate_all()
            else:
                self._prefetch.invalidate(inode_id)

    def close(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()

    @staticmethod
    def _split(
        layout: Layout, offset: int, size: int
    ) -> List[Tuple[int, int, int, int]]:
        """-> [(chunk_index, chain_id, offset_in_chunk, length)] covering the
        range."""
        out = []
        cs = layout.chunk_size
        pos = offset
        end = offset + size
        while pos < end:
            idx = pos // cs
            in_off = pos % cs
            n = min(end - pos, cs - in_off)
            out.append((idx, layout.chain_of_chunk(idx), in_off, n))
            pos += n
        return out

    def _is_ec(self, chain_id: int) -> bool:
        chain = self._storage._chain(chain_id)
        return chain.is_ec

    def is_ec_chain(self, chain_id: int) -> bool:
        """Whether a layout chain is erasure-coded (routing lookup) — the
        ckpt archiver's already-archived test."""
        return self._is_ec(chain_id)

    def write(self, inode: Inode, offset: int, data: bytes) -> int:
        """Write a byte range. Chunk ops are BATCHED, not issued one at a
        time: consecutive CR chunks go through StorageClient.batch_write
        (one request per node, ref StorageClientImpl.cc:1030,1771) and
        consecutive full EC stripes through write_stripes (ONE device
        encode for the run + one BatchShardWrite per node); boundary
        partial-stripe EC writes take the read-modify-write path. Runs
        flush in FILE ORDER, so a failure always leaves a clean written
        prefix of whole runs — never new data after a hole (within a run
        the batch may land partially, as in the reference's batch APIs)."""
        layout = inode.layout
        assert layout is not None, "write() needs a file inode with layout"
        cs = layout.chunk_size

        def flush(kind, run) -> None:
            if not run:
                return
            if kind == "cr":
                for reply in self._storage.batch_write(run, chunk_size=cs):
                    if not reply.ok:
                        raise FsError(Status(reply.code, reply.message))
            elif kind == "ec_full":
                # one run may span the layout's chains (chunks round-robin
                # over them): one write_stripes per chain covers the run
                by_chain: dict = {}
                for chain_id, cid, part in run:
                    by_chain.setdefault(chain_id, []).append((cid, part))
                for chain_id, items in by_chain.items():
                    for reply in self._storage.write_stripes(
                            chain_id, items, chunk_size=cs):
                        if not reply.ok:
                            raise FsError(Status(reply.code, reply.message))
            else:  # ec_partial
                for chain_id, idx, in_off, part in run:
                    reply = self._write_ec_chunk(
                        inode, chain_id, idx, in_off, part, cs)
                    if not reply.ok:
                        raise FsError(Status(reply.code, reply.message))

        if self._prefetch is not None:
            # write-through invalidation: cached windows may now be stale
            self._prefetch.invalidate(inode.id)
        # gather: per-chunk parts are VIEWS of the caller's buffer
        # (bytes/bytearray/ndarray), not slices — they ride the bulk
        # request frames straight into sendmsg with no assembly copy
        mv = _byte_view(data)
        pos = 0
        kind: Optional[str] = None
        run: list = []
        for idx, chain_id, in_off, n in self._split(layout, offset, len(mv)):
            # a part covering the whole caller buffer passes the original
            # bytes object through: the native transport borrows a bytes
            # pointer for free but must copy a read-only view
            part = data if (pos == 0 and n == len(mv)
                            and type(data) is bytes) else mv[pos : pos + n]
            pos += n
            if self._is_ec(chain_id):
                if in_off == 0 and n == cs:
                    seg_kind, seg = "ec_full", (chain_id,
                                                ChunkId(inode.id, idx), part)
                else:
                    seg_kind, seg = "ec_partial", (chain_id, idx, in_off, part)
            else:
                seg_kind, seg = "cr", (chain_id, ChunkId(inode.id, idx),
                                       in_off, part)
            if seg_kind != kind:
                flush(kind, run)
                kind, run = seg_kind, []
            run.append(seg)
        flush(kind, run)
        return len(mv)

    def batch_write_files(
        self, files: List[Tuple[Inode, int, bytes]], *,
        with_checksums: bool = False,
    ):
        """Write many (inode, offset, data) ranges as ONE node-grouped
        batch through StorageClient.batch_write — the write-side twin of
        batch_read_files (ckpt save / kvcache write-back: batching across
        files is what amortizes round trips and feeds the striped
        pipelined fan-out). CR chunk ops across ALL files gather into one
        batch; full EC stripes group into one write_stripes per chain;
        partial EC stripes take the read-modify-write ladder. Any failed
        op raises (after batch_write's internal retry ladder); on success
        returns per-file byte counts.

        ``with_checksums=True`` returns ``(counts, checksums)`` where
        checksums[i] is the CRC32C of file i's WRITTEN range, built from
        ONE pooled native pass over the per-chunk slices (combined with
        crc32c_combine — no second content pass). The same per-chunk CRCs
        ride down to batch_write as trusted CRCs, so an in-process chain
        (the fabric) does not checksum the payload again anywhere: the
        ckpt saver turns them directly into manifest shard CRCs."""
        cr_runs: List[Tuple[list, int, list]] = []  # (ops, chunk_size, crc idxs)
        cr_ops: List[Tuple[int, ChunkId, int, object]] = []
        cr_idx: List[int] = []
        cr_cs: Optional[int] = None
        ec_full: dict = {}          # chain_id -> [(ChunkId, part)]
        ec_partial: list = []       # (inode, chain_id, idx, in_off, part, cs)
        counts: List[int] = []
        parts: List[object] = []    # every written slice, file order
        spans: List[Tuple[int, int]] = []  # per file: [lo, hi) into parts
        for inode, offset, data in files:
            layout = inode.layout
            assert layout is not None
            if self._prefetch is not None:
                self._prefetch.invalidate(inode.id)
            mv = _byte_view(data)
            counts.append(len(mv))
            cs = layout.chunk_size
            pos = 0
            lo = len(parts)
            for idx, chain_id, in_off, n in self._split(
                    layout, offset, len(mv)):
                part = data if (pos == 0 and n == len(mv)
                                and type(data) is bytes) \
                    else mv[pos : pos + n]
                pos += n
                parts.append(part)
                if self._is_ec(chain_id):
                    if in_off == 0 and n == cs:
                        ec_full.setdefault(chain_id, []).append(
                            (ChunkId(inode.id, idx), part))
                    else:
                        ec_partial.append(
                            (inode, chain_id, idx, in_off, part, cs))
                else:
                    if cr_cs is None:
                        cr_cs = cs
                    elif cr_cs != cs:
                        # batch_write carries ONE chunk_size; mixed-layout
                        # batches close the run so far and start a new one
                        cr_runs.append((cr_ops, cr_cs, cr_idx))
                        cr_ops, cr_idx, cr_cs = [], [], cs
                    cr_ops.append((chain_id, ChunkId(inode.id, idx),
                                   in_off, part))
                    cr_idx.append(len(parts) - 1)
            spans.append((lo, len(parts)))
        if cr_ops:
            cr_runs.append((cr_ops, cr_cs, cr_idx))
        part_crcs: Optional[List] = None
        sums: Optional[List] = None
        if with_checksums:
            part_crcs = (Checksum.of_many(parts, self._storage.device)
                         if parts else [])
            sizes = [c.length for c in part_crcs]
            sums = [Checksum(v, sum(sizes[lo:hi])) for v, (lo, hi) in zip(
                combine_spans([c.value for c in part_crcs], sizes, spans),
                spans)]
        for ops, run_cs, idxs in cr_runs:
            self._flush_cr(ops, run_cs,
                           op_crcs=([part_crcs[j].value for j in idxs]
                                    if part_crcs is not None else None))
        for chain_id, items in ec_full.items():
            # full stripes only land here, so any part's length IS the
            # layout chunk size
            for reply in self._storage.write_stripes(
                    chain_id, items, chunk_size=len(items[0][1])):
                if not reply.ok:
                    raise FsError(Status(reply.code, reply.message))
        for inode, chain_id, idx, in_off, part, cs in ec_partial:
            reply = self._write_ec_chunk(inode, chain_id, idx, in_off,
                                         part, cs)
            if not reply.ok:
                raise FsError(Status(reply.code, reply.message))
        if with_checksums:
            return counts, sums
        return counts

    def _flush_cr(self, ops, chunk_size, op_crcs=None) -> None:
        if not ops:
            return
        for reply in self._storage.batch_write(ops, chunk_size=chunk_size,
                                               op_crcs=op_crcs):
            if not reply.ok:
                raise FsError(Status(reply.code, reply.message))

    def _write_ec_chunk(self, inode: Inode, chain_id: int, idx: int,
                        in_off: int, part: bytes, chunk_size: int):
        """EC chunks are whole stripes: a full-chunk write encodes directly.
        A partial write first tries DELTA-PARITY RMW (write_stripe_rmw:
        read touched data + parity shards, ``P' = P ^ c*(D'^D)``, stage
        touched + parity + payload-free rebases — no stripe re-encode);
        when the fast path does not apply (fresh/degraded/raced stripe) it
        falls back to full read-modify-write re-encoding the stripe.
        Concurrent partial writers of the SAME stripe race on the stripe
        version (last write wins) — like the reference, non-overlapping
        writers of a shared file should write different chunks."""
        cid = ChunkId(inode.id, idx)
        if in_off == 0 and len(part) == chunk_size:
            return self._storage.write_stripe(
                chain_id, cid, part, chunk_size=chunk_size)
        fast = self._storage.write_stripe_rmw(
            chain_id, cid, in_off, part, chunk_size=chunk_size)
        if fast is not None:
            return fast
        cur = self._storage.read_stripe(
            chain_id, cid, 0, chunk_size, chunk_size=chunk_size)
        if cur.ok:
            base = bytearray(cur.data.ljust(chunk_size, b"\x00"))
            # fresh-nonce encoded version: hand-computing commit_ver + 1
            # would put concurrent RMW writers on the IDENTICAL encoded
            # version and mix their shards (see EC_VER_SHIFT)
            next_ver = self._storage.next_stripe_ver(cur.commit_ver)
        elif cur.code == Code.CHUNK_NOT_FOUND:
            base = bytearray(chunk_size)
            next_ver = 0
        else:
            # normalize: callers raise FsError(code, MESSAGE) off write
            # replies — a raw failed ReadReply has no message field
            # (surfaced by the production-day soak: an archive write
            # failing inside a fault window crashed on reply.message
            # instead of raising the real error)
            from tpu3fs_torch.storage.craq import UpdateReply

            return UpdateReply(
                cur.code,
                message=f"stripe RMW read of {cid} failed",
            )
        base[in_off : in_off + len(part)] = part
        # trim stripe padding back to the logical extent so shard lengths
        # (and hence the file length from query_last_chunk) stay precise
        logical = max(in_off + len(part), cur.logical_len if cur.ok else 0)
        return self._storage.write_stripe(
            chain_id, cid, bytes(base[:logical]), chunk_size=chunk_size,
            update_ver=next_ver)

    @staticmethod
    def _assemble(inode: Inode, pairs: Iterable[Tuple[object, int]],
                  size: int) -> bytes:
        """POSIX-style assembly of chunk read replies for one file range:
        holes (CHUNK_NOT_FOUND) and short chunks read as zeros, each part
        padded to its slot so later chunks keep their file offsets; an
        untracked-length inode with no chunks at all is true EOF (empty
        read), not a hole. `pairs` is [(reply, slot_length)] in file order;
        an EC reply brings its stripe's range as parts (_reply_parts).
        Shared by read() and batch_read_files() so their semantics cannot
        drift apart."""
        if size == 0:
            return b""
        parts: List[bytes] = []
        any_data = False
        for reply, n in pairs:
            if reply.code == Code.CHUNK_NOT_FOUND:
                parts.append(b"\x00" * n)  # hole
                continue
            if not reply.ok:
                raise FsError(Status(reply.code))
            any_data = True
            # replies may carry zero-copy transport memoryviews and an EC
            # stripe its shards' buffers: append the buffers themselves
            # (join below is the ONE assembly copy) and pad a short chunk
            # with a separate zeros part
            got = _reply_parts(reply)
            parts.extend(got)
            short = n - sum(map(len, got))
            if short > 0:
                parts.append(b"\x00" * short)
        if not any_data and inode.length == 0:
            return b""
        with _spans.span("client.read", "assemble"):
            return b"".join(parts)

    def read(self, inode: Inode, offset: int, size: int) -> bytes:
        """POSIX-style read: holes and short chunks inside the file read as
        zeros; the result is clamped to the inode's length (short read at
        EOF). With prefetch on, sequential reads are served from (and
        arm) the readahead window."""
        if inode.length:
            size = max(0, min(size, inode.length - offset))
        with _spans.root_span("client.read", nbytes=size):
            pf = self._prefetch
            if pf is None:
                return self._read_direct(inode, offset, size)
            data = pf.lookup(inode.id, offset, size)
            if data is None:
                data = self._read_direct(inode, offset, size)
            pf.record_read(inode, offset, size)
            return data

    def _read_direct(self, inode: Inode, offset: int, size: int) -> bytes:
        """The uncached read path (also the prefetcher's fetch fn; size is
        already clamped by the caller)."""
        layout = inode.layout
        assert layout is not None
        # generator: a fatal error on an early chunk short-circuits inside
        # _assemble before the remaining chunk RPCs are ever issued
        def one(chain_id: int, idx: int, in_off: int, n: int):
            if self._is_ec(chain_id):
                return self._storage.read_stripe_parts(
                    chain_id, ChunkId(inode.id, idx), in_off, n,
                    chunk_size=layout.chunk_size)
            return self._storage.read_chunk(
                chain_id, ChunkId(inode.id, idx), in_off, n)

        pairs = (
            (one(chain_id, idx, in_off, n), n)
            for idx, chain_id, in_off, n in self._split(layout, offset, size)
        )
        return self._assemble(inode, pairs, size)

    def read_into(self, inode: Inode, offset: int, size: int,
                  dest) -> int:
        """Read a byte range DIRECTLY into a caller-owned buffer (memoryview
        over registered shm): chunk replies are written at their slots with
        no intermediate assembly, and the chunk ops ride ONE node-grouped
        batch_read — the USRBIO zero-copy read path (the reference
        RDMA-WRITEs results into the user's registered iov,
        StorageOperator.cc:176-226). Returns bytes filled (short at EOF);
        holes and short chunks zero-fill their slots."""
        from tpu3fs_torch.client.storage_client import ReadReq

        layout = inode.layout
        assert layout is not None
        if inode.length:
            size = max(0, min(size, inode.length - offset))
        if size == 0:
            return 0
        pf = self._prefetch
        if pf is not None:
            hit = pf.lookup(inode.id, offset, size)
            if hit is not None:
                dest[:size] = hit
                pf.record_read(inode, offset, size)
                return size
        segs = self._split(layout, offset, size)
        reqs = [
            ReadReq(chain_id, ChunkId(inode.id, idx), in_off, n,
                    chunk_size=layout.chunk_size)
            for idx, chain_id, in_off, n in segs
        ]
        replies = self._storage.batch_read_parts(reqs)
        pos = 0
        any_data = False
        for (idx, chain_id, in_off, n), reply in zip(segs, replies):
            slot = dest[pos:pos + n]
            if reply.code == Code.CHUNK_NOT_FOUND:
                slot[:] = b"\x00" * n           # hole
            elif not reply.ok:
                raise FsError(Status(reply.code))
            else:
                any_data = True
                filled = 0  # each part straight into its slot
                for part in _reply_parts(reply):
                    take = min(len(part), n - filled)
                    if take <= 0:
                        break
                    slot[filled:filled + take] = (
                        part if take == len(part)
                        else memoryview(part)[:take])
                    filled += take
                if filled < n:
                    slot[filled:] = b"\x00" * (n - filled)
            pos += n
        if not any_data and inode.length == 0:
            return 0
        if pf is not None:
            pf.record_read(inode, offset, size)
        return size

    def batch_read_files(
        self, files: List[Tuple[Inode, int, int]]
    ) -> List[bytes]:
        """Read many (inode, offset, size) ranges as ONE node-grouped batch
        through StorageClient.batch_read — the data-loader/KVCache path where
        batching across files is what amortizes round trips. With prefetch
        on, ranges inside a readahead window are served from cache and the
        rest go out as one (smaller) batch."""
        pf = self._prefetch
        if pf is None:
            return self._batch_read_files_direct(files)
        out: List[Optional[bytes]] = [None] * len(files)
        missing: List[int] = []
        for i, (inode, offset, size) in enumerate(files):
            if inode.length:
                size = max(0, min(size, inode.length - offset))
            hit = pf.lookup(inode.id, offset, size)
            if hit is not None:
                out[i] = hit
            else:
                missing.append(i)
        if missing:
            got = self._batch_read_files_direct([files[i] for i in missing])
            for i, blob in zip(missing, got):
                out[i] = blob
        for inode, offset, size in files:
            pf.record_read(inode, offset, size)
        return out  # type: ignore[return-value]

    def _fetch_window(self, inode: Inode, offset: int, size: int) -> bytes:
        """The prefetcher's fetch fn: one node-grouped batched read (NOT
        the per-chunk ladder — a 4 MiB window must not cost 16 serial
        round trips)."""
        return self._batch_read_files_direct([(inode, offset, size)])[0]

    def _batch_read_files_direct(
        self, files: List[Tuple[Inode, int, int]]
    ) -> List[bytes]:
        from tpu3fs_torch.client.storage_client import ReadReq

        reqs: List[ReadReq] = []
        spans: List[List[Tuple[int, int]]] = []  # per file: (req idx, n)
        sizes: List[int] = []
        for inode, offset, size in files:
            layout = inode.layout
            assert layout is not None
            if inode.length:
                size = max(0, min(size, inode.length - offset))
            sizes.append(size)
            mine: List[Tuple[int, int]] = []
            for idx, chain_id, in_off, n in self._split(layout, offset, size):
                mine.append((len(reqs), n))
                reqs.append(ReadReq(
                    chain_id, ChunkId(inode.id, idx), in_off, n,
                    chunk_size=layout.chunk_size,
                ))
            spans.append(mine)
        replies = self._storage.batch_read_parts(reqs)
        return [
            self._assemble(
                inode, [(replies[req_i], n) for req_i, n in mine], size
            )
            for (inode, _, _), mine, size in zip(files, spans, sizes)
        ]

    def file_length(self, inode: Inode) -> int:
        """Precise length: max over chains of last chunk end (FileHelper)."""
        layout = inode.layout
        if layout is None:
            return 0
        best = 0
        for chain_id in set(layout.chains):
            idx, length = self._storage.query_last_chunk(chain_id, inode.id)
            if idx >= 0:
                best = max(best, idx * layout.chunk_size + length)
        return best

    def remove_chunks(self, inode: Inode) -> None:
        if self._prefetch is not None:
            self._prefetch.invalidate(inode.id)
        layout = inode.layout
        if layout is None:
            return
        for chain_id in set(layout.chains):
            self._storage.remove_file_chunks(chain_id, inode.id)

    def truncate_chunks(self, inode: Inode, length: int) -> None:
        """Drop chunks past the new EOF and trim the boundary chunk, down
        every chain of the layout (the storage half of meta truncate)."""
        if self._prefetch is not None:
            self._prefetch.invalidate(inode.id)
        layout = inode.layout
        if layout is None:
            return
        cs = layout.chunk_size
        last_idx = (length - 1) // cs if length > 0 else -1
        last_len = (length - last_idx * cs) if last_idx >= 0 else 0
        if last_idx >= 0:
            bchain = layout.chain_of_chunk(last_idx)
            if self._is_ec(bchain) and last_len < cs:
                # trimming one shard would invalidate the parity: re-encode
                # and rewrite the boundary stripe at its shortened length
                cid = ChunkId(inode.id, last_idx)
                cur = self._storage.read_stripe(
                    bchain, cid, 0, cs, chunk_size=cs)
                if cur.ok:
                    self._storage.write_stripe(
                        bchain, cid, cur.data[:last_len], chunk_size=cs,
                        update_ver=self._storage.next_stripe_ver(cur.commit_ver))
        for chain_id in set(layout.chains):
            self._storage.truncate_file_chunks(
                chain_id, inode.id, last_idx, last_len
            )
