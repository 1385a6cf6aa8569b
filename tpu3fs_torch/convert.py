"""Carry state across from the JAX package as plain values.

``codec_from_arrays`` builds the port's codec from the arrays a JAX
``RSCode``/``BatchCrc32c`` holds, so the two can be shown to compute the same
function from the same state. ``engine_from_chunks`` loads a plain dump of
a storage target's committed chunks into the port's ``MemChunkEngine``,
and ``fabric_from_dump`` a plain dump of a whole in-process cluster (its
KV store and every target's chunks) into the port's ``Fabric``. A KV
cache carries across with it: its entries are files, and its pin leases
xattrs on their inodes. The caller reads the arrays and the dumps; this
module never imports ``tpu3fs``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

from tpu3fs_torch.kv import with_transaction
from tpu3fs_torch.ops.crc32c import BatchCrc32c
from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.ops.stripe import StripeCodec
from tpu3fs_torch.storage.engine import MemChunkEngine
from tpu3fs_torch.storage.types import ChunkId
from tpu3fs_torch.utils.result import Code, FsError


def codec_from_arrays(arrays: Dict[str, np.ndarray], device=None) -> StripeCodec:
    """Build a StripeCodec from

    - ``parity_matrix`` (m, k) uint8 and ``parity_bits`` (8m, 8k) int8
      (``RSCode.parity_matrix`` and ``RSCode._parity_bits``);
    - ``crc_b_t`` (8*block, 32) int8, ``crc_ks`` (N, 32, 32) int8 and
      ``crc_const`` uint32 (``BatchCrc32c._b_t``, ``._ks``, ``._const``).

    The shard size is N * block. Its ``.rs`` and ``._crc`` are the port's
    RSCode and BatchCrc32c."""
    rs = RSCode.from_arrays(arrays["parity_matrix"], arrays["parity_bits"],
                            device=device)
    crc = BatchCrc32c.from_arrays(arrays["crc_b_t"], arrays["crc_ks"],
                                  arrays["crc_const"], device=device)
    return StripeCodec.from_parts(rs, crc)


def engine_from_chunks(chunks: Iterable[Mapping], device=None) -> MemChunkEngine:
    """A ``MemChunkEngine`` on ``device`` holding the dumped chunks.

    Each entry gives ``chunk_id`` (file id, index), ``committed_ver``,
    ``chain_ver``, ``data`` (the committed bytes), ``crc`` and ``length``,
    and may give ``aux`` (an EC shard's stripe length). A chunk is installed
    as committed content at its version through the engine's validated
    install, which checksums it on ``device``: a CRC or a length that does
    not match its bytes raises ``ValueError``."""
    engine = MemChunkEngine(device=device)
    for c in chunks:
        cid = ChunkId(*c["chunk_id"])
        data = bytes(c["data"])
        if len(data) != c["length"]:
            raise ValueError(f"chunk {cid}: {len(data)} bytes, length "
                             f"{c['length']}")
        try:
            engine.update(cid, c["committed_ver"], c["chain_ver"], data, 0,
                          full_replace=True, chunk_size=len(data),
                          aux=c.get("aux", 0), expected_crc=c["crc"])
        except FsError as e:
            if e.code != Code.CHUNK_CHECKSUM_MISMATCH:
                raise
            raise ValueError(f"chunk {cid}: crc {c['crc']:#010x} does not "
                             "match its bytes") from e
    return engine


def fabric_from_dump(dump: Mapping, cfg=None, device=None):
    """A port ``Fabric(cfg, device)`` holding a dumped fabric's state.

    ``dump`` gives ``kv``, every (key, value) pair of the KV store as bytes
    (mgmtd's routing records and meta's inodes and directory entries,
    which both packages' serde encodes alike); ``clock``, the fabric
    clock's reading; and ``targets``, target id -> that target's chunks in
    ``engine_from_chunks``'s form. ``cfg`` must be the dumped fabric's
    ``SystemSetupConfig``, so the booted fabric has the same nodes,
    targets and chains; every node is taken to be up. The booted records
    are replaced by the dumped ones, mgmtd reloads its routing from them,
    and each target gets an engine loaded (and every CRC checked) on the
    fabric's device."""
    from tpu3fs_torch.fabric import Fabric

    fab = Fabric(cfg, device=device)
    booted = fab.kv.dump_at(fab.kv.version)

    def load(txn) -> None:
        for key, _ in booted:
            txn.clear(key)
        for key, value in dump["kv"]:
            txn.set(bytes(key), bytes(value))

    with_transaction(fab.kv, load)
    fab.clock.t = float(dump["clock"])
    fab.mgmtd._load()
    routing = fab.routing()
    targets: Dict[int, object] = {
        t.target_id: t for node in fab.nodes.values()
        for t in node.service.targets()}
    unknown = set(map(int, dump["targets"])) - set(targets)
    if unknown or set(routing.targets) != set(targets):
        raise ValueError("the dump's targets are not the ones cfg lays out: "
                         f"unknown {sorted(unknown)}")
    for tid, target in targets.items():
        target.engine = engine_from_chunks(dump["targets"].get(tid, ()),
                                           device=fab.device)
    for nid, node in fab.nodes.items():
        node.hb_version = routing.nodes[nid].heartbeat_version
    fab.heartbeat_all()
    return fab
