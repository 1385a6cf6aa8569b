"""Carry state across from the JAX package as plain values.

``codec_from_arrays`` builds the port's codec from the arrays a JAX
``RSCode``/``BatchCrc32c`` holds, so the two can be shown to compute the same
function from the same state. ``engine_from_chunks`` loads a plain dump of
a storage target's committed chunks into the port's ``MemChunkEngine``.
The caller reads the arrays and the dump; this module never imports
``tpu3fs``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

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
