"""The storage tier: the JAX package's and the port's (on the CPU, the
kernels' plain versions) answer one seeded request sequence alike.

Each side is a tier built by hand (``tests/torch_storage_tier.py``): CRAQ
chain writes, partial overwrites and reads from every replica, EC stripes
staged client-encoded (``batch_write_shard``) and through the pipelined
chain encode, a degraded read with a data and a parity target down, the EC
rebuild worker, the CR resync worker and the file-level calls. Reply codes,
versions, checksums, bytes read and every target's stored chunks must be
equal: tolerance 0.
"""

import numpy as np
import pytest

from tpu3fs.ops.stripe import get_codec as jax_codec
from tpu3fs.ops.stripe import shard_size_of as jax_shard_size_of
from tpu3fs_torch.ops.stripe import get_codec, shard_size_of
from torch_storage_tier import CR_CHAIN, EC_CHAIN, Tier, run_sequence

# (k, m, EC chunk bytes, CR chunk bytes, CR chunks, stripes a round)
SHAPES = [(4, 2, 16 << 10, 16 << 10, 6, 4), (12, 4, 48 << 10, 4 << 10, 4, 2)]


def _tier(pkg, k, m, S, cr_chunk, device=None):
    # the CR chain avoids the nodes of EC shards 1 and k, which go down
    return Tier(pkg, k + m, [(CR_CHAIN, [0, 2, 3], 0, 0, cr_chunk),
                             (EC_CHAIN, list(range(k + m)), k, m, S)],
                device=device)


@pytest.mark.parametrize("k,m,ec_chunk,cr_chunk,cr_chunks,stripes", SHAPES,
                         ids=lambda v: str(v))
def test_tier_matches_jax(k, m, ec_chunk, cr_chunk, cr_chunks, stripes):
    S = shard_size_of(ec_chunk, k)
    assert S == jax_shard_size_of(ec_chunk, k)
    out = {}
    for pkg, codec, device in (
            ("tpu3fs", jax_codec(k, m, S), None),
            ("tpu3fs_torch", get_codec(k, m, S, device="cpu"), "cpu")):
        tier = _tier(pkg, k, m, S, cr_chunk, device)
        try:
            rec, written = run_sequence(tier, codec, seed=k * 100 + m,
                                        cr_chunks=cr_chunks, stripes=stripes)
            out[pkg] = (rec, tier.stored(), tier.routing.version)
        finally:
            tier.close()
    jrec, jstored, jver = out["tpu3fs"]
    trec, tstored, tver = out["tpu3fs_torch"]
    assert len(trec) == len(jrec)
    for j, t in zip(jrec, trec):
        assert t == j, j[0]
    assert tstored.keys() == jstored.keys()
    for tid in jstored:
        assert tstored[tid] == jstored[tid], tid
    assert tver == jver
    # the EC rebuild and the CR resync moved something, and every stripe
    # written is held by the tier
    kinds = {r[0]: r for r in trec}
    assert kinds["ec.rebuild"][1] == 2 * stripes
    assert kinds["cr.resync"][1] > 0
    assert len(written) == 2 * stripes


def test_stored_shards_equal_client_encode():
    """The golden equality of the chain encode: each chain-encoded shard
    (file 9) equals the client-encoded shard of the same payload."""
    k, m, S = 4, 2, 4096
    codec = get_codec(k, m, S, device="cpu")
    tier = _tier("tpu3fs_torch", k, m, S, 4096, "cpu")
    try:
        from torch_storage_tier import payloads, write_stripes

        ChunkId = tier.types.ChunkId
        rng = np.random.default_rng(3)
        data = payloads(rng, 3, k * S, 1000)
        for f, ce in ((8, False), (9, True)):
            reps = write_stripes(tier, codec,
                                 [(ChunkId(f, i), d) for i, d in enumerate(data)],
                                 1, chain_encode=ce)
            assert all(r[0] == 0 for r in reps)
        for tid, rows in tier.stored().items():
            by_file = {}
            for row in rows:
                by_file.setdefault(row[0][0], []).append(row[1:])
            assert by_file.get(8) == by_file.get(9), tid
    finally:
        tier.close()
