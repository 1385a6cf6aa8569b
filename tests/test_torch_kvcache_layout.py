"""The KV cache's on-disk formats in the port against the JAX package: the
array wire format byte for byte for every dtype the JAX package round-trips
(and for 0-d and empty shapes), tensors written as their numpy twins, the
bfloat16 page (the JAX package writes it under numpy's ``<V2`` and reads
it back as a void array; the port keeps that format), the zero-hole,
stale and corrupt headers, entry paths, chain keys and the lease codec.
Tolerance 0."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu3fs.kvcache.blocks as jax_blocks
import tpu3fs.kvcache.layout as jax_layout
from tpu3fs.utils.result import Code as JaxCode
from tpu3fs.utils.result import FsError as JaxFsError
from tpu3fs_torch.kvcache import blocks, layout
from tpu3fs_torch.utils.result import Code, FsError

DTYPES = ["?", "u1", "u2", "u4", "u8", "i1", "i2", "i4", "i8", "f2", "f4",
          "f8"]
SHAPES = [(), (0,), (3, 0, 2), (7,), (2, 3, 5), (32, 2, 1, 16, 4)]


def _array(dtype: str, shape) -> np.ndarray:
    rng = np.random.default_rng(len(shape) * 31 + DTYPES.index(dtype))
    raw = rng.integers(0, 256, int(np.prod(shape, dtype=np.int64)) *
                       np.dtype(dtype).itemsize, dtype=np.uint8)
    arr = raw.view(dtype).reshape(shape)
    return arr.astype(bool) if dtype == "?" else arr


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_array_bytes_equal_the_jax_package(dtype, shape):
    arr = _array(dtype, shape)
    raw = layout.encode_array(arr)
    assert raw == jax_layout.encode_array(arr)
    for got in (layout.decode_array(raw), jax_layout.decode_array(raw)):
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert got.tobytes() == arr.tobytes()
    back = layout.decode_array(raw)
    if back.size:
        assert np.shares_memory(back, np.frombuffer(raw, np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_is_written_as_its_numpy_twin(dtype):
    arr = _array(dtype, (2, 3, 4))
    assert layout.encode_array(torch.from_numpy(arr)) == \
        jax_layout.encode_array(arr)


def test_bfloat16_page_keeps_the_jax_format():
    """A torch.bfloat16 tensor is written as the JAX package writes an
    ml_dtypes.bfloat16 array (header ``<V2``, the raw bits), and both
    packages read it back as the same void array: the element type is
    lost in both, and a void page cannot go to a device in either."""
    vals = np.random.default_rng(5).standard_normal((2, 4, 8))
    ref = vals.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    raw = layout.encode_array(t)
    assert raw == jax_layout.encode_array(ref)
    assert raw[:8].rstrip(b"\0") == layout.BF16_NAME.encode() == b"<V2"
    got, want = layout.decode_array(raw), jax_layout.decode_array(raw)
    assert got.dtype == want.dtype == np.dtype("V2")
    assert got.shape == want.shape == (2, 4, 8)
    assert got.tobytes() == want.tobytes() == ref.tobytes()
    with pytest.raises(TypeError):
        blocks._to_device(got, torch.device("cpu"))


def test_zero_hole_probe():
    raw = layout.encode_array(np.ones(8, np.float32))
    for mod in (layout, jax_layout):
        assert mod.zero_hole(b"\0" * len(raw))
        assert not mod.zero_hole(raw)
        assert not mod.zero_hole(b"\0" * 8)   # shorter than a header


def _headers():
    raw = bytearray(layout.encode_array(np.ones(8, np.float32)))
    magic = bytearray(raw)
    magic[12] ^= 0xFF
    name = bytearray(raw)
    name[0:8] = b"zz\0\0\0\0\0\0"
    return {"stale": (bytes(len(raw)), "KVCACHE_STALE"),
            "bad_magic": (bytes(magic), "KVCACHE_CORRUPT"),
            "truncated": (b"\x01\x02", "KVCACHE_CORRUPT"),
            "bad_dtype": (bytes(name), "KVCACHE_CORRUPT")}


@pytest.mark.parametrize("case", sorted(_headers()))
def test_bad_headers_raise_the_same_codes(case):
    raw, code = _headers()[case]
    with pytest.raises(JaxFsError) as jax_err:
        jax_layout.decode_array(raw)
    with pytest.raises(FsError) as err:
        layout.decode_array(raw)
    assert jax_err.value.code == getattr(JaxCode, code)
    assert err.value.code == getattr(Code, code) == int(jax_err.value.code)


@pytest.mark.parametrize("root", ["/kvcache", "/tenant-a/kv"])
def test_shard_paths_equal(root):
    keys = [f"req{i}/layer{i % 7}" for i in range(50)] + ["", "é/ü"]
    assert [layout.shard_path(root, k) for k in keys] == \
        [jax_layout.shard_path(root, k) for k in keys]


@pytest.mark.parametrize("block_tokens,salt", [(1, b""), (4, b""),
                                               (16, b"tenant-a")])
def test_chain_keys_equal(block_tokens, salt):
    rng = np.random.default_rng(block_tokens)
    toks = [int(t) for t in rng.integers(-2**40, 2**40, 203)]
    assert blocks.chain_keys(toks, block_tokens, salt=salt) == \
        jax_blocks.chain_keys(toks, block_tokens, salt=salt)


def test_lease_codec_equal():
    for ts, owner in [(1_800_000_000.25, "kvlease-1a2b3c4d"), (0.0, ""),
                      (1e-7, "a b c")]:
        raw = layout.encode_lease(ts, owner)
        assert raw == jax_layout.encode_lease(ts, owner)
        assert layout.decode_lease(raw) == jax_layout.decode_lease(raw) == \
            (ts, owner)
    for bad in (b"not-a-time owner", b"\xff\xfe"):
        assert layout.decode_lease(bad) == jax_layout.decode_lease(bad) == \
            (0.0, "")


@pytest.mark.parametrize("now,want", [(99.0, True), (100.0, False),
                                      (101.0, False)])
def test_lease_active_equal(now, want):
    from types import SimpleNamespace

    inode = SimpleNamespace(xattrs={layout.LEASE_XATTR:
                                    layout.encode_lease(100.0, "o")})
    assert layout.lease_active(inode, now) == \
        jax_layout.lease_active(inode, now) == want
    assert not layout.lease_active(SimpleNamespace(xattrs={}), now)
