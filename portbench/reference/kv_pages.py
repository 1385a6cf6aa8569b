"""The plain reference of the KV cache's MLA pages: what a page holds, what
its stored entry looks like, and what a layer-first pool holds after pages
land in it. NumPy and PyTorch only, nothing of the program; the comparison
is of bits, so no arithmetic runs here at all (TF32 and the like cannot
enter).

A page is one block of ``T`` tokens of every layer's latent cache,
page-first: ``(L, T, W)`` bfloat16 values, DeepSeek-V3's ``L`` = 61,
``W`` = kv_lora_rank + qk_rope_head_dim = 576 and FlashMLA's ``T`` = 64.
Its values are drawn from (seed, session, page): random 16-bit words with
bit 14 cleared, so every one is a finite bfloat16 of magnitude under 2.

A stored entry is a 16-byte header (the element type's name in 8 bytes,
``<V2`` for bfloat16; the number of dims and the magic ``0x4B564131`` as
little-endian u32), the dims as little-endian u64, then the page's bytes:
40 bytes of header for a page of three dims.
"""

from __future__ import annotations

import numpy as np
import torch

MAGIC = 0x4B564131
BF16_NAME = b"<V2"
_HEAD = np.dtype([("name", "S8"), ("ndim", "<u4"), ("magic", "<u4")])


def page_bits(seed: int, session: int, page: int, shape) -> np.ndarray:
    """The bfloat16 bits (uint16) of page ``page`` of session ``session``."""
    gen = np.random.SFC64(np.random.SeedSequence(
        [seed % (1 << 64), session, page]))
    n = int(np.prod(shape))
    words = gen.random_raw(-(-n // 4)).astype("<u8", copy=False)
    bits = words.view("<u2")[:n].reshape(shape)
    return bits & np.uint16(0xBFFF)


def as_bf16(bits: np.ndarray) -> torch.Tensor:
    """A bfloat16 tensor over the bits (a view, no copy)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def bits_of(t: torch.Tensor) -> np.ndarray:
    """The bits of a bfloat16 tensor, on the host, as uint16."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def entry_bytes(bits: np.ndarray) -> bytes:
    """The stored entry of a bfloat16 page."""
    head = np.zeros((), dtype=_HEAD)
    head["name"], head["ndim"], head["magic"] = BF16_NAME, bits.ndim, MAGIC
    dims = np.asarray(bits.shape, dtype="<u8")
    return head.tobytes() + dims.tobytes() + \
        np.ascontiguousarray(bits, dtype="<u2").tobytes()


def parse_entry(raw) -> tuple:
    """-> (element type name, shape, the page's bytes) of a stored entry;
    raises ValueError on a wrong magic or a payload of the wrong size."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    head = buf[:_HEAD.itemsize].view(_HEAD)[0]
    if int(head["magic"]) != MAGIC:
        raise ValueError(f"magic {int(head['magic']):#x}")
    ndim = int(head["ndim"])
    off = _HEAD.itemsize + 8 * ndim
    shape = tuple(int(d) for d in buf[_HEAD.itemsize:off].view("<u8"))
    name = bytes(head["name"]).rstrip(b"\0").decode()
    payload = buf[off:]
    itemsize = 2 if name == BF16_NAME.decode() else np.dtype(name).itemsize
    if payload.size != itemsize * int(np.prod(shape)):
        raise ValueError(f"{payload.size} payload bytes for {shape} of "
                         f"{name}")
    return name, shape, payload


def pool_bits(before: np.ndarray, seed: int, slot_map: dict) -> np.ndarray:
    """The bits a layer-first pool ``(L, P, T, W)`` holds after page
    (session, page) of ``slot_map[slot]`` lands in each slot: ``before``,
    the pool's bits before, in every slot the map leaves out."""
    want = before.copy()
    page_shape = (before.shape[0],) + before.shape[2:]
    for slot, (session, page) in slot_map.items():
        want[:, slot] = page_bits(seed, session, page, page_shape)
    return want
