"""DeepSeek-V3's MLA KV pages (bfloat16, page-first ``(layers, tokens,
576)``) through the port's prefix-block store on ``Fabric(device="cpu")``,
held bit for bit against the plain reference
(``tests/torch_kv_mla_reference.py``): the entries as stored, blocks read
under a declared ``torch.bfloat16``, pages landed into a layer-first pool
by slot (through the staging of ``kvcache/landing.py``), pages the JAX
package wrote with ``ml_dtypes.bfloat16`` landing as the same bits, a GC'd
page a miss that leaves its slot as it was, the pool's mismatches raising
INVALID_ARG before anything lands, and the spans and counters of the
hand-off. At a small size: 3 layers, 8-token pages, the published width
576 = kv_lora_rank 512 + qk_rope_head_dim 64. Tolerance 0."""

import ast
from pathlib import Path
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

import torch_kv_mla_reference as ref
import tpu3fs.fabric as jax_fabric
import tpu3fs.kvcache as jax_kvcache
import tpu3fs.kvcache.layout as jax_layout
from test_torch_convert import _dump
from torch_fabric_sequence import deterministic
from tpu3fs_torch import convert, kvcache
from tpu3fs_torch.analytics import spans
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.kvcache import landing
from tpu3fs_torch.utils.result import Code, FsError

ROOT = Path(__file__).resolve().parents[1]
L, T, W = 3, 8, 576
SHAPE = (L, T, W)
PAGE_BYTES = 2 * L * T * W
SEED = 2**31 + 17
PAGES = (4, 6)          # pages of session 0 and 1
SLOTS = 16
CFG = dict(num_storage_nodes=4, num_chains=2, chunk_size=12 * 4096, ec_k=12,
           ec_m=4)


def _tokens(session: int, pages: int) -> list:
    rng = np.random.default_rng([SEED, 1, session])
    return rng.integers(0, 129280, pages * T).tolist()


def _pages(session: int, n: int) -> list:
    return [ref.page_bits(SEED, session, p, SHAPE) for p in range(n)]


def _before(seed: int = 5) -> np.ndarray:
    """A pool's bits before a landing: seeded, so an untouched slot shows."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, (L, SLOTS, T, W), dtype=np.uint16)
    return bits & np.uint16(0xBFFF)


def _pool(before: np.ndarray) -> torch.Tensor:
    return ref.as_bf16(before.copy())


@pytest.fixture(scope="module")
def world():
    fab = Fabric(SystemSetupConfig(**CFG), device="cpu")
    cache = kvcache.KVCacheClient(fab.meta, fab.file_client(),
                                  inode_cache=64)
    store = kvcache.PrefixBlockStore(cache, block_tokens=T)
    toks = [_tokens(s, n) for s, n in enumerate(PAGES)]
    for s, n in enumerate(PAGES):
        store.append_blocks(toks[s], [ref.as_bf16(b) for b in _pages(s, n)])
    yield SimpleNamespace(fab=fab, cache=cache, store=store, toks=toks)
    fab.close()


@pytest.mark.parametrize("session", [0, 1])
def test_entries_are_the_reference_and_jax_bytes(world, session):
    """Stored entries: the reference's header and bits, and what the JAX
    package's encoder writes for the same ``ml_dtypes.bfloat16`` page."""
    keys = world.store.block_keys(world.toks[session])
    assert len(keys) == PAGES[session]
    for key, bits in zip(keys, _pages(session, PAGES[session])):
        raw = world.cache.get(key)
        assert raw == ref.entry_bytes(bits)
        assert raw == jax_layout.encode_array(bits.view(ml_dtypes.bfloat16))
        name, shape, payload = ref.parse_entry(raw)
        assert (name, shape, len(raw) - payload.size) == ("<V2", SHAPE, 40)


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("session", [0, 1])
def test_blocks_under_declared_bfloat16(world, session, device):
    got = world.store.get_blocks(world.toks[session], device=device,
                                 dtype=torch.bfloat16)
    assert len(got) == PAGES[session]
    for blk, bits in zip(got, _pages(session, PAGES[session])):
        assert blk.dtype == torch.bfloat16 and tuple(blk.shape) == SHAPE
        assert np.array_equal(ref.bits_of(blk), bits)


def _slot_maps() -> dict:
    n = PAGES[1]
    return {"ring_wrap": [(SLOTS - 2 + i) % SLOTS for i in range(n)],
            "scattered": [int(s) for s in
                          np.random.default_rng(2).permutation(SLOTS)[:n]],
            "descending": list(range(n + 3, 3, -1))}


@pytest.mark.parametrize("stage_pages", [1, 2, 32])
@pytest.mark.parametrize("slots", sorted(_slot_maps()))
def test_pool_landing_equals_the_reference(world, slots, stage_pages,
                                           monkeypatch):
    """Every page in every layer of its slot, every other slot as it was;
    staging of 1 and 2 pages makes each page, and each pair, a chunk of
    its own (runs split at chunk edges, both buffers reused)."""
    monkeypatch.setattr(landing, "STAGE_PAGES", stage_pages)
    slot_list = _slot_maps()[slots]
    before = _before()
    pool = _pool(before)
    got = world.store.get_blocks(world.toks[1], device="cpu",
                                 dtype=torch.bfloat16, out=pool,
                                 slots=slot_list)
    assert got == slot_list
    want = ref.pool_bits(before, SEED, {s: (1, p)
                                        for p, s in enumerate(slot_list)})
    assert np.array_equal(ref.bits_of(pool), want)


def test_count_and_repeat_lands_a_prefix(world):
    before = _before(6)
    pool = _pool(before)
    toks = world.toks[0] + [7] * (3 * T + 5)   # a new turn: never stored
    match = world.store.match_prefix(toks)
    assert match.blocks == PAGES[0]
    for slots in ([0, 1, 2, 3], [9, 10, 11, 12]):
        got = world.store.get_blocks(toks, count=match.blocks, out=pool,
                                     dtype=torch.bfloat16, slots=slots)
        assert got == slots
    want = ref.pool_bits(before, SEED, {s: (0, p % 4) for p, s in
                                        enumerate([0, 1, 2, 3, 9, 10, 11,
                                                   12])})
    assert np.array_equal(ref.bits_of(pool), want)


@pytest.fixture(scope="module")
def from_jax():
    """Pages the JAX package wrote (``ml_dtypes.bfloat16``), dumped and
    loaded into the port's fabric."""
    toks = _tokens(0, PAGES[0])
    with deterministic(seed=4):
        jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**CFG))
        jstore = jax_kvcache.PrefixBlockStore(
            jax_kvcache.KVCacheClient(jfab.meta, jfab.file_client()),
            block_tokens=T)
        jstore.append_blocks(toks, [b.view(ml_dtypes.bfloat16)
                                    for b in _pages(0, PAGES[0])])
        dump = _dump(jfab)
    fab = convert.fabric_from_dump(dump, SystemSetupConfig(**CFG),
                                   device="cpu")
    store = kvcache.PrefixBlockStore(
        kvcache.KVCacheClient(fab.meta, fab.file_client()), block_tokens=T)
    yield SimpleNamespace(store=store, toks=toks)
    fab.close()
    jfab.close()


@pytest.mark.parametrize("how", ["pool", "blocks"])
def test_jax_written_pages_land_as_the_same_bits(from_jax, how):
    want = _pages(0, PAGES[0])
    if how == "blocks":
        got = from_jax.store.get_blocks(from_jax.toks, device="cpu",
                                        dtype=torch.bfloat16)
        assert all(np.array_equal(ref.bits_of(b), w)
                   for b, w in zip(got, want))
        return
    before = _before(7)
    pool = _pool(before)
    slots = [5, 6, 7, 8]
    assert from_jax.store.get_blocks(from_jax.toks, dtype=torch.bfloat16,
                                     out=pool, slots=slots) == slots
    assert np.array_equal(ref.bits_of(pool), ref.pool_bits(
        before, SEED, {s: (0, p) for p, s in enumerate(slots)}))


@pytest.mark.parametrize("lost", [0, 2, 5])
def test_gcd_page_is_a_miss_and_leaves_its_slot(lost):
    """A page whose entry the GC removed, read through the reader's cached
    inode, reads back as holes (KVCACHE_STALE): the store re-probes, finds
    it gone and reports a miss, never zeros; its slot keeps its bits."""
    fab = Fabric(SystemSetupConfig(**CFG), device="cpu")
    try:
        cache = kvcache.KVCacheClient(fab.meta, fab.file_client(),
                                      inode_cache=64)
        store = kvcache.PrefixBlockStore(cache, block_tokens=T)
        toks = _tokens(1, PAGES[1])
        store.append_blocks(toks, [ref.as_bf16(b)
                                   for b in _pages(1, PAGES[1])])
        slots = list(range(PAGES[1]))
        store.get_blocks(toks, dtype=torch.bfloat16,
                         out=_pool(_before()), slots=slots)  # inodes cached
        gc = kvcache.KVCacheClient(fab.meta, fab.file_client())
        assert gc.remove(store.block_keys(toks)[lost])
        assert fab.run_gc() >= 1
        before = _before(8)
        pool = _pool(before)
        got = store.get_blocks(toks, dtype=torch.bfloat16, out=pool,
                               slots=slots)
        assert got == [None if p == lost else p for p in slots]
        want = ref.pool_bits(before, SEED, {p: (1, p) for p in slots
                                            if p != lost})
        assert np.array_equal(ref.bits_of(pool), want)
        assert store.match_prefix(toks).blocks == lost
    finally:
        fab.close()


def _mismatch(case: str, pool: torch.Tensor) -> dict:
    """get_blocks keywords for each way a landing does not fit."""
    n = PAGES[0]
    kw = dict(dtype=torch.bfloat16, out=pool, slots=list(range(n)))
    bad_pool = {
        "layers": (L + 1, SLOTS, T, W), "tokens": (L, SLOTS, T + 1, W),
        "width": (L, SLOTS, T, W - 64), "rank": (L * SLOTS * T * W,)}
    if case in bad_pool:
        kw["out"] = torch.zeros(bad_pool[case], dtype=torch.bfloat16)
    elif case == "pool_dtype":
        kw["out"] = torch.zeros(pool.shape, dtype=torch.float16)
    elif case == "declared_dtype":
        kw["dtype"] = torch.float16
    elif case == "not_contiguous":
        kw["out"] = torch.zeros((SLOTS, L, T, W),
                                dtype=torch.bfloat16).transpose(0, 1)
    elif case == "slot_count":
        kw["slots"] = list(range(n - 1))
    elif case == "slot_range":
        kw["slots"] = [0, 1, 2, SLOTS]
    elif case == "slot_repeat":
        kw["slots"] = [0, 1, 1, 2]
    elif case == "no_slots":
        del kw["slots"]
    elif case == "no_pool":
        del kw["out"]
    elif case == "device":
        kw["device"] = "meta"
    return kw


MISMATCHES = ["layers", "tokens", "width", "rank", "pool_dtype",
              "declared_dtype", "not_contiguous", "slot_count", "slot_range",
              "slot_repeat", "no_slots", "no_pool", "device"]


@pytest.mark.parametrize("case", MISMATCHES)
def test_pool_mismatch_raises_invalid_arg(world, case):
    before = _before(9)
    pool = _pool(before)
    kw = _mismatch(case, pool)
    with pytest.raises(FsError) as e:
        world.store.get_blocks(world.toks[0], **kw)
    assert e.value.code == Code.INVALID_ARG
    assert np.array_equal(ref.bits_of(pool), before)  # nothing landed


@pytest.mark.parametrize("how", ["device", "pool"])
def test_undeclared_bfloat16_page_raises_type_error(world, how):
    """Without a declared type a ``<V2`` page cannot become a tensor, as
    before: the element type is not in the entry."""
    kw = ({"device": "cpu"} if how == "device" else
          {"out": _pool(_before()), "slots": list(range(PAGES[0]))})
    with pytest.raises(TypeError):
        world.store.get_blocks(world.toks[0], **kw)


@pytest.fixture
def tracer():
    old = spans._TRACER
    spans._TRACER = spans.Tracer()
    try:
        yield spans._TRACER
    finally:
        spans._TRACER = old


@pytest.mark.parametrize("how", ["pool", "device"])
def test_spans_and_counters_of_the_hand_off(world, tracer, how):
    store = world.store
    pages0, bytes0 = store.pages_landed.total, store.page_bytes_landed.total
    stage0 = dict(store.stage_s)
    tracer.configure(memory=True, sample_rate=1.0)
    toks = world.toks[1]
    match = store.match_prefix(toks)
    kw = ({"out": _pool(_before()), "slots": list(range(match.blocks))}
          if how == "pool" else {"device": "cpu"})
    store.get_blocks(toks, count=match.blocks, dtype=torch.bfloat16, **kw)
    events, dropped = tracer.drain()
    assert dropped == 0
    ops = {(ev.op, ev.stage) for ev in events}
    assert ops == {("kvcache.match_prefix", ""), ("kvcache.get_blocks", ""),
                   ("kvcache.get_blocks", "fs_read"),
                   ("kvcache.get_blocks", "decode"),
                   ("kvcache.get_blocks", "h2d")} | {
        (op, st) for op, st in ops if not op.startswith("kvcache.")}
    op_span = [ev for ev in events if ev.op == "kvcache.get_blocks"
               and not ev.stage][0]
    for ev in events:
        if ev.op == "kvcache.get_blocks" and ev.stage:
            assert ev.parent_id == op_span.span_id and ev.t_ns > 0
    assert store.pages_landed.total - pages0 == PAGES[1]
    assert store.page_bytes_landed.total - bytes0 == PAGES[1] * PAGE_BYTES
    assert set(store.stage_s) == {"fs_read", "decode", "copy"}
    assert all(store.stage_s[k] > stage0[k] for k in stage0)


def test_host_blocks_count_nothing_landed(world):
    store = world.store
    before = (store.pages_landed.total, store.page_bytes_landed.total)
    store.get_blocks(world.toks[0], dtype=torch.bfloat16)
    store.get_blocks(world.toks[0])
    assert (store.pages_landed.total, store.page_bytes_landed.total) == \
        before


@pytest.mark.parametrize("slots, want", [
    ([], []), ([3], [(0, 3, 1)]), ([0, 1, 2], [(0, 0, 3)]),
    ([14, 15, 0, 1], [(0, 14, 2), (2, 0, 2)]),
    ([5, 4, 3], [(0, 5, 1), (1, 4, 1), (2, 3, 1)]),
    ([1, 2, 7, 8, 9, 3], [(0, 1, 2), (2, 7, 3), (5, 3, 1)]),
])
def test_landing_runs(slots, want):
    assert landing.runs(slots) == want


def test_the_two_reference_copies_are_one_code():
    """The tests' reference and the benchmark's are the same module, and
    import neither JAX nor anything of the program."""
    ours = ROOT / "tests" / "torch_kv_mla_reference.py"
    bench = ROOT / "portbench" / "reference" / "kv_pages.py"
    assert ours.read_text() == bench.read_text()
    tree = ast.parse(ours.read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch"}


@pytest.mark.parametrize("page", [0, 1, 255])
def test_reference_page_bits_are_finite_and_seeded(page):
    bits = ref.page_bits(SEED, 1, page, SHAPE)
    assert bits.dtype == np.uint16 and bits.shape == SHAPE
    vals = ref.as_bf16(bits).float()
    assert torch.isfinite(vals).all() and vals.abs().max() < 2
    assert np.array_equal(bits, ref.page_bits(SEED, 1, page, SHAPE))
    assert not np.array_equal(bits, ref.page_bits(SEED + 1, 1, page, SHAPE))
    assert not np.array_equal(bits, ref.page_bits(SEED, 0, page, SHAPE))


def test_staging_is_reused_across_threads():
    """A landing on another thread takes the staging the last one gave
    back; a larger page replaces it."""
    import threading

    lander = landing.PageLander()
    pages = [ref.as_bf16(b) for b in _pages(1, 2)]
    pool = _pool(_before())
    lander.land(pages, pool, [0, 1])
    (st,) = lander._free
    t = threading.Thread(target=lander.land, args=(pages, pool, [2, 3]))
    t.start()
    t.join()
    assert lander._free == [st]
    wide = torch.zeros((L, SLOTS, 2 * T, W), dtype=torch.bfloat16)
    lander.land([torch.zeros((L, 2 * T, W), dtype=torch.bfloat16)], wide,
                [0])
    assert len(lander._free) == 1 and lander._free[0] is not st
    assert np.array_equal(ref.bits_of(pool), ref.pool_bits(
        _before(), SEED, {s: (1, s % 2) for s in range(4)}))
