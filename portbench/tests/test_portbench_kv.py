"""The cell kv-mla-prefix-read: its configuration, traffic and metrics found
by name, its sizes from their sources, the reference of its pages against
pages made by hand, each of its readers on a recorded run, whole runs on
the CPU at a tiny size, and its controls and a planted wrong slot coming
out not correct."""

import json
import struct

import numpy as np
import pytest
import torch

from portbench import harness, spec, trace
from portbench.reference import kv_pages
from portbench.runtime import Record
from portbench.tests.cells import load_cell

CELL = "kv-mla-prefix-read"
CPU = torch.device("cpu")
MS = 1_000_000
GIB = 1 << 30
METRICS = ["read_p95_ms.kvprefix", "fs_read_ms_per_gib.kvprefix",
           "h2d_ms_per_gib.kvprefix", "device_idle.kvprefix"]


def tiny_cell():
    """The cell at a size the CPU runs in a second: 3 layers, 8-token
    pages, 16 slots, prefixes of 4 and 6 pages, 4 KiB shards; the width
    (576) and every count of the mix kept."""
    cell = load_cell(CELL)
    c, t = dict(cell.config), dict(cell.traffic)
    c.update(num_hidden_layers=3, page_tokens=8, pool_slots=16,
             shard_size=4096, chunk_size=12 * 4096)
    t.update(prefix_tokens=[32, 48], turn_tokens=[8, 24])
    cell.config, cell.traffic = c, t
    return cell


def _run(*, control=None, seconds=0.6, seed=2**31 + 3, trace_on=False):
    return harness.run_cell(tiny_cell(), seed, seconds, trace_on, CPU,
                            control=control, log=lambda s: None)


# -- found by name, sized from the sources ------------------------------------

def test_the_cell_is_found_by_name():
    cell = load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic["driver"] == "kv_prefix"
    assert spec.driver("kv_prefix").Driver.unit == "get"
    assert [m["name"] for m in cell.end_to_end] == ["read_gibps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    for m in cell.per_layer:
        assert m["moves"] == "read_gibps" and callable(
            spec.metric_reader(m["name"]))
    bench = json.loads((spec.find_root() / "BENCHMARK.json").read_text())
    cfg = [c for c in bench["configs"] if c["name"] == "kv-dsv3-mla"][0]
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    assert cfg["reduced"] == cell.config["reduced"]


def test_the_configuration_keeps_the_published_widths():
    c = load_cell(CELL).config
    assert (c["num_hidden_layers"], c["kv_lora_rank"],
            c["qk_rope_head_dim"]) == (61, 512, 64)
    assert c["page_tokens"] == 64 and c["kv_dtype"] == "bfloat16"
    assert c["pool_slots"] * c["page_tokens"] == \
        c["max_position_embeddings"] == 163840
    for key in c["reduced"]:
        assert key in c["published"] and key in c["why_reduced"]
    assert not any(k.endswith(("_dim", "_rank", "_size", "_width"))
                   for k in c["reduced"])
    ec = load_cell("ec-degraded-read").config
    for key in ("num_storage_nodes", "num_chains", "ec_k", "ec_m",
                "chunk_size", "shard_size", "engine", "allocator"):
        assert c[key] == ec[key]
    assert len(c["guarantees"]) == 4


def test_the_traffic_sizes_come_from_their_sources():
    cell = load_cell(CELL)
    c, t = cell.config, cell.traffic
    width = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    assert width == 576
    assert c["num_hidden_layers"] * width * 2 == 70272     # a token's cache
    page = c["page_tokens"] * c["num_hidden_layers"] * width * 2
    assert page == 4497408
    assert t["prefix_tokens"] == [16384, 32768]
    pages = [n // c["page_tokens"] for n in t["prefix_tokens"]]
    assert pages == [256, 512]
    assert [n * page / GIB for n in pages] == pytest.approx([1.072, 2.145],
                                                            abs=1e-3)
    entry = page + 40                                       # the header
    shards = -(-entry // c["shard_size"])
    assert shards == 5 and entry <= c["chunk_size"]
    assert [n * shards for n in pages] == [1280, 2560]
    assert sum(pages) * page / GIB == pytest.approx(3.217, abs=1e-3)
    assert c["pool_slots"] * page == 11513364480
    assert t["turn_tokens"] == [1024, 4096] and t["readers"] == 1


# -- the reference against pages made by hand ---------------------------------

def test_entry_bytes_equal_a_header_made_by_hand():
    bits = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
    raw = kv_pages.entry_bytes(bits)
    head = struct.pack("<8sII", b"<V2", 3, 0x4B564131) + \
        struct.pack("<3Q", 2, 3, 4)
    assert len(head) == 40
    assert raw == head + bits.astype("<u2").tobytes()
    name, shape, payload = kv_pages.parse_entry(raw)
    assert (name, shape) == ("<V2", (2, 3, 4))
    assert payload.tobytes() == bits.tobytes()
    with pytest.raises(ValueError):
        kv_pages.parse_entry(raw[:-2])
    with pytest.raises(ValueError):
        kv_pages.parse_entry(bytes(len(raw)))                # a GC'd hole


def test_bf16_bits_by_hand():
    # 1.0 is 0x3F80, -2^-1 is 0xBF00, the largest below 2 is 0x3FFF
    bits = np.array([0x3F80, 0xBF00, 0x3FFF], dtype=np.uint16)
    t = kv_pages.as_bf16(bits)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.0, -0.5, 1.9921875]
    assert np.array_equal(kv_pages.bits_of(t), bits)


def test_pages_are_seeded_finite_and_under_two():
    a = kv_pages.page_bits(2**31 + 9, 1, 3, (2, 4, 576))
    assert np.array_equal(a, kv_pages.page_bits(2**31 + 9, 1, 3, (2, 4, 576)))
    for other in ((2**31 + 10, 1, 3), (2**31 + 9, 0, 3), (2**31 + 9, 1, 4)):
        assert not np.array_equal(a, kv_pages.page_bits(*other, (2, 4, 576)))
    assert not (a & 0x4000).any()
    vals = kv_pages.as_bf16(a).float()
    assert torch.isfinite(vals).all() and vals.abs().max() < 2


def test_pool_bits_by_hand():
    before = np.full((2, 3, 1, 2), 7, dtype=np.uint16)
    want = kv_pages.pool_bits(before, 5, {2: (0, 1)})
    page = kv_pages.page_bits(5, 0, 1, (2, 1, 2))
    assert np.array_equal(want[:, 2], page)
    assert (want[:, :2] == 7).all() and (before == 7).all()


# -- the readers on a recorded run ----------------------------------------------

def _record(spans, before, after, events=None):
    rec = Record(cell=load_cell(CELL), t0=0, t1=1000 * MS, unit="get",
                 spans=spans, before=before, after=after, work={},
                 jobs=spec.kernel_jobs(), hbm_bytes_per_s=3.35e12)
    if events is not None:
        rec.device = {"events": events,
                      "busy_s": trace.busy_s(events, rec.t0, rec.t1),
                      "window_s": (rec.t1 - rec.t0) / 1e9}
    return rec


def test_readers_on_a_recorded_run():
    # 20 gets of 0.5 GiB, the i-th taking 10 (i + 1) ms
    gets = [("get", i * 40 * MS, i * 40 * MS + 10 * (i + 1) * MS, GIB // 2)
            for i in range(20)]
    events = [("Memcpy HtoD (Pinned -> Device)", 100 * MS, 150 * MS),
              ("Memcpy HtoD (Pinned -> Device)", 140 * MS, 160 * MS),
              ("spin_kernel", 2000 * MS, 2001 * MS)]
    rec = _record(gets, {"fs_read_s": 1.0, "h2d_s": 0.5},
                  {"fs_read_s": 6.0, "h2d_s": 1.5}, events)
    read = {m: spec.metric_reader(m)(rec) for m in METRICS}
    assert read["read_p95_ms.kvprefix"] == 190.0   # nearest rank 19 of 20
    assert read["fs_read_ms_per_gib.kvprefix"] == pytest.approx(500.0)
    assert read["h2d_ms_per_gib.kvprefix"] == pytest.approx(100.0)
    assert read["device_idle.kvprefix"] == pytest.approx(94.0)
    assert spec.metric_reader("read_gibps")(rec) == pytest.approx(10.0)


def test_readers_leave_out_what_the_run_lacks():
    """A program without the counters (the parent's), or an untraced run,
    gives no value and raises nothing."""
    rec = _record([("get", 0, MS, 1)], {}, {})
    for m in METRICS[1:]:
        assert spec.metric_reader(m)(rec) is None, m
    assert spec.metric_reader(METRICS[0])(_record([], {}, {})) is None


# -- whole runs on the CPU ------------------------------------------------------

def test_result_line():
    result, checks = _run()
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"read_gibps", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == {
        "failed_calls", "checked_pages", "pages_wrong", "dtype_wrong",
        "prefix_misses", "landed_bytes_unequal", "end_to_end_missing"}
    assert result["checks"]["checked_pages"]["value"] >= 8
    json.dumps(result)


class _FakeTrace:
    def __init__(self, device):
        self.t0 = None

    def start(self):
        import time

        self.t0 = time.perf_counter_ns()

    def stop(self):
        import time

        step = (time.perf_counter_ns() - self.t0) // 10
        return [("Memcpy HtoD (Pinned -> Device)", self.t0 + i * step,
                 self.t0 + i * step + step // 2) for i in range(10)]


def test_traced_line(monkeypatch):
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    result, _ = _run(trace_on=True)
    assert result["correct"] is True
    assert set(result["metrics"]) == set(METRICS)
    assert result["metrics"]["device_idle.kvprefix"]["value"] < 100
    assert result["breakdown"]["device_ops"][0][0].startswith("Memcpy HtoD")


def test_the_sample_draws_from_every_call():
    lines = []
    result, _ = harness.run_cell(tiny_cell(), 17, 1.5, False, CPU,
                                 log=lines.append)
    said = [s for s in lines if s.startswith("# samples:")][0]
    assert "x" in said and result["correct"] is True


@pytest.mark.parametrize("control", ["layer_swap", "zero_pages",
                                     "fp8_pages"])
def test_control_is_not_correct(control):
    result, checks = _run(control=control)
    assert result["correct"] is False
    assert result["checks"]["pages_wrong"]["value"] > 0


def test_controls_leave_the_program_as_it_was():
    from tpu3fs_torch.kvcache import landing

    land = landing.PageLander.land
    _run(control="layer_swap")
    assert landing.PageLander.land is land


def test_a_wrong_slot_is_not_correct(monkeypatch):
    """Every page one slot past the one asked for."""
    from tpu3fs_torch.kvcache import landing

    land = landing.PageLander.land

    def shifted(self, pages, out, slots):
        return land(self, pages, out, [(s + 1) % out.shape[1]
                                       for s in slots])

    monkeypatch.setattr(landing.PageLander, "land", shifted)
    result, _ = _run()
    assert result["correct"] is False
    assert result["checks"]["pages_wrong"]["value"] > 0


def test_a_miss_is_not_correct(monkeypatch):
    """A store that answers the last block of every get as a miss."""
    from tpu3fs_torch.kvcache import KVCacheClient

    get = KVCacheClient.batch_get

    def drop_last(self, keys):
        out = get(self, keys)
        return out[:-1] + [None] if len(keys) > 2 else out

    monkeypatch.setattr(KVCacheClient, "batch_get", drop_last)
    result, _ = _run()
    assert result["correct"] is False
    assert result["checks"]["prefix_misses"]["value"] > 0


def test_a_program_without_the_landing_fails_at_once(monkeypatch):
    """The parent's get_blocks has no dtype, out or slots: set-up stops
    before the cluster is built."""
    from tpu3fs_torch.kvcache import PrefixBlockStore

    def old(self, token_ids, *, count=None, device=None):
        raise AssertionError("not reached")

    monkeypatch.setattr(PrefixBlockStore, "get_blocks", old)
    with pytest.raises(RuntimeError, match="cannot land"):
        _run()


def test_an_unknown_control_is_refused():
    with pytest.raises(ValueError):
        _run(control="no_decode")


@pytest.mark.gpu
def test_controls_on_the_card():
    """The card's run of the tiny cell is correct (the 2-D copies of the
    kernel library land every page), each control's is not."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    card = torch.device("cuda", 0)
    ok, _ = harness.run_cell(tiny_cell(), 11, 1.0, False, card,
                             log=lambda s: None)
    assert ok["correct"] is True, ok["checks"]
    for control in ("layer_swap", "zero_pages", "fp8_pages"):
        bad, _ = harness.run_cell(tiny_cell(), 11, 1.0, False, card,
                                  control=control, log=lambda s: None)
        assert bad["correct"] is False, control
