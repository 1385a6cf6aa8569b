"""Every per-layer reader, and the trace arithmetic, on a recorded run."""

import pytest

from portbench import spec, trace
from portbench.runtime import Record
from portbench.tests.cells import load_cell

GIB = 1 << 30
MS = 1_000_000


def _record(cell_name, unit, spans, before, after, work=None, events=None):
    cell = load_cell(cell_name)
    rec = Record(cell=cell, t0=0, t1=1000 * MS, unit=unit, spans=spans,
                 before=before, after=after, work=work or {},
                 jobs=spec.kernel_jobs(), hbm_bytes_per_s=3.35e12)
    if events is not None:
        rec.device = {"events": events,
                      "busy_s": trace.busy_s(events, rec.t0, rec.t1),
                      "window_s": (rec.t1 - rec.t0) / 1e9}
    return rec


def _read(name, rec):
    return spec.metric_reader(name)(rec)


# 20 writes of 1 GiB, the i-th taking i+1 ms; a create and a close a file
WRITES = [("write", i * 40 * MS, i * 40 * MS + (i + 1) * MS, GIB)
          for i in range(20)]
META = [("meta.create", 0, 2 * MS, 0), ("meta.close", 3 * MS, 4 * MS, 0),
        ("meta.create", 5 * MS, 6 * MS, 0), ("meta.close", 7 * MS, 9 * MS, 0)]
# the card: an encode kernel 10 ms, a checksum kernel 20 ms, a copy 70 ms
EVENTS = [("void gf2_mma_kernel<true>(...)", 100 * MS, 110 * MS),
          ("crc32c_mma_kernel(...)", 105 * MS, 125 * MS),
          ("Memcpy DtoH (Device -> Pageable)", 300 * MS, 370 * MS),
          ("spin_kernel", 2000 * MS, 2001 * MS)]


def test_write_cell_readers():
    rec = _record("ec-write", "write", WRITES + META,
                  {"launches": 10, "encode_s": 1.0},
                  {"launches": 2810, "encode_s": 3.0},
                  work={"encode": 16 * 1e9, "checksum": 32 * 1e9},
                  events=EVENTS)
    assert _read("write_p95_ms.write", rec) == 19.0   # nearest rank 19 of 20
    assert _read("meta_ms_per_file.write", rec) == pytest.approx(3.0)
    assert _read("launches_per_gib.write", rec) == pytest.approx(140.0)
    assert _read("encode_ms_per_gib.write", rec) == pytest.approx(100.0)
    # 16 GB at 3.35 TB/s is 4.776 ms, in 10 ms of encode kernels
    assert _read("encode_roofline.write", rec) == pytest.approx(
        100 * 16e9 / 3.35e12 / 0.010)
    assert _read("crc_roofline.write", rec) == pytest.approx(
        100 * 32e9 / 3.35e12 / 0.020)
    # busy: 100-125 and 300-370 ms of the 1 s window
    assert _read("device_idle.write", rec) == pytest.approx(90.5)


def test_readers_leave_out_what_the_run_lacks():
    rec = _record("ec-write", "write", [], {}, {})
    for name in ("write_p95_ms.write", "meta_ms_per_file.write",
                 "launches_per_gib.write", "encode_ms_per_gib.write",
                 "encode_roofline.write", "crc_roofline.write",
                 "device_idle.write"):
        assert _read(name, rec) is None, name
    # traced, but no kernel of the job ran: no roofline, never 0
    rec = _record("ec-write", "write", WRITES, {}, {},
                  work={"encode": 1e9}, events=EVENTS[2:3])
    assert _read("encode_roofline.write", rec) is None


def test_degraded_readers():
    stripe = 12 << 20
    reads = [("read", 0, 10 * MS, 4 * stripe), ("read", 0, 20 * MS,
                                               4 * stripe)]
    rec = _record("ec-degraded-read", "read", reads, {"degraded_stripes": 2},
                  {"degraded_stripes": 8},
                  work={"decode": 8 * 13 * (1 << 20)},
                  events=[("xor_reduce_kernel<uint4>", 0, 5 * MS)])
    assert _read("degraded_share.degraded", rec) == pytest.approx(75.0)
    assert _read("read_p95_ms.degraded", rec) == 20.0
    assert _read("decode_roofline.degraded", rec) == pytest.approx(
        100 * 8 * 13 * (1 << 20) / 3.35e12 / 0.005)


def test_end_to_end_readers():
    """A rate is every byte done over the window to the last completion;
    setup_s is the record's."""
    rec = _record("ec-write", "write", WRITES, {}, {})
    rec.setup_s = 17.5
    assert _read("write_gibps", rec) == pytest.approx(20.0)  # 20 GiB in 1 s
    assert _read("setup_s", rec) == 17.5
    reads = [("read", 0, 500 * MS, GIB), ("read", 0, 900 * MS, GIB)]
    rec = _record("ec-degraded-read", "read", reads, {}, {})
    assert _read("read_gibps", rec) == pytest.approx(2.0)
    rec = _record("ec-degraded-read", "read", [], {}, {})
    assert _read("read_gibps", rec) is None


def test_trace_arithmetic():
    ev = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 95, 130)]
    assert trace.busy_intervals(ev, 0, 100) == [(0, 20), (30, 40), (95, 100)]
    assert trace.busy_s(ev, 0, 100) == pytest.approx(35e-9)
    assert trace.top_ops(ev, 0, 100) == [["a", 20e-9], ["b", 15e-9],
                                         ["c", 5e-9]]
    assert trace.job_seconds(ev, ["a", "c"], 0, 100) == pytest.approx(25e-9)
    spans = [("write", 0, 25, 0), ("write", 10, 60, 0), ("close", 35, 50, 0)]
    # gaps 20-30 (write), 40-95 (middle 67: none)
    assert trace.idle_gaps(ev, spans, 0, 100) == [["none", 55e-9],
                                                  ["write", 10e-9]]
    spans.append(("close", 60, 80, 0))
    assert trace.idle_gaps(ev, spans, 0, 100)[0] == ["close", 55e-9]
