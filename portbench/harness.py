"""One run of one cell: set-up, a measured window, the comparison that
decides ``correct``, and the result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The run refuses without as many CUDA cards as the cell asks for (exit 2),
without the program ``tpu3fs_torch`` (exit 3), and with JAX or the JAX
package loaded once the window has closed (exit 4); it then prints no
result. Otherwise the last line of standard output is one JSON object, and
the last lines of standard error are the numbers compared, each beside its
limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import threading
import time
from pathlib import Path

from portbench import allocator, hostinfo, spec
from portbench.runtime import Check, Context, Record, SpanLog

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3fs")
GIB = float(1 << 30)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="plant a control or fault (control runs only)")
    return p.parse_args(argv)


def process_elapsed_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])          # field 22 of stat(5)
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path) -> None:
    """Every compile cache at a fixed path inside the checkout."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def run_window(drv, spans: SpanLog, seconds: float) -> tuple:
    """Start the driver's workers together, stop issuing at the deadline,
    wait for every call in flight. -> (t0, t_last) in perf_counter_ns."""
    go = threading.Event()
    clock = {}
    errors = []

    def body(i):
        go.wait()
        try:
            drv.worker(i, clock["deadline"])
        except BaseException as e:  # reported after the join
            errors.append((i, e))
            raise

    threads = [threading.Thread(target=body, args=(i,), name=f"pb-{i}")
               for i in range(drv.workers)]
    for t in threads:
        t.start()
    t0 = time.perf_counter_ns()
    clock["deadline"] = t0 + int(seconds * 1e9)
    go.set()
    for t in threads:
        t.join(timeout=seconds + 600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a worker did not finish within 600 s of the "
                           "deadline")
    if errors:
        i, e = errors[0]
        raise RuntimeError(f"worker {i} failed: {e!r}") from e
    done = spans.named(drv.unit)
    t_last = max((s[2] for s in done), default=time.perf_counter_ns())
    return t0, t_last


class _GcWatch:
    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, 0.0

    def callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t


def watch_gc() -> _GcWatch:
    """Count Python's collections and the time they take from now on."""
    w = _GcWatch()
    gc.callbacks.append(w.callback)
    return w


def timeline(rec: Record, bucket_s: float) -> list:
    """Bytes done in each ``bucket_s`` of the window, by completion time."""
    n = max(1, int((rec.t1 - rec.t0) / 1e9 / bucket_s) + 1)
    out = [0] * n
    for s in rec.done():
        out[min(n - 1, int((s[2] - rec.t0) / 1e9 / bucket_s))] += s[3]
    return out


def read_metrics(entries: list, rec: Record) -> dict:
    """Each entry's ``metrics/<name>.py`` on the record; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             control=None, setup_origin=None, log=print) -> tuple:
    """Run one cell on ``device``. -> (result dict, checks). The caller
    has checked for the card; tests call this with the CPU."""
    import torch

    from portbench.trace import DeviceTrace, busy_s, idle_gaps, top_ops

    if setup_origin is None:
        setup_origin = (time.perf_counter(), process_elapsed_s())
    mod = spec.driver(cell.traffic["driver"])
    spans = SpanLog()
    ctx = Context(cell=cell, seed=seed, device=device, spans=spans, log=log,
                  control=control)
    drv = mod.Driver(ctx)
    try:
        drv.setup()
        drv.begin_window()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gc.collect()
        tracer = DeviceTrace(device) if trace else None
        if tracer is not None:
            tracer.start()
        spans.clear()
        gc_pause = watch_gc()
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        before = drv.counters()
        t0, t_last = run_window(drv, spans, seconds)
        after = drv.counters()
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(gc_pause.callback)
        events = tracer.stop() if tracer is not None else None
        setup_s = setup_origin[1] + (t0 / 1e9 - setup_origin[0])
        bad = forbidden_modules()
        if bad:
            raise ForbiddenModules(bad)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        rec = Record(cell=cell, t0=t0, t1=t_last, unit=drv.unit,
                     spans=list(spans.spans), before=before, after=after,
                     work={}, jobs=spec.kernel_jobs(),
                     hbm_bytes_per_s=(spec.peak(name, "hbm_bytes_per_s")
                                      if device.type == "cuda" else 0.0))
        rec.work = drv.work(rec)
        rec.setup_s = setup_s
        done = rec.done()
        failed = len(spans.named(drv.unit + ".failed"))
        log(f"# window: {seconds} s asked, {(t_last - t0) / 1e9:.6f} s to "
            f"the last completion; {len(done)} calls done, {failed} failed, "
            f"{rec.done_bytes} bytes")
        for line in drv.sample_lines(rec):
            log("# samples: " + line)
        log("# host in the window: " + ", ".join(
            f"{k} {getattr(use1, 'ru_' + k) - getattr(use0, 'ru_' + k):.6g}"
            for k in ("utime", "stime", "minflt", "majflt", "nvcsw",
                      "nivcsw"))
            + f"; gc {gc_pause.count} collections, {gc_pause.seconds:.3f} s")
        log("# timeline: GiB done in each 5 s of the window: " + " ".join(
            f"{b / GIB:.3f}" for b in timeline(rec, 5.0)))
        dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": name, "count": cell.chips,
               "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": len(done) + failed,
                  "failed": failed, "metrics": {}, "device": dev}
        if trace:
            window_s = (t_last - t0) / 1e9
            rec.device = {"events": events,
                          "busy_s": busy_s(events, t0, t_last),
                          "window_s": window_s}
            dev["busy_s"] = rec.device["busy_s"]
            dev["window_s"] = window_s
            result["metrics"] = read_metrics(cell.per_layer, rec)
            result["breakdown"] = {
                "device_ops": top_ops(events, t0, t_last),
                "idle_gaps": idle_gaps(events, rec.spans, t0, t_last)}
        else:
            result["metrics"] = read_metrics(cell.end_to_end, rec)
        log(f"# setup_s {setup_s}")
        checks = drv.check(rec)
        if not trace:  # a window with nothing done has no rate to report
            checks.append(Check("end_to_end_missing", len(
                [m for m in cell.end_to_end
                 if m["name"] not in result["metrics"]]), 0))
    finally:
        drv.close()
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    result["correct"] = bool(checks) and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "op": c.op} for c in checks}
    return result, checks


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"loaded: {', '.join(names)}")
        self.names = names


def main(argv=None, setup_origin=None) -> int:
    if setup_origin is None:
        setup_origin = (time.perf_counter(), process_elapsed_s())
    args = parse(sys.argv[1:] if argv is None else argv)
    root = spec.find_root()
    cell = spec.load_cell(args.workload, root)
    set_cache_dirs(root)
    os.environ["USE_FLAX"] = "0"
    # the storage engines' preallocated memory, as a storage node holds its
    # block pools before it serves (the program reads it at bring-up)
    os.environ["TPU3FS_MEM_PREALLOC_MB"] = str(
        int(cell.traffic.get("engine_prealloc_mb", 0)))
    import torch

    print(f"# start: torch imported {process_elapsed_s():.3f} s after the "
          "process started", flush=True)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 2
    # the deployment's allocator, set before the program and its threads
    for line in allocator.apply(cell.config.get("allocator", {})):
        print("# allocator: " + line, flush=True)
    try:
        import tpu3fs_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"portbench: the program is not importable: {e}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.init()
    print(f"# start: card and program ready {process_elapsed_s():.3f} s "
          "after the process started", flush=True)
    for line in hostinfo.lines():
        print("# host: " + line, flush=True)
    try:
        result, checks = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device,
                                  control=args.control,
                                  setup_origin=setup_origin,
                                  log=lambda s: print(s, flush=True))
    except ForbiddenModules as e:
        print(f"portbench: refused, {e}", file=sys.stderr)
        return 4
    for line in hostinfo.lines(card_only=True):
        print("# after: " + line, flush=True)
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.op} {c.limit}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
