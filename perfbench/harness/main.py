"""One run of one cell: set-up, the measured window, the reference's
comparison and the result line. See ``perfbench/README.md``."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "nesie_tpu")
# the part of a traced run's window under the profiler: a quarter, at
# most PROFILED_MAX_S (the trace of a longer part takes long to reduce)
PROFILED_SHARE = 0.25
PROFILED_MAX_S = 3.0
WINDOW_LABEL = "perfbench.window"


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def load_kind(name: str):
    return importlib.import_module(f"perfbench.harness.kinds.{name}").Kind


def load_metric(bench, name: str):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The end-to-end metrics (``trace`` False) or per-layer metrics of a
    cell: those that list it, and those that list no cells and move an
    end-to-end metric it reports."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def window(kind, seconds: float, label: str | None = None):
    """Units back to back until ``seconds`` have passed, then a
    synchronize: (units, wall seconds)."""
    import torch

    t0 = time.perf_counter()
    n = 0
    while True:
        if label:
            with torch.profiler.record_function(label):
                kind.run_unit()
        else:
            kind.run_unit()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    kind.sync()
    return n, time.perf_counter() - t0


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def measure(cell, spec, seconds: float, trace: bool, started,
            log=print) -> dict:
    """Set-up, window and comparison of ``cell`` on its device; returns
    the result dict (without ``device``'s card fields) and the checks."""
    import torch

    from perfbench.harness import trace as tracing
    from perfbench.harness.cell import BENCH
    from perfbench.harness.spans import Spans

    kind = load_kind(cell.traffic["kind"])(cell)
    cuda = cell.device.type == "cuda"
    kind.setup()
    kind.sync()
    setup_s = started()
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    wanted = cell_metrics(spec, cell.name, trace)
    metrics, extra = {}, {}
    if not trace:
        units, wall = window(kind, seconds)
        values = dict(kind.window_metrics(units, wall), setup_s=setup_s)
        log(f"[window] {units} x {kind.unit} in {wall:.6f} s; set-up "
            f"{setup_s:.6f} s")
    else:
        readers = {m["name"]: load_metric(BENCH, m["name"]) for m in wanted}
        spans = Spans(cell.device)
        placed = set()
        for r in readers.values():
            for w in getattr(r, "WRAPS", ()):
                key = (w["module"], w["attr"])
                if key not in placed:
                    placed.add(key)
                    spans.wrap(w["module"], w["attr"], w["span"],
                               w.get("clock", "cuda"), w.get("measure"))
        kind.spans = spans
        t1 = seconds - min(seconds * PROFILED_SHARE, PROFILED_MAX_S)
        units, wall = window(kind, t1)
        kind.spans = None
        spans.restore()
        span_rows = spans.results()
        log(f"[window] spans part: {units} x {kind.unit} in {wall:.6f} s; "
            f"set-up {setup_s:.6f} s")
        for name, why in spans.missing.items():
            log(f"[spans] {name} not placed: {why}")
        timeline = None
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(WINDOW_LABEL):
                    units2, wall2 = window(kind, seconds - t1,
                                           f"perfbench.{kind.unit}")
                t0 = time.perf_counter()
            log(f"[trace] profiler stopped in {time.perf_counter() - t0:.3f} "
                "s")
            t0 = time.perf_counter()
            timeline = tracing.from_profiler(prof, WINDOW_LABEL)
            log(f"[trace] reduced in {time.perf_counter() - t0:.3f} s")
            log(f"[window] profiled part: {units2} x {kind.unit} in "
                f"{wall2:.6f} s, device busy {timeline['busy_s']:.6f} s of "
                f"{timeline['window_s']:.6f} s")
            extra["breakdown"] = dict(device_ops=timeline["device_ops"],
                                      idle_gaps=timeline["idle_gaps"])
            extra["busy_s"] = timeline["busy_s"]
            extra["window_s"] = timeline["window_s"]
        ctx = dict(cell=cell, spans=span_rows, missing=spans.missing,
                   units=units, wall_s=wall, timeline=timeline, log=log)
        values = {}
        for name, r in readers.items():
            t0 = time.perf_counter()
            v = r.read(ctx)
            log(f"[metric] {name} read in {time.perf_counter() - t0:.3f} s")
            if v is None:
                log(f"[metric] {name}: nothing to read, left out")
            else:
                values[name] = v
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    units_for = {m["name"]: m["unit"] for m in wanted}
    for name in units_for:
        if name in values:
            metrics[name] = dict(value=values[name], unit=units_for[name])
    attempted, failed = kind.outcome()
    for line in kind.notes():
        log(f"[traffic] {line}")
    if cuda:
        from nesie_tpu_torch.ops._build import launch_counts
        log(f"[launches] {launch_counts()}")
    kind.free()
    t0 = time.perf_counter()
    numbers = kind.numbers(kind.reference())
    log(f"[reference] compared in {time.perf_counter() - t0:.3f} s")
    limits = cell.limits["checks"]
    # a number that could not be formed (a shape that differs, a value
    # that is not finite) reads as the largest float, which no limit takes
    checks = {k: dict(value=(float(numbers[k]) if math.isfinite(numbers[k])
                             else sys.float_info.max),
                      limit=float(limits[k])) for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return dict(correct=bool(ok and attempted > 0 and failed == 0),
                attempted=attempted, failed=failed, metrics=metrics,
                peak=peak, checks=checks, **extra)


def result_line(res: dict, device: dict, trace: bool) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` in a traced
    run), ``breakdown`` in a traced run, and the compared numbers with
    their limits last."""
    device = dict(device)
    if trace and "busy_s" in res:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    out = dict(correct=res["correct"], attempted=res["attempted"],
               failed=res["failed"], metrics=res["metrics"], device=device)
    if trace and "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness.cell import Cell, find, load_spec

    spec = load_spec()
    entry, _ = find(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count="
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = Cell.load(args.workload, args.seed, dev)
    if cell.cfg["dtype"] != "float32" or cell.cfg["tf32"]:
        raise SystemExit("this harness runs float32 with TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = measure(cell, spec, args.seconds, bool(args.trace), process_age_s,
                  log=lambda s: print(s, flush=True))
    print(f"[device] {torch.cuda.get_device_name(dev)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {process_age_s():.3f} s since the process "
          f"started", flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                  count=entry["chips"], memory_peak_bytes=int(res["peak"]))
    out = result_line(res, device, bool(args.trace))
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
