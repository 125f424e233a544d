#!/usr/bin/env python3
"""The FPS step-variant lab: the step bodies of the TPU lab
``tools/fps_lab.py`` as CUDA kernels on the shipped FPS's on-chip frame,
held to ``fps_ref`` and timed.

    python3 -m nesie_tpu_torch.tools.fps_lab check [--device cpu]
    python3 -m nesie_tpu_torch.tools.fps_lab bench
    python3 -m nesie_tpu_torch.tools.fps_lab sass [--json-out PATH]

``check`` holds each variant of ``LAB_VARIANTS`` to ``fps_ref`` on a
random cloud and a tie-heavy one (40 distinct points tiled to N), at
B=3, N=600, M=37, on the card; ``--device cpu`` runs the variants' plain
versions instead, and is the only way to the CPU. ``bench`` needs the
card: at B=8, N=40000, M=2048, uniform in [0, 1)^3, it checks and times
``v0_current``, the shipped FPS (the dispatch
``ops.pointops.furthest_point_sample``, i.e. ``csrc/fps_onchip.cu``),
each variant and ``v0_current`` again at the end, and prints one JSON
line each: ``{variant, ms, exact, us_per_step}`` and, for a variant, its
plan (``ops.fps_variants.fps_variant_plan``) and its time over
``v0_current``'s; ``ms`` is the mean of a launch from CUDA events.
``sass`` compiles ``csrc/fps_variants.cu`` and ``csrc/fps_onchip.cu``
(``nvcc -Xptxas -v``, as the build does, in parallel) and prints, for each
kernel, its registers, spills and the ``BAR.SYNC``, ``REDUX`` and
``SYNCS`` instructions of ``cuobjdump -sass``, and the compile time of each
source. The inputs come from numpy seeds.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch.ops import _build
from nesie_tpu_torch.ops.fps import fps_ref
from nesie_tpu_torch.ops.fps_variants import (
    LAB_VARIANTS,
    VARIANTS,
    fps_variant_cuda,
    fps_variant_plan,
    fps_variant_ref,
    plan_tag,
)
from nesie_tpu_torch.ops.pointops import furthest_point_sample
from nesie_tpu_torch.utils import time_ms

CHECK_SHAPE = (3, 600, 37)    # B, N, M of the TPU lab's check
BENCH_SHAPE = (8, 40000, 2048)  # and of its bench


def check_clouds(b: int, n: int) -> dict:
    """A random cloud and a tie-heavy one: 40 distinct points tiled to n."""
    rand = np.random.default_rng(0).uniform(size=(b, n, 3))
    base = np.random.default_rng(1).uniform(size=(b, 40, 3))
    dup = np.tile(base, (1, -(-n // 40), 1))[:, :n]
    return {tag: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            for tag, a in (("rand", rand), ("dup", dup))}


def bench_cloud(device) -> torch.Tensor:
    b, n, _ = BENCH_SHAPE
    xyz = np.random.default_rng(0).uniform(size=(b, n, 3)).astype(np.float32)
    return torch.from_numpy(xyz).to(device)


def check(device: str = "cuda", variants=LAB_VARIANTS, shape=CHECK_SHAPE,
          clouds=("rand", "dup")) -> int:
    """Each variant against ``fps_ref`` on the check clouds of ``shape``
    (B, N, M); 0 when all agree."""
    b, n, m = shape
    run = fps_variant_ref if device == "cpu" else fps_variant_cuda
    pts_by_tag = check_clouds(b, n)
    for tag in clouds:
        pts = pts_by_tag[tag].to(device)
        want = fps_ref(pts, m)
        for name in variants:
            got = run(pts, m, name)
            ok = torch.equal(want, got)
            print(f"{name} {tag} {b}x{n}->{m}: "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                bad = int((want != got).any(dim=0).int().argmax())
                print("  first bad slot", bad, want[:, bad].tolist(),
                      got[:, bad].tolist())
                return 1
    print("all variants exact")
    return 0


def bench(variants=LAB_VARIANTS, reps: int = 10) -> list[dict]:
    """Check and time the shipped FPS, each variant and the shipped FPS
    again (``v0_current_end``: the drift over the run) at the
    bench shape on the card; one dict (and one printed line) each."""
    xyz = bench_cloud("cuda")
    b, n, m = BENCH_SHAPE
    want = fps_ref(xyz, m)
    cand = {"v0_current": lambda: furthest_point_sample(xyz, m)}
    cand.update({name: (lambda name=name: fps_variant_cuda(xyz, m, name))
                 for name in variants})
    cand["v0_current_end"] = cand["v0_current"]  # the drift over the run
    rows = []
    for name, fn in cand.items():
        exact = torch.equal(fn(), want)
        ms = time_ms(fn, reps)
        row = {"variant": name, "ms": ms, "exact": exact,
               "us_per_step": ms * 1000 / (m - 1)}
        if name in VARIANTS:
            plan = fps_variant_plan(name, b, n)
            row.update(plan=plan_tag(plan),
                       vs_v0_current=ms / rows[0]["ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# a kernel of the two sources, named by its template arguments
_KERNEL = re.compile(r"(fps_variant_kernel|fps_variant_rows2_kernel|"
                     r"fps_onchip_kernel)I((?:L[ib]\d+E)+)E")


def _kernel_name(mangled: str) -> str | None:
    """``fps_variant_kernel<6, 48, 3>`` for its mangled name; None for a
    kernel of neither template."""
    hit = _KERNEL.search(mangled)
    if hit is None:
        return None
    args = re.findall(r"L[ib](\d+)E", hit.group(2))
    return f"{hit.group(1)}<{', '.join(args)}>"


def sass() -> dict:
    """Registers, spills and barrier / reduction / mbarrier instructions
    of each kernel of ``fps_variants.cu`` and ``fps_onchip.cu``, and each
    source's compile time. Needs nvcc and cuobjdump, not the card."""
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    srcs = [_build._CSRC / name
            for name in ("fps_variants.cu", "fps_onchip.cu")]
    out = {"compile_s": {}, "kernels": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()

        def compile_one(src: Path):
            obj = Path(tmp) / f"{src.stem}.o"
            proc = subprocess.run(
                [nvcc, "-Xptxas=-v", *_build._NVCC_FLAGS, "-c", "-o",
                 str(obj), str(src)], capture_output=True, text=True)
            return src, obj, proc, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            done = list(pool.map(compile_one, srcs))
        for src, obj, proc, seconds in done:
            log = proc.stdout + proc.stderr
            out["compile_s"][src.name] = seconds
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            name = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    name = _kernel_name(line)
                    if name:
                        out["kernels"][name] = {}
                elif name and "spill stores" in line:
                    out["kernels"][name]["spill_bytes"] = int(
                        re.search(r"(\d+) bytes spill stores", line)[1])
                elif name and "Used" in line and "registers" in line:
                    out["kernels"][name]["registers"] = int(
                        re.search(r"Used (\d+) registers", line)[1])
            dump = subprocess.run([cuobjdump, "-sass", str(obj)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            name = None
            for line in dump.splitlines():
                if "Function :" in line:
                    name = _kernel_name(line)
                    if name:
                        out["kernels"][name].update(
                            instructions=0, BAR_SYNC=0, REDUX=0, SYNCS=0)
                elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                    counts = out["kernels"][name]
                    counts["instructions"] += 1
                    for op, key in (("BAR.SYNC", "BAR_SYNC"),
                                    ("REDUX", "REDUX"), ("SYNCS", "SYNCS")):
                        counts[key] += op in line
    for name, counts in out["kernels"].items():
        print(json.dumps({"kernel": name, **counts}), flush=True)
    print(json.dumps({"compile_s": out["compile_s"]}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="check",
                   choices=("check", "bench", "sass"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions (check only)")
    p.add_argument("--json-out", default=None, help="sass: write it here")
    args = p.parse_args(argv)
    if args.mode == "sass":
        result = sass()
        if args.json_out:
            Path(args.json_out).write_text(json.dumps(result, indent=1))
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fps_lab: no CUDA device (check --device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    if args.mode == "check":
        return check(args.device)
    if args.device == "cpu":
        print("fps_lab: bench times the kernels on the card",
              file=sys.stderr)
        return 1
    rows = bench()
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
