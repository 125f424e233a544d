#!/usr/bin/env python3
"""The FPS step-variant lab: the step bodies of the TPU lab
``tools/fps_lab.py`` as CUDA kernels, held to ``fps_ref`` and timed.

    python3 -m nesie_tpu_torch.tools.fps_lab check [--device cpu]
    python3 -m nesie_tpu_torch.tools.fps_lab bench

``check`` holds each variant of ``LAB_VARIANTS`` to ``fps_ref`` on a
random cloud and a tie-heavy one (40 distinct points tiled to N), at
B=3, N=600, M=37, on the card; ``--device cpu`` runs the variants' plain
versions instead, and is the only way to the CPU. ``bench`` needs the
card: at B=8, N=40000, M=2048, uniform in [0, 1)^3, it checks the port's
FPS dispatch (``v0_current``), ``fps.cu`` (``v0``) and each variant
against ``fps_ref`` and prints one JSON line each: ``{variant, ms, exact,
us_per_step}``, the mean time of a launch from CUDA events. The inputs
come from numpy seeds.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nesie_tpu_torch.ops.fps import fps_cuda, fps_ref
from nesie_tpu_torch.ops.fps_variants import (
    LAB_VARIANTS,
    fps_variant_cuda,
    fps_variant_ref,
)
from nesie_tpu_torch.ops.pointops import furthest_point_sample
from nesie_tpu_torch.tools.fps_cluster_sweep import time_ms

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


def check(device: str = "cuda", variants=LAB_VARIANTS) -> int:
    """Each variant against ``fps_ref`` on both clouds; 0 when all agree."""
    b, n, m = CHECK_SHAPE
    run = fps_variant_ref if device == "cpu" else fps_variant_cuda
    for name in variants:
        for tag, pts in check_clouds(b, n).items():
            pts = pts.to(device)
            want = fps_ref(pts, m)
            got = run(pts, m, name)
            ok = torch.equal(want, got)
            print(f"{name} {tag}: {'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                bad = int((want != got).any(dim=0).int().argmax())
                print("  first bad slot", bad, want[:, bad].tolist(),
                      got[:, bad].tolist())
                return 1
    print("all variants exact")
    return 0


def bench(variants=LAB_VARIANTS, reps: int = 10) -> list[dict]:
    """Check and time the dispatch, ``fps.cu`` and each variant at the
    bench shape on the card; one dict (and one printed line) each."""
    xyz = bench_cloud("cuda")
    m = BENCH_SHAPE[2]
    want = fps_ref(xyz, m)
    cand = {"v0_current": lambda: furthest_point_sample(xyz, m),
            "v0": lambda: fps_cuda(xyz, m)}
    cand.update({name: (lambda name=name: fps_variant_cuda(xyz, m, name))
                 for name in variants})
    rows = []
    for name, fn in cand.items():
        exact = torch.equal(fn(), want)
        ms = time_ms(fn, reps)
        row = {"variant": name, "ms": ms, "exact": exact,
               "us_per_step": ms * 1000 / m}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="check",
                   choices=("check", "bench"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions (check only)")
    args = p.parse_args(argv)
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
