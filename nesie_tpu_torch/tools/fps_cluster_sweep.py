#!/usr/bin/env python3
"""Time the cluster FPS kernel at every cluster size against fps.cu.

    python3 -m nesie_tpu_torch.tools.fps_cluster_sweep

Needs one CUDA card and nvcc. For each (B, N, M) of the FPS calls of the
port's paths, checks ``fps_cluster_cuda`` at cluster sizes 1 to 16 (and
the plan's own choice, "auto") against ``fps_ref`` (identical indices
required), and prints one line per size with its mean time over a few
launches (CUDA events), the plan it took, and ``fps.cu``'s time on the
same input. The inputs are uniform random points in a 6 x 6 x 3 m box,
seeded.
"""
from __future__ import annotations

import json
import sys

import torch

from nesie_tpu_torch.ops.fps import (
    fps_cluster_cuda,
    fps_cluster_plan,
    fps_cuda,
    fps_ref,
)

SHAPES = ((1, 40000, 2048), (12, 40000, 2048), (12, 1024, 256),
          (2, 200000, 2048), (16, 40000, 2048), (32, 40000, 2048))
SIZES = (0, 1, 2, 4, 8, 16)


def time_ms(fn, reps: int = 3) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("fps_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for b, n, m in SHAPES:
        xyz = (torch.rand((b, n, 3), generator=gen, device=dev)
               * torch.tensor([6.0, 6.0, 3.0], device=dev)).contiguous()
        want = fps_ref(xyz, m)
        block_ms = time_ms(lambda: fps_cuda(xyz, m))
        for c in SIZES:
            try:
                plan = fps_cluster_plan(b, n, c)
            except RuntimeError as err:  # no plan fits this size
                print(f"B={b} N={n} M={m} cluster={c}: {err}")
                continue
            got = fps_cluster_cuda(xyz, m, cluster_size=c)
            if not torch.equal(got, want):
                raise AssertionError(f"B={b} N={n} M={m} cluster={c}: "
                                     "indices differ from fps_ref")
            ms = time_ms(lambda: fps_cluster_cuda(xyz, m, cluster_size=c))
            row = dict(b=b, n=n, m=m, request=c, plan=plan, ms=ms,
                       fps_cu_ms=block_ms)
            rows.append(row)
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
