#!/usr/bin/env python3
"""Time the on-chip FPS kernel by plan against fps.cu and fps_cluster.cu.

    python3 -m nesie_tpu_torch.tools.fps_onchip_sweep [--quick]

Needs one CUDA card and nvcc. For each (B, N, M) below, prints one JSON
line per plan of ``fps_onchip_cuda`` (cluster size 1-8 or the plan's own
choice "0", a thread cap of 256, 512 or 1024 or the default "0"), with
its mean time over a few launches (CUDA events), its microseconds per
step and the plan it took; then ``fps.cu``'s and
``fps_cluster.cu``'s times on the same input (the plan's own cluster
size, and C=2 where B > 16). Every plan must give ``fps_ref``'s
indices. ``--quick`` times only the plan's own choice.
The inputs are uniform random points in a 6 x 6 x 3 m box, seeded.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from nesie_tpu_torch.ops.fps import (
    fps_cluster_cuda,
    fps_cluster_plan,
    fps_cuda,
    fps_onchip_cuda,
    fps_onchip_plan,
    fps_ref,
)
from nesie_tpu_torch.tools.fps_cluster_sweep import time_ms

# the eval forward's SA1, a ragged B > 16 row, then K2's shapes (B <= 16)
SHAPES = ((32, 40000, 2048), (17, 40001, 2048), (12, 40000, 2048),
          (1, 40000, 2048))
CLUSTERS = (0, 1, 2, 3, 4, 5, 6, 7, 8)
THREADS = (0, 256, 512, 1024)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fps_onchip_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0))))
    for b, n, m in SHAPES:
        xyz = (torch.rand((b, n, 3), generator=gen, device=dev)
               * torch.tensor([6.0, 6.0, 3.0], device=dev)).contiguous()
        want = fps_ref(xyz, m)
        if not torch.equal(fps_cuda(xyz, m), want):
            raise AssertionError(f"B={b} N={n}: fps.cu differs from fps_ref")
        base = dict(b=b, n=n, m=m, fps_cu_ms=time_ms(lambda: fps_cuda(xyz, m)),
                    fps_cluster_ms=time_ms(lambda: fps_cluster_cuda(xyz, m)),
                    fps_cluster_plan=fps_cluster_plan(b, n))
        if b > 16:
            base["fps_cluster_c2_ms"] = time_ms(
                lambda: fps_cluster_cuda(xyz, m, cluster_size=2))
        print(json.dumps(base))
        clusters, threads = ((0,), (0,)) if args.quick else (CLUSTERS, THREADS)
        seen = set()
        for c in clusters:
            for t in threads:
                try:
                    plan = fps_onchip_plan(b, n, c, t)
                except RuntimeError as err:  # no plan fits this request
                    print(json.dumps(dict(b=b, n=n, request=[c, t],
                                          error=str(err))))
                    continue
                key = tuple(sorted(plan.items()))
                if key in seen:  # another request gave the same plan
                    continue
                seen.add(key)
                got = fps_onchip_cuda(xyz, m, c, t)
                if not torch.equal(got, want):
                    raise AssertionError(f"B={b} N={n} plan {plan}: indices "
                                         "differ from fps_ref")
                ms = time_ms(lambda: fps_onchip_cuda(xyz, m, c, t))
                print(json.dumps(dict(b=b, n=n, m=m, request=[c, t],
                                      plan=plan, ms=ms,
                                      us_per_step=ms * 1e3 / (m - 1))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
