#!/usr/bin/env python3
"""Time the on-chip FPS kernel by plan.

    python3 -m nesie_tpu_torch.tools.fps_onchip_sweep [--quick]
        [--shapes 0,1,...]

Needs one CUDA card and nvcc. For each (B, N, M) below (or those
``--shapes`` picks by position), prints one JSON line per plan of
``fps_onchip_cuda``
(each exchange or the plan's own "auto"; cluster size 1-16 or the plan's
own "0"; a thread cap of 64, 128, 256 or 512 or the default "0";
requests that give a plan already timed are skipped), with its mean time
over a few launches (CUDA events), its microseconds per step and the plan
it took. Every plan must give ``fps_ref``'s indices. ``--quick`` times
only the plan's own choice. The inputs are uniform random points in a
6 x 6 x 3 m box, seeded.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from nesie_tpu_torch.ops.fps import (
    EXCHANGES,
    fps_onchip_cuda,
    fps_onchip_plan,
    fps_ref,
)
from nesie_tpu_torch.utils import time_ms

# the eval forward's SA1, a ragged B > 16 row, then the B <= 16 shapes:
# semi-step SA1, a request, the vote-mode aggregation, 200000-point rows
SHAPES = ((32, 40000, 2048), (17, 40001, 2048), (12, 40000, 2048),
          (1, 40000, 2048), (12, 1024, 256), (2, 200000, 2048))
CLUSTERS = tuple(range(17))
THREADS = (0, 64, 128, 256, 512)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated positions in SHAPES")
    args = ap.parse_args()
    shapes = (SHAPES if args.shapes is None else
              [SHAPES[int(i)] for i in args.shapes.split(",")])
    if not torch.cuda.is_available():
        print("fps_onchip_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0))))
    for b, n, m in shapes:
        xyz = (torch.rand((b, n, 3), generator=gen, device=dev)
               * torch.tensor([6.0, 6.0, 3.0], device=dev)).contiguous()
        want = fps_ref(xyz, m)
        requests = ([(0, 0, "auto")] if args.quick else
                    [(c, t, x) for x in EXCHANGES for c in CLUSTERS
                     for t in THREADS])
        seen = set()
        for c, t, x in requests:
            try:
                plan = fps_onchip_plan(b, n, c, t, x)
            except RuntimeError:  # no plan fits this request
                continue
            key = tuple(sorted(plan.items()))
            if key in seen:  # another request gave the same plan
                continue
            seen.add(key)
            got = fps_onchip_cuda(xyz, m, c, t, x)
            if not torch.equal(got, want):
                raise AssertionError(f"B={b} N={n} plan {plan}: indices "
                                     "differ from fps_ref")
            ms = time_ms(lambda: fps_onchip_cuda(xyz, m, c, t, x))
            print(json.dumps(dict(b=b, n=n, m=m, request=[c, t, x],
                                  plan=plan, ms=ms,
                                  us_per_step=ms * 1e3 / (m - 1))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
