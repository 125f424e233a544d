#!/usr/bin/env python3
"""Time the ball-query kernel at the eval forward's five shapes.

    python3 -m nesie_tpu_torch.tools.bench_ball_query

Needs one CUDA card and nvcc. Builds B=32 synthetic rooms of 40000 points
(``data.synthetic.make_scene``, seeded as ``chip_smoke.py`` does), picks
SA1's 2048 centers with FPS, and derives the flagship's other queries
from them as the forward does: SA2-SA4 query prefixes of the centers
(2048 -> 1024 -> 512 -> 256), the aggregation queries 256 of 1024 votes
(seeds moved by 0.05 m noise). Then the same five queries on the first
12 rows (the semi step's batch) and on the first row (a ``Detector``
request). For each: the kernel must give ``ball_query_ref``'s indices; prints
one JSON line with the mean device time of 10 launches (CUDA events), the
(center, point) pairs tested up to each center's K-th hit, and the card's
name. Besides ``utils.time_ms``, only ``ops`` entry points that every
version of the port has are called, so the script also times the kernel
of another checkout that has ``utils.time_ms``:
``PYTHONPATH=<checkout> python3 <this file>``.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from nesie_tpu_torch.data.synthetic import make_scene
from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
from nesie_tpu_torch.ops.pointops import furthest_point_sample, gather_points
from nesie_tpu_torch.utils import time_ms

B, N_POINTS = 32, 40000
BATCHES = (32, 12, 1)  # the eval forward, the semi step, a request


def eval_shapes(xyz: torch.Tensor, centers: torch.Tensor) -> list:
    """The eval forward's ball queries from the scenes ``xyz`` (B, 40000,
    3) and SA1's FPS centers (B, 2048, 3): (name, points, centers, radius,
    K) each."""
    votes = (centers[:, :1024] + 0.05 * torch.randn(
        (xyz.shape[0], 1024, 3), generator=torch.Generator(
            xyz.device).manual_seed(1), device=xyz.device)).contiguous()

    def prefix(t, m):
        return t[:, :m].contiguous()

    return [("SA1", xyz, centers, 0.2, 64),
            ("SA2", centers, prefix(centers, 1024), 0.4, 32),
            ("SA3", prefix(centers, 1024), prefix(centers, 512), 0.8, 16),
            ("SA4", prefix(centers, 512), prefix(centers, 256), 1.2, 16),
            ("aggregation", votes, prefix(votes, 256), 0.3, 16)]


def scanned_pairs(idx: torch.Tensor, n: int) -> float:
    """(center, point) pairs a query must test up to each center's K-th
    hit: a center with fewer than K hits tests all n points."""
    last, first = idx[..., -1].long(), idx[..., 0].long()
    return torch.where(last > first, last + 1, n).double().sum().item()


def scenes(device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(np.stack([make_scene(rng, N_POINTS)
                                      for _ in range(B)])).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_ball_query: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    xyz = scenes(dev)
    centers = gather_points(xyz, furthest_point_sample(xyz, 2048)).contiguous()
    cases = [case for b in BATCHES
             for case in eval_shapes(xyz[:b].contiguous(),
                                     centers[:b].contiguous())]
    kind = torch.cuda.get_device_name(0)
    for name, x, c, r, k in cases:
        got = ball_query_cuda(x, c, r, k)
        if not torch.equal(got, ball_query_ref(x, c, r, k)):
            raise AssertionError(f"{name} B={x.shape[0]}: indices differ "
                                 "from ball_query_ref")
        ms = time_ms(lambda: ball_query_cuda(x, c, r, k), reps=10)
        print(json.dumps(dict(shape=name, b=x.shape[0], n=x.shape[1],
                              m=c.shape[1], radius=r, k=k, ms=ms,
                              pairs=scanned_pairs(got, x.shape[1]),
                              device=kind)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
