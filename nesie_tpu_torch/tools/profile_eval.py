#!/usr/bin/env python3
"""Where the time of the batched eval forward goes, on one card.

    python3 -m nesie_tpu_torch.tools.profile_eval [--runs 3] [--head saqe]

Needs one CUDA card and nvcc. Builds the flagship VoteNetNesie (seeded
random weights, BN running statistics randomised, eval mode; with
``--head saqe`` the flagship SAQE model of the shipped configs) and the
batch of ``chip_smoke.py``'s eval path (B=32 synthetic rooms x 40000 x 4),
runs two warm-up forwards, then ``--runs`` forwards under
``torch.profiler`` (CPU and CUDA activities). Prints the wall time per
forward, the device's busy time (the sum of the kernels' device time, one
stream) and idle share, the kernels grouped by kind (the groups of
``profile_train_step``) with their device ms per forward, the largest
kernels, and each ball query's shape with its launches and device ms per
forward; then one JSON line of the same numbers. ``profile_forward`` is
the measurement alone, for a model and batch of the caller's.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import nesie_tpu_torch.nn.pointnet2 as pn2
from nesie_tpu_torch.config import get_config
from nesie_tpu_torch.data import io
from nesie_tpu_torch.data.synthetic import make_scene
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.tools.profile_train_step import GROUPS
from nesie_tpu_torch.train.runner import build_model

B, N_POINTS = 32, 40000


def profile_forward(model, points, runs: int = 3) -> dict:
    """Two warm-up forwards of ``model`` on ``points``, then ``runs``
    under ``torch.profiler``: wall ms a forward, device busy ms, idle
    share, device ms by kernel group and by kernel, and the ball queries
    by shape."""
    queries = []  # (B, N, M, K, radius) of each ball query, in call order
    ball_query = pn2.ball_query

    def recorded(xyz, centers, radius, k, *a, **kw):
        queries.append((xyz.shape[0], xyz.shape[1], centers.shape[1], k,
                        radius))
        return ball_query(xyz, centers, radius, k, *a, **kw)

    with torch.inference_mode():
        for _ in range(2):
            model(points)
        torch.cuda.synchronize()
        pn2.ball_query = recorded
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(runs):
                    model(points)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / runs
        finally:
            pn2.ball_query = ball_query
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    per_kernel: dict = {}
    for e in kernels:
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3 / runs)
    busy = sum(per_kernel.values())
    groups: dict = {}
    for name, ms in per_kernel.items():
        label = next((g for g, pat in GROUPS if re.search(pat, name)),
                     "other")
        groups[label] = groups.get(label, 0.0) + ms
    # the i-th ball-query kernel on the device is the i-th call
    bq = [e for e in kernels if re.search(r"ball_query", e.name)]
    if len(bq) != len(queries):
        raise AssertionError(f"{len(bq)} ball-query kernels for "
                             f"{len(queries)} calls")
    by_shape: dict = {}
    for q, e in zip(queries, bq):
        key = "B={} N={} M={} K={} r={}".format(*q)
        launches, ms = by_shape.get(key, (0, 0.0))
        by_shape[key] = (launches + 1,
                         ms + e.time_range.elapsed_us() / 1e3 / runs)
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                groups=groups, per_kernel=per_kernel, ball_query=by_shape)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--head", default="nesie", choices=["nesie", "saqe"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if args.head == "saqe":
        model = build_model(get_config("saqe-votenet-scannet-train-050"))
    else:
        model = VoteNetNesie()
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    model = model.eval().to(dev)
    rng = np.random.default_rng(0)
    batch = np.stack([io.add_height(make_scene(rng, N_POINTS))
                      for _ in range(B)]).astype(np.float32)
    points = torch.from_numpy(batch).to(dev)

    res = profile_forward(model, points, args.runs)
    wall, busy = res["wall_ms"], res["busy_ms"]
    print(f"eval forward B={B} x {N_POINTS} x 4 ({args.head} head) under "
          f"the profiler: wall {wall:.3f} ms per forward, device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f}")
    for label, ms in sorted(res["groups"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / busy:6.1%}  {label}")
    print("largest kernels:")
    for name, ms in sorted(res["per_kernel"].items(),
                           key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    print(f"ball queries ({args.runs} forwards):")
    for key, (launches, ms) in res["ball_query"].items():
        print(f"  {key}: {launches} launches, {ms:.4f} ms per forward")
    print(json.dumps(dict(wall_ms=wall, busy_ms=busy,
                          idle_share=res["idle_share"], groups=res["groups"],
                          ball_query={k: dict(launches=n, ms_per_forward=ms)
                                      for k, (n, ms)
                                      in res["ball_query"].items()},
                          head=args.head,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
