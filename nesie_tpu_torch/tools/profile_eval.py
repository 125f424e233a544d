#!/usr/bin/env python3
"""Where the time of the batched eval forward goes, on one card.

    python3 -m nesie_tpu_torch.tools.profile_eval [--runs 3] [--head saqe] \
        [--sample-mod seed|vote|random|spec] [--compute-dtype bfloat16]

Needs one CUDA card and nvcc. Builds the flagship VoteNetNesie (seeded
random weights, BN running statistics randomised, eval mode; with
``--head saqe`` the flagship SAQE model of the shipped configs; with
``--compute-dtype bfloat16`` its backbone MLPs in bf16) and the batch of
``chip_smoke.py``'s eval path (B=32 synthetic rooms x 40000 x 4), runs
two warm-up forwards in ``--sample-mod`` (default ``seed``; ``random``
draws from a seeded generator), then ``--runs`` forwards under
``torch.profiler`` (CPU and CUDA activities) with the program's spans on
(``utils.span``). Prints the wall time per forward, the device's busy
time (the union of the device events' intervals, ``profile_train_step.
timeline``) and idle share, the device's idle time under each innermost
program span (``nn.forward``, ``pointops.fps``, ...), the kernels grouped
by kind (the groups of ``profile_train_step``) with their device ms per
forward, the largest kernels, and each ball query's shape with its
launches and device ms per forward; then one JSON line of the same
numbers. ``profile_forward`` is the measurement alone, for a model and
batch of the caller's.
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
from nesie_tpu_torch import utils
from nesie_tpu_torch.config import apply_overrides, get_config
from nesie_tpu_torch.data import io
from nesie_tpu_torch.data.synthetic import make_scene
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.tools.profile_train_step import (
    GROUPS,
    device_events,
    timeline,
)
from nesie_tpu_torch.train.runner import build_model

B, N_POINTS = 32, 40000


def profile_forward(model, points, runs: int = 3, sample_mod: str = "seed",
                    generator: torch.Generator | None = None) -> dict:
    """Two warm-up forwards of ``model`` on ``points`` in ``sample_mod``
    (``generator``: ``random``'s draws), then ``runs`` under
    ``torch.profiler`` with spans on: wall ms a forward, device busy ms
    (the union of the device events' intervals), idle share, idle ms
    under each innermost program span, device ms by kernel group and by
    kernel, and the ball queries by shape."""
    queries = []  # (B, N, M, K, radius) of each ball query, in call order
    ball_query = pn2.ball_query

    def recorded(xyz, centers, radius, k, *a, **kw):
        queries.append((xyz.shape[0], xyz.shape[1], centers.shape[1], k,
                        radius))
        return ball_query(xyz, centers, radius, k, *a, **kw)

    with torch.inference_mode():
        for _ in range(2):
            model(points, sample_mod, generator=generator)
        torch.cuda.synchronize()
        pn2.ball_query = recorded
        was = utils.set_tracing(True)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(runs):
                    model(points, sample_mod, generator=generator)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / runs
        finally:
            pn2.ball_query = ball_query
            utils.set_tracing(was)
            utils.clear_spans()
    kernels = sorted(device_events(prof), key=lambda e: e.time_range.start)
    per_kernel: dict = {}
    for e in kernels:
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3 / runs)
    tl = timeline(prof)
    busy = tl["busy_ms"] / runs
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
                idle_ms={k: v / runs for k, v in tl["idle_ms"].items()},
                groups=groups, per_kernel=per_kernel, ball_query=by_shape)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--head", default="nesie", choices=["nesie", "saqe"])
    ap.add_argument("--sample-mod", default="seed",
                    choices=["seed", "vote", "random", "spec"])
    ap.add_argument("--compute-dtype", default=None, choices=["bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if args.head == "saqe":
        cfg = apply_overrides(get_config("saqe-votenet-scannet-train-050"),
                              [f"model.compute_dtype={args.compute_dtype}"])
        model = build_model(cfg)
    else:
        model = VoteNetNesie(compute_dtype=args.compute_dtype)
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    model = model.eval().to(dev)
    rng = np.random.default_rng(0)
    batch = np.stack([io.add_height(make_scene(rng, N_POINTS))
                      for _ in range(B)]).astype(np.float32)
    points = torch.from_numpy(batch).to(dev)

    res = profile_forward(model, points, args.runs, args.sample_mod,
                          torch.Generator(dev).manual_seed(0))
    wall, busy = res["wall_ms"], res["busy_ms"]
    what = (f"{args.head} head, sample_mod {args.sample_mod}, compute dtype "
            f"{args.compute_dtype or 'float32'}")
    print(f"eval forward B={B} x {N_POINTS} x 4 ({what}) under "
          f"the profiler: wall {wall:.3f} ms per forward, device busy "
          f"{busy:.3f} ms, idle share {res['idle_share']:.3f}")
    for label, ms in sorted(res["groups"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {label} (kernel time, streams summed)")
    print("device idle under the innermost program span, a forward:")
    for name, ms in res["idle_ms"].items():
        print(f"  {ms:10.3f} ms  {name}")
    print("largest kernels:")
    for name, ms in sorted(res["per_kernel"].items(),
                           key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    print(f"ball queries ({args.runs} forwards):")
    for key, (launches, ms) in res["ball_query"].items():
        print(f"  {key}: {launches} launches, {ms:.4f} ms per forward")
    print(json.dumps(dict(wall_ms=wall, busy_ms=busy,
                          idle_share=res["idle_share"], groups=res["groups"],
                          idle_ms=res["idle_ms"],
                          ball_query={k: dict(launches=n, ms_per_forward=ms)
                                      for k, (n, ms)
                                      in res["ball_query"].items()},
                          head=args.head, sample_mod=args.sample_mod,
                          compute_dtype=args.compute_dtype,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
