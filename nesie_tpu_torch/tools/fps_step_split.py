#!/usr/bin/env python3
"""Split the on-chip FPS step into its phases, by exchange.

    python3 -m nesie_tpu_torch.tools.fps_step_split [--steps 400]

Needs one CUDA card and nvcc. Runs the instrumented instantiation of
``csrc/fps_onchip.cu`` (``ops.fps.fps_onchip_timed``), whose thread 0 of
row 0's first CTA stamps ``clock64()`` over the first steps, at 40000 ->
2048 for B = 1, 12 and 32, cluster sizes 2, 4 and 8 for the barrier
exchange and 2, 4, 8 and 16 for the mailbox exchanges (every warp
pushing, or one push per CTA); C=2 at 512 threads, the others at 256.
Prints one JSON line per run: the plan, the median cycles of each phase
over steps 17 to ``--steps`` (the point loop, the warp reduction, the
push, the barrier or wait, the cross-CTA reduction, the whole step), the
kernel's time (CUDA events, one launch) and its ns a step, and the SM
clock those imply. Every run must give ``fps_ref``'s indices. The inputs
are uniform random points in a 6 x 6 x 3 m box, seeded.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from nesie_tpu_torch.ops.fps import (
    TIMED_STEPS,
    fps_onchip_plan,
    fps_onchip_timed,
    fps_ref,
)

N, M = 40000, 2048
BATCHES = (1, 12, 32)
RUNS = (("barrier", (2, 4, 8)), ("mailbox", (2, 4, 8, 16)),
        ("mailbox_cta", (2, 4, 8, 16)))
PHASES = ("point_loop", "warp_reduce", "push", "barrier_or_wait",
          "cross_reduce")
SKIP = 16  # the first steps, while the clocks and caches settle


def threads_for(cluster: int) -> int:
    """C=2 holds 20000 points a CTA: 512 threads of 40 points."""
    return 512 if cluster == 2 else 256


def split(stamps: torch.Tensor, steps: int) -> dict:
    """Median cycles of each phase and of the whole step (start to the
    next step's start) over steps SKIP+1 .. steps."""
    s = stamps[SKIP:steps].double()
    out = {}
    for k, name in enumerate(PHASES):
        a, b = s[:, k], s[:, k + 1]
        ok = (a >= 0) & (b >= 0)
        out[name] = (b[ok] - a[ok]).median().item() if ok.any() else None
    step = s[1:, 0] - s[:-1, 0]
    out["step"] = step.median().item()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fps_step_split: no CUDA device", file=sys.stderr)
        return 1
    steps = min(args.steps, TIMED_STEPS, M - 1)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), n=N, m=M,
                          steps=[SKIP + 1, steps])))
    for b in BATCHES:
        xyz = (torch.rand((b, N, 3), generator=gen, device=dev)
               * torch.tensor([6.0, 6.0, 3.0], device=dev)).contiguous()
        want = fps_ref(xyz, M)
        for exchange, clusters in RUNS:
            for c in clusters:
                t = threads_for(c)
                try:
                    plan = fps_onchip_plan(b, N, c, t, exchange, timed=True)
                except RuntimeError as err:
                    print(json.dumps(dict(b=b, cluster=c, exchange=exchange,
                                          error=str(err))))
                    continue
                fps_onchip_timed(xyz, M, c, t, exchange)  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                got, stamps = fps_onchip_timed(xyz, M, c, t, exchange)
                end.record()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"B={b} C={c} {exchange}: indices "
                                         "differ from fps_ref")
                ms = start.elapsed_time(end)
                cycles = split(stamps.cpu(), steps)
                ns_step = ms * 1e6 / (M - 1)
                print(json.dumps(dict(
                    b=b, cluster=c, exchange=exchange, plan=plan,
                    cycles=cycles, ms=ms, ns_per_step=ns_step,
                    implied_ghz=cycles["step"] / ns_step)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
