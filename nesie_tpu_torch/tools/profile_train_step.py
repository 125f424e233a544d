#!/usr/bin/env python3
"""Where the time of one semi-supervised train step goes, on one card.

    python3 -m nesie_tpu_torch.tools.profile_train_step [--steps 3]
        [--supervised]

Needs one CUDA card and nvcc. Builds the flagship VoteNetNesie (seeded
random weights), the reference semi-step batch of ``chip_smoke.py``
(4 labeled + 8 unlabeled synthetic rooms x 40000 x 4), runs two warm-up
steps, then ``--steps`` steps under ``torch.profiler`` (CPU and CUDA
activities) with the program's spans on (``utils.span``).
``--supervised`` profiles the supervised step on the first 8 scenes of
that batch instead (``chip_smoke.py``'s B=8 step). Prints the wall time
per step, the device's busy time (the union of the device events'
intervals, so that two streams at once count once) and idle share, the
device's idle time under each innermost program span (``semi.teacher``,
``train.update``, ...), and the kernels grouped by kind with their device
ms per step, largest first, then one JSON line of the same numbers.
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

from nesie_tpu_torch import utils
from nesie_tpu_torch.data.synthetic import semi_batch
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
from nesie_tpu_torch.train.step import make_supervised_train_step

# kernel-name patterns, first match wins
GROUPS = (
    ("fps_onchip (CUDA, ours)", r"fps_onchip"),
    ("ball_query (CUDA, ours)", r"ball_query"),
    ("three_nn (CUDA, ours)", r"three_nn_kernel"),
    ("GEMM (cuBLAS; fp32, bf16)", r"gemm|sgemm|cutlass|Kernel2|ampere|sm90"),
    ("reductions (BN stats, sums, max)", r"reduce|Reduce"),
    ("gather / scatter / index", r"index|gather|scatter|Index"),
    ("sort / top-k", r"sort|Sort|topk|radix"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
    ("copies / cat", r"copy|Copy|cat|Cat|memcpy|memset"),
)


def timeline(prof) -> dict:
    """The device's side of a finished profile, on the profiler's one
    clock: ``busy_ms``, the union of the device events' intervals;
    ``window_ms``, from the start of the first program span to the end of
    the last; ``idle_ms``, the device's idle gaps inside that window, each
    under the innermost program span open at its middle (a span is a
    ``record_function`` range: ``utils.span`` with tracing on)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-6
        end = start + e.duration_ns() * 1e-6
        flag = getattr(e, "is_user_annotation", None)
        annotation = (flag() if callable(flag) else
                      "user_annotation" in str(e.activity_type()))
        if e.device_type() == cuda:
            if not annotation:  # a range mirrored on the device is no work
                dev.append((start, end))
        elif annotation:
            spans.append((start, end, e.name()))
    busy = []
    for s, e in sorted(dev):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    if not spans:
        return dict(busy_ms=sum(e - s for s, e in busy), window_ms=0.0,
                    idle_ms={})
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, w1)))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle: dict = {}
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inner = min((sp for sp in spans if sp[0] <= mid <= sp[1]),
                    key=lambda sp: sp[1] - sp[0], default=None)
        name = inner[2] if inner else "outside the program's spans"
        idle[name] = idle.get(name, 0.0) + (e - s)
    return dict(busy_ms=sum(e - s for s, e in busy), window_ms=w1 - w0,
                idle_ms=dict(sorted(idle.items(), key=lambda kv: -kv[1])))


def device_events(prof) -> list:
    """The profiler's events of device work, without the ranges
    (``record_function``, spans) that it mirrors on the device."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_times(prof) -> dict:
    """Device microseconds by kernel name, from the profiler's events."""
    out: dict = {}
    for evt in device_events(prof):
        out[evt.name] = out.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--supervised", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = VoteNetNesie()
    init_weights_(model, torch.Generator().manual_seed(3))
    state = create_train_state(model, make_lr_schedule(8e-3, 1000), device=dev)
    n_lab, n_unl, scans = 4, 8, 64
    batch = semi_batch(np.random.default_rng(7), n_lab, n_unl, 40000, 64, 8,
                       dev)
    ulb = [UlbState.create(scans, 18, device=dev)]
    step = make_semi_train_step(n_lab, scans)
    gen = torch.Generator(dev).manual_seed(2)

    def run():
        ulb[0], _ = step(state, ulb[0], batch, generator=gen)

    what = f"semi step {n_lab}+{n_unl} x 40000 x 4"
    if args.supervised:
        b = 8
        sup_batch = dict(points=batch["points_raw_s"][:b],
                         gt_boxes=batch["gt_boxes"][:b],
                         gt_labels=batch["gt_labels"][:b],
                         gt_valid=batch["gt_valid"][:b],
                         aug=batch["aug_s"].slice(0, b))
        sup = make_supervised_train_step()
        what = f"supervised step B={b} x 40000 x 4"

        def run():
            sup(state, sup_batch, generator=gen)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    was = utils.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    utils.set_tracing(was)
    utils.clear_spans()
    per_kernel = {k: v / 1e3 / args.steps for k, v in kernel_times(prof).items()}
    tl = timeline(prof)
    busy = tl["busy_ms"] / args.steps
    idle = {k: v / args.steps for k, v in tl["idle_ms"].items()}
    groups: dict = {}
    for name, ms in per_kernel.items():
        label = next((g for g, pat in GROUPS if re.search(pat, name)),
                     "other")
        groups[label] = groups.get(label, 0.0) + ms
    print(f"{what} under the profiler: wall "
          f"{wall:.3f} ms per step, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}")
    for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {label} (kernel time, streams summed)")
    print("device idle under the innermost program span, a step:")
    for name, ms in idle.items():
        print(f"  {ms:10.3f} ms  {name}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    print("largest kernels:")
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    print(json.dumps(dict(wall_ms=wall, busy_ms=busy,
                          idle_share=1 - busy / wall, groups=groups,
                          idle_ms=idle, device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
