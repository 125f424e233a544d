#!/usr/bin/env python
"""FLOP count of the eval forward and the semi step (counterpart of
``tools/flops_analysis.py``).

Counts the port's own program with ``torch.utils.flop_counter.
FlopCounterMode`` while it runs: the flagship's eval forward at B=8 x
40000 points and the 4 + 8 semi step (forward, backward and the
teacher's forward), total and by operator. The counter sees the matmuls
and convolutions PyTorch dispatches. It does not see the point kernels
(K1-K4: FPS, the ball query, three-NN), which are launched through
``ctypes``: their operations are counted apart, a call at a time, with
``chip_smoke.py``'s bound formulas (FPS 10 a point and step, the ball
query 8 a pair tested up to the K-th hit, three-NN 9 a pair), and printed
on lines of their own. These are counts of this program, not of the JAX
package's: its XLA ``cost_analysis`` also counts elementwise work.

    python -m nesie_tpu_torch.tools.flops_analysis          # on the card
    python -m nesie_tpu_torch.tools.flops_analysis --device cpu --tiny
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

EVAL_B, N_POINTS = 8, 40000
SEMI = dict(n_labeled=4, n_unlabeled=8, max_gt=64, n_boxes=8)
TINY_POINTS = 2048
# the K1-K4 plain and kernel entry points of ops.pointops, by kernel
POINT_OPS = {"fps": ("fps_ref", "fps_onchip_cuda"),
             "ball_query": ("ball_query_ref", "ball_query_cuda"),
             "three_nn": ("three_nn_ref", "three_nn_cuda")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--tiny", action="store_true",
                   help="overfit_check's small model, B=2 eval and a 1 + 2 "
                        "semi step at 2048 points (CPU-sized)")
    return p.parse_args(argv)


def fps_ops(b: int, n: int, m: int) -> float:
    """D-FPS: per step and point 3 subtractions, 3 products, 2 sums, one
    min and one compare of the argmax."""
    return 10.0 * b * n * (m - 1)


def ball_query_ops(idx: torch.Tensor, n: int) -> float:
    """8 operations per (center, point) pair up to the K-th hit, the
    points this call's data needs (a center with fewer than K hits scans
    all n)."""
    last, first = idx[..., -1].long(), idx[..., 0].long()
    return 8.0 * torch.where(last > first, last + 1, n).double().sum().item()


def three_nn_ops(b: int, m: int, n: int) -> float:
    """8 operations per (query, source) pair for the distance, one
    compare."""
    return 9.0 * b * m * n


def _counted(name: str, fn, calls: list):
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        if name == "fps":
            (b, n, _), m = args[0].shape, args[1]
            ops = fps_ops(b, n, m)
        elif name == "ball_query":
            ops = ball_query_ops(out, args[0].shape[1])
        else:
            (b, m, _), n = args[0].shape, args[1].shape[1]
            ops = three_nn_ops(b, m, n)
        calls.append((name, ops))
        return out
    return wrapper


@contextlib.contextmanager
def point_op_calls():
    """Within the block, every FPS, ball query and three-NN that
    ``ops.pointops`` runs (plain or kernel) appends (kernel, operations)
    to the yielded list."""
    from nesie_tpu_torch.ops import pointops

    calls: list = []
    saved = {}
    for name, attrs in POINT_OPS.items():
        for attr in attrs:
            saved[attr] = getattr(pointops, attr)
            setattr(pointops, attr, _counted(name, saved[attr], calls))
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(pointops, attr, fn)


def count(fn) -> dict:
    """Run ``fn`` once under the flop counter and the point-op count:
    the total FLOPs, FLOPs by operator and the point kernels' launches
    and operations."""
    with point_op_calls() as calls, FlopCounterMode(display=False) as fc:
        fn()
    by_op = {str(op): int(n)
             for op, n in fc.get_flop_counts()["Global"].items()}
    point = {}
    for name, ops in calls:
        p = point.setdefault(name, dict(launches=0, ops=0.0))
        p["launches"] += 1
        p["ops"] += ops
    return dict(flops=int(fc.get_total_flops()), by_op=by_op,
                point_ops=point)


def eval_forward(model, points):
    """The seed-mode eval forward, as ``make_eval_forward`` runs it."""
    model = model.to(points.device).eval()

    @torch.no_grad()
    def forward():
        return model(points, "seed", with_jitter=False)

    return forward


def semi_step(model, batch, device, n_labeled: int):
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule

    state = create_train_state(model, make_lr_schedule(1e-3, 1),
                               device=device)
    step = make_semi_train_step(n_labeled, num_labeled_scans=120)
    ulb = UlbState.create(1200, 18, device=device)
    gen = torch.Generator(device).manual_seed(0)
    return lambda: step(state, ulb, batch, generator=gen,
                        teacher_generator=gen)


def report(name: str, res: dict) -> None:
    print(f"{name}: {res['flops']:.6e} FLOPs (FlopCounterMode)")
    for op, n in sorted(res["by_op"].items(), key=lambda kv: -kv[1]):
        print(f"  {n:.6e}  {op}")
    for kernel, p in sorted(res["point_ops"].items()):
        print(f"{name} point kernel {kernel}: {p['launches']} launches, "
              f"{p['ops']:.6e} operations (not FLOPs of the counter)")


def run(args) -> dict:
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.synthetic import make_scene, semi_batch
    from nesie_tpu_torch.nn.detector import init_weights_flax_
    from nesie_tpu_torch.tools.overfit_check import build_model

    device = torch.device(args.device)
    b, n = (2, TINY_POINTS) if args.tiny else (EVAL_B, N_POINTS)
    semi = dict(SEMI, n_labeled=1, n_unlabeled=2) if args.tiny else SEMI

    def model():
        m = build_model(args.tiny)
        init_weights_flax_(m, torch.Generator().manual_seed(0))
        return m

    rng = np.random.default_rng(0)
    points = torch.from_numpy(np.stack(
        [io.add_height(make_scene(rng, n)) for _ in range(b)]
    ).astype(np.float32)).to(device)
    out = {"eval_forward": count(eval_forward(model(), points))}
    batch = semi_batch(rng, semi["n_labeled"], semi["n_unlabeled"], n,
                       semi["max_gt"], semi["n_boxes"], device)
    out["semi_step"] = count(semi_step(model(), batch, device,
                                       semi["n_labeled"]))
    shape = dict(eval_b=b, semi=f"{semi['n_labeled']}+{semi['n_unlabeled']}",
                 points=n, device=str(device))
    if device.type == "cuda":
        shape["card"] = torch.cuda.get_device_name(device)
    report(f"eval forward B={b} x {n}", out["eval_forward"])
    report(f"semi step {shape['semi']} x {n}", out["semi_step"])
    print(json.dumps({k: dict(flops=v["flops"], point_ops=v["point_ops"])
                      for k, v in out.items()} | {"shape": shape}))
    return out


def main(argv=None) -> int:
    from nesie_tpu_torch.utils import no_card

    args = parse_args(argv)
    if no_card(args.device, "flops_analysis"):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
