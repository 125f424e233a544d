"""Matrix-multiplication FLOPs of a cell's unit of work, from the
configuration's widths and the cell's shapes.

The count is ``torch.utils.flop_counter.FlopCounterMode`` over the
benchmark's frozen reference (``perfbench/reference``) run on the
``meta`` device: shapes only, no data, and no code of the port. Every
Linear of this architecture sees a row count that the shapes fix (the
sampled centers, the neighbours, the proposals, the grids), so the count
is the architecture's, whatever kernels a later program uses. The FPS
loop, whose indices do not change any shape, is replaced by zeros while
counting, since on ``meta`` it only costs time.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import build, ops
from perfbench.reference.data.augment import AugParams
from perfbench.reference.train.semi import UlbState


@contextlib.contextmanager
def _shape_only_fps():
    steps = ops.fps_steps
    ops.fps_steps = lambda xyz, m, select: torch.zeros(
        (xyz.shape[0], m), dtype=torch.int32, device=xyz.device)
    try:
        yield
    finally:
        ops.fps_steps = steps


def eval_forward_flops(cfg: dict, batch: int, points: int) -> int:
    """The eval forward of ``batch`` clouds of ``points`` points in the
    test protocol's ``sample_mod``."""
    with _shape_only_fps(), torch.device("meta"):
        net = build.model(cfg).eval()
        pts = torch.empty(batch, points, cfg["model"]["in_channels"])
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            net(pts, cfg["test"]["sample_mod"])
    return int(fc.get_total_flops())


def semi_step_flops(cfg: dict, traffic: dict) -> int:
    """One semi-supervised step: teacher forward, student forward with
    the jittered proposals, losses and backward."""
    n_l, n_u = traffic["labeled"], traffic["unlabeled"]
    b, n, g = n_l + n_u, traffic["points"], traffic["max_gt"]
    p = cfg["model"]["num_proposal"]
    with _shape_only_fps(), torch.device("meta"):
        net = build.model(cfg)
        state = build.train_state(cfg, net, "meta")
        state.optimizer.step = lambda *a, **k: None  # no matmul; reads
        # its step count with .item(), which meta tensors cannot give
        batch = dict(
            points_raw_s=torch.empty(b, n, cfg["model"]["in_channels"]),
            points_raw_t=torch.empty(b, n, cfg["model"]["in_channels"]),
            gt_boxes=torch.empty(b, g, 7),
            gt_labels=torch.zeros(b, g, dtype=torch.long),
            gt_valid=torch.zeros(b, g, dtype=torch.bool),
            aug_s=AugParams.identity((b,), device="meta"),
            aug_t=AugParams.identity((b,), device="meta"),
            ulb_scan_idx=torch.zeros(b, dtype=torch.long))
        ulb = UlbState.create(traffic["unlabeled_scans"],
                              cfg["model"]["num_classes"], device="meta")
        step = build.semi_step(cfg, n_l, traffic["labeled_scans"])
        noise = (torch.empty(b, p, 3), torch.empty(b, p, 3))
        with FlopCounterMode(display=False) as fc:
            step(state, ulb, batch, noise=noise)
    return int(fc.get_total_flops())
