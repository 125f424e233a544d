"""The benchmark's counts: the matmul FLOPs from the frozen reference on
the meta device against ``FlopCounterMode`` over the port itself, and
against the counts PERF.md cited before the benchmark existed; the point
searches' bounds against ``chip_smoke.py``'s."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import flops, peaks
from perfbench.counts.pointops import (
    ball_query_bound_s,
    ball_query_scanned,
    fps_bound_s,
    three_nn_bound_s,
)
from perfbench.tests.tiny import cell_of

SMALL = dict(points=4096)  # the published widths, fewer points


def test_flops_match_the_counts_cited_before():
    """PERF.md's FLOPs (``tools/flops_analysis``, my chip runs 1-2, PR
    13): the eval forward at B=8 x 40000 and the 4 + 8 semi step."""
    cell = cell_of("nesie-scannet", "semi-4-8")
    assert flops.eval_forward_flops(cell.cfg, 8, 40000) == 220168060928
    assert flops.semi_step_flops(cell.cfg, cell.traffic) == 1776983912448


@pytest.mark.parametrize("name", ["nesie-scannet", "saqe-scannet"])
def test_flops_match_the_port(name):
    """FlopCounterMode over the port's own eval forward and semi step,
    at the published widths on 4096 points, counts what the meta-device
    count of the reference gives."""
    from nesie_tpu_torch.config import get_config
    from nesie_tpu_torch.train.runner import build_model
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import create_train_state
    from nesie_tpu_torch.data.augment import AugParams

    cell = cell_of(name, "semi-4-8")
    cfg = cell.cfg
    net = build_model(get_config(cfg["port_configs"]["train"])).eval()
    pts = torch.rand(1, SMALL["points"], 4) * 4.0
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(pts, cfg["test"]["sample_mod"])
    assert fc.get_total_flops() == flops.eval_forward_flops(
        cfg, 1, SMALL["points"])

    traffic = dict(cell.traffic, labeled=1, unlabeled=1, **SMALL)
    b, g = 2, traffic["max_gt"]
    state = create_train_state(net.train(), lambda s: 8e-3, device="cpu")
    batch = dict(points_raw_s=torch.rand(b, SMALL["points"], 4) * 4.0,
                 points_raw_t=torch.rand(b, SMALL["points"], 4) * 4.0,
                 gt_boxes=torch.rand(b, g, 7), gt_labels=torch.zeros(
                     b, g, dtype=torch.long),
                 gt_valid=torch.zeros(b, g, dtype=torch.bool),
                 aug_s=AugParams.identity((b,)),
                 aug_t=AugParams.identity((b,)),
                 ulb_scan_idx=torch.zeros(b, dtype=torch.long))
    p = cfg["model"]["num_proposal"]
    step = make_semi_train_step(1, traffic["labeled_scans"],
                                head=cfg["model"]["head"])
    ulb = UlbState.create(traffic["unlabeled_scans"], 18, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(state, ulb, batch, noise=(torch.randn(b, p, 3),
                                       torch.randn(b, p, 3)))
    assert fc.get_total_flops() == flops.semi_step_flops(cfg, traffic)


def test_bounds_match_chip_smoke():
    """chip_smoke.py's bounds at 32 x 40000 -> 2048 (0.7832 ms) and
    1 x 40000 -> 2048 (0.0245 ms) took 132 SMs x 128 lanes x 1.98 GHz;
    the data sheet's 67 TFLOP/s / 2 lies within 0.2% of it."""
    assert peaks.FP32_OPS == pytest.approx(132 * 128 * 1.98e9, rel=2e-3)
    assert fps_bound_s(32, 40000, 2048) * 1e3 == pytest.approx(0.7832,
                                                                rel=3e-3)
    assert fps_bound_s(1, 40000, 2048) * 1e3 == pytest.approx(0.0245,
                                                               rel=3e-3)
    # three-NN at PERF.md's Nesie side grid shape: 0.2166 ms
    assert three_nn_bound_s(32, 256 * 96, 1024) * 1e3 == pytest.approx(
        0.2166, rel=3e-3)


def test_ball_query_work_counts_up_to_the_kth_hit():
    n = 100
    idx = torch.tensor([[[3, 5, 9], [7, 7, 7], [0, 0, 0]]], dtype=torch.int32)
    # 10 pairs to the 3rd hit; a center with one hit, and one with none,
    # scan all 100
    assert float(ball_query_scanned(idx, n)) == 10 + 100 + 100
    ops = 8.0 * 210
    nbytes = 12.0 * (n + 3) + 4.0 * 9
    assert ball_query_bound_s(210, 1, n, 3, 3) == max(
        ops / peaks.FP32_OPS, nbytes / peaks.HBM_BYTES_PER_S)
