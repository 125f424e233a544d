#!/usr/bin/env python
"""Probe the pseudo-label gate against a pretrain checkpoint (counterpart
of ``tools/probe_thresholds.py``).

The reference's filter (votenet_nesie.py:152-166) passes a teacher
proposal only when pos_obj > obj_thr AND iou_pred > iou_thr AND
max_cls > cls_thr. Its shipped thresholds (obj 0.9) assume a fully
trained real-data teacher; after a short synthetic pretrain the gate can
pass nothing, and the semi loop then trains on the labeled scenes alone
(the runner's zero-pseudo warning). This tool pretrains (or, with a
finished checkpoint in place, restores) a ``validation_run``-style model,
runs the teacher-style forward (train-mode BN under ``frozen_bn_stats``,
no jitter, ``test.sample_mod``) on held-out scenes, and prints the score
distributions and the accepted pseudo-labels over an ``obj_thr`` sweep.

    python -m nesie_tpu_torch.tools.probe_thresholds --out build/study2 \\
        --split 050 [--seed 0] [--json-out probe.json]

``--pretrain-dir`` restores another run's pretrain (its
``<work_dir>/<name>`` directory, e.g. ``diagnose_teacher``'s) instead of
``<out>/work_s<seed>/<config>_s<seed>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

PERCENTILES = (50, 75, 90, 95, 99, 100)
OBJ_THRS = (0.9, 0.7, 0.5, 0.4, 0.3, 0.2)
# (cls_thr_base, iou_thr_base): thresh_warmup with no visited scans gives
# acc = 0, so the shipped gate's floor is cls 0.7 / iou 0.25
GATES = {"shipped_cls_iou": (0.7, 0.25),
         "relaxed_cls_iou": (0.5, 0.10),
         "floor_cls_iou": (0.2, 0.05)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/study2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", default="050")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--pretrain-epochs", type=int, default=12)
    p.add_argument("--pretrain-repeat", type=int, default=2)
    p.add_argument("--head", default="nesie", choices=["nesie", "saqe"])
    p.add_argument("--n-scenes", type=int, default=16)
    p.add_argument("--model-overrides", nargs="*",
                   default=["model.num_proposal=32", "model.reg_max=8"])
    p.add_argument("--pretrain-dir", default=None,
                   help="a pretrain run's <work_dir>/<name> to restore")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--json-out", default=None)
    return p.parse_args(argv)


@torch.no_grad()
def teacher_forward(model, points, sample_mod: str, with_jitter=False,
                    noise=None, generator=None) -> dict:
    """The semi step's teacher forward on ``points``: train-mode BN on the
    batch statistics, the running statistics left as they are."""
    from nesie_tpu_torch.nn.layers import frozen_bn_stats

    model.train()
    try:
        with frozen_bn_stats(model):
            return model(points, sample_mod, with_jitter=with_jitter,
                         noise=noise, generator=generator)
    finally:
        model.eval()


def gate_scores(out: dict) -> dict:
    """The three gated scores of every proposal, numpy: ``pos_obj``,
    ``iou_pred`` (at the class argmax) and ``max_cls`` (a logit, as the
    reference gates it)."""
    sem = out["sem_scores"]
    argmax_cls = sem.argmax(dim=-1, keepdim=True)
    return dict(
        pos_obj=torch.softmax(out["obj_scores"], dim=-1)[..., 1],
        iou_pred=out["iou_scores"].gather(-1, argmax_cls)[..., 0],
        max_cls=sem.max(dim=-1).values)


def percentiles(x) -> np.ndarray:
    return np.percentile(np.asarray(x), PERCENTILES)


def pct(x) -> str:
    return " ".join(f"p{p}={v:.3f}" for p, v in zip(PERCENTILES,
                                                    percentiles(x)))


def sweep(out: dict, num_classes: int, max_num_obj: int) -> dict:
    """Accepted pseudo-labels (over the batch) at every ``obj_thr`` of
    ``OBJ_THRS`` and every gate of ``GATES``, through the port's
    ``get_pseudo_labels`` with ``acc`` = 0."""
    from nesie_tpu_torch.train.pseudo_label import (
        PseudoLabelConfig,
        get_pseudo_labels,
    )

    acc = torch.zeros(num_classes, device=out["sem_scores"].device)
    report = {}
    for obj_thr in OBJ_THRS:
        n = {}
        for tag, (cls_b, iou_b) in GATES.items():
            cfg = PseudoLabelConfig(num_classes=num_classes,
                                    max_num_obj=max_num_obj, obj_thr=obj_thr,
                                    cls_thr_base=cls_b, iou_thr_base=iou_b)
            n[tag] = int(get_pseudo_labels(out, acc, cfg).valid.sum())
        report[obj_thr] = n
    return report


def probe(out: dict, num_classes: int, max_num_obj: int,
          n_scenes: int) -> dict:
    """Print the percentile report and the sweep; returns the JSON report
    (the JAX tool's layout)."""
    s = {k: v.cpu().numpy() for k, v in gate_scores(out).items()}
    for k in ("pos_obj", "iou_pred", "max_cls"):
        print(f"{k:8s}: {pct(s[k])}")
    # the three gates are correlated: show the iou / cls distribution
    # among the high-objectness proposals, which the joint gate sees
    hi = s["pos_obj"] > np.percentile(s["pos_obj"], 90)
    print(f"among pos_obj>p90: iou_pred {pct(s['iou_pred'][hi])}")
    print(f"among pos_obj>p90: max_cls  {pct(s['max_cls'][hi])}")
    report = {k: pct(s[k]) for k in ("pos_obj", "iou_pred", "max_cls")}
    report["sweep"] = sweep(out, num_classes, max_num_obj)
    for obj_thr, n in report["sweep"].items():
        print(f"obj_thr={obj_thr:.1f}: accepted pseudo-labels (over "
              f"{n_scenes} scenes) shipped cls/iou={n['shipped_cls_iou']}"
              f"  relaxed cls/iou={n['relaxed_cls_iou']}")
    return report


def pretrain_config(args):
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.tools.validation_run import MID_MODEL

    model_over = ([f"model.{k}={v}" for k, v in MID_MODEL.items()]
                  + args.model_overrides)
    cfg = get_config(f"{args.head}-votenet-scannet-pretrain-{args.split}")
    cfg = apply_overrides(cfg, model_over + [
        f"data.num_points={args.num_points}",
        f"optim.max_epochs={args.pretrain_epochs}",
        "data.samples_per_step=4",
        f"data.repeat={args.pretrain_repeat}",
        f"checkpoint_interval_epochs={args.pretrain_epochs}",
    ])
    if args.pretrain_dir:
        run_dir = Path(args.pretrain_dir)
        return dataclasses.replace(cfg, seed=args.seed, num_devices=1,
                                   work_dir=str(run_dir.parent),
                                   name=run_dir.name)
    return dataclasses.replace(
        cfg, seed=args.seed, num_devices=1,
        work_dir=str(Path(args.out) / f"work_s{args.seed}"),
        name=cfg.name + f"_s{args.seed}")


def run(args) -> dict:
    from nesie_tpu_torch.data.dataset import ScanNetScenes, SubScanNetScenes
    from nesie_tpu_torch.train import runner

    root = Path(args.out) / "data"
    cfg = pretrain_config(args)
    pre_ds = SubScanNetScenes(root, root / cfg.data.train_ann_file,
                              root / cfg.data.label_list_file)
    # resume=True with a finished checkpoint restores and skips training
    state = runner.train_supervised(cfg, pre_ds, resume=True,
                                    device=args.device)
    val_ds = ScanNetScenes(root, root / cfg.data.val_ann_file)
    idx = list(range(min(args.n_scenes, len(val_ds))))
    batch = val_ds.eval_batch(idx, np.random.default_rng(7), args.num_points)
    points = torch.from_numpy(batch["points"]).to(args.device)
    out = teacher_forward(state.model, points, cfg.test.sample_mod)
    report = probe(out, cfg.loss.num_classes, cfg.pseudo.max_num_obj,
                   len(idx))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    from nesie_tpu_torch.utils import no_card

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    if no_card(args.device, "probe_thresholds"):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
