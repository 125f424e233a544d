#!/usr/bin/env python
"""The teacher_jitter -> pseudo-label coupling, measured directly
(counterpart of ``tools/jitter_delta.py``).

The reference's semi teacher runs the quality module on 2P proposals
(the P proposals and their jittered copies, nesie_head.py:178-209),
though the pseudo-labels read only the P proposals' scores
(votenet_nesie.py:129-209). Under train-mode BN the one coupling from the
jittered copies to the pseudo-labels is the quality module's batch
statistics, taken over 2P rows instead of P. ``teacher_jitter=False``
drops the copies.

This tool restores the pretrain checkpoint of a ``diagnose_teacher`` /
``validation_run``-style directory (``<root>/work/<pretrain config>``),
runs the same weak-view batches through the teacher with and without the
jitter (its noise from a generator on the device seeded with ``--seed``)
and reports the IoU-score deltas and the pseudo-label selection
agreement at the reference and the relaxed thresholds. Near-identical
selections mean an mAP A/B of the flag measures noise.

    python -m nesie_tpu_torch.tools.jitter_delta --root build/val_ab
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

PRETRAIN = "nesie-votenet-scannet-pretrain-010"
SEMI = "nesie-votenet-scannet-train-010"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="build/val_ab",
                   help="a diagnose_teacher / validation_run --out dir "
                        "(data/ and work/ inside)")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    return p.parse_args(argv)


def relaxed_config(pseudo):
    """The relaxed thresholds the tool reports beside the reference's."""
    return dataclasses.replace(pseudo, obj_thr=0.5, cls_thr_base=0.0,
                               cls_thr_cap=0.5, iou_thr_base=0.05,
                               iou_thr_cap=0.1)


def teacher_pair(model, points, sample_mod: str, noise=None,
                 generator=None):
    """The teacher forward with the jittered copies (``noise``, or drawn
    from ``generator``) and without: (out_on, out_off)."""
    from nesie_tpu_torch.tools.probe_thresholds import teacher_forward

    on = teacher_forward(model, points, sample_mod, with_jitter=True,
                         noise=noise, generator=generator)
    off = teacher_forward(model, points, sample_mod)
    return on, off


def selection_agreement(pl_on, pl_off) -> dict:
    """How many pseudo-boxes each run selects and how many of the first's
    are among the second's (by box coordinates, atol 1e-4)."""
    von = pl_on.valid.cpu().numpy()
    voff = pl_off.valid.cpu().numpy()
    bon = pl_on.boxes.cpu().numpy()[von]
    boff = pl_off.boxes.cpu().numpy()[voff]
    inter = sum(1 for row in bon if len(boff) and np.any(np.all(
        np.isclose(boff, row, atol=1e-4), axis=1)))
    return dict(on=int(von.sum()), off=int(voff.sum()), inter=inter)


def compare(out_on: dict, out_off: dict, acc, configs: dict) -> dict:
    """One batch's deltas and, for each named pseudo-label config, the
    selection agreement."""
    from nesie_tpu_torch.train.pseudo_label import get_pseudo_labels

    d_iou = (out_on["iou_scores"] - out_off["iou_scores"]).abs()
    d_obj = (out_on["obj_scores"] - out_off["obj_scores"]).abs()
    return dict(
        d_iou_max=float(d_iou.max()), d_iou_mean=float(d_iou.mean()),
        d_obj_max=float(d_obj.max()),
        agree={tag: selection_agreement(get_pseudo_labels(out_on, acc, c),
                                        get_pseudo_labels(out_off, acc, c))
               for tag, c in configs.items()})


def summarize(per_batch: list, checkpoint_step: int) -> dict:
    """The JAX tool's result layout over the batches."""
    agree = {tag: {k: sum(b["agree"][tag][k] for b in per_batch)
                   for k in ("on", "off", "inter")}
             for tag in per_batch[0]["agree"]} if per_batch else {}
    n = max(len(per_batch), 1)
    return dict(
        checkpoint_step=int(checkpoint_step), batches=len(per_batch),
        iou_score_delta=dict(
            max=max((b["d_iou_max"] for b in per_batch), default=0.0),
            mean=sum(b["d_iou_mean"] for b in per_batch) / n),
        obj_score_delta_max=max((b["d_obj_max"] for b in per_batch),
                                default=0.0),
        selection_agreement=agree)


def configs(root: Path, num_points: int):
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.tools.validation_run import MID_MODEL

    over = ([f"model.{k}={v}" for k, v in MID_MODEL.items()]
            + [f"data.num_points={num_points}"])
    pcfg = dataclasses.replace(apply_overrides(get_config(PRETRAIN), over),
                               num_devices=1, work_dir=str(root / "work"))
    return pcfg, apply_overrides(get_config(SEMI), over)


def run(args) -> dict:
    from nesie_tpu_torch.data.augment import augment_points
    from nesie_tpu_torch.data.dataset import SimiScanNetScenes, batch_to_device
    from nesie_tpu_torch.train import runner
    from nesie_tpu_torch.train.pseudo_label import classwise_acc
    from nesie_tpu_torch.train.semi import UlbState

    root = Path(args.root)
    device = torch.device(args.device)
    pcfg, scfg = configs(root, args.num_points)
    state = runner.init_state(pcfg, runner.build_model(pcfg), 1, device)
    ckpt = runner.CheckpointManager(Path(pcfg.work_dir) / pcfg.name)
    state, _, at = ckpt.restore(state, mesh_size=1)
    print(f"restored pretrain checkpoint at step {at}", file=sys.stderr)
    # a pretrain has no EMA: the teacher is the student's weights
    model = state.model

    data = root / "data"
    ds = SimiScanNetScenes(data, data / scfg.data.train_ann_file,
                           data / scfg.data.label_list_file,
                           ratio=scfg.data.unlabeled_ratio)
    ulb = UlbState.create(ds.num_unlabeled, scfg.model.num_classes,
                          device=device)
    acc = classwise_acc(ulb.ulb_list, ulb.ulb_flag, ds.num_labeled,
                        scfg.pseudo.thresh_warmup,
                        literal=scfg.pseudo.literal_reference_cbl)
    cfgs = {"reference": scfg.pseudo, "relaxed": relaxed_config(scfg.pseudo)}
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device).manual_seed(args.seed)
    per_batch = []
    for _ in range(args.batches):
        batch = ds.semi_batch(
            list(rng.integers(0, ds.num_labeled, size=2)), rng,
            strong_cfg=runner.strong_aug_config(scfg),
            num_points=args.num_points, n_unlabeled=4)
        batch = batch_to_device(batch, device)
        pts = augment_points(batch["points_raw_t"], batch["aug_t"],
                             shift_height=True)
        on, off = teacher_pair(model, pts, scfg.sample_mod_train,
                               generator=gen)
        per_batch.append(compare(on, off, acc, cfgs))
    result = summarize(per_batch, at)
    print(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    from nesie_tpu_torch.utils import no_card

    args = parse_args(argv)
    if no_card(args.device, "jitter_delta"):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
