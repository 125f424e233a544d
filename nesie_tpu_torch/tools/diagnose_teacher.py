#!/usr/bin/env python
"""Diagnose the EMA teacher's eval collapse (counterpart of
``tools/diagnose_teacher.py``).

On short synthetic horizons the semi phase's EMA teacher has evaluated
below its own initialisation. This tool bisects where the decay comes
from, on a generated dataset:

  1. sanity: the teacher's eval at semi step 0 equals the pretrain's
     (the teacher starts as a copy of the loaded student); checked,
  2. per-epoch curves: student and teacher mAP through the semi phase,
  3. end-state pairings that separate parameter blending from a BN
     statistics mismatch:
       - teacher parameters + the final student's BN statistics
       - teacher parameters + the pretrain's BN statistics
       - pretrain parameters + the final student's BN statistics
       - 0.5 * (pretrain + student) parameters + the student's statistics
         (a loss-barrier probe).

With ~780 semi steps at momentum 1e-3 the teacher is a ~46/54 parameter
interpolation between the pretrain and an EMA of the early trajectory;
the reference's real runs take m * N = 1e-3 * ~5400 steps ~ 5.4, so its
teacher converges to a lagged student (simi_teacher_hook.py:54-64).
``--ema-momentum`` lets a second run match that product on a short
horizon.

    python -m nesie_tpu_torch.tools.diagnose_teacher --out build/validation

Writes ``<out>/data`` (generated once), the pretrain under
``<out>/work/nesie-votenet-scannet-pretrain-010`` (resumed when it is
there; ``jitter_delta --root <out>`` reads it) and the report to
``--json-out`` (default ``<out>/diagnose_teacher.json``).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import sys
from pathlib import Path

import torch

PRETRAIN = "nesie-votenet-scannet-pretrain-010"
SEMI = "nesie-votenet-scannet-train-010"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/validation")
    p.add_argument("--n-train", type=int, default=128)
    p.add_argument("--n-val", type=int, default=32)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--pretrain-epochs", type=int, default=14)
    p.add_argument("--semi-epochs", type=int, default=12)
    p.add_argument("--eval-every", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema-momentum", type=float, default=None,
                   help="override cfg.ema_momentum for the semi phase")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--json-out", default=None)
    return p.parse_args(argv)


def snapshot(model) -> dict:
    """The module's parameters and buffers, cloned."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def pairing(params_sd: dict, stats_sd: dict, model) -> dict:
    """A state_dict of ``model``'s layout with its parameters from
    ``params_sd`` and its buffers (BN statistics) from ``stats_sd``."""
    names = {n for n, _ in model.named_parameters()}
    return {k: (params_sd if k in names else stats_sd)[k]
            for k in model.state_dict()}


def blend(a: dict, b: dict, model) -> dict:
    """``0.5 * a + 0.5 * b`` over ``model``'s parameters (the JAX tool's
    ``jax.tree.map`` over params); buffers are not in the result."""
    return {n: 0.5 * a[n] + 0.5 * b[n] for n, _ in model.named_parameters()}


def check_step0(pretrain: dict, teacher: dict) -> None:
    """The teacher's eval at semi step 0 must equal the pretrain's."""
    if pretrain != teacher:
        raise AssertionError(f"the teacher at semi step 0 evaluates "
                             f"{teacher}, the pretrain {pretrain}")


def configs(args, out: Path):
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.tools.validation_run import MID_MODEL

    model_over = [f"model.{k}={v}" for k, v in MID_MODEL.items()]
    common = [f"data.num_points={args.num_points}", "log_interval=20"]

    def milestones(epochs):
        return f"optim.lr_milestones=({int(epochs * 0.7)},{int(epochs * 0.9)})"

    pcfg = apply_overrides(get_config(PRETRAIN), model_over + common + [
        f"optim.max_epochs={args.pretrain_epochs}",
        milestones(args.pretrain_epochs),
        "data.samples_per_step=4",
        "data.repeat=10",
        f"checkpoint_interval_epochs={args.pretrain_epochs}",
    ])
    pcfg = dataclasses.replace(pcfg, seed=args.seed, num_devices=1,
                               work_dir=str(out / "work"))
    scfg = apply_overrides(get_config(SEMI), model_over + common + [
        f"optim.max_epochs={args.semi_epochs}",
        milestones(args.semi_epochs),
        "optim.lr=0.004",
        "data.samples_per_step=2",
        "data.repeat=10",
        "checkpoint_interval_epochs=1000",
    ])
    scfg = dataclasses.replace(scfg, seed=args.seed, num_devices=1,
                               work_dir=str(out / "work"))
    if args.ema_momentum is not None:
        scfg = dataclasses.replace(scfg, ema_momentum=args.ema_momentum)
    return pcfg, scfg


def run(args) -> dict:
    from nesie_tpu_torch.data.dataset import (
        ScanNetScenes,
        SimiScanNetScenes,
        SubScanNetScenes,
    )
    from nesie_tpu_torch.data.synthetic import write_synthetic_scannet
    from nesie_tpu_torch.tools.validation_run import eval_mAP
    from nesie_tpu_torch.train import runner

    device = torch.device(args.device)
    out = Path(args.out)
    root = out / "data"
    json_out = Path(args.json_out or out / "diagnose_teacher.json")
    if not (root / "scannet_infos_train.pkl").exists():
        write_synthetic_scannet(root, args.n_train, args.n_val, seed=args.seed)
    pcfg, scfg = configs(args, out)

    # ---- pretrain (resumed when its checkpoint is there) ----
    pre_ds = SubScanNetScenes(root, root / pcfg.data.train_ann_file,
                              root / pcfg.data.label_list_file)
    pre_state = runner.train_supervised(pcfg, pre_ds, resume=True,
                                        device=device)
    val_ds = ScanNetScenes(root, root / pcfg.data.val_ann_file)
    report = {"curve": [], "probes": {},
              "args": {k: v for k, v in vars(args).items()}}

    def save():
        json_out.parent.mkdir(parents=True, exist_ok=True)
        json_out.write_text(json.dumps(report, indent=2))

    pre_map = eval_mAP(pcfg, pre_state.model, val_ds, device)
    logging.info("pretrain: %s", pre_map)
    report["probes"]["pretrain"] = pre_map

    # ---- semi phase with per-epoch teacher / student curves ----
    semi_ds = SimiScanNetScenes(root, root / scfg.data.train_ann_file,
                                root / scfg.data.label_list_file,
                                ratio=scfg.data.unlabeled_ratio)
    fresh = runner.init_state(scfg, runner.build_model(scfg), 1, device)
    load_state = runner.weights_only_load(fresh, pre_state)
    pre_sd = snapshot(pre_state.model)

    t0_map = eval_mAP(scfg, load_state.teacher, val_ds, device)
    logging.info("teacher@step0: %s (must == pretrain)", t0_map)
    report["probes"]["teacher_step0"] = t0_map
    check_step0(pre_map, t0_map)

    def on_epoch(epoch, state):
        if (epoch + 1) % args.eval_every and epoch + 1 != args.semi_epochs:
            return
        s = eval_mAP(scfg, state.model, val_ds, device)
        t = eval_mAP(scfg, state.teacher, val_ds, device)
        logging.info("epoch %d: student %.4f teacher %.4f (mAP@0.25)",
                     epoch, s["mAP_0.25"], t["mAP_0.25"])
        report["curve"].append(dict(epoch=epoch, student=s, teacher=t))
        save()

    semi_state = runner.train_semi(scfg, semi_ds, load_state,
                                   epoch_callback=on_epoch, device=device)

    # ---- end-state pairing probes ----
    model = semi_state.model
    student_sd, teacher_sd = snapshot(model), snapshot(semi_state.teacher)
    probe_model = copy.deepcopy(model)

    def probe(name, sd):
        probe_model.load_state_dict(sd)
        m = eval_mAP(scfg, probe_model, val_ds, device)
        logging.info("probe %s: %s", name, m)
        report["probes"][name] = m
        save()

    probe("student_final", student_sd)
    probe("teacher+student_stats", pairing(teacher_sd, student_sd, model))
    probe("teacher+pretrain_stats", pairing(teacher_sd, pre_sd, model))
    probe("pretrain+student_stats", pairing(pre_sd, student_sd, model))
    probe("midpoint+student_stats",
          pairing(blend(pre_sd, student_sd, model), student_sd, model))
    save()
    print(json.dumps(report["probes"], indent=2))
    return report


def main(argv=None) -> int:
    from nesie_tpu_torch.utils import no_card

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    if no_card(args.device, "diagnose_teacher"):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
