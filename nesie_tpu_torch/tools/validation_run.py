#!/usr/bin/env python
"""Full-pipeline accuracy validation on a generated dataset (counterpart
of ``tools/validation_run.py``).

Runs the reference's training protocol (supervised pretrain on the
labeled split, then semi-supervised teacher-student training over the
full unlabeled pool) through the port's runner and on-disk data path, and
evaluates held-out mAP for the pretrain baseline, the semi student and
the semi EMA teacher, over ``--seeds`` and named ``--semi-variants``
(pretrain shared per seed, one semi phase per variant). The gates:
student mean mAP@0.25 above pretrain's, teacher mean at or above 0.98 x
pretrain's.

    python -m nesie_tpu_torch.tools.validation_run --out build/validation \\
        --seeds 0,1,2 --json-out build/validation/study.json

``--head saqe`` runs the same protocol on the ``saqe-votenet-scannet-*``
configs, as the JAX tool's ``--head``. A variant that needs an option the
port lacks (``teacher_jitter=true``) fails with the runner's
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np

MID_MODEL = dict(
    num_proposal=64,
    reg_max=16,
    num_points=(256, 128, 64, 64),
    num_samples=(32, 16, 8, 8),
    sa_channels=((32, 32, 64), (64, 64, 64), (64, 64, 64), (64, 64, 64)),
    fp_channels=((64, 64), (64, 64)),
)

# the reference's EMA horizon: momentum 1e-3 over ~36 epochs of real
# ScanNet semi training ≈ 5400 steps -> m*N ≈ 5.4, i.e. the teacher
# converges to a lagged student. Short synthetic runs must SCALE the
# momentum to the same product or the teacher is left a pretrain/student
# parameter interpolation mid loss-barrier.
REF_EMA_PRODUCT = 5.4
KEY = "mAP_0.25"


def eval_mAP(cfg, model, ds, device, batch=8, seed=9):
    from nesie_tpu_torch.tools.test import evaluate

    res = evaluate(cfg, model, ds, batch, seed, device)
    return {k: float(v) for k, v in res.items()
            if k.startswith("mAP") or k.startswith("mAR")}


def parse_variants(specs):
    """['default=', 'quirk=pseudo.literal_reference_cbl=false,...'] ->
    [(name, [overrides...]), ...]"""
    out = []
    for spec in specs:
        name, _, rest = spec.partition("=")
        over = [o for o in rest.split(",") if o]
        out.append((name, over))
    return out


def run_seed(args, root, seed, variants):
    """One full pretrain + per-variant semi pipeline; returns metrics."""
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data.dataset import (
        ScanNetScenes,
        SimiScanNetScenes,
        SubScanNetScenes,
    )
    from nesie_tpu_torch.train import runner

    prefix = "saqe" if args.head == "saqe" else "nesie"
    model_over = ([f"model.{k}={v}" for k, v in MID_MODEL.items()]
                  + args.model_overrides)
    common_over = [f"data.num_points={args.num_points}", "log_interval=20"]
    out = Path(args.out)

    # per-seed RANDOM labeled split (the reference protocol's "3 random
    # splits") — seed 0 keeps the canonical prefix split
    frac = {"005": "0.05", "010": "0.1", "020": "0.2", "050": "0.5"}[args.split]
    if seed != 0:
        names = (root / "meta_data" / "scannetv2_train_all.txt").read_text().split()
        k = len((root / "meta_data" / f"scannetv2_train_{frac}.txt").read_text().split())
        picked = np.random.default_rng(1000 + seed).permutation(names)[:k]
        split_file = f"meta_data/scannetv2_train_{frac}_s{seed}.txt"
        (root / split_file).write_text("\n".join(sorted(picked)) + "\n")
        common_over = common_over + [f"data.label_list_file={split_file}"]

    pcfg = get_config(f"{prefix}-votenet-scannet-pretrain-{args.split}")
    pcfg = apply_overrides(pcfg, model_over + common_over + [
        f"optim.max_epochs={args.pretrain_epochs}",
        f"optim.lr_milestones=({int(args.pretrain_epochs*0.7)},"
        f"{int(args.pretrain_epochs*0.9)})",
        "data.samples_per_step=4",
        f"data.repeat={args.pretrain_repeat}",
        # checkpoint once at the end so reruns skip the pretrain
        f"checkpoint_interval_epochs={args.pretrain_epochs}",
    ])
    pcfg = dataclasses.replace(
        pcfg, seed=seed, num_devices=1,
        work_dir=str(out / f"work_s{seed}"),
        name=pcfg.name + f"_s{seed}",
    )
    pre_ds = SubScanNetScenes(root, root / pcfg.data.train_ann_file,
                              root / pcfg.data.label_list_file)
    logging.info("[seed %d] pretrain: %d labeled scenes", seed, len(pre_ds))
    t0 = time.time()
    pre_state = runner.train_supervised(pcfg, pre_ds, resume=True,
                                        device=args.device)
    pre_min = (time.time() - t0) / 60
    logging.info("[seed %d] pretrain took %.1f min", seed, pre_min)

    val_ds = ScanNetScenes(root, root / pcfg.data.val_ann_file)
    pre_map = eval_mAP(pcfg, pre_state.model, val_ds, args.device)
    logging.info("[seed %d] pretrain val: %s", seed, pre_map)

    results = {"pretrain": pre_map, "pretrain_min": pre_min, "variants": {}}
    for vname, vover in variants:
        scfg = get_config(f"{prefix}-votenet-scannet-train-{args.split}")
        scfg = apply_overrides(scfg, model_over + common_over + [
            f"optim.max_epochs={args.semi_epochs}",
            f"optim.lr_milestones=({int(args.semi_epochs*0.7)},"
            f"{int(args.semi_epochs*0.9)})",
            "optim.lr=0.004",
            "data.samples_per_step=2",
            f"data.repeat={args.semi_repeat}",
            "checkpoint_interval_epochs=1000",  # semi variants retrain
        ] + args.semi_overrides + vover)
        scfg = dataclasses.replace(
            scfg, seed=seed, num_devices=1,
            work_dir=str(out / f"work_s{seed}_{vname}"))
        semi_ds = SimiScanNetScenes(root, root / scfg.data.train_ann_file,
                                    root / scfg.data.label_list_file,
                                    ratio=scfg.data.unlabeled_ratio)
        steps = max(
            max(semi_ds.num_labeled * scfg.data.repeat
                // scfg.data.samples_per_step, 1) * args.semi_epochs, 1)
        if args.ema_scale_ref:
            m = min(0.05, REF_EMA_PRODUCT / steps)
            scfg = dataclasses.replace(scfg, ema_momentum=m)
            logging.info("[seed %d/%s] ema momentum scaled to %.4f "
                         "(%d steps, m*N=%.1f)", seed, vname, m, steps,
                         m * steps)
        fresh = runner.init_state(scfg, runner.build_model(scfg), 1,
                                  args.device)
        load_state = runner.weights_only_load(fresh, pre_state)
        t0 = time.time()
        stats = {}
        semi_state = runner.train_semi(scfg, semi_ds, load_state,
                                       run_stats=stats, device=args.device)
        semi_min = (time.time() - t0) / 60
        logging.info("[seed %d/%s] semi took %.1f min (pseudo/step %s)",
                     seed, vname, semi_min,
                     [f"{x:.1f}" for x in
                      stats.get("num_pseudo_per_step", [])])

        student = eval_mAP(scfg, semi_state.model, val_ds, args.device)
        teacher = eval_mAP(scfg, semi_state.teacher, val_ds, args.device)
        logging.info("[seed %d/%s] student %s", seed, vname, student)
        logging.info("[seed %d/%s] teacher %s", seed, vname, teacher)
        results["variants"][vname] = {
            "student": student, "teacher": teacher, "semi_min": semi_min,
            "num_pseudo_per_step": stats.get("num_pseudo_per_step", []),
            "num_pseudo_mean": stats.get("num_pseudo_mean", 0.0),
        }
    return results


def _agg(values):
    a = np.asarray(values, np.float64)
    return float(a.mean()), float(a.std())


def summary(per_seed, variants) -> tuple[list[str], dict]:
    """Mean ± std of mAP@0.25 over the seeds, and the two gates of the
    ``default`` variant."""
    seeds = sorted(per_seed)
    pre = _agg([per_seed[s]["pretrain"][KEY] for s in seeds])
    lines = [f"pretrain {KEY}: {pre[0]:.4f} ± {pre[1]:.4f}"]
    for s in seeds:
        r = per_seed[s]
        parts = [f"pretrain {r['pretrain'][KEY]:.4f}"]
        for vname, _ in variants:
            v = r["variants"][vname]
            parts.append(f"[{vname}] student {v['student'][KEY]:.4f} teacher "
                         f"{v['teacher'][KEY]:.4f} (pseudo/step "
                         f"{v['num_pseudo_mean']:.3f})")
        lines.append(f"seed {s}: " + ", ".join(parts))
    gates = {}
    for vname, _ in variants:
        st = _agg([per_seed[s]["variants"][vname]["student"][KEY]
                   for s in seeds])
        te = _agg([per_seed[s]["variants"][vname]["teacher"][KEY]
                   for s in seeds])
        lines.append(f"[{vname}] student {KEY}: {st[0]:.4f} ± {st[1]:.4f}, "
                     f"teacher {te[0]:.4f} ± {te[1]:.4f}")
        if vname == "default":
            gates = {"student > pretrain": st[0] > pre[0],
                     "teacher >= 0.98*pretrain": te[0] >= 0.98 * pre[0]}
    return lines, gates


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="build/validation")
    p.add_argument("--n-train", type=int, default=128)
    p.add_argument("--n-val", type=int, default=32)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--data-classes", type=int, default=18,
                   help="distinct object classes in the generated scenes")
    p.add_argument("--objects", default="3,8",
                   help="min,max objects per scene")
    p.add_argument("--pretrain-epochs", type=int, default=14)
    p.add_argument("--semi-epochs", type=int, default=12)
    p.add_argument("--pretrain-repeat", type=int, default=10,
                   help="RepeatDataset factor for the pretrain phase")
    p.add_argument("--semi-repeat", type=int, default=10,
                   help="RepeatDataset factor for the semi phase (labeled "
                        "stream; steps/epoch = n_labeled*repeat/batch)")
    p.add_argument("--seeds", default="0",
                   help="comma list; the study runs the full pipeline per "
                        "seed and reports mean±std")
    p.add_argument("--head", default="nesie", choices=["nesie", "saqe"])
    p.add_argument("--split", default="010",
                   choices=["005", "010", "020", "050"],
                   help="labeled split (reference config family suffix)")
    p.add_argument("--ema-scale-ref", action="store_true", default=True)
    p.add_argument("--no-ema-scale-ref", dest="ema_scale_ref",
                   action="store_false",
                   help="keep the literal reference momentum 1e-3 even on "
                        "short horizons")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json-out", default=None)
    p.add_argument("--model-overrides", nargs="*", default=[],
                   help="extra model.* overrides applied to BOTH phases")
    p.add_argument("--semi-overrides", nargs="*", default=[],
                   help="extra cfg overrides applied to every semi arm")
    p.add_argument("--semi-variants", nargs="*", default=["default="],
                   help="name=ov1,ov2 per arm; e.g. "
                        "quirk_cbl=pseudo.literal_reference_cbl=false")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from nesie_tpu_torch.data.synthetic import write_synthetic_scannet

    out = Path(args.out)
    t_start = time.time()
    root = out / "data"
    lo, hi = (int(x) for x in args.objects.split(","))
    if not (root / "scannet_infos_train.pkl").exists():
        write_synthetic_scannet(root, args.n_train, args.n_val,
                                seed=0, num_classes=args.data_classes,
                                num_objects=(lo, hi))
    logging.info("dataset at %s (%d train / %d val)", root, args.n_train,
                 args.n_val)

    variants = parse_variants(args.semi_variants)
    seeds = [int(s) for s in args.seeds.split(",")]
    payload = {"args": {k: v for k, v in vars(args).items()
                        if isinstance(v, (int, float, str, bool, list))},
               "per_seed": {}}
    per_seed = payload["per_seed"]
    for seed in seeds:
        per_seed[seed] = run_seed(args, root, seed, variants)
        if args.json_out:
            Path(args.json_out).write_text(json.dumps(payload, indent=2))

    lines, gates = summary(per_seed, variants)
    payload["gates"] = gates
    payload["minutes"] = (time.time() - t_start) / 60
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(payload, indent=2))
    print(json.dumps(per_seed, indent=2))
    print(f"head {args.head}")
    for line in lines:
        print(line)
    print("gates: " + ", ".join(f"{k}: {'yes' if v else 'NO'}"
                                for k, v in gates.items()))
    print(f"wall clock: {payload['minutes']:.1f} min")
    return payload


if __name__ == "__main__":
    main()
