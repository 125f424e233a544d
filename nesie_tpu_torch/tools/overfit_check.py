#!/usr/bin/env python
"""Synthetic-overfit check (counterpart of ``tools/overfit_check.py``):
train the flagship detector on a handful of generated scenes and report
its mAP on those same scenes.

With no dataset at hand, the smoke signal is that the whole
train -> decode -> eval stack drives mAP well above chance on scenes it
has memorised. The batches come from one numpy stream seeded with
``--seed``, drawn as the JAX tool draws them, so both packages see the
same batch sequence; the weights are flax's default initialisers, the
proposal jitter comes from a generator on the device seeded with
``--seed``.

    python -m nesie_tpu_torch.tools.overfit_check      # flagship, B=8 x 40000
    python -m nesie_tpu_torch.tools.overfit_check --device cpu --tiny
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# the JAX tool's small model for --tiny, at TINY_POINTS points a scene
TINY_MODEL = dict(
    num_proposal=64,
    num_points=(256, 128, 64, 64),
    sa_channels=((32, 32, 64),) + ((64, 64, 64),) * 3,
    fp_channels=((64, 64), (64, 64)),
)
TINY_POINTS = 4096
# a floor, not a target: random predictions score ~0.00, and the JAX
# tool's tiny 300-step CPU run lands ~0.19
MAP_FLOOR = 0.15
RAW_KEYS = ("obj_scores", "sem_scores", "bbox_preds", "iou_scores")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--num-points", type=int, default=40000)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="small model + 4096 points (CPU-sized)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    args = p.parse_args(argv)
    if args.tiny:
        args.num_points = TINY_POINTS
    return args


def build_model(tiny: bool = False):
    from nesie_tpu_torch.nn.detector import VoteNetNesie

    return VoteNetNesie(**TINY_MODEL) if tiny else VoteNetNesie()


def make_dataset(n_scenes: int, seed: int):
    """``n_scenes`` generated scenes, every one labeled."""
    from nesie_tpu_torch.data.dataset import SubScanNetScenes
    from nesie_tpu_torch.data.synthetic import make_synthetic_scenes

    scenes = make_synthetic_scenes(n_scenes, seed=seed)
    return SubScanNetScenes(scenes=scenes,
                            labeled_ids=[s.scene_id for s in scenes])


def draw_batch(ds, rng, batch: int, num_points: int) -> dict:
    """One training batch as the JAX tool draws it: ``batch`` scenes with
    replacement, then their point samples, from the same stream."""
    idx = rng.choice(len(ds), size=batch, replace=True)
    out = ds.eval_batch(list(idx), rng, num_points)
    out.pop("scene_ids")
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_steps(state, step_fn, ds, rng, steps: int, batch: int,
                num_points: int, device, generator=None, noises=None,
                log_every: int = 50) -> dict:
    """``steps`` supervised steps on batches from ``draw_batch``; the
    step's jitter noise is ``noises[i]`` when given, else drawn from
    ``generator``. Returns every step's loss, its time (ms, host clock,
    from its batch on the device to its loss on the host) and the host
    time to draw its batch (ms)."""
    from nesie_tpu_torch.data.dataset import batch_to_device

    losses, step_ms, batch_ms = [], [], []
    t_start = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        host = draw_batch(ds, rng, batch, num_points)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        b = batch_to_device(host, device)
        _sync(device)
        t0 = time.perf_counter()
        m = step_fn(state, b, noise=None if noises is None else noises[i],
                    generator=generator)
        losses.append(float(m["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:8.3f}  "
                  f"({time.perf_counter() - t_start:.0f}s)", flush=True)
    return dict(losses=losses, step_ms=step_ms, batch_ms=batch_ms)


def gt_anno(batch: dict, b: int) -> dict:
    """Scene ``b``'s valid GT boxes, gravity-centred, and labels."""
    valid = batch["gt_valid"][b]
    gb = batch["gt_boxes"][b][valid].copy()
    gb[:, 2] += gb[:, 5] / 2
    return dict(boxes=gb, labels=batch["gt_labels"][b][valid])


def dt_annos(decoded: dict, n_real: int) -> list:
    """The first ``n_real`` scenes' per-class detections from a batch's
    decoded outputs (numpy)."""
    from nesie_tpu_torch.eval.postprocess import expand_per_class

    out = []
    for b in range(n_real):
        boxes, scores, labels = expand_per_class(
            {k: v[b] for k, v in decoded.items()})
        out.append(dict(boxes=boxes, scores=scores, labels=labels))
    return out


@torch.no_grad()
def evaluate_scenes(state, ds, rng, batch: int, num_points: int, device,
                    generator=None) -> dict:
    """The seed-mode eval forward, ``decode_and_nms`` and ``indoor_eval``
    over every scene of ``ds`` in batches of ``batch`` (the tail padded
    with its last scene), the point samples drawn from ``rng``. Returns
    the metrics (``results``), the number of proposals kept after NMS
    (``kept``) and, a batch each, the points, the head's raw outputs and
    the decoded outputs on the host (``batches``), so that a caller can
    decode the same outputs again elsewhere."""
    from nesie_tpu_torch.data.scannet_meta import CLASS_NAMES
    from nesie_tpu_torch.eval import decode_and_nms, indoor_eval
    from nesie_tpu_torch.train.step import make_eval_forward

    fwd = make_eval_forward("seed")
    gts, dts, batches = [], [], []
    for start in range(0, len(ds), batch):
        idx = list(range(start, min(start + batch, len(ds))))
        n_real = len(idx)
        idx = idx + [idx[-1]] * (batch - n_real)
        host = ds.eval_batch(idx, rng, num_points)
        points = torch.from_numpy(host["points"]).to(device)
        out = fwd(state, points, generator)
        decoded = {k: v.cpu().numpy()
                   for k, v in decode_and_nms(out, points).items()}
        dts += dt_annos(decoded, n_real)
        gts += [gt_anno(host, b) for b in range(n_real)]
        batches.append(dict(
            n_real=n_real, points=host["points"], decoded=decoded,
            raw={k: out[k].cpu().numpy() for k in RAW_KEYS},
            gt=gts[-n_real:]))
    results = indoor_eval(gts, dts, class_names=list(CLASS_NAMES))
    kept = int(sum(b["decoded"]["selected"][:b["n_real"]].sum()
                   for b in batches))
    return dict(results=results, kept=kept, batches=batches)


def check_floor(results: dict, n_scenes: int) -> None:
    """Raise when mAP@0.25 is not above ``MAP_FLOOR``."""
    if not results["mAP_0.25"] > MAP_FLOOR:
        raise AssertionError(
            "overfit sanity failed: the stack should memorize "
            f"{n_scenes} scenes (mAP@0.25 = {results['mAP_0.25']:.3f})")


def run(args) -> dict:
    """Train, evaluate, print, check the floor; returns the training log
    (``train_steps``) and the evaluation (``evaluate_scenes``)."""
    from nesie_tpu_torch.nn.detector import init_weights_flax_
    from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
    from nesie_tpu_torch.train.step import make_supervised_train_step

    device = torch.device(args.device)
    model = build_model(args.tiny)
    ds = make_dataset(args.scenes, args.seed)
    rng = np.random.default_rng(args.seed)
    init_weights_flax_(model, torch.Generator().manual_seed(args.seed))
    state = create_train_state(
        model, make_lr_schedule(args.lr, max(args.steps, 1)), device=device)
    gen = torch.Generator(device).manual_seed(args.seed)
    log = train_steps(state, make_supervised_train_step(), ds, rng,
                      args.steps, args.batch, args.num_points, device, gen)
    ev = evaluate_scenes(state, ds, rng, args.batch, args.num_points,
                         device, gen)
    results = ev["results"]
    for k in sorted(results):
        if k.startswith("mAP") or k.startswith("mAR"):
            print(f"{k}: {results[k]:.4f}")
    print(f"proposals kept after NMS: {ev['kept']} over {len(ds)} scenes")
    if args.steps:
        print(f"median step {np.median(log['step_ms']):.3f} ms, median "
              f"host batch {np.median(log['batch_ms']):.3f} ms")
    check_floor(results, args.scenes)
    print("overfit check PASSED")
    return dict(log=log, eval=ev)


def main(argv=None) -> int:
    from nesie_tpu_torch.utils import no_card

    args = parse_args(argv)
    if no_card(args.device, "overfit_check"):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
