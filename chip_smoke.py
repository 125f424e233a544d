#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nesie_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources beside this
file; fails without them. In order:

1. toolchain: the card's name and power limit, torch / CUDA / nvcc
   versions, TF32 off for matmuls and cuDNN;
2. builds the CUDA kernels from ``nesie_tpu_torch/csrc``;
3. kernel phases: each kernel against its plain PyTorch version on the
   same seeded inputs at the main path's shapes (integer outputs must be
   identical), with both times;
   FPS runs ``fps_onchip.cu`` on both paths (each row held on chip on
   one CTA or across a thread-block cluster, a mailbox exchange across a
   cluster): B > 16 (the eval forward's 32 x 40000 -> 2048 and a ragged
   17 x 40001, each beside the barrier exchange, ``fps.cu`` and
   ``fps_cluster.cu`` at C=2) and B <= 16 (the four shapes of requests
   and training steps, each beside ``fps_cluster.cu`` and the barrier
   exchange), all held to ``fps_ref`` and to each other. ``fps_cluster.cu``
   (one cluster per row) and ``fps.cu`` (one block per row: the lab's
   ``v0`` baseline) are second references, off the eval and training
   paths; the ball query at the eval forward's five shapes (SA1-SA4, the
   aggregation) at B=32 and at SA1 for B=12; three-NN at the side grid,
   the box grid and the two FP shapes, each beside ``torch.topk`` of
   ``torch.cdist``;
   [fps-lab], counts set to 0 before and read after (path ``lab``): the
   FPS lab's two entry points run all eight step variants of
   ``csrc/fps_variants.cu`` (the TPU lab's K5 and K6) on the tie-heavy
   and random check clouds (B=3, N=600, M=37; odd B for the two-row
   ``v3``), at K5's bench shape (8 x 40000 -> 2048, uniform) and at K6's
   default (32 x 40000 -> 2048, normal x 3), each beside ``fps.cu`` and
   ``fps_cluster.cu``; every variant must give ``fps_ref``'s indices.
   Then each variant against its plain version, with both times;
4. eval path: the flagship VoteNetNesie (seeded random weights, BN
   running stats randomised) runs the batched eval forward at
   B=32 x 40000 x 4 and serves three ``Detector`` requests (B=1), with
   every kernel's launch count set to 0 just before and read just after;
   then one scene's GPU forward is held against the same forward on the
   CPU, which runs the plain versions;
5. training path, counts set to 0 before and read after: five timed
   teacher-student semi steps of the flagship at the reference shape
   (4 labeled + 8 unlabeled scenes x 40000 x 4, 64 GT slots with 8 boxes
   per labeled scene) after one warm-up, then five supervised steps at
   B=8 after one warm-up, with the losses, gradients, the parameter and
   BN-statistic updates and the EMA teacher checked;
6. one semi step of a narrow model (1 + 2 scenes of 4096 points, relaxed
   pseudo-label thresholds) on the card and on the CPU from the same
   weights and inputs: pseudo-boxes and a nonzero unsupervised IoU loss
   on both, identical FPS and ball-query indices, loss terms within
   atol 1e-4 + rtol 1e-3, gradient cosine above 0.999;
7. [runner], counts set to 0 before and read after each of its two paths:
   ``write_synthetic_scannet`` writes 16 training and 32 val scenes under
   ``build/``; ``tools/train.py`` (in-process) pretrains the flagship
   (``nesie-votenet-scannet-pretrain-050``, 2 epochs of 2 steps at B=4 x
   40000), trains it semi-supervised from that checkpoint
   (``...-train-050``, 2 epochs of 2 steps at 4 + 8 scenes) and resumes
   that run for a third epoch (path ``runner``); ``tools/test.py``
   evaluates the student and the teacher on the 32 val scenes in one
   batch of 32, and ``init_detector(config name, checkpoint dir)`` serves
   one request (path ``runner_eval``). Checks: finite values on every
   logged step, a checkpoint that reloads bit for bit (parameters,
   buffers, optimizer state, step, ``UlbState``), the resumed run's first
   step, mAP and mAR at 0.25 in [0, 1]. Prints the runner's step times
   beside the bare steps of phase 5, the host time of one
   ``semi_batch`` and ``evaluate``'s scenes a second;
8. [saqe], the SAQE family (``saqe-votenet-scannet-train-050``'s model:
   18 classes, reg_max 32, 256 proposals, jitter 0.5 + 0.2; seeded
   flax-style weights): three-NN at the quality module's 162-point grid
   (32 x 41472 and 12 x 82944 queries against 1024 seeds), identical to
   ``three_nn_ref``, beside its bound and ``torch.topk(torch.cdist)``;
   then, counts set to 0 before and read after each of four paths: the
   B=32 eval forward (median of 5, beside this run's Nesie forward) and
   the SUN RGB-D test config's, three requests through
   ``init_detector("saqe-votenet-scannet-test")`` (path ``saqe_eval``:
   the ball query at 5 launches a forward, three-NN at 3); the bare SAQE
   semi step (4 + 8 scenes) and supervised step (B=8) with every SAQE
   loss term finite, peak memory, student, BN and teacher moved (path
   ``saqe_train``); the train CLI on ``[runner]``'s dataset, SAQE
   pretrain then semi from it, one epoch each (``saqe_runner``); the
   test CLI on the student and the teacher at B=32 and one request from
   the checkpoint (``saqe_runner_eval``). Between them, the eval forward
   under the profiler (busy, idle share) and one scene against the CPU.

Prints ``{"kernels": [...]}``, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

B, N_POINTS = 32, 40000
# the main path's kernel shapes (flagship VoteNetNesie, sample_mod="seed")
SA1 = dict(n=N_POINTS, m=2048, radius=0.2, k=64)
SEEDS = 1024  # SA2's points: the vote seeds
SIDE_GRID = dict(m=256 * 96, n=1024)  # side-grid queries vs seeds
FP1 = dict(m=1024, n=512)
# three-NN's shapes at B=32: (what, queries a row, sources a row)
K4_SHAPES = (("side grid", SIDE_GRID["m"], SIDE_GRID["n"]),
             ("box grid", 256 * 64, SEEDS),
             ("FP1", FP1["m"], FP1["n"]),
             ("FP2", 512, 256))
LARGE_FPS = dict(b=2, scenes_per_row=5, m=2048)  # rows of 200000 points
# the B <= 16 FPS shapes (the TPU's single-row kernel's): (what, B, N, M)
K2_SHAPES = (("a Detector request", 1, N_POINTS, 2048),
             ("semi-step SA1", 12, N_POINTS, 2048),
             ("vote-mode aggregation", 12, 1024, 256),
             ("the single-row regime", 2, 200000, 2048))
K2_MAIN = 1  # the shape reported in the kernels line
# CPU-vs-GPU rule for one scene: float outputs within atol + rtol*|x|,
# and a proposal agrees when all its box, objectness and IoU outputs do
ATOL = RTOL = 1e-3
MIN_AGREE = 0.95
# the semi step of the reference recipe (configs/...train-010.py:
# samples_per_gpu=4, ratio=2), and the supervised step
SEMI = dict(n_labeled=4, n_unlabeled=8, max_gt=64, n_boxes=8, scans=64)
SUP_B = 8
TIMED_STEPS = 5
# GPU-vs-CPU training step: the narrow widths of tests/test_torch_slice.py
TINY = dict(
    reg_max=8,
    num_proposal=128,
    num_points=(256, 128, 128, 128),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
TINY_POINTS = 4096
TRAIN_ATOL, TRAIN_RTOL, MIN_COSINE = 1e-4, 1e-3, 0.999
# pseudo-label thresholds relaxed (as in tests/test_torch_train_semi.py)
# so that the narrow teacher's random weights yield pseudo-boxes and the
# quality-weighted unsupervised losses are compared where they are not 0
RELAXED_PL = dict(obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0,
                  cls_thr_cap=0.0, iou_thr_base=0.3, iou_thr_scale=0.0,
                  iou_thr_cap=0.3)
# the kernels the eval and training paths must launch; fps.cu and
# fps_cluster.cu are second references and must read 0 on both
EVAL_KERNELS = ("fps_onchip", "fps_onchip_small", "ball_query", "three_nn")
TRAIN_KERNELS = ("fps_onchip_small", "ball_query", "three_nn")
OFF_PATH = ("fps", "fps_cluster")
# the batched FPS kernel's shapes beyond the eval forward's: (B, N, M)
ONCHIP_RAGGED = (17, N_POINTS + 1, 2048)
SEMI_B = 12  # the semi step's batch, for the SA1 ball query
LAB_REPS = 5
# [runner]: the flagship through the CLIs on a written synthetic dataset
# (split 050: 8 of the 16 training scenes labeled; B=4 labeled, 4 + 8 in
# the semi step, 2 steps an epoch), evaluated on 32 val scenes at once
RUNNER = dict(n_train=16, n_val=32, eval_batch=32, data_seed=0,
              pretrain="nesie-votenet-scannet-pretrain-050",
              semi="nesie-votenet-scannet-train-050")
RUNNER_OVER = ["optim.max_epochs=2", "data.repeat=1", "log_interval=1"]
RUNNER_EVAL_KERNELS = ("fps_onchip",)
SEMI_BATCH_REPS = 3
# [saqe]: the flagship SAQE model of the shipped configs (18 classes,
# reg_max 32, 256 proposals, jitter 0.5 with size bias 0.2), its SUN RGB-D
# test config, and three-NN at the quality module's grid: 162 points a
# box, 256 boxes a row at eval (B=32), 512 (main + jittered) in the semi
# student's 12 rows
SAQE_CONFIG = "saqe-votenet-scannet-train-050"
SAQE_PRETRAIN = "saqe-votenet-scannet-pretrain-050"
SAQE_SERVE = "saqe-votenet-scannet-test"
SAQE_SUN = "saqe-votenet-sunrgbd-test"
SAQE_GRID = 162
SAQE_K4_SHAPES = (("SAQE eval grid", B, 256 * SAQE_GRID, SEEDS),
                  ("SAQE semi-student grid", SEMI_B, 512 * SAQE_GRID, SEEDS))
SAQE_PRETRAIN_TERMS = ("vote_loss", "objectness_loss", "center_loss",
                       "surface_loss", "angle_loss", "angle_pred_loss",
                       "semantic_loss", "iou_loss", "iou_pred_loss",
                       "side_loss")
SAQE_SEMI_TERMS = tuple(t for t in SAQE_PRETRAIN_TERMS
                        if t != "angle_pred_loss") + (
    "unsup_center_loss", "unsup_semantic_loss", "unsup_iou_loss",
    "unsup_surface_loss")
# the kernel launches of one forward of either head: the ball query at
# SA1-SA4 and the aggregation, three-NN at FP1, FP2 and the quality grid
# (one grid for SAQE)
SAQE_BQ_PER_FORWARD, SAQE_3NN_PER_FORWARD = 5, 3
# The rate of fp32 operations that are not FMAs: 132 SMs x 128 lanes x
# the 1.98 GHz boost clock (the data sheet's 67 TFLOP/s counts an FMA as
# two). sq_dist.cuh forbids contraction, so none of the point kernels can
# use FMAs; and HBM3's published 3.35 TB/s.
NON_FMA_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(name, kernel, plain, reps=10, plain_reps=2):
    """Kernel vs plain version on the same inputs: identical integer
    output required. Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = (got.double() - want.double()).abs().max().item()
    mismatched = int((got != want).sum().item())
    if mismatched:
        raise AssertionError(f"{name}: {mismatched} indices differ from the "
                             f"plain version (max |diff| {err})")
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(plain, plain_reps)
    print(f"[kernel] {name}: identical to plain, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: fp32
    operations at the card's rate for operations that are not FMAs, or
    each input read and each output written once at its memory rate."""
    t_ops, t_bytes = ops / NON_FMA_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fps_bound(b: int, n: int, m: int):
    """D-FPS: per step and point 3 subtractions, 3 products, 2 sums, one
    min and one compare of the argmax; reads the coordinates, writes the
    indices."""
    return bound(10.0 * b * n * (m - 1), 12.0 * b * n + 4.0 * b * m)


def ball_query_bound(idx, n: int):
    """Ball query: 8 operations per (center, point) pair up to the K-th
    hit, the point count this run's data needs (a center with fewer than
    K hits scans all n); reads both point sets, writes the indices."""
    import torch

    k = idx.shape[-1]
    last, first = idx[..., -1].long(), idx[..., 0].long()
    scanned = torch.where(last > first, last + 1, n).double().sum().item()
    b, m = idx.shape[:2]
    return bound(8.0 * scanned, 12.0 * b * (n + m) + 4.0 * idx.numel())


def three_nn_bound(b: int, m: int, n: int):
    """Three-NN: 8 operations per (query, source) pair for the distance
    and one compare; reads both point sets, writes 3 indices a query."""
    return bound(9.0 * b * m * n, 12.0 * b * (m + n) + 12.0 * b * m)


def fps_lab_phase():
    """[fps-lab]: the lab path (both lab entry points, every variant on
    the card, counts set to 0 before and read after), then each variant
    against its plain version. Returns (launches of the path, the
    kernels-line entries of the variants)."""
    import torch

    from nesie_tpu_torch.ops import _build, fps_variants
    from nesie_tpu_torch.ops.fps_variants import (
        LAB_VARIANTS,
        VARIANTS,
        fps_variant_cuda,
        fps_variant_ref,
    )
    from nesie_tpu_torch.tools import fps_experiments, fps_lab

    t0 = time.perf_counter()
    _build.reset_launch_counts()
    fps_variants.reset_launch_counts()
    # ----- the lab path
    if fps_lab.check("cuda", VARIANTS) != 0:
        raise AssertionError("[fps-lab] a variant differs from fps_ref on "
                             "the check clouds")
    k5 = {r["variant"]: r for r in fps_lab.bench(VARIANTS, reps=LAB_REPS)}
    b5, n5, m5 = fps_lab.BENCH_SHAPE
    k6_batch = 32  # fps_experiments' default; K5 and K6 share N and M
    k6 = fps_experiments.run(batch=k6_batch, n=n5, m=m5,
                             variants=["v0", *VARIANTS], iters=LAB_REPS)
    launches = _build.launch_counts()
    per_variant = fps_variants.launch_counts()
    # ----- end of the lab path
    bad = [f"K5 {k}" for k, r in k5.items() if not r["exact"]] + [
        f"K6 {k}" for k, r in k6.items() if not r["exact_vs_xla"]]
    if bad:
        raise AssertionError(f"[fps-lab] indices differ from fps_ref: {bad}")
    print(f"[fps-lab] launches during the lab path: {launches}; by variant "
          f"{per_variant}")
    for name, n in {**per_variant, "fps": launches["fps"],
                    "fps_cluster": launches["fps_cluster"]}.items():
        if n <= 0:
            raise AssertionError(f"[fps-lab] {name} was never launched")

    clouds = {"K5": (fps_lab.bench_cloud("cuda"), m5),
              "K6": (fps_experiments.make_cloud(k6_batch, n5, "cuda"), m5)}
    k5_tag, k6_tag = f"{b5}x{n5}->{m5}", f"{k6_batch}x{n5}->{m5}"
    print(f"[fps-lab] ms by variant: {k5_tag} (mean of {LAB_REPS}, beside "
          f"fps.cu {k5['v0']['ms']:.4f} and the dispatch's fps_cluster.cu "
          f"{k5['v0_current']['ms']:.4f}) | {k6_tag} (least of "
          f"{LAB_REPS}, beside fps.cu {k6['v0']['ms']:.4f} and "
          f"fps_cluster.cu {k6['fps_cluster']['ms']:.4f})")
    entries = []
    for name, v in VARIANTS.items():
        which = "K5" if name in LAB_VARIANTS else "K6"
        x, m = clouds[which]
        got = fps_variant_cuda(x, m, name)
        want = fps_variant_ref(x, m, name)
        if not torch.equal(got, want):
            raise AssertionError(f"[fps-lab] {name} differs from its plain "
                                 "version")
        err = (got.double() - want.double()).abs().max().item()
        plain_ms = time_ms(lambda: fps_variant_ref(x, m, name), 1)
        b_ms, b_by = fps_bound(x.shape[0], x.shape[1], m)
        by_shape = {k5_tag: k5[name]["ms"], k6_tag: k6[name]["ms"]}
        print(f"[fps-lab] {name:12s} ({v.select}, {v.fetch}, rows {v.rows}, "
              f"unroll {v.unroll}): {by_shape[k5_tag]:.4f} | "
              f"{by_shape[k6_tag]:.4f} ms; plain {plain_ms:.4f} ms at "
              f"{which}'s shape, bound {b_ms:.4f} ms")
        entries.append(dict(
            name=f"fps_variant:{name}", route="cuda",
            source="nesie_tpu_torch/csrc/fps_variants.cu",
            replaces=v.replaces, launches=per_variant[name],
            max_abs_err=err, ms=by_shape[k5_tag if which == "K5" else k6_tag],
            ms_by_shape=by_shape, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
    print(f"[fps-lab] phase {time.perf_counter() - t0:.2f} s")
    return launches, entries


def timed_steps(run_step, n: int):
    """One warm-up and ``n`` timed calls of ``run_step`` (host clock around
    work that ends in a synchronize); returns (times ms, last result)."""
    import torch

    out = run_step()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = run_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def check_finite(metrics: dict, model, what: str) -> None:
    import torch

    for k, v in metrics.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{what}: {k} = {v.item()} is not finite")
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{what}: gradient of {name} missing or not "
                                 "finite")


def training_path(dev, head: str = "nesie") -> dict:
    """The flagship's semi and supervised steps on the card; every check
    of the training phase. ``head="saqe"``: the flagship SAQE model
    (``SAQE_CONFIG``, flax-style seeded weights) with the SAQE losses, and
    every SAQE loss term checked by name. Returns the numbers it
    printed."""
    import torch

    from nesie_tpu_torch.data.synthetic import semi_batch
    from nesie_tpu_torch.nn.detector import (
        VoteNetNesie,
        init_weights_,
        init_weights_flax_,
    )
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import (
        create_train_state,
        make_lr_schedule,
    )
    from nesie_tpu_torch.train.step import make_supervised_train_step

    tag = "[saqe]" if head == "saqe" else "[train]"
    if head == "saqe":
        model = saqe_model()
        init_weights_flax_(model, torch.Generator().manual_seed(3))
    else:
        model = VoteNetNesie()  # flagship width and depth
        init_weights_(model, torch.Generator().manual_seed(3))
    state = create_train_state(model, make_lr_schedule(8e-3, 1000),
                               device=dev)
    rng = np.random.default_rng(7)
    batch = semi_batch(rng, SEMI["n_labeled"], SEMI["n_unlabeled"],
                        N_POINTS, SEMI["max_gt"], SEMI["n_boxes"], dev)
    ulb = [UlbState.create(SEMI["scans"], 18, device=dev)]
    step = make_semi_train_step(SEMI["n_labeled"], SEMI["scans"], head=head)
    gen = torch.Generator(dev).manual_seed(2)
    conv = state.model.backbone.SA_modules[0].mlps[0].layer0
    watched = {"SA1 conv weight": conv.conv.weight,
               "SA1 BN running mean": conv.bn.running_mean}
    if head == "saqe":
        fused = state.model.bbox_head.grid_conv.mlps_head[6]
        watched.update({"fused quality head weight": fused[6].weight,
                        "fused quality head BN running mean":
                        fused[1].running_mean})
    before = {k: v.detach().clone() for k, v in watched.items()}

    def semi_step():
        ulb[0], metrics = step(state, ulb[0], batch, generator=gen)
        return metrics

    b_semi = SEMI["n_labeled"] + SEMI["n_unlabeled"]
    torch.cuda.reset_peak_memory_stats()
    times, metrics = timed_steps(semi_step, TIMED_STEPS - 1)
    # the last step once more with the teacher watched: EMA rule
    teacher_w = state.teacher.backbone.SA_modules[0].mlps[0].layer0.conv.weight
    e0 = teacher_w.detach().clone()
    t0 = time.perf_counter()
    metrics = semi_step()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite(metrics, state.model, f"{head} semi step")
    if head == "saqe":
        check_terms(metrics, SAQE_SEMI_TERMS, "SAQE semi step")
    m = min(1e-3, (1.0 + state.step) / (10.0 + state.step))
    want = (1.0 - m) * e0 + m * conv.conv.weight.detach()
    if not torch.allclose(teacher_w, want, rtol=1e-5, atol=1e-7):
        raise AssertionError("the teacher did not move by the EMA rule")
    for k, v in watched.items():
        if torch.equal(v.detach(), before[k]):
            raise AssertionError(f"the student's {k} did not move")
    ms = float(np.median(times))
    terms = {k: round(v.item(), 6) for k, v in metrics.items()}
    print(f"{tag} semi step {SEMI['n_labeled']} labeled + "
          f"{SEMI['n_unlabeled']} unlabeled x {N_POINTS} x 4: median "
          f"{ms:.3f} ms over {len(times)} steps ({times}), "
          f"{b_semi / ms * 1e3:.2f} scenes/s, peak device memory "
          f"{peak:.3f} GiB")
    print(f"{tag} semi step terms (last step): {terms}")
    print(f"{tag} student and BN running stats moved; teacher moved by "
          f"the EMA rule (m={m:.6f}, step {state.step})")

    sup_batch = dict(points=batch["points_raw_s"][:SUP_B],
                     gt_boxes=batch["gt_boxes"][:SUP_B],
                     gt_labels=batch["gt_labels"][:SUP_B],
                     gt_valid=batch["gt_valid"][:SUP_B],
                     aug=batch["aug_s"].slice(0, SUP_B))
    sup = make_supervised_train_step(head=head)
    torch.cuda.reset_peak_memory_stats()
    sup_times, sup_metrics = timed_steps(
        lambda: sup(state, sup_batch, generator=gen), TIMED_STEPS)
    sup_peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite(sup_metrics, state.model, f"{head} supervised step")
    if head == "saqe":
        check_terms(sup_metrics, SAQE_PRETRAIN_TERMS,
                    "SAQE supervised step")
    sup_ms = float(np.median(sup_times))
    print(f"{tag} supervised step B={SUP_B} x {N_POINTS} x 4: median "
          f"{sup_ms:.3f} ms over {len(sup_times)} steps ({sup_times}), "
          f"{SUP_B / sup_ms * 1e3:.2f} scenes/s, peak device memory "
          f"{sup_peak:.3f} GiB; terms "
          f"{ {k: round(v.item(), 6) for k, v in sup_metrics.items()} }")
    return dict(semi_ms=ms, sup_ms=sup_ms, peak_gib=peak,
                sup_peak_gib=sup_peak)


def check_terms(metrics: dict, want: tuple, what: str) -> None:
    """Every loss term of ``want`` is among the metrics (finite: see
    ``check_finite``)."""
    missing = sorted(set(want) - set(metrics))
    if missing:
        raise AssertionError(f"{what}: loss terms {missing} missing")


def gpu_vs_cpu_training_step(dev) -> None:
    """One semi step of a narrow model on the card (kernels) and on the
    CPU (plain versions) from the same weights, inputs and jitter noise."""
    import copy

    import torch

    import nesie_tpu_torch.nn.pointnet2 as pn2
    from nesie_tpu_torch.data.synthetic import semi_batch
    from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
    from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import (
        create_train_state,
        make_lr_schedule,
    )

    model = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(4)
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    cpu_batch = semi_batch(np.random.default_rng(11), 1, 2, TINY_POINTS,
                            SEMI["max_gt"], SEMI["n_boxes"], "cpu")
    b = 3
    noise = tuple(torch.randn((b, TINY["num_proposal"], 3), generator=gen)
                  for _ in range(2))
    runs = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        state = create_train_state(copy.deepcopy(model),
                                   make_lr_schedule(1e-3, 1000),
                                   device=device)
        batch = {k: v.to(device) for k, v in cpu_batch.items()}
        ulb = UlbState.create(SEMI["scans"], 18, device=device)
        indices = []
        fps, bq = pn2.furthest_point_sample, pn2.ball_query

        def rec_fps(*a, **kw):
            out = fps(*a, **kw)
            indices.append(("fps", out.cpu()))
            return out

        def rec_bq(*a, **kw):
            out = bq(*a, **kw)
            indices.append(("ball_query", out.cpu()))
            return out

        pn2.furthest_point_sample, pn2.ball_query = rec_fps, rec_bq
        try:
            _, metrics = make_semi_train_step(
                1, SEMI["scans"], pl_cfg=PseudoLabelConfig(**RELAXED_PL))(
                state, ulb, batch, noise=tuple(n.to(device) for n in noise))
        finally:
            pn2.furthest_point_sample, pn2.ball_query = fps, bq
        grad = torch.cat([p.grad.flatten().double().cpu()
                          for p in state.model.parameters()])
        runs[where] = (indices, {k: v.item() for k, v in metrics.items()},
                       grad)
        if not (metrics["num_pseudo"] > 0 and metrics["unsup_iou_loss"] != 0):
            raise AssertionError(
                f"narrow semi step on {where}: no pseudo-boxes reached the "
                f"unsupervised losses (num_pseudo "
                f"{metrics['num_pseudo'].item()}, unsup_iou_loss "
                f"{metrics['unsup_iou_loss'].item()})")
    (gi, gm, gg), (ci, cm, cg) = runs["cuda"], runs["cpu"]
    if len(gi) != len(ci) or any(
            a[0] != b[0] or not torch.equal(a[1], b[1]) for a, b in zip(gi, ci)):
        raise AssertionError("FPS or ball-query indices of the training step "
                             "differ between the card and the CPU")
    worst = 0.0
    for k, v in cm.items():
        diff = abs(gm[k] - v)
        worst = max(worst, diff)
        if diff > TRAIN_ATOL + TRAIN_RTOL * abs(v):
            raise AssertionError(f"training step {k}: card {gm[k]} vs CPU {v}")
    cos = torch.nn.functional.cosine_similarity(gg, cg, dim=0).item()
    if not cos > MIN_COSINE:
        raise AssertionError(f"gradient cosine card vs CPU {cos} <= "
                             f"{MIN_COSINE}")
    print(f"[train] card vs CPU, one semi step of the narrow model (1+2 "
          f"scenes x {TINY_POINTS}, relaxed pseudo-label thresholds: "
          f"num_pseudo {gm['num_pseudo']:g} / {cm['num_pseudo']:g}, "
          f"unsup_iou_loss {gm['unsup_iou_loss']:.6f} / "
          f"{cm['unsup_iou_loss']:.6f}): {len(gi)} FPS / ball-query index "
          f"tensors identical; loss terms within atol {TRAIN_ATOL} + rtol "
          f"{TRAIN_RTOL} (max |diff| {worst:.3e}); gradient cosine "
          f"{cos:.8f}")


def metric_rows(work: Path) -> list[dict]:
    """The logged steps of a run's ``metrics.jsonl`` (every line with a
    loss), in order."""
    rows = [json.loads(line) for line in
            (work / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "loss" in r]


def step_seconds(rows: list[dict]) -> list[float]:
    """Wall seconds between consecutive logged steps: with
    ``log_interval=1`` each row is written after its step's values reached
    the host, so a difference is one step with its batch wait."""
    return [b["time"] - a["time"] for a, b in zip(rows, rows[1:])]


def check_rows(rows: list[dict], what: str) -> None:
    for r in rows:
        bad = {k: v for k, v in r.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"{what} step {r['step']}: non-finite {bad}")


def state_tensors(state) -> dict:
    out = {f"student.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    return out


def runner_phase(dev, bare: dict) -> dict:
    """The flagship through the user's entry points: the train and test
    CLIs, ``evaluate`` and ``init_detector``. Returns the launch counts of
    its training and eval paths and the numbers it printed."""
    import shutil

    import torch

    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data.dataset import ScanNetScenes, SimiScanNetScenes
    from nesie_tpu_torch.data.synthetic import write_synthetic_scannet
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.tools import train as train_cli
    from nesie_tpu_torch.train import runner
    from nesie_tpu_torch.train.semi import UlbState

    base = ROOT / "build" / "runner_smoke"
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    data = write_synthetic_scannet(base / "data", RUNNER["n_train"],
                                   RUNNER["n_val"], seed=RUNNER["data_seed"])
    print(f"[runner] dataset: {RUNNER['n_train']} train + {RUNNER['n_val']} "
          f"val scenes written in {time.perf_counter() - t0:.2f} s")
    work = base / "work"
    common = ["--data-root", str(data), "--work-dir", str(work),
              "--device", str(dev)]
    pre_work, semi_work = work / RUNNER["pretrain"], work / RUNNER["semi"]

    # ----- the runner's training path
    _build.reset_launch_counts()
    train_cli.main([RUNNER["pretrain"], *common,
                    "--cfg-options", *RUNNER_OVER])
    semi_state = train_cli.main([
        RUNNER["semi"], *common, "--load-from",
        str(pre_work / "checkpoints"), "--cfg-options", *RUNNER_OVER])
    pre_rows, semi_rows = metric_rows(pre_work), metric_rows(semi_work)
    cfg = apply_overrides(get_config(RUNNER["semi"]), RUNNER_OVER)
    ckpt = runner.CheckpointManager(semi_work)
    saved_step = ckpt.latest_step()
    semi_ds = SimiScanNetScenes(data, data / cfg.data.train_ann_file,
                                data / cfg.data.label_list_file,
                                ratio=cfg.data.unlabeled_ratio)
    resumed = train_cli.main([
        RUNNER["semi"], *common, "--resume", "--cfg-options", *RUNNER_OVER,
        "optim.max_epochs=3"])
    launches = {"runner": _build.launch_counts()}
    # ----- end of the runner's training path
    resume_rows = metric_rows(semi_work)[len(semi_rows):]
    for rows, what in ((pre_rows, "pretrain"), (semi_rows, "semi"),
                       (resume_rows, "resumed semi")):
        check_rows(rows, what)
    steps_per_epoch = semi_ds.num_labeled * cfg.data.repeat \
        // cfg.data.samples_per_step
    if not (len(pre_rows) == len(semi_rows) == 2 * steps_per_epoch
            and [r["step"] for r in resume_rows] == [5, 6]
            and resumed.step == 6 and saved_step == 4):
        raise AssertionError(
            f"runner steps: pretrain {[r['step'] for r in pre_rows]}, semi "
            f"{[r['step'] for r in semi_rows]}, resumed "
            f"{[r['step'] for r in resume_rows]} (want epoch 2's steps 5, "
            f"6), checkpoint {saved_step}")
    print(f"[runner] launches during the runner's training path: "
          f"{launches['runner']}")
    check_launches(launches["runner"], "runner's training")

    # the checkpoint the semi run wrote reloads bit for bit
    fresh = runner.init_state(cfg, runner.build_model(cfg), 1, dev)
    ulb = UlbState.create(semi_ds.num_unlabeled, cfg.model.num_classes,
                          device=dev)
    restored, ulb, at = ckpt.restore(fresh, ulb, step=saved_step)
    # the semi run's state as it left the loop (the resumed run restored
    # its own copy) against the one read back
    mem, disk = state_tensors(semi_state), state_tensors(restored)
    if mem.keys() != disk.keys() or semi_state.step != restored.step:
        raise AssertionError("checkpoint reload: tensors or step differ")
    for name, v in mem.items():
        if v.device != disk[name].device or not torch.equal(v, disk[name]):
            raise AssertionError(f"checkpoint reload: {name} differs "
                                 f"({v.device} / {disk[name].device})")
    # UlbState lives in the loop only: its saved copy survives a restore
    # and a second save bit for bit
    again = runner.CheckpointManager(base / "roundtrip")
    again.save(at, restored, ulb, meta={"mesh_size": 1})
    first, second = ckpt.load(at), again.load(at)
    pairs = [(f"{k}.{n}", first[k][n], second[k][n])
             for k in ("model", "teacher") for n in first[k]]
    pairs += [(f"ulb_state.{n}", v, second["ulb_state"][n])
              for n, v in first["ulb_state"].items()]
    for i, st in first["optimizer"]["state"].items():
        pairs += [(f"optimizer.{i}.{n}", v,
                   second["optimizer"]["state"][i][n]) for n, v in st.items()]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint reload: {name} differs")
    if not (first["step"] == second["step"] == at == 4
            and first["optimizer"]["param_groups"]
            == second["optimizer"]["param_groups"]):
        raise AssertionError("checkpoint reload: step or param groups differ")
    print(f"[runner] checkpoint of step {at} reloads bit for bit: "
          f"{len(mem)} tensors of the trained state (student, teacher, "
          f"optimizer) and its step; {len(pairs)} tensors with UlbState's "
          "and the param groups through restore and a second save")

    # the host time of one semi batch, outside the loop
    rng = np.random.default_rng(0)
    host = []
    for _ in range(SEMI_BATCH_REPS):
        t0 = time.perf_counter()
        semi_ds.semi_batch(list(range(cfg.data.samples_per_step)), rng,
                           strong_cfg=runner.strong_aug_config(cfg),
                           num_points=cfg.data.num_points)
        host.append((time.perf_counter() - t0) * 1e3)

    # ----- the runner's eval path
    del fresh, restored, resumed, semi_state, mem, disk
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    test_args = [RUNNER["semi"], str(semi_work / "checkpoints"),
                 "--data-root", str(data), "--device", str(dev),
                 "--batch-size", str(RUNNER["eval_batch"]),
                 "--cfg-options", *RUNNER_OVER]
    results = {"student": test_cli.main(test_args),
               "teacher": test_cli.main(test_args + ["--teacher"])}
    model = runner.build_model(cfg)
    model.load_state_dict(ckpt.load()["model"])
    model = model.to(dev)
    val = ScanNetScenes(data, data / cfg.data.val_ann_file)
    t0 = time.perf_counter()
    test_cli.evaluate(cfg, model, val, RUNNER["eval_batch"], 9, dev)
    eval_s = time.perf_counter() - t0
    detector = init_detector(RUNNER["semi"], semi_work / "checkpoints",
                             device=dev, cfg_options=RUNNER_OVER)
    cloud = np.fromfile(str(val.scenes[0].pts_path), np.float32)
    t0 = time.perf_counter()
    served = detector(cloud.reshape(-1, 6)[:, :3])
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches["runner_eval"] = _build.launch_counts()
    # ----- end of the runner's eval path
    print(f"[runner] launches during the runner's eval path: "
          f"{launches['runner_eval']}")
    check_launches(launches["runner_eval"], "runner's eval",
                   need=RUNNER_EVAL_KERNELS)
    for who, res in results.items():
        for k in ("mAP_0.25", "mAR_0.25"):
            if not 0.0 <= res.get(k, -1.0) <= 1.0:
                raise AssertionError(f"{who} {k} = {res.get(k)}")
    if not (np.isfinite(served["boxes_3d"]).all()
            and np.isfinite(served["scores_3d"]).all()):
        raise AssertionError("runner checkpoint request: non-finite output")

    pre_s, semi_s = step_seconds(pre_rows), step_seconds(semi_rows)
    out = dict(
        pretrain_ms=float(np.median(pre_s)) * 1e3,
        semi_ms=float(np.median(semi_s)) * 1e3,
        semi_batch_host_ms=float(np.median(host)),
        eval_scenes_per_s=len(val) / eval_s)
    print(f"[runner] step wall times after the first (ms): pretrain B=4 "
          f"{[round(x * 1e3, 3) for x in pre_s]} median "
          f"{out['pretrain_ms']:.3f}; semi 4 + 8 "
          f"{[round(x * 1e3, 3) for x in semi_s]} median "
          f"{out['semi_ms']:.3f}; bare steps of the training path: semi "
          f"{bare['semi_ms']:.3f}, supervised B={SUP_B} {bare['sup_ms']:.3f}; "
          f"runner semi / bare semi {out['semi_ms'] / bare['semi_ms']:.4f}")
    print(f"[runner] host time of one semi_batch (4 + 8 scenes x "
          f"{cfg.data.num_points}, two views): median "
          f"{out['semi_batch_host_ms']:.3f} ms of {host}")
    print(f"[runner] evaluate: {len(val)} val scenes in one batch of "
          f"{RUNNER['eval_batch']}: {eval_s:.3f} s, "
          f"{out['eval_scenes_per_s']:.2f} scenes/s; student "
          f"mAP_0.25 {results['student']['mAP_0.25']:.4f} mAR_0.25 "
          f"{results['student']['mAR_0.25']:.4f}, teacher mAP_0.25 "
          f"{results['teacher']['mAP_0.25']:.4f} mAR_0.25 "
          f"{results['teacher']['mAR_0.25']:.4f}; request from the "
          f"checkpoint {serve_ms:.3f} ms, {len(served['boxes_3d'])} boxes")
    print(f"[runner] losses: pretrain "
          f"{[round(r['loss'], 4) for r in pre_rows]}, semi "
          f"{[round(r['loss'], 4) for r in semi_rows]}, resumed "
          f"{[round(r['loss'], 4) for r in resume_rows]}; num_pseudo "
          f"{[r['num_pseudo'] for r in semi_rows + resume_rows]}")
    return dict(launches=launches, **out)


def saqe_model(name: str = SAQE_CONFIG):
    """The model of a named SAQE config, as the runner builds it."""
    from nesie_tpu_torch.config import get_config
    from nesie_tpu_torch.train import runner

    return runner.build_model(get_config(name))


def saqe_grid_queries(seeds, n_boxes: int, seed: int):
    """QualityEstimation's grid for ``n_boxes`` boxes a row, centred at
    the first seeds with sizes of 0.3-1.5 m, heading 0 (ScanNet):
    (B, n_boxes * 162, 3)."""
    import torch

    from nesie_tpu_torch.nn.quality_estimation import make_saqe_side_grids

    b = seeds.shape[0]
    gen = torch.Generator(seeds.device).manual_seed(seed)
    size = 0.3 + 1.2 * torch.rand((b, n_boxes, 3), generator=gen,
                                  device=seeds.device)
    heading = torch.zeros((b, n_boxes), device=seeds.device)
    grid = make_saqe_side_grids(seeds[:, :n_boxes], size, heading)
    return grid.reshape(b, n_boxes * SAQE_GRID, 3).contiguous()


def scene_agreement(gpu: dict, cpu: dict, keys) -> tuple[float, float]:
    """One scene's head outputs on the card and on the CPU: the share of
    its 256 proposals whose ``keys`` all agree within ATOL + RTOL * |cpu|,
    and the largest difference."""
    import torch

    agree = torch.ones(256, dtype=torch.bool)
    worst = 0.0
    for key in keys:
        g, c = gpu[key][0].cpu(), cpu[key][0]
        ok = (g - c).abs() <= ATOL + RTOL * c.abs()
        agree &= ok.reshape(256, -1).all(dim=1)
        worst = max(worst, (g - c).abs().max().item())
    return agree.float().mean().item(), worst


def check_launches(counts: dict, path: str, forwards: int | None = None,
                   need=TRAIN_KERNELS) -> None:
    """Each kernel of ``need`` launched on ``path``, the second references
    not; with ``forwards``, the ball query and three-NN at their count a
    forward."""
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"{path} path")
    for name in OFF_PATH:
        if counts[name] != 0:
            raise AssertionError(f"{name} was launched on the {path} path")
    if forwards is not None and (
            counts["ball_query"] != SAQE_BQ_PER_FORWARD * forwards
            or counts["three_nn"] != SAQE_3NN_PER_FORWARD * forwards):
        raise AssertionError(
            f"{path}: {counts['ball_query']} ball queries and "
            f"{counts['three_nn']} three-NN launches for {forwards} "
            f"forwards (want {SAQE_BQ_PER_FORWARD} and "
            f"{SAQE_3NN_PER_FORWARD} a forward)")


def saqe_phase(dev, scenes, requests, nesie: dict) -> dict:
    """[saqe]: the SAQE family on the card. Three-NN at the quality
    module's grid; the flagship SAQE model's eval forward at B=32 (ScanNet,
    and the SUN RGB-D test config), one scene against the CPU, three
    requests through ``init_detector(config name)``, the bare semi and
    supervised steps, and the train and test CLIs on ``[runner]``'s
    dataset. Launch counts set to 0 before and read after each of its
    four paths. ``nesie``: this run's Nesie numbers, printed beside.
    Returns the launches by path and three-NN's entries by shape."""
    import shutil

    import torch

    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.dataset import ScanNetScenes
    from nesie_tpu_torch.eval.postprocess import decode_and_nms
    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.ops import _build, pointops
    from nesie_tpu_torch.ops.fps import fps_onchip_cuda
    from nesie_tpu_torch.ops.three_nn import (
        three_nn_cuda,
        three_nn_plan,
        three_nn_ref,
    )
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.tools import train as train_cli
    from nesie_tpu_torch.tools.profile_eval import profile_forward

    t_phase = time.perf_counter()
    launches, k4 = {}, {}
    xyz = torch.from_numpy(np.stack(scenes)).to(dev)
    seeds = pointops.gather_points(
        xyz, fps_onchip_cuda(xyz, SEEDS)).contiguous()
    del xyz

    # ---- three-NN at the quality module's grid
    for (what, b, m, n), boxes in zip(SAQE_K4_SHAPES, (256, 512)):
        q = saqe_grid_queries(seeds[:b], boxes, seed=b)
        src = seeds[:b]
        tag = f"{what} B={b} M={m} N={n}"
        err, k_ms, p_ms = kernel_phase(f"three_nn {tag}",
                                       lambda: three_nn_cuda(q, src),
                                       lambda: three_nn_ref(q, src))
        lib_ms = time_ms(
            lambda: torch.topk(torch.cdist(q, src), 3, largest=False), 5)
        b_ms, b_by = three_nn_bound(b, m, n)
        k4[tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, plan=three_nn_plan(b, m))
        print(f"[saqe] three_nn {tag}: {k_ms:.4f} ms (plan "
              f"{k4[tag]['plan']}), {k_ms / b_ms:.3f} x its bound "
              f"{b_ms:.4f} ms ({b_by}), plain {p_ms:.4f} ms, "
              f"torch.topk(torch.cdist) {lib_ms:.4f} ms")
        del q
    del seeds
    torch.cuda.empty_cache()

    # ---- the eval path: B=32 forwards (ScanNet, SUN RGB-D), requests
    model = saqe_model()
    gen = torch.Generator().manual_seed(0)
    init_weights_flax_(model, gen)
    randomize_bn_(model, gen)
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
    sun = saqe_model(SAQE_SUN)
    init_weights_flax_(sun, gen)
    randomize_bn_(sun, gen)
    sun = sun.to(dev).eval()
    sun_points = get_config(SAQE_SUN).data.num_points
    batch = np.stack([io.add_height(s) for s in scenes]).astype(np.float32)
    points = torch.from_numpy(batch).to(dev)
    sun_batch = torch.from_numpy(np.stack([
        io.add_height(make_scene_points(i, sun_points)) for i in range(B)
    ]).astype(np.float32)).to(dev)

    def forwards(net, x):
        with torch.inference_mode():
            out = net(x)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                out = net(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return times, out

    _build.reset_launch_counts()
    # ----- the SAQE eval path
    times, out = forwards(model, points)
    with torch.inference_mode():
        decoded = decode_and_nms(out, points)
        torch.cuda.synchronize()
    sun_times, sun_out = forwards(sun, sun_batch)
    detector = init_detector(SAQE_SERVE, device=dev)
    served = []
    for cloud in requests:
        t0 = time.perf_counter()
        res = detector(cloud)  # ends in a host copy: synchronised
        served.append(((time.perf_counter() - t0) * 1e3, res))
    launches["saqe_eval"] = _build.launch_counts()
    # ----- end of the SAQE eval path
    print(f"[saqe] launches during the SAQE eval path: "
          f"{launches['saqe_eval']}")
    check_launches(launches["saqe_eval"], "SAQE eval", forwards=12 + 3,
                   need=EVAL_KERNELS)
    if launches["saqe_eval"]["fps_onchip"] != 12:
        raise AssertionError("SAQE eval path: want one fps_onchip launch a "
                             "B=32 forward")
    ms, sun_ms = float(np.median(times)), float(np.median(sun_times))
    print(f"[saqe] eval forward B={B} x {N_POINTS} x 4 ({SAQE_CONFIG}'s "
          f"model): median {ms:.3f} ms over {len(times)} runs ({times}), "
          f"{B / ms * 1e3:.2f} scenes/s; this run's Nesie eval forward "
          f"{nesie['eval_ms']:.3f} ms (SAQE / Nesie "
          f"{ms / nesie['eval_ms']:.4f})")
    print(f"[saqe] SUN RGB-D eval forward B={B} x {sun_points} x 4 "
          f"({SAQE_SUN}: 10 classes, box headings): median {sun_ms:.3f} ms "
          f"over {len(sun_times)} runs ({sun_times})")
    for res, name, classes in ((out, "ScanNet", 18), (sun_out, "SUN RGB-D",
                                                      10)):
        for key, shape in (("bbox_preds", (B, 256, 7)),
                           ("R_obj_scores", (B, 256, 2)),
                           ("rotate_scores", (B, 256, classes)),
                           ("iou_scores", (B, 256, classes)),
                           ("side_scores", (B, 256, 6, classes))):
            v = res[key]
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                raise AssertionError(f"SAQE {name} {key}: shape "
                                     f"{tuple(v.shape)} (want {shape}) or "
                                     "non-finite values")
    if not sun_out["bbox_preds"][..., 6].abs().sum() > 0:
        raise AssertionError("SUN RGB-D SAQE forward: all headings 0")
    print(f"[saqe] decode_and_nms (R_obj objectness): selected proposals "
          f"per scene {decoded['selected'].sum(dim=1).tolist()}")
    for i, (lat, res) in enumerate(served):
        if not (np.isfinite(res["boxes_3d"]).all()
                and np.isfinite(res["scores_3d"]).all()):
            raise AssertionError(f"SAQE request {i}: non-finite output")
        print(f"[saqe] request {i} ({SAQE_SERVE}, init_detector): "
              f"{lat:.3f} ms, {len(res['boxes_3d'])} boxes")
    with torch.inference_mode():
        prof = profile_forward(model, points, runs=2)
    print(f"[saqe] eval forward under the profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"idle share {prof['idle_share']:.3f}; three-NN "
          f"{prof['groups'].get('three_nn (CUDA, ours)', 0.0):.3f} ms a "
          "forward")

    # one scene on the CPU (plain versions) against the card
    with torch.inference_mode():
        gpu = model(points[:1])
        t0 = time.perf_counter()
        cpu = cpu_model(points[:1].cpu())
        cpu_s = time.perf_counter() - t0
    share, worst = scene_agreement(gpu, cpu,
                                   ("bbox_preds", "R_obj_scores", "iou_scores"))
    print(f"[saqe] CPU vs GPU, one scene (CPU forward {cpu_s:.2f} s): "
          f"{share:.4f} of proposals agree within atol {ATOL} + rtol {RTOL} "
          f"(boxes, R_obj, IoU); max |diff| {worst:.3e}")
    if share < MIN_AGREE:
        raise AssertionError(f"SAQE: only {share:.4f} of proposals agree")
    del model, cpu_model, sun, points, sun_batch, out, sun_out, gpu, cpu
    del detector
    torch.cuda.empty_cache()

    # ---- the training path: the bare steps
    _build.reset_launch_counts()
    bare = training_path(dev, head="saqe")
    launches["saqe_train"] = _build.launch_counts()
    # ----- end of the SAQE training path
    print(f"[saqe] launches during the SAQE training path: "
          f"{launches['saqe_train']}")
    # 6 semi steps (teacher + student) and 6 supervised ones
    check_launches(launches["saqe_train"], "SAQE training",
                   forwards=2 * (TIMED_STEPS + 1) + (TIMED_STEPS + 1))
    print(f"[saqe] bare steps beside this run's Nesie steps: semi "
          f"{bare['semi_ms']:.3f} / {nesie['semi_ms']:.3f} ms "
          f"({bare['semi_ms'] / nesie['semi_ms']:.4f}), peak "
          f"{bare['peak_gib']:.3f} / {nesie['peak_gib']:.3f} GiB; "
          f"supervised {bare['sup_ms']:.3f} / {nesie['sup_ms']:.3f} ms "
          f"({bare['sup_ms'] / nesie['sup_ms']:.4f})")

    # ---- the CLIs on [runner]'s dataset
    base = ROOT / "build" / "runner_smoke"
    data, work = base / "data", base / "saqe_work"
    shutil.rmtree(work, ignore_errors=True)
    over = [*RUNNER_OVER, "optim.max_epochs=1"]
    common = ["--data-root", str(data), "--work-dir", str(work),
              "--device", str(dev)]
    _build.reset_launch_counts()
    # ----- the SAQE CLIs' training path
    train_cli.main([SAQE_PRETRAIN, *common, "--cfg-options", *over])
    semi_state = train_cli.main([
        SAQE_CONFIG, *common, "--load-from",
        str(work / SAQE_PRETRAIN / "checkpoints"), "--cfg-options", *over])
    launches["saqe_runner"] = _build.launch_counts()
    # ----- end of the SAQE CLIs' training path
    pre_rows = metric_rows(work / SAQE_PRETRAIN)
    semi_rows = metric_rows(work / SAQE_CONFIG)
    check_rows(pre_rows, "SAQE pretrain")
    check_rows(semi_rows, "SAQE semi")
    cfg = apply_overrides(get_config(SAQE_CONFIG), over)
    if not (len(pre_rows) == len(semi_rows) == semi_state.step == 2):
        raise AssertionError(f"SAQE CLI steps: pretrain {len(pre_rows)}, "
                             f"semi {len(semi_rows)} (want 2 each)")
    for rows, want, what in ((pre_rows, SAQE_PRETRAIN_TERMS, "pretrain"),
                             (semi_rows, SAQE_SEMI_TERMS, "semi")):
        check_terms(rows[-1], want, f"SAQE CLI {what}")
    print(f"[saqe] launches during the SAQE CLIs' training path: "
          f"{launches['saqe_runner']}")
    check_launches(launches["saqe_runner"], "SAQE CLI training")
    del semi_state
    torch.cuda.empty_cache()

    ckpt = work / SAQE_CONFIG / "checkpoints"
    test_args = [SAQE_CONFIG, str(ckpt), "--data-root", str(data),
                 "--device", str(dev), "--batch-size",
                 str(RUNNER["eval_batch"]), "--cfg-options", *over]
    val = ScanNetScenes(data, data / cfg.data.val_ann_file)
    cloud = np.fromfile(str(val.scenes[0].pts_path), np.float32)
    _build.reset_launch_counts()
    # ----- the SAQE CLIs' eval path
    t0 = time.perf_counter()
    results = {"student": test_cli.main(test_args)}
    eval_s = time.perf_counter() - t0
    results["teacher"] = test_cli.main(test_args + ["--teacher"])
    detector = init_detector(SAQE_CONFIG, ckpt, device=dev, cfg_options=over)
    t0 = time.perf_counter()
    served = detector(cloud.reshape(-1, 6)[:, :3])
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches["saqe_runner_eval"] = _build.launch_counts()
    # ----- end of the SAQE CLIs' eval path
    print(f"[saqe] launches during the SAQE CLIs' eval path: "
          f"{launches['saqe_runner_eval']}")
    check_launches(launches["saqe_runner_eval"], "SAQE CLI eval",
                   need=RUNNER_EVAL_KERNELS)
    for who, res in results.items():
        for k in ("mAP_0.25", "mAR_0.25"):
            if not 0.0 <= res.get(k, -1.0) <= 1.0:
                raise AssertionError(f"SAQE {who} {k} = {res.get(k)}")
    if not (np.isfinite(served["boxes_3d"]).all()
            and np.isfinite(served["scores_3d"]).all()):
        raise AssertionError("SAQE checkpoint request: non-finite output")
    print(f"[saqe] CLIs: pretrain losses "
          f"{[round(r['loss'], 4) for r in pre_rows]}, semi "
          f"{[round(r['loss'], 4) for r in semi_rows]} (num_pseudo "
          f"{[r['num_pseudo'] for r in semi_rows]}); test CLI on "
          f"{len(val)} val scenes at B={RUNNER['eval_batch']}: student "
          f"{eval_s:.3f} s, mAP_0.25 {results['student']['mAP_0.25']:.4f} "
          f"mAR_0.25 {results['student']['mAR_0.25']:.4f}, teacher "
          f"mAP_0.25 {results['teacher']['mAP_0.25']:.4f}; request from "
          f"the checkpoint {serve_ms:.3f} ms, "
          f"{len(served['boxes_3d'])} boxes")
    print(f"[saqe] phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, k4=k4)


def make_scene_points(i: int, n: int):
    """Room ``i`` of the SUN RGB-D forward's batch, ``n`` points."""
    from nesie_tpu_torch.data.synthetic import make_scene

    return make_scene(np.random.default_rng(200 + i), n)


def main() -> int:
    if not (ROOT / "nesie_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the nesie_tpu_torch sources are not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.synthetic import make_scene
    from nesie_tpu_torch.eval.postprocess import decode_and_nms
    from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
    from nesie_tpu_torch.ops import _build, pointops
    from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
    from nesie_tpu_torch.ops.fps import (
        fps_cluster_cuda,
        fps_cluster_plan,
        fps_cuda,
        fps_onchip_cuda,
        fps_onchip_plan,
        fps_ref,
    )
    from nesie_tpu_torch.ops.three_nn import (
        three_nn_cuda,
        three_nn_plan,
        three_nn_ref,
    )
    from nesie_tpu_torch.tools.bench_ball_query import eval_shapes

    # ---- 1. toolchain -------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"[toolchain] nvidia-smi: {smi}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"[toolchain] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, nvcc: "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    print(f"[toolchain] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"[build] {lib_path.relative_to(ROOT)}: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")

    # ---- 3. kernel phases ---------------------------------------------
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, N_POINTS) for _ in range(B)]
    xyz = torch.from_numpy(np.stack(scenes)).to(dev)  # (B, 40000, 3)
    results, bounds, library = {}, {}, dict.fromkeys(_build.KERNELS)

    fps_idx = fps_onchip_cuda(xyz, SA1["m"])
    results["fps"] = kernel_phase(
        f"fps B={B} N={N_POINTS} M={SA1['m']} (the lab's v0)",
        lambda: fps_cuda(xyz, SA1["m"]), lambda: fps_ref(xyz, SA1["m"]),
        reps=5, plain_reps=1)
    bounds["fps"] = fps_bound(B, N_POINTS, SA1["m"])
    centers = pointops.gather_points(xyz, fps_idx).contiguous()
    ragged = torch.from_numpy(np.stack([
        make_scene(rng, ONCHIP_RAGGED[1]) for _ in range(ONCHIP_RAGGED[0])
    ])).to(dev)
    for x, m, main_shape in ((xyz, SA1["m"], True),
                             (ragged, ONCHIP_RAGGED[2], False)):
        b, n = x.shape[:2]
        plan = fps_onchip_plan(b, n)
        name = f"fps_onchip B={b} N={n} M={m}"
        res = kernel_phase(name, lambda: fps_onchip_cuda(x, m),
                           lambda: fps_ref(x, m), reps=5, plain_reps=1)
        got = fps_onchip_cuda(x, m)
        if not (torch.equal(got, fps_cuda(x, m)) and torch.equal(
                got, fps_onchip_cuda(x, m, exchange="barrier"))):
            raise AssertionError(f"{name}: fps_onchip.cu's exchanges or "
                                 "fps.cu differ")
        barrier_plan = fps_onchip_plan(b, n, exchange="barrier")
        barrier_ms = time_ms(
            lambda: fps_onchip_cuda(x, m, exchange="barrier"), 5)
        block_ms = time_ms(lambda: fps_cuda(x, m), 3)
        c2_ms = time_ms(lambda: fps_cluster_cuda(x, m, cluster_size=2), 3)
        b_ms, b_by = fps_bound(b, n, m)
        print(f"[kernel] {name}: plan {plan}; fps_onchip {res[1]:.4f} ms "
              f"({res[1] * 1e3 / (m - 1):.4f} us a step); the barrier "
              f"exchange {barrier_ms:.4f} ms (plan {barrier_plan}); fps.cu "
              f"{block_ms:.4f} ms, fps_cluster C=2 {c2_ms:.4f} ms, plain "
              f"{res[2]:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if main_shape:
            results["fps_onchip"] = res
            bounds["fps_onchip"] = (b_ms, b_by)
    del ragged

    big = torch.from_numpy(np.stack([
        np.concatenate([make_scene(rng, N_POINTS)
                        for _ in range(LARGE_FPS["scenes_per_row"])])
        for _ in range(LARGE_FPS["b"])])).to(dev)
    _, vb, vn, _ = K2_SHAPES[2]  # votes: seeds moved by small offsets
    vote_like = (centers[:vb, :vn] + 0.05 * torch.randn(
        (vb, vn, 3), generator=torch.Generator(dev).manual_seed(3),
        device=dev)).contiguous()
    k2_inputs = (xyz[:K2_SHAPES[0][1]], xyz[:K2_SHAPES[1][1]], vote_like, big)
    k2_ms = {}
    for i, ((what, b, n, m), x) in enumerate(zip(K2_SHAPES, k2_inputs)):
        assert tuple(x.shape) == (b, n, 3), (what, x.shape)
        plan = fps_onchip_plan(b, n)
        barrier_plan = fps_onchip_plan(b, n, exchange="barrier")
        cluster_plan = fps_cluster_plan(b, n)
        tag = f"B={b} N={n} M={m}"
        reps = 3 if n > N_POINTS else 5
        res = kernel_phase(f"fps_onchip {tag} ({what})",
                           lambda: fps_onchip_cuda(x, m),
                           lambda: fps_ref(x, m), reps=reps, plain_reps=1)
        got = fps_onchip_cuda(x, m)
        if not (torch.equal(got, fps_cluster_cuda(x, m)) and torch.equal(
                got, fps_onchip_cuda(x, m, exchange="barrier"))):
            raise AssertionError(f"fps {tag}: fps_onchip.cu, its barrier "
                                 "exchange and fps_cluster.cu differ")
        cluster_ms = time_ms(lambda: fps_cluster_cuda(x, m), reps)
        barrier_ms = time_ms(lambda: fps_onchip_cuda(x, m, exchange="barrier"),
                             reps)
        b_ms, b_by = fps_bound(b, n, m)
        k2_ms[tag] = dict(ms=res[1], fps_cluster_ms=cluster_ms,
                          barrier_ms=barrier_ms, plain_ms=res[2],
                          bound_ms=b_ms, bound_by=b_by, plan=plan)
        print(f"[kernel] fps {tag} ({what}): fps_onchip {res[1]:.4f} ms "
              f"(plan {plan}); fps_cluster.cu {cluster_ms:.4f} ms (plan "
              f"{cluster_plan}); the barrier exchange {barrier_ms:.4f} ms "
              f"(plan {barrier_plan}); plain {res[2]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); identical to fps_ref and to each "
              "other")
        if i == K2_MAIN:
            results["fps_onchip_small"] = res
            bounds["fps_onchip_small"] = (b_ms, b_by)
            results["fps_cluster"] = (res[0], cluster_ms, res[2])
            bounds["fps_cluster"] = (b_ms, b_by)
    del big, vote_like

    bq_shapes = eval_shapes(xyz, centers)
    bq_shapes.append(("SA1", xyz[:SEMI_B].contiguous(),
                      centers[:SEMI_B].contiguous(), SA1["radius"], SA1["k"]))
    bq_ms = {}
    for what, x, c, r, k in bq_shapes:
        b, n, m = x.shape[0], x.shape[1], c.shape[1]
        tag = f"{what} B={b} N={n} M={m} r={r} K={k}"
        res = kernel_phase(f"ball_query {tag}",
                           lambda: ball_query_cuda(x, c, r, k),
                           lambda: ball_query_ref(x, c, r, k))
        b_ms, b_by = ball_query_bound(ball_query_cuda(x, c, r, k), n)
        bq_ms[tag] = dict(ms=res[1], plain_ms=res[2], bound_ms=b_ms,
                          bound_by=b_by)
        print(f"[kernel] ball_query {tag}: {res[1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        if what == "SA1" and b == B:
            results["ball_query"] = res
            bounds["ball_query"] = (b_ms, b_by)
    seeds = centers[:, :SEEDS].contiguous()

    # three-NN: side- and box-grid queries (96 face and 64 box points in
    # each of 256 boxes around seeds) against the seeds; the FP modules'
    # seeds against a prefix of the SA centers
    box_c = seeds[:, :256]
    k4_ms = {}
    for what, m, n in K4_SHAPES:
        if what.endswith("grid"):
            per_box = m // 256
            q = (box_c[:, :, None, :] + torch.rand(
                (B, 256, per_box, 3),
                generator=torch.Generator(dev).manual_seed(per_box),
                device=dev) - 0.5).reshape(B, m, 3).contiguous()
        else:
            q = centers[:, :m].contiguous()
        src = seeds if n == SEEDS else centers[:, :n].contiguous()
        tag = f"{what} B={B} M={m} N={n}"
        res = kernel_phase(f"three_nn {tag}", lambda: three_nn_cuda(q, src),
                           lambda: three_nn_ref(q, src))
        # the one PyTorch call that computes the same function (matmul form
        # of the distance, so it may order near-ties otherwise); a
        # yardstick only, the port never calls it
        lib_ms = time_ms(
            lambda: torch.topk(torch.cdist(q, src), 3, largest=False), 5)
        b_ms, b_by = three_nn_bound(B, m, n)
        k4_ms[tag] = dict(ms=res[1], plain_ms=res[2], bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms,
                          plan=three_nn_plan(B, m))
        print(f"[kernel] three_nn {tag}: {res[1]:.4f} ms (plan "
              f"{k4_ms[tag]['plan']}), bound {b_ms:.4f} ms ({b_by}), "
              f"torch.topk(torch.cdist) {lib_ms:.4f} ms")
        if what == "side grid":
            results["three_nn"] = res
            bounds["three_nn"] = (b_ms, b_by)
            library["three_nn"] = lib_ms
    del xyz, centers, seeds, bq_shapes, q, src

    # ---- 3b. the FPS lab -----------------------------------------------
    lab_launches, lab_entries = fps_lab_phase()

    # ---- 4. slice phase -----------------------------------------------
    gen = torch.Generator().manual_seed(0)
    model = VoteNetNesie()  # flagship width and depth
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    model.eval()
    weights = ROOT / "build" / "nesie_tpu_torch" / "smoke_weights.pth"
    weights.parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), weights)
    cpu_model = copy.deepcopy(model)
    model = model.to(dev)

    batch = np.stack([io.add_height(s) for s in scenes]).astype(np.float32)
    points = torch.from_numpy(batch).to(dev)
    requests = [make_scene(np.random.default_rng(100 + i), 50000)
                for i in range(3)]

    _build.reset_launch_counts()
    # ----- the main path: batched eval forward + decode, then requests
    with torch.inference_mode():
        out = model(points)
        decode_and_nms(out, points)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = model(points)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        decoded = decode_and_nms(out, points)
        torch.cuda.synchronize()
    detector = init_detector(weights, device=dev)
    served = []
    for cloud in requests:
        t0 = time.perf_counter()
        res = detector(cloud)  # ends in a host copy: synchronised
        served.append(((time.perf_counter() - t0) * 1e3, res))
    launches = {"lab": lab_launches, "eval": _build.launch_counts()}
    # ----- end of the eval path
    print(f"[slice] launches during the eval path: {launches['eval']}")
    check_launches(launches["eval"], "eval", need=EVAL_KERNELS)
    ms = float(np.median(times))
    print(f"[slice] eval forward B={B} x {N_POINTS} x 4: median {ms:.3f} ms "
          f"per batch over {len(times)} runs ({times}), "
          f"{B / ms * 1e3:.2f} scenes/s")
    for key, shape in (("bbox_preds", (B, 256, 7)), ("obj_scores", (B, 256, 2)),
                       ("sem_scores", (B, 256, 18)),
                       ("iou_scores", (B, 256, 18))):
        v = out[key]
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            raise AssertionError(f"{key}: shape {tuple(v.shape)} (want "
                                 f"{shape}) or non-finite values")
    n_sel = decoded["selected"].sum(dim=1).tolist()
    print(f"[slice] decode_and_nms: selected proposals per scene {n_sel}")
    for i, (lat, res) in enumerate(served):
        n = len(res["boxes_3d"])
        if not (np.isfinite(res["boxes_3d"]).all()
                and np.isfinite(res["scores_3d"]).all()):
            raise AssertionError(f"request {i}: non-finite boxes or scores")
        print(f"[slice] Detector request {i}: {lat:.3f} ms, {n} boxes "
              f"({n // 18} proposals x 18 classes)")

    # one scene on the CPU through the plain versions
    with torch.inference_mode():
        scene = points[:1]
        gpu = model(scene)
        gpu_bb = model.backbone(scene)
        cpu_scene = scene.cpu()
        t0 = time.perf_counter()
        cpu_bb = cpu_model.backbone(cpu_scene)
        cpu = cpu_model.bbox_head(cpu_bb)
        cpu_s = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(gpu_bb["sa_indices"], cpu_bb["sa_indices"])):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"FPS indices of SA stage {i} differ")
    sa = model.backbone.SA_modules
    for i, mod in enumerate(sa):
        g = ball_query_cuda(gpu_bb["sa_xyz"][i].contiguous(),
                            gpu_bb["sa_xyz"][i + 1].contiguous(),
                            mod.radius, mod.num_sample)
        c = ball_query_ref(cpu_bb["sa_xyz"][i].contiguous(),
                           cpu_bb["sa_xyz"][i + 1].contiguous(),
                           mod.radius, mod.num_sample)
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"backbone ball query of SA stage {i} "
                                 "differs between GPU and CPU")
    share, worst = scene_agreement(gpu, cpu,
                                   ("bbox_preds", "obj_scores", "iou_scores"))
    print(f"[slice] CPU vs GPU, one scene (CPU forward {cpu_s:.2f} s): FPS "
          f"and backbone ball-query indices identical; {share:.4f} of "
          f"proposals agree within atol {ATOL} + rtol {RTOL}; max |diff| "
          f"{worst:.3e}")
    if share < MIN_AGREE:
        raise AssertionError(f"only {share:.4f} of proposals agree (need "
                             f">= {MIN_AGREE})")

    # ---- 5. training path ---------------------------------------------
    del model, cpu_model, detector, points, out, gpu, cpu
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    bare = training_path(dev)
    launches["train"] = _build.launch_counts()
    # ----- end of the training path
    print(f"[train] launches during the training path: {launches['train']}")
    check_launches(launches["train"], "training")

    # ---- 6. one training step, card vs CPU ------------------------------
    gpu_vs_cpu_training_step(dev)

    # ---- 7. the runner and the CLIs -----------------------------------
    torch.cuda.empty_cache()
    launches.update(runner_phase(dev, bare)["launches"])

    # ---- 8. the SAQE family -------------------------------------------
    torch.cuda.empty_cache()
    saqe = saqe_phase(dev, scenes, requests, dict(eval_ms=ms, **bare))
    launches.update(saqe["launches"])
    k4_ms.update(saqe["k4"])

    sources = {
        "fps_onchip": ("nesie_tpu_torch/csrc/fps_onchip.cu",
                       "nesie_tpu/ops/pallas_fps.py:73"),
        "fps_onchip_small": ("nesie_tpu_torch/csrc/fps_onchip.cu",
                             "nesie_tpu/ops/pallas_fps.py:25"),
        "fps": ("nesie_tpu_torch/csrc/fps.cu",
                "nesie_tpu/ops/pallas_fps.py:73"),
        "fps_cluster": ("nesie_tpu_torch/csrc/fps_cluster.cu",
                        "nesie_tpu/ops/pallas_fps.py:25"),
        "ball_query": ("nesie_tpu_torch/csrc/ball_query.cu",
                       "nesie_tpu/ops/pallas_ball_query.py:39"),
        "three_nn": ("nesie_tpu_torch/csrc/three_nn.cu",
                     "nesie_tpu/ops/pallas_three_nn.py:35"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        err, k_ms, p_ms = results[name]
        by_path = {path: n[name] for path, n in launches.items()}
        b_ms, b_by = bounds[name]
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=library[name])
        if name == "fps":
            entry["role"] = ("the FPS lab's v0 baseline and a second "
                             "reference for fps_onchip; off the eval and "
                             "training paths")
        if name == "fps_cluster":
            entry["role"] = ("the first port of the single-row kernel, a "
                             "second reference for fps_onchip at B <= 16; "
                             "off the eval and training paths")
        if name == "fps_onchip_small":
            entry["role"] = "fps_onchip.cu at B <= 16 (K2's regime)"
        if name in ("fps_onchip_small", "fps_cluster"):
            entry["by_shape"] = {
                tag: r["ms" if name == "fps_onchip_small" else
                       "fps_cluster_ms"] for tag, r in k2_ms.items()}
        if name == "ball_query":
            entry["by_shape"] = bq_ms
        if name == "three_nn":
            entry["by_shape"] = k4_ms
        kernels.append(entry)
    for entry in lab_entries:
        by_path = {path: n["fps_variant"] for path, n in launches.items()}
        by_path["lab"] = entry["launches"]
        entry["launches_by_path"] = by_path
        entry["launches"] = sum(by_path.values())
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
