#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nesie_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources beside this
file; fails without them. In order:

1. toolchain: the card's name and power limit, torch / CUDA / nvcc
   versions, TF32 off for matmuls and cuDNN;
2. builds the program's kernel library from ``nesie_tpu_torch/csrc``;
3. kernel phases: each kernel against its plain PyTorch version on the
   same seeded inputs at the main path's shapes (integer outputs must be
   identical), with both times;
   FPS runs ``fps_onchip.cu`` on both paths (each row held on chip on
   one CTA or across a thread-block cluster, a mailbox exchange across a
   cluster): B > 16 (the eval forward's 32 x 40000 -> 2048 and a ragged
   17 x 40001) and B <= 16 (the four shapes of requests and training
   steps), each beside the barrier exchange, all held to ``fps_ref`` and
   to each other; the ball query at the eval forward's
   five shapes (SA1-SA4, the aggregation) at B=32 and at SA1 for B=12;
   three-NN at the side grid,
   the box grid and the two FP shapes, each beside ``torch.topk`` of
   ``torch.cdist``; the decode's keep mask (``csrc/decode_nms.cu``: point
   counts and class-aware NMS) at the eval batch (32 x 40000, 256
   proposals) and a request (1 x 40000), keep mask and counts identical
   to the plain per-scene version on the card;
   [fps-lab], counts set to 0 before and read after (path ``lab``): the
   FPS lab's two entry points run all eight step variants of
   ``csrc/fps_variants.cu`` (the TPU lab's K5 and K6, on the shipped
   FPS's on-chip frame and plan) on the tie-heavy and random check clouds
   (B=3, N=600, M=37; odd B for the two-row ``v3``), on the tie-heavy
   cloud at K5's bench shape (40 distinct points tiled to 8 x 40000 ->
   2048: ties across a cluster's CTAs), at K5's bench shape (uniform) and
   at K6's default (32 x 40000 -> 2048, normal x 3), each beside the
   shipped ``fps_onchip.cu``; the lab's library is built there, on its
   first launch; every variant must give ``fps_ref``'s indices and (K6)
   the shipped FPS's. Then each variant against its plain version, with
   both times, its plan and its ms a step;
4. eval path: the flagship VoteNetNesie (seeded random weights, BN
   running stats randomised); first the eval set abstraction kernel
   (``csrc/sa_mlp.cu``: gather, three Linear + BN + ReLU layers, max over
   K) against its plain version ``sa_mlp_ref`` on the inputs of the
   forward's five calls (SA1-SA4, the aggregation) at B=32 and B=1,
   within float32 reordering and bit-equal in all but a few outputs,
   each timed as a CUDA-graph replay beside its FFMA bound; then the
   model runs the batched eval forward at
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
   under the profiler (busy, idle share) and one scene against the CPU;
9. [options], the head, training and eval options off the shipped
   configs on the flagship: FPS at the real seed FPS's and SA2-SA4's
   shapes (32 and 12 rows x {1024 -> 256, 2048 -> 1024, 1024 -> 512,
   512 -> 256}) and the ball query at ``spec``'s (1024 votes over 1024
   seeds), identical to ``fps_ref`` / ``ball_query_ref``, beside their
   bounds; then, counts set to 0 before and read after each path: B=32
   eval forwards in ``spec``, ``random`` and ``seed`` with the real seed
   and SA2-SA4 FPS (which must reproduce the default forward's samples),
   each beside this run's default forward (``options_spec``,
   ``options_random``, ``options_seed_fps``); ``compute_dtype=
   "bfloat16"``'s eval forward and semi step beside float32's, with peak
   memory and the distance of the outputs (``options_bf16``); semi steps
   with ``teacher_jitter`` and with ``sample_mod_train=spec`` (4 + 8
   scenes, or the largest smaller count that fits: ``options_train``);
   the test CLI with ``test.iou_opt=true`` on ``[runner]``'s checkpoint
   (three-NN exactly 2 x (opt_step + 1) a batch over the forward's 4) and
   ``evaluate`` with and without it (``options_iou_opt``); a SAQE eval
   forward under ``spec`` (``options_saqe_spec``);
10. [ddp], data parallelism (``nesie_tpu_torch.parallel``): FPS, the ball
   query and three-NN at the shapes one of two ranks gives them (6, 4
   and 16 rows), identical to their plain versions, beside their bounds;
   one process's reference semi step (4 + 8) and supervised step (B=8),
   then the same steps from the same weights, batch and jitter noise on 2
   ranks spawned under gloo on this card, 2 + 4 and 4 scenes a rank
   (path ``ddp_train``; counts set to 0 in each rank before and read
   after, summed over the ranks): every loss term and the gradient norm
   within ``DDP_STEP_TOL`` of one process, the ranks' students and
   teachers bit-identical, ``UlbState`` equal; per-rank step ms, peak GiB
   and the gradient sum's ms. With two cards or more, the same comparison
   under NCCL across two cards. The train CLI (semi from ``[runner]``'s
   pretrain checkpoint, 2 epochs of 2 steps, a checkpoint, a resume)
   under NCCL at world size 1 and under gloo at 2 ranks (``ddp_runner``);
   the test CLI at 2 ranks x 16 scenes on ``[runner]``'s semi checkpoint
   (``ddp_eval``), its metrics against one process at 16 scenes a batch;
11. the point-based tail: FPS, the ball query and three-NN at its shapes
   (the segmentor's 16 and 24 blocks and one request of 8192 -> 1024
   points, its SA1-SA4 ball queries at r 0.1-0.8, K 32, its four FPs up
   to 8192 queries over 1024; the VoteHead detector's at 8 x 40000),
   identical to their plain versions, beside their bounds and, for
   three-NN, ``torch.topk(torch.cdist)`` (entries under ``tail_by_shape``);
   then, counts set to 0 before and read after each path, exact per
   forward: [segmentor] ``PointNet2Segmentor(with_aux=True)`` at its
   defaults, forward + ``encoder_decoder_loss`` (aux, Lovasz) + backward
   at 16 blocks (``segmentor_train``: FPS 1, ball query 4, three-NN 4 a
   forward), ``slide_inference`` over a ~100k-point room at batch 24
   (``segmentor_slide``), three ``inference_segmentor`` requests
   (``segmentor_request``), one block against the CPU; [votehead]
   ``VoteNet()`` at 8 x 40000: eval forwards in both sample modes with
   ``BinBoxCoder.decode``, ``votehead_supervised_loss`` + backward,
   ``consistency_losses`` between two forwards under a recorded flip /
   rotation / scale (``votehead``: FPS 2, ball query 5, three-NN 2 a
   forward); [paconv] ``PAConvSAModule`` at 16 x 8192 -> 1024 in eval
   and train mode + backward, ``PointSAModuleMSG`` at two scales
   (``paconv``); [tta] the flagship ``Detector`` over the 4 views of
   ``make_tta_views(flip=True)`` and ``merge_aug_bboxes_3d`` beside one
   plain request (``tta``: 4 requests' launches);
12. [migrate], a user on the card's machine (no jax) from raw data and a
   reference checkpoint to detections, counts set to 0 before and read
   after (path ``migrate``, every launch predicted from the forwards it
   runs): raw ScanNet (8 generated rooms of ~60000 vertices: PLY,
   segments, aggregation, axis alignment, label map) and SUN RGB-D (4
   samples, ``.npy`` depth) trees; ``tools/create_data`` on both (infos,
   box and label shapes, ``.bin`` sizes); ``tools/train.py`` on the
   prepared infos (``nesie-votenet-scannet-pretrain-050``, 2 steps at B=4
   x 40000; one step of ``nesie-votenet-sunrgbd-pretrain-050``); a
   reference-layout ``.pth`` of the flagship (unit dims, ``ema_*``
   buffers from a second seed) through ``tools/import_torch_ckpt`` (the
   student and the teacher exactly the ``.pth``'s); ``tools/
   dump_eval_set`` (40000 points) and the test CLI on it at B=32,
   student and teacher, its raw outputs within 1e-4 of
   ``init_detector(.pth)`` on the same clouds; ``tools/demo.py`` on one
   exported ``.bin`` (``.obj`` files, ``Visualizer.render``);
   ``points_sampler`` D-FPS at 32 and 8 x 40000 -> 2048 (K1, K2) against
   ``fps_ref``, F-FPS and ``FS`` at 16 x 8192 x 4 -> 1024 and ``knn`` (k
   16, 8 x 1024 over 8192) against the CPU, with their times;
13. [voxel], the voxel and outdoor stack (plain PyTorch), counts set to 0
   before and read after (path ``voxel``: no kernel of the port may
   launch), each step on the card and on the CPU from the same seeded
   inputs (integer outputs identical, floats within ``VOXEL_TOL`` of their
   scale), with its median ms of 5 calls and its peak GiB: a LiDAR-like
   cloud of 120000 points in KITTI's range; ``voxelize`` at SECOND's
   voxel layer (0.05 x 0.05 x 0.1, 5 points, 16000 and 40000 voxels) and
   ``VoxelGenerator`` (its voxels those of ``voxelize``), ``dynamic_scatter``
   mean and max; a sparse network on the (41, 1600, 1408) grid at V=40000
   (two ``SparseBasicBlock``s of 16, ``SparseConv3d`` to 32, a block of
   32, ``sparse_maxpool3d``, then ``sparse_inverse_conv3d`` and
   ``sparse_conv_transpose3d`` back) forward and backward in float32;
   ``roiaware_pool3d`` max and avg at PartA2's 14^3 x 128 on 128 rois
   over 16384 points of 16 channels, forward and backward; SECOND's
   3-class anchors on the 200 x 176 map and ``delta_xyzwhlr`` encode /
   decode over them; ``box3d_multiclass_nms`` and ``pcdet_nms.nms`` on
   1000 boxes of 3 classes; CenterPoint nuScenes' ``centerpoint_decode``
   + ``circle_nms`` (4 x 2 x 128 x 128, 500 boxes) and
   ``draw_heatmap_gaussian``; ``create_data scannet --gt-db`` on
   [migrate]'s tree, ``DataBaseSampler.sample_all`` + ``object_sample``
   on one scene, the pasted scene voxelized on both devices;
14. [diagnose], the port's last modules, counts set to 0 before and read
   after each path: ``tools/overfit_check`` at its defaults (the
   flagship, B=8 x 40000, 16 generated scenes, 300 supervised steps at
   lr 4e-3; path ``overfit``, exactly 300 training and 2 eval forwards'
   launches), mAP_0.25 above its floor of 0.15, and the trained model's
   head outputs decoded again on the CPU (keep lists and boxes identical,
   scores within ``OVERFIT_SCORE_TOL``, ``indoor_eval`` within
   ``OVERFIT_MAP_TOL``); ``tools/diagnose_teacher`` at ``DIAGNOSE``'s cut
   regime, then ``tools/probe_thresholds`` and ``tools/jitter_delta`` on
   the pretrain it leaves (path ``diagnose``, every launch predicted from
   the forwards the tools run), each tool's JSON printed; ``nn/mono3d``'s
   flip and merge at the shapes of FCOS3D on nuScenes, identical card
   against CPU, and the shell's forward and flip TTA with a small conv
   backbone and head, and ``eval/instance_seg``'s ScanNet benchmark on
   [migrate]'s generated scans (path ``mono3d``: no kernel);
   ``tools/flops_analysis`` at its defaults (path ``flops``: the B=8 x
   40000 eval forward and the 4 + 8 semi step).

Prints ``{"kernels": [...]}``, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from nesie_tpu_torch.utils import time_ms

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
# the decode's keep mask (csrc/decode_nms.cu) at the eval batch and a
# request: (what, B, proposals a scene), 4-channel clouds of N_POINTS
DECODE_SHAPES = (("eval batch", B, 256), ("a Detector request", 1, 256))
DECODE_THR = dict(nms_thr=0.25, score_thr=0.05)
# the eval SA kernel (csrc/sa_mlp.cu) at the flagship's five calls, at the
# eval batch and a request: (what, B). Its outputs are the torch path's
# within float32 reordering of the Linears' sums through three layers
# (SA_RTOL of the output's scale, as tests/test_torch_kernels_gpu.py
# holds it) and, rounding as PyTorch's ops do but for cuBLAS's summation
# order, equal to them bit for bit in at least SA_MIN_EQUAL of outputs
SA_BATCHES = (("eval batch", B), ("a Detector request", 1))
SA_RTOL = 1e-5
SA_MIN_EQUAL = 0.99
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
# the kernels the eval and training paths must launch
EVAL_KERNELS = ("fps_onchip", "fps_onchip_small", "ball_query", "three_nn",
                "sa_mlp")
TRAIN_KERNELS = ("fps_onchip_small", "ball_query", "three_nn")
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
RUNNER_EVAL_KERNELS = ("fps_onchip", "sa_mlp")
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
# [options]: the head, training and eval options off the shipped configs
# on the flagship. FPS at the shapes that no default path runs, K1's at
# B=32 and K2's at the semi step's 12 rows: (what, N, M) over FPS-ordered
# SA1 samples; the ball query at spec's shape (the 1024 votes over the
# 1024 seeds); the spec semi step at the reference's 4 + 8 scenes, else
# the largest of the smaller counts that fits on the card
OPT_FPS_SHAPES = (("seed FPS", SEEDS, 256), ("SA2", 2048, 1024),
                  ("SA3", 1024, 512), ("SA4", 512, 256))
OPT_SPEC_BQ = dict(radius=0.3, k=16)
OPT_SEMI_SCENES = ((4, 8), (2, 4), (1, 2))
OPT_STEPS = 3
OPT_BF16 = dict(atol=5e-2, rtol=5e-2)  # bf16 vs float32 outputs, stated
# launches of one B=32 forward by option: fps_onchip, ball_query, three_nn
OPT_PER_FORWARD = {"spec": (1, 5, 4), "random": (1, 5, 4),
                   "seed, real FPS": (5, 5, 4), "bfloat16": (1, 5, 4)}

# [ddp]: data parallelism on the card. Two ranks share one card under gloo
# (NCCL refuses two ranks on one GPU): each holds 2 + 4 of the reference
# semi step's 4 + 8 scenes and 4 of the supervised step's 8; float32 loss
# terms and the gradient norm against one process within DDP_STEP_TOL (the
# ranks sum BN statistics in another order). The train CLI at 2 labeled
# scenes a rank (the global 4 of [runner]); the test CLI at 16 scenes a
# rank (the 32 val scenes in one global batch). The kernels at the shapes
# a rank gives them: (what, B, N, M) for FPS, (what, B) for the SA1 ball
# query, (what, B, queries, sources) for three-NN
DDP_WORLD = 2
DDP_TIMEOUT_S = 300  # a rank still running then is killed; the phase fails
# the 2-rank steps against one process: in float64 (the kernels take
# float32 copies of the coordinates, as always) to 1e-6; in float32, the
# training dtype, to 1e-2: the rank-split BN sums round otherwise, and the
# fast variance E[x^2] - E[x]^2 amplifies that through the layers (the
# phase prints one process's own distance on the rows in another order)
DDP_TOL = {"64": dict(atol=1e-8, rtol=1e-6), "32": dict(atol=1e-3, rtol=1e-2)}
DDP_EVAL_ATOL = 1e-6
DDP_TIMED = 3
DDP_DTYPES = ("float32", "float64")
DDP_EVAL_BATCH = 16
DDP_RUNNER_OVER = RUNNER_OVER + ["data.samples_per_step=2"]
DDP_K2_SHAPES = (("semi-step SA1 a rank", 6, N_POINTS, 2048),
                 ("vote-mode aggregation a rank", 6, SEEDS, 256),
                 ("supervised SA1 a rank", 4, N_POINTS, 2048),
                 ("eval SA1 a rank", 16, N_POINTS, 2048))
DDP_BQ_SHAPES = (("semi-step SA1 a rank", 6), ("supervised SA1 a rank", 4),
                 ("eval SA1 a rank", 16))
DDP_K4_SHAPES = (("semi student side grid a rank", 6, 512 * 96, SEEDS),
                 ("eval side grid a rank", 16, 256 * 96, SEEDS),
                 ("FP1 a rank", 6, FP1["m"], FP1["n"]))

# the point-based tail: the segmentor (PointNet2Segmentor's defaults,
# mmdet3d's pointnet2_ssg ScanNet widths) on 1.5 m blocks of 8192 points,
# B=16 in training, batch 24 in slide_inference over a ~100k-point room
# (sample_rate 0.5), three requests; 5% of the labels ignored (255). The
# VoteHead detector at VoteNet's ScanNet widths on 8 scenes x 40000
SEG = dict(b=16, n=8192, block=1.5, slide_batch=24, sample_rate=0.5,
           room_points=100000, requests=3, timed=5, ignore=0.05)
SEG_NET = dict(num_points=(1024, 256, 64, 16), radii=(0.1, 0.2, 0.4, 0.8),
               num_samples=(32, 32, 32, 32))
VOTE_B = 8
# [migrate]: a port user with no jax on the card's machine. Raw trees of
# generated rooms (ScanNet: ~60000 vertices a scan, so export_scan
# subsamples to 50000; SUN RGB-D with .npy depth), create_data, the train
# CLI on the prepared infos, a reference .pth imported, a presampled eval
# set through the test CLI, the demo, and the point-op helpers.
MIGRATE = dict(scenes=8, train=4, floor_points=56000, points_per_object=1000,
               sun_samples=4, eval_points=N_POINTS, eval_batch=B, seed=21,
               pretrain="nesie-votenet-scannet-pretrain-050",
               sun_pretrain="nesie-votenet-sunrgbd-pretrain-050",
               repeat=2, sun_repeat=1, requests=3)
MIGRATE_OVER = ["optim.max_epochs=1", "log_interval=1"]
MIGRATE_DFPS = ((B, N_POINTS, 2048), (8, N_POINTS, 2048))  # K1, K2
MIGRATE_FFPS = dict(b=16, n=8192, d=1, m=1024)
MIGRATE_KNN = dict(b=8, m=1024, n=8192, k=16)
MIGRATE_ATOL = 1e-4
# [voxel]: the voxel and outdoor stack (plain PyTorch; it launches none of
# the port's kernels) at the shapes of public mmdetection3d configs: SECOND
# on KITTI (configs/_base_/models/hv_second_secfpn_kitti.py: voxel layer,
# 3-class anchors on the 200 x 176 map, the test-time NMS), PartA2's RoI
# extractors (configs/parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-3class
# .py: out_size 14, 128 points a voxel) and CenterPoint on nuScenes
# (configs/_base_/models/centerpoint_01voxel_second_secfpn_nus.py: a
# 128 x 128 map, a 2-class task with velocity). Each step runs on the card
# and on the CPU from the same seeded inputs.
KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
VOXEL = dict(points=120000, objects=24, seed=31, voxel_size=(0.05, 0.05, 0.1),
             max_points=5, max_voxels=(16000, 40000), grid=(41, 1600, 1408),
             timed=5)
VOXEL_ROI = dict(rois=128, points=16384, channels=16, out_size=14,
                 max_pts=128, face_margin=1e-4)
VOXEL_ANCHORS = dict(
    ranges=((0, -40.0, -0.6, 70.4, 40.0, -0.6),
            (0, -40.0, -0.6, 70.4, 40.0, -0.6),
            (0, -40.0, -1.78, 70.4, 40.0, -1.78)),
    sizes=((0.6, 0.8, 1.73), (0.6, 1.76, 1.73), (1.6, 3.9, 1.56)),
    rotations=(0, 1.57), featmap=(1, 200, 176))
VOXEL_NMS = dict(boxes=1000, classes=3, score_thr=0.1, nms_thr=0.01,
                 max_num=50)
CENTERPOINT = dict(b=4, classes=2, size=128, max_num=500, score_threshold=0.1,
                   pc_range=(-51.2, -51.2), out_size_factor=8,
                   voxel_size=(0.1, 0.1),
                   post_center_range=(-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
                   min_radius=12.0, gaussians=40)
# card vs CPU at these sizes: every integer output identical; a float
# output within VOXEL_TOL times the largest magnitude of the CPU's (at
# least 1): forwards are elementwise or short sums (1e-5), gradients sum
# over up to 40000 rows (1e-4)
VOXEL_TOL = dict(forward=1e-5, grad=1e-4)
# [diagnose]: the port's last modules. overfit_check at its defaults (the
# flagship at B=8 x 40000, 16 generated scenes, 300 steps at lr 4e-3), its
# trained model's decode held card against CPU: keep lists and boxes
# identical, scores within OVERFIT_SCORE_TOL, indoor_eval within
# OVERFIT_MAP_TOL. diagnose_teacher, then probe_thresholds and
# jitter_delta on the pretrain it leaves, at DIAGNOSE's cut regime. The
# mono3d flip / merge on dense maps at the shapes of mmdetection3d's
# FCOS3D on nuScenes (configs/fcos3d/fcos3d_r101_caffe_fpn_gn-head_dcn_
# 2x8_1x_nus-mono3d.py: 1600 x 900 images padded to 1600 x 928, strides
# 8-128, 10 classes, 9 regression channels with velocity, 2 direction
# bins, 9 attributes, 1 centerness; 2 images a card), identical card
# against CPU; the shell's forward with a small conv backbone and head
# within MONO3D_TOL of its scale. The ScanNet instance benchmark on the
# instance ids of [migrate]'s generated scans against seeded perturbed
# masks, and on the GT masks themselves (all_ap exactly 1). flops_analysis
# at its defaults.
OVERFIT = dict(steps=300, batch=8, scenes=16, num_points=N_POINTS, lr=4e-3,
               seed=0, tiny=False)
FLOPS_ARGV = ()  # flops_analysis's defaults: B=8 x 40000, the 4 + 8 step
OVERFIT_SCORE_TOL = 1e-6
OVERFIT_MAP_TOL = 1e-6
DIAGNOSE = dict(n_train=16, n_val=8, num_points=2048, pretrain_epochs=1,
                semi_epochs=1, jitter_batches=2, eval_batch=8)
DIAGNOSE_REDUCED = (
    "diagnose_teacher at 16 train and 8 val generated scenes (its defaults "
    "128 + 32), MID_MODEL, 2048 points (4096), 1 pretrain and 1 semi epoch "
    "(14 + 12); probe_thresholds on its pretrain (12 epochs of its own "
    "otherwise); jitter_delta over 2 batches (8) at 2048 points (4096)")
FCOS3D = dict(batch=2, pad=(928, 1600), strides=(8, 16, 32, 64, 128),
              classes=10, reg=9, dir=2, attr=9, centerness=1, width=16,
              seed=41)
MONO3D_TOL = 1e-5
INSTANCE = dict(keep=0.9, spill=0.01, dup_every=3, false_pos=3, seed=23)
# launches a forward: FPS, ball query, three-NN. A training forward
# samples its proposals over the votes (sample_mod_train="vote"): one FPS
# more.
EVAL_FORWARD = dict(fps=1, ball_query=5, three_nn=4)
TRAIN_FORWARD = dict(fps=2, ball_query=5, three_nn=4)

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


def decode_nms_bound(b: int, n: int, p: int):
    """The decode's keep mask: 14 operations a point-in-box test (3
    differences, 4 products, a difference, a sum, 3 compares, 2 ands) and
    25 an IoU pair of a scene's upper triangle; reads x, y, z of each
    point and the boxes' inputs (box, cos, sin, minmax, score, class),
    writes and reads the counts, writes the mask."""
    return bound(14.0 * b * n * p + 25.0 * b * p * (p - 1) / 2,
                 12.0 * b * n + (28 + 8 + 24 + 4 + 8 + 8 + 1) * b * p)


def sa_mlp_bound(xyz, new_xyz, features, idx, widths):
    """The eval SA kernel: one FMA a product of its three layers
    (c + 3 -> c1 -> c2 -> c3) on each grouped row, an FMA taking a lane
    one cycle as any other operation does; reads idx, the centres, the
    points and their features once and the weights, writes the pooled
    (B, M, c3)."""
    b, m, k = idx.shape
    c = 0 if features is None else features.shape[-1]
    chain = [c + 3, *widths]
    macs = sum(a * z for a, z in zip(chain, chain[1:]))
    moved = (idx.numel() + new_xyz.numel() + xyz.shape[0] * xyz.shape[1]
             * (3 + c) + macs + 4 * sum(widths) + b * m * widths[-1])
    return bound(float(b * m * k * macs), 4.0 * moved)


def sa_calls(model, points) -> list:
    """The five ``PointSAModule`` calls of ``model(points)`` (SA1-SA4,
    the vote aggregation): (name, module, xyz, new_xyz, features, idx)
    each, the ball query's idx computed as the module computes it."""
    from nesie_tpu_torch.nn.pointnet2 import PointSAModule, sample_centers
    from nesie_tpu_torch.ops import ball_query

    names = {id(m): f"SA{i + 1}"
             for i, m in enumerate(model.backbone.SA_modules)}
    names[id(model.bbox_head.vote_aggregation)] = "aggregation"
    calls = []

    def hook(mod, args, kwargs):
        xyz = args[0]
        features = args[1] if len(args) > 1 else kwargs.get("features")
        new_xyz, _ = sample_centers(xyz, mod.num_point,
                                    kwargs.get("indices"),
                                    kwargs.get("target_xyz"),
                                    mod.input_fps_ordered)
        idx = ball_query(xyz, new_xyz, mod.radius, mod.num_sample)
        calls.append((names[id(mod)], mod, xyz, new_xyz.contiguous(),
                      features, idx))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, PointSAModule)]
    try:
        model(points)
    finally:
        for h in hooks:
            h.remove()
    return calls


def graph_replay(fn):
    """``fn`` captured as a CUDA graph: its replay, so that ``time_ms``
    reads the device's work and not the host's launches (a request's SA
    call takes the card less time than its wrapper takes the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def sa_mlp_phase(model, points) -> tuple[dict, tuple, tuple]:
    """The eval SA kernel against ``sa_mlp_ref`` on the inputs of the
    five calls of ``model``'s eval forward, at each of ``SA_BATCHES``.
    Returns (entries by call and batch, (max_abs_err, kernel ms, plain ms)
    and (bound ms, bound by) of the five calls at B)."""
    import torch

    from nesie_tpu_torch.ops.sa_mlp import mlp_layers, sa_mlp_cuda, sa_mlp_ref

    by_shape, totals = {}, {}
    for what, b in SA_BATCHES:
        sums = np.zeros(4)  # max err, kernel ms, plain ms, bound ms
        with torch.inference_mode():
            for name, mod, xyz, new_xyz, feats, idx in sa_calls(
                    model, points[:b]):
                mlp = mod.mlps[0]

                def kernel(mod=mod, xyz=xyz, new_xyz=new_xyz, feats=feats,
                           idx=idx, layers=mlp_layers(mlp)):
                    return sa_mlp_cuda(xyz, new_xyz, feats, idx, mod.radius,
                                       layers, mod.normalize_xyz)

                def plain(mod=mod, xyz=xyz, new_xyz=new_xyz, feats=feats,
                          idx=idx, mlp=mlp):
                    return sa_mlp_ref(xyz, new_xyz, feats, idx, mod.radius,
                                      mlp, mod.use_xyz, mod.normalize_xyz,
                                      mod.pool)

                got, want = kernel(), plain()
                tag = f"{name} B={b} M={idx.shape[1]} K={idx.shape[2]}"
                if got.shape != want.shape or not torch.isfinite(want).all():
                    raise AssertionError(f"sa_mlp {tag}: {tuple(got.shape)} "
                                         f"vs {tuple(want.shape)}, or "
                                         "non-finite plain outputs")
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                equal = float((got == want).double().mean())
                if not err <= SA_RTOL * scale or equal < SA_MIN_EQUAL:
                    raise AssertionError(
                        f"sa_mlp {tag}: max |diff| {err:.3e} (limit "
                        f"{SA_RTOL * scale:.3e}), {equal:.6f} of outputs "
                        f"bit-equal (need >= {SA_MIN_EQUAL})")
                k_ms = time_ms(graph_replay(kernel), 20)
                p_ms = time_ms(graph_replay(plain), 5)
                widths = [layer.conv.out_features for layer in mlp]
                b_ms, b_by = sa_mlp_bound(xyz, new_xyz, feats, idx, widths)
                by_shape[tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                     bound_by=b_by, max_abs_err=err,
                                     equal_share=equal)
                print(f"[kernel] sa_mlp {tag} ({what}): within "
                      f"{err:.3e} of plain (scale {scale:.3e}), "
                      f"{equal:.6f} bit-equal; kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the "
                      f"kernel at {b_ms / k_ms:.1%} of it")
                sums[0] = max(sums[0], err)
                sums[1:] += (k_ms, p_ms, b_ms)
        print(f"[kernel] sa_mlp B={b} ({what}), the five calls: kernel "
              f"{sums[1]:.4f} ms, plain {sums[2]:.4f} ms, bound "
              f"{sums[3]:.4f} ms; the kernel at {sums[3] / sums[1]:.1%} of "
              "it")
        totals[b] = sums
        torch.cuda.empty_cache()
    err, k_ms, p_ms, b_ms = (float(v) for v in totals[B])
    return by_shape, (err, k_ms, p_ms), (b_ms, "operations")


def decode_case(xyz, p: int, seed: int):
    """Inputs of the keep mask on ``xyz``'s card: the cloud with a fourth
    channel (the height), p boxes a scene around its points (0.1-1.6 m,
    any yaw; some empty, many overlapping), scores on a grid of 1/64 (ties)
    and 4 classes."""
    import torch

    g = torch.Generator(xyz.device).manual_seed(seed)
    b, n, _ = xyz.shape
    pts = torch.cat([xyz, xyz[..., 2:3]], -1).contiguous()
    pick = torch.randint(0, n, (b, p), generator=g, device=xyz.device)
    around = torch.gather(xyz, 1, pick[..., None].expand(b, p, 3))
    bbox = torch.cat([
        around + 0.3 * torch.randn((b, p, 3), generator=g, device=xyz.device),
        0.1 + 1.5 * torch.rand((b, p, 3), generator=g, device=xyz.device),
        (torch.rand((b, p, 1), generator=g, device=xyz.device) - 0.5)
        * 2 * np.pi], -1).contiguous()
    obj = torch.round(torch.rand((b, p), generator=g, device=xyz.device)
                      * 64) / 64
    cls = torch.randint(0, 4, (b, p), generator=g, device=xyz.device)
    return pts, bbox, obj, cls


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
        fps_variant_plan,
        fps_variant_ref,
        plan_tag,
    )
    from nesie_tpu_torch.tools import fps_experiments, fps_lab

    t0 = time.perf_counter()
    _build.reset_launch_counts()
    fps_variants.reset_launch_counts()
    # ----- the lab path
    if fps_lab.check("cuda", VARIANTS) != 0:
        raise AssertionError("[fps-lab] a variant differs from fps_ref on "
                             "the check clouds")
    # a tie that spans the CTAs of a cluster: 40 distinct points tiled
    if fps_lab.check("cuda", VARIANTS, shape=fps_lab.BENCH_SHAPE,
                     clouds=("dup",)) != 0:
        raise AssertionError("[fps-lab] a variant differs from fps_ref on "
                             "the tie-heavy cloud at the bench shape")
    k5 = {r["variant"]: r for r in fps_lab.bench(VARIANTS, reps=LAB_REPS)}
    b5, n5, m5 = fps_lab.BENCH_SHAPE
    k6_batch = 32  # fps_experiments' default; K5 and K6 share N and M
    k6 = fps_experiments.run(batch=k6_batch, n=n5, m=m5,
                             variants=["v0", *VARIANTS], iters=LAB_REPS)
    launches = _build.launch_counts()
    per_variant = fps_variants.launch_counts()
    # ----- end of the lab path
    bad = [f"K5 {k}" for k, r in k5.items() if not r["exact"]] + [
        f"K6 {k}" for k, r in k6.items()
        if not (r["exact_vs_xla"] and r["exact_vs_v0"])]
    if bad:
        raise AssertionError(f"[fps-lab] indices differ from fps_ref or the "
                             f"shipped FPS: {bad}")
    print(f"[fps-lab] launches during the lab path: {launches}; by variant "
          f"{per_variant}; the lab library's nvcc "
          f"{_build.build_seconds.get('fps_lab')} s")
    for name, n in per_variant.items():
        if n <= 0:
            raise AssertionError(f"[fps-lab] {name} was never launched")

    clouds = {"K5": (fps_lab.bench_cloud("cuda"), m5),
              "K6": (fps_experiments.make_cloud(k6_batch, n5, "cuda"), m5)}
    k5_tag, k6_tag = f"{b5}x{n5}->{m5}", f"{k6_batch}x{n5}->{m5}"
    v0_ms = {k5_tag: k5["v0_current"]["ms"], k6_tag: k6["v0"]["ms"]}
    print(f"[fps-lab] ms by variant: {k5_tag} (mean of {LAB_REPS}, beside "
          f"the shipped fps_onchip.cu {v0_ms[k5_tag]:.4f}) | {k6_tag} (least "
          f"of {LAB_REPS}, beside the shipped fps_onchip.cu "
          f"{v0_ms[k6_tag]:.4f})")
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
        plans = {k5_tag: plan_tag(fps_variant_plan(name, b5, n5)),
                 k6_tag: plan_tag(fps_variant_plan(name, k6_batch, n5))}
        tag = k5_tag if which == "K5" else k6_tag
        print(f"[fps-lab] {name:12s} ({v.select}, {v.fetch}, rows {v.rows}, "
              f"unroll {v.unroll}): {by_shape[k5_tag]:.4f} ms "
              f"[{plans[k5_tag]}] x{by_shape[k5_tag] / v0_ms[k5_tag]:.3f} | "
              f"{by_shape[k6_tag]:.4f} ms [{plans[k6_tag]}] "
              f"x{by_shape[k6_tag] / v0_ms[k6_tag]:.3f} of the shipped FPS; "
              f"plain {plain_ms:.4f} ms at {which}'s shape, bound "
              f"{b_ms:.4f} ms")
        entries.append(dict(
            name=f"fps_variant:{name}", route="cuda",
            source="nesie_tpu_torch/csrc/fps_variants.cu",
            replaces=v.replaces, launches=per_variant[name],
            max_abs_err=err, ms=by_shape[tag], ms_per_step=by_shape[tag] / (
                m - 1), plan=plans[tag], ms_by_shape=by_shape,
            plan_by_shape=plans,
            vs_shipped_by_shape={k: by_shape[k] / v0_ms[k] for k in v0_ms},
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
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
    check_counts(launches["runner"], "runner's training", {"sa_mlp": 0})

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
    """Each kernel of ``need`` launched on ``path``; with ``forwards``, the
    ball query and three-NN at their count a forward."""
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 f"{path} path")
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
    check_counts(launches["saqe_train"], "SAQE training", {"sa_mlp": 0})
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
    check_counts(launches["saqe_runner"], "SAQE CLI training", {"sa_mlp": 0})
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


def options_kernels(dev, scenes) -> dict:
    """K1 and K2 at the FPS shapes of the real seed and SA2-SA4 FPS, K3 at
    spec's shape, each identical to its plain version, beside its bound.
    Returns the entries by kernel and shape."""
    import torch

    from nesie_tpu_torch.ops import pointops
    from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
    from nesie_tpu_torch.ops.fps import fps_onchip_cuda, fps_onchip_plan, fps_ref

    xyz = torch.from_numpy(np.stack(scenes)).to(dev)
    centers = pointops.gather_points(
        xyz, fps_onchip_cuda(xyz, SA1["m"])).contiguous()  # SA1's samples
    del xyz
    out = {"fps_onchip": {}, "fps_onchip_small": {}, "ball_query": {}}
    for what, n, m in OPT_FPS_SHAPES:
        for b, name in ((B, "fps_onchip"), (SEMI_B, "fps_onchip_small")):
            x = centers[:b, :n].contiguous()
            tag = f"{what} B={b} N={n} M={m}"
            err, k_ms, p_ms = kernel_phase(
                f"{name} {tag} [options]", lambda: fps_onchip_cuda(x, m),
                lambda: fps_ref(x, m), reps=10, plain_reps=1)
            b_ms, b_by = fps_bound(b, n, m)
            out[name][tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, plan=fps_onchip_plan(b, n))
            print(f"[options] {name} {tag}: {k_ms:.4f} ms "
                  f"({k_ms * 1e3 / (m - 1):.4f} us a step, plan "
                  f"{out[name][tag]['plan']}), bound {b_ms:.4f} ms "
                  f"({b_by}), plain {p_ms:.4f} ms")
    seeds = centers[:, :SEEDS].contiguous()
    votes = (seeds + 0.05 * torch.randn(
        seeds.shape, generator=torch.Generator(dev).manual_seed(5),
        device=dev)).contiguous()
    r, k = OPT_SPEC_BQ["radius"], OPT_SPEC_BQ["k"]
    tag = f"spec aggregation B={B} N={SEEDS} M={SEEDS} r={r} K={k}"
    err, k_ms, p_ms = kernel_phase(
        f"ball_query {tag} [options]",
        lambda: ball_query_cuda(seeds, votes, r, k),
        lambda: ball_query_ref(seeds, votes, r, k))
    b_ms, b_by = ball_query_bound(ball_query_cuda(seeds, votes, r, k), SEEDS)
    out["ball_query"][tag] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by)
    print(f"[options] ball_query {tag}: {k_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), plain {p_ms:.4f} ms")
    return out


def check_counts(counts: dict, path: str, want: dict) -> None:
    """Exact launch counts on ``path``."""
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{path}: {counts[name]} {name} launches "
                                 f"(want {n})")


def semi_steps(dev, model, n_labeled: int, n_unlabeled: int, **step_kw):
    """One warm-up and ``OPT_STEPS`` timed semi steps of ``model`` at
    ``n_labeled`` + ``n_unlabeled`` scenes x 40000; finite losses and
    gradients. Returns (median ms, peak GiB, the last metrics)."""
    import torch

    from nesie_tpu_torch.data.synthetic import semi_batch
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule

    state = create_train_state(model, make_lr_schedule(8e-3, 1000),
                               device=dev)
    batch = semi_batch(np.random.default_rng(7), n_labeled, n_unlabeled,
                       N_POINTS, SEMI["max_gt"], SEMI["n_boxes"], dev)
    ulb = [UlbState.create(SEMI["scans"], 18, device=dev)]
    step = make_semi_train_step(n_labeled, SEMI["scans"], **step_kw)
    gen = torch.Generator(dev).manual_seed(2)
    gen_t = torch.Generator(dev).manual_seed(3)

    def run():
        ulb[0], metrics = step(state, ulb[0], batch, generator=gen,
                               teacher_generator=gen_t)
        return metrics

    torch.cuda.reset_peak_memory_stats()
    times, metrics = timed_steps(run, OPT_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_finite(metrics, state.model, f"semi step {step_kw}")
    return float(np.median(times)), peak, metrics


def options_phase(dev, scenes, nesie: dict) -> dict:
    """[options]: the flagship VoteNetNesie with the options of ROADMAP
    §1.3 on the card. The kernels at their new shapes; then, counts set
    to 0 before and read after each path: eval forwards at B=32 in
    ``spec``, ``random`` and ``seed`` with the real seed and SA2-SA4 FPS
    (``options_spec``, ``options_random``, ``options_seed_fps``); bf16
    beside float32, an eval forward and a semi step (``options_bf16``);
    semi steps with ``teacher_jitter`` and with ``sample_mod_train=spec``
    (``options_train``); the test CLI with ``test.iou_opt=true`` on
    ``[runner]``'s checkpoint and ``evaluate`` with and without it
    (``options_iou_opt``); a SAQE eval forward under ``spec``
    (``options_saqe_spec``). ``nesie``: this run's default numbers, printed
    beside. Returns the launches by path and the kernel entries by
    shape."""
    import gc

    import torch

    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.dataset import ScanNetScenes
    from nesie_tpu_torch.nn.detector import (
        VoteNetNesie,
        init_weights_,
        init_weights_flax_,
        randomize_bn_,
    )
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.train import runner

    t_phase = time.perf_counter()
    kernels = options_kernels(dev, scenes)
    torch.cuda.empty_cache()
    launches = {}
    weights = torch.load(ROOT / "build" / "nesie_tpu_torch" /
                         "smoke_weights.pth", weights_only=True)
    points = torch.from_numpy(np.stack(
        [io.add_height(s) for s in scenes]).astype(np.float32)).to(dev)

    def timed_forwards(net, mode, reps=5):
        gen = torch.Generator(dev).manual_seed(0)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            out = net(points, mode, generator=gen)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = net(points, mode, generator=gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return (float(np.median(times)), times,
                torch.cuda.max_memory_allocated() / 2**30, out)

    def check_out(out, what, n_prop):
        for key, shape in (("bbox_preds", (B, n_prop, 7)),
                           ("obj_scores", (B, n_prop, 2)),
                           ("iou_scores", (B, n_prop, 18))):
            v = out[key]
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                raise AssertionError(f"[options] {what} {key}: shape "
                                     f"{tuple(v.shape)} (want {shape}) or "
                                     "non-finite values")

    # ---- the eval forwards by sample mode
    base = VoteNetNesie()
    base.load_state_dict(weights)
    base = base.to(dev).eval()
    real_fps = VoteNetNesie()  # the module fields JAX has for the option
    for sa in real_fps.backbone.SA_modules:
        sa.input_fps_ordered = False
    real_fps.bbox_head.seed_fps_prefix_opt = False
    real_fps.load_state_dict(weights)
    real_fps = real_fps.to(dev).eval()
    outs = {}
    for path, what, net, mode, n_prop in (
            ("options_spec", "spec", base, "spec", SEEDS),
            ("options_random", "random", base, "random", 256),
            ("options_seed_fps", "seed, real FPS", real_fps, "seed", 256)):
        _build.reset_launch_counts()
        # ----- the path: 6 forwards (a warm-up and 5 timed)
        ms, times, peak, out = timed_forwards(net, mode)
        launches[path] = _build.launch_counts()
        # ----- end of the path
        fps_n, bq_n, nn_n = OPT_PER_FORWARD[what]
        check_counts(launches[path], path, {"fps_onchip": 6 * fps_n,
                                            "ball_query": 6 * bq_n,
                                            "three_nn": 6 * nn_n})
        check_out(out, what, n_prop)
        outs[what] = out
        print(f"[options] launches during {path}: {launches[path]}")
        print(f"[options] eval forward B={B} x {N_POINTS} x 4, {what}: "
              f"median {ms:.3f} ms over {len(times)} runs ({times}), peak "
              f"{peak:.3f} GiB; this run's default forward "
              f"{nesie['eval_ms']:.3f} ms (ratio "
              f"{ms / nesie['eval_ms']:.4f})")
    if outs["spec"]["aggregated_indices"] is not None:
        raise AssertionError("spec: aggregated_indices should be None")
    draw = outs["random"]["aggregated_indices"]
    if not (draw.min() >= 0 and draw.max() < SEEDS):
        raise AssertionError("random: seed indices out of range")
    # the real FPS over FPS-ordered inputs is the prefix (FPS prefix
    # consistency): the same samples and outputs as the default forward
    with torch.inference_mode():
        default = base(points)
    real = outs["seed, real FPS"]
    arange = torch.arange(256, device=dev, dtype=torch.int32).expand(B, -1)
    same = (torch.equal(real["seed_indices"], default["seed_indices"])
            and torch.equal(real["aggregated_indices"], arange))
    diff = (real["bbox_preds"] - default["bbox_preds"]).abs().max().item()
    print(f"[options] seed with the real seed and SA2-SA4 FPS: samples "
          f"equal the prefix ones: {same}; max |bbox diff| against the "
          f"default forward {diff:.3e}")
    if not same or diff > 1e-4:
        raise AssertionError("the real FPS at SA2-SA4 and the seeds did "
                             "not reproduce the prefix samples")
    del real_fps, outs, real
    torch.cuda.empty_cache()

    # ---- bf16 beside float32: the eval forward, then a semi step
    bf16 = VoteNetNesie(compute_dtype="bfloat16")
    bf16.load_state_dict(weights)
    bf16 = bf16.to(dev).eval()
    f32_ms, f32_times, f32_peak, f32_out = timed_forwards(base, "seed")
    _build.reset_launch_counts()
    # ----- the bf16 path: 6 forwards, then the semi steps
    bf_ms, bf_times, bf_peak, bf_out = timed_forwards(bf16, "seed")
    fwd_counts = _build.launch_counts()
    fps_n, bq_n, nn_n = OPT_PER_FORWARD["bfloat16"]
    check_counts(fwd_counts, "options_bf16 (forwards)",
                 {"fps_onchip": 6 * fps_n, "ball_query": 6 * bq_n,
                  "three_nn": 6 * nn_n})
    check_out(bf_out, "bfloat16", 256)
    del bf16
    model = VoteNetNesie(compute_dtype="bfloat16")
    init_weights_(model, torch.Generator().manual_seed(3))
    semi_bf = semi_steps(dev, model, SEMI["n_labeled"], SEMI["n_unlabeled"])
    launches["options_bf16"] = _build.launch_counts()
    # ----- end of the bf16 path
    del model
    torch.cuda.empty_cache()
    model = VoteNetNesie()
    init_weights_(model, torch.Generator().manual_seed(3))
    semi_f32 = semi_steps(dev, model, SEMI["n_labeled"], SEMI["n_unlabeled"])
    del model
    torch.cuda.empty_cache()
    print(f"[options] launches during options_bf16: "
          f"{launches['options_bf16']}")
    check_launches(launches["options_bf16"], "options_bf16",
                   need=EVAL_KERNELS)
    keys = ("bbox_preds", "obj_scores", "iou_scores")
    agree = torch.ones(B, 256, dtype=torch.bool, device=dev)
    dist = {}
    for key in keys:
        d = (bf_out[key] - f32_out[key]).abs()
        dist[key] = d.max().item()
        agree &= (d <= OPT_BF16["atol"] + OPT_BF16["rtol"]
                  * f32_out[key].abs()).reshape(B, 256, -1).all(-1)
    share = agree.float().mean().item()
    print(f"[options] bf16 eval forward B={B}: median {bf_ms:.3f} ms "
          f"({bf_times}), peak {bf_peak:.3f} GiB; float32 in the same "
          f"phase {f32_ms:.3f} ms ({f32_times}), peak {f32_peak:.3f} GiB "
          f"(bf16 / float32 {bf_ms / f32_ms:.4f})")
    print(f"[options] bf16 against float32, same weights and batch: max "
          f"|diff| {dist}; {share:.4f} of proposals agree within atol "
          f"{OPT_BF16['atol']} + rtol {OPT_BF16['rtol']} (boxes, "
          "objectness, IoU)")
    print(f"[options] semi step {SEMI['n_labeled']} + {SEMI['n_unlabeled']} "
          f"scenes: bf16 median {semi_bf[0]:.3f} ms, peak {semi_bf[1]:.3f} "
          f"GiB; float32 {semi_f32[0]:.3f} ms, peak {semi_f32[1]:.3f} GiB "
          f"(bf16 / float32 {semi_bf[0] / semi_f32[0]:.4f}); "
          f"{OPT_STEPS} steps after a warm-up each")
    del bf_out, f32_out

    # ---- semi steps: teacher_jitter, then sample_mod_train=spec
    _build.reset_launch_counts()
    # ----- the options_train path
    model = VoteNetNesie()
    init_weights_(model, torch.Generator().manual_seed(3))
    tj = semi_steps(dev, model, SEMI["n_labeled"], SEMI["n_unlabeled"],
                    teacher_jitter=True)
    del model
    torch.cuda.empty_cache()
    spec = None
    for n_l, n_u in OPT_SEMI_SCENES:
        model = VoteNetNesie()
        init_weights_(model, torch.Generator().manual_seed(3))
        try:
            spec = (n_l, n_u) + semi_steps(dev, model, n_l, n_u,
                                           sample_mod="spec")
        except torch.cuda.OutOfMemoryError:
            print(f"[options] spec semi step at {n_l} + {n_u} scenes does "
                  f"not fit on the card (peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB)")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if spec is not None:
            break
    launches["options_train"] = _build.launch_counts()
    # ----- end of the options_train path
    if spec is None:
        raise AssertionError("the spec semi step fits at no scene count")
    print(f"[options] launches during options_train: "
          f"{launches['options_train']}")
    check_launches(launches["options_train"], "options_train")
    check_counts(launches["options_train"], "options_train", {"sa_mlp": 0})
    print(f"[options] semi step with teacher_jitter ({SEMI['n_labeled']} + "
          f"{SEMI['n_unlabeled']} scenes): median {tj[0]:.3f} ms, peak "
          f"{tj[1]:.3f} GiB, num_pseudo {tj[2]['num_pseudo'].item()}; this "
          f"run's default semi step "
          f"{nesie['semi_ms']:.3f} ms, peak {nesie['peak_gib']:.3f} GiB")
    print(f"[options] semi step with sample_mod_train=spec at {spec[0]} + "
          f"{spec[1]} scenes (P={SEEDS} proposals): median {spec[2]:.3f} "
          f"ms, peak {spec[3]:.3f} GiB; terms "
          f"{ {k: round(v.item(), 6) for k, v in spec[4].items()} }")

    # ---- test-time IoU optimisation on [runner]'s checkpoint
    data = ROOT / "build" / "runner_smoke" / "data"
    ckpt = (ROOT / "build" / "runner_smoke" / "work" / RUNNER["semi"]
            / "checkpoints")
    over = [*RUNNER_OVER, "test.iou_opt=true"]
    cfg = apply_overrides(get_config(RUNNER["semi"]), over)
    plain_cfg = apply_overrides(get_config(RUNNER["semi"]), RUNNER_OVER)
    val = ScanNetScenes(data, data / cfg.data.val_ann_file)
    model = runner.build_model(cfg)
    model.load_state_dict(
        runner.CheckpointManager(ckpt.parent).load()["model"])
    model = model.to(dev)
    _build.reset_launch_counts()
    # ----- the options_iou_opt path
    cli = test_cli.main([RUNNER["semi"], str(ckpt), "--data-root", str(data),
                         "--device", str(dev), "--batch-size",
                         str(RUNNER["eval_batch"]), "--cfg-options", *over])
    cli_counts = _build.launch_counts()
    t0 = time.perf_counter()
    test_cli.evaluate(cfg, model, val, RUNNER["eval_batch"], 9, dev)
    opt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_cli.evaluate(plain_cfg, model, val, RUNNER["eval_batch"], 9, dev)
    plain_s = time.perf_counter() - t0
    launches["options_iou_opt"] = _build.launch_counts()
    # ----- end of the options_iou_opt path
    batches = -(-len(val) // RUNNER["eval_batch"])
    per_batch = 2 * (cfg.test.opt_step + 1)
    check_counts(cli_counts, "options_iou_opt (the test CLI)",
                 {"three_nn": batches * (4 + per_batch),
                  "ball_query": batches * 5, "fps_onchip": batches})
    if not 0.0 <= cli.get("mAP_0.25", -1.0) <= 1.0:
        raise AssertionError(f"iou_opt test CLI: mAP_0.25 "
                             f"{cli.get('mAP_0.25')}")
    print(f"[options] launches during options_iou_opt: "
          f"{launches['options_iou_opt']}; the test CLI alone {cli_counts}: "
          f"three-NN {per_batch} = 2 x (opt_step + 1) a batch over the "
          f"forward's 4")
    print(f"[options] test.iou_opt=true on [runner]'s checkpoint, "
          f"{len(val)} val scenes at B={RUNNER['eval_batch']}: evaluate "
          f"{len(val) / opt_s:.2f} scenes/s against {len(val) / plain_s:.2f} "
          f"without (the runner phase's {nesie['eval_scenes_per_s']:.2f}); "
          f"the CLI's mAP_0.25 {cli['mAP_0.25']:.4f}")
    del model
    torch.cuda.empty_cache()

    # ---- one SAQE eval forward under spec
    saqe = saqe_model()
    init_weights_flax_(saqe, torch.Generator().manual_seed(0))
    saqe = saqe.to(dev).eval()
    _build.reset_launch_counts()
    # ----- the options_saqe_spec path
    s_ms, s_times, s_peak, s_out = timed_forwards(saqe, "spec", reps=3)
    launches["options_saqe_spec"] = _build.launch_counts()
    # ----- end of the options_saqe_spec path
    check_counts(launches["options_saqe_spec"], "options_saqe_spec",
                 {"fps_onchip": 4, "ball_query": 4 * SAQE_BQ_PER_FORWARD,
                  "three_nn": 4 * SAQE_3NN_PER_FORWARD})
    check_out(s_out, "SAQE spec", SEEDS)
    if not torch.isfinite(s_out["R_obj_scores"]).all():
        raise AssertionError("SAQE spec: non-finite R_obj_scores")
    print(f"[options] SAQE eval forward B={B} under spec: median "
          f"{s_ms:.3f} ms ({s_times}), peak {s_peak:.3f} GiB")
    del saqe, s_out, base, points
    torch.cuda.empty_cache()
    print(f"[options] phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, kernels=kernels)


# ------------------------------------------------------------------ [ddp]
def _ddp_rows(tree, index):
    """Rows ``index`` of every tensor of a (nested dict of) batch."""
    if isinstance(tree, dict):
        return {k: _ddp_rows(v, index) for k, v in tree.items()}
    return tree[index]


def _ddp_to(tree, dev):
    """A host batch (augmentation records as dicts) on ``dev``, the
    ``aug*`` entries as ``AugParams``."""
    from nesie_tpu_torch.data.augment import AugParams

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = AugParams(**{f: a.to(dev) for f, a in v.items()})
        else:
            out[k] = v.to(dev)
    return out


def ddp_steps(inputs: dict, dev, timed: int, dtypes=DDP_DTYPES) -> dict:
    """In each of ``dtypes`` (names): one semi step (``SEMI``'s layout: the rank's
    labeled rows, then its unlabeled rows) and one supervised step, each
    from ``inputs``' weights with its jitter noise, on this process's rows
    of the global batch (all of them without a process group); in float32
    then ``timed`` more of each, timed, and the gradient sum over the
    ranks, timed. Returns, by dtype tag ("32", "64"), the first steps'
    metrics, the ``UlbState`` after the semi step and a digest of the
    student's and teacher's bits after each first step; the times and
    peak memory; this process's launch counts."""
    import hashlib

    import torch

    from nesie_tpu_torch import parallel
    from nesie_tpu_torch.nn.detector import VoteNetNesie
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
    from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
    from nesie_tpu_torch.train.step import make_supervised_train_step

    n_l, n_u = SEMI["n_labeled"], SEMI["n_unlabeled"]
    world = parallel.world_size()
    semi_rows = parallel.part_rows(n_l // world, n_u // world)
    sup_rows = parallel.part_rows(SUP_B // world)

    def local(x, rows, dtype):
        x = x if rows is None else _ddp_rows(x, rows.index())
        if isinstance(x, dict):
            return {k: local(v, None, dtype) for k, v in x.items()}
        return x.to(dtype) if x.is_floating_point() else x

    def fresh_state(dtype):
        model = VoteNetNesie()
        model.load_state_dict(inputs["state"])
        return create_train_state(model.to(dtype),
                                  make_lr_schedule(8e-3, 1000), device=dev)

    def digest(state):
        h = hashlib.sha256()
        for t in [*state.model.state_dict().values(),
                  *state.teacher.state_dict().values()]:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def timed_run(fn):
        torch.cuda.synchronize()
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    out = {}
    _build.reset_launch_counts()
    # ----- the ddp_train path (in each rank)
    for name in dtypes:
        dtype, tag = getattr(torch, name), name[-2:]
        state = fresh_state(dtype)
        batch = _ddp_to(local(inputs["semi_batch"], semi_rows, dtype), dev)
        noise = tuple(local(n, semi_rows, dtype).to(dev)
                      for n in inputs["semi_noise"])
        step = make_semi_train_step(n_l // world, SEMI["scans"])
        ulb = [UlbState.create(SEMI["scans"], 18, device=dev)]
        torch.cuda.reset_peak_memory_stats(dev)

        def semi():
            ulb[0], m = step(state, ulb[0], batch, noise=noise)
            return m

        out[f"semi{tag}"] = {k: v.item() for k, v in semi().items()}
        out[f"ulb{tag}"] = [t.cpu() for t in ulb[0]]
        out[f"semi{tag}_digest"] = digest(state)
        if tag == "32":
            out["semi_ms"] = timed_run(semi)
            out["semi_peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                    / 2**30)
            grads = [p.grad for p in state.model.parameters()]
            out["grad_numel"] = sum(g.numel() for g in grads)
            out["allreduce_ms"] = timed_run(
                lambda: parallel.all_reduce_sum_(grads))
            del grads
        del state, batch, noise

        state = fresh_state(dtype)
        sup_batch = _ddp_to(local(inputs["sup_batch"], sup_rows, dtype), dev)
        sup_noise = tuple(local(n, sup_rows, dtype).to(dev)
                          for n in inputs["sup_noise"])
        sup = make_supervised_train_step()
        torch.cuda.reset_peak_memory_stats(dev)
        metrics = sup(state, sup_batch, noise=sup_noise)
        out[f"sup{tag}"] = {k: v.item() for k, v in metrics.items()}
        out[f"sup{tag}_digest"] = digest(state)
        if tag == "32":
            out["sup_ms"] = timed_run(
                lambda: sup(state, sup_batch, noise=sup_noise))
            out["sup_peak_gib"] = (torch.cuda.max_memory_allocated(dev)
                                   / 2**30)
        del state, sup_batch, sup_noise
        torch.cuda.empty_cache()
    out["launches"] = _build.launch_counts()
    # ----- end of the ddp_train path
    return out


def ddp_reordered(inputs: dict) -> dict:
    """``inputs`` with the rows of each part of both batches (and of their
    noise) in reverse order: the same sums in another order."""
    import torch

    n_l, n_u = SEMI["n_labeled"], SEMI["n_unlabeled"]
    semi = torch.cat([torch.arange(n_l).flip(0),
                      n_l + torch.arange(n_u).flip(0)])
    sup = torch.arange(SUP_B).flip(0)
    return dict(inputs,
                semi_batch=_ddp_rows(inputs["semi_batch"], semi),
                semi_noise=[n[semi] for n in inputs["semi_noise"]],
                sup_batch=_ddp_rows(inputs["sup_batch"], sup),
                sup_noise=[n[sup] for n in inputs["sup_noise"]])


def ddp_step_rank(args) -> dict:
    """A rank of ``ddp_phase``'s step comparison (spawned): the process
    group from the launcher's environment, then ``ddp_steps``."""
    import torch

    from nesie_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = parallel.make_mesh(device=args["device"])
    inputs = torch.load(args["inputs"], weights_only=True)
    out = ddp_steps(inputs, mesh.device, args["timed"])
    out.update(backend=mesh.backend, device=str(mesh.device))
    return out


@contextlib.contextmanager
def recorded_detections(store: dict):
    """Within the block, each AP evaluation's detections land in
    ``store["dt"]``: every scene's box count, and the boxes and scores of
    all scenes in order."""
    import importlib

    import torch

    teval = importlib.import_module("nesie_tpu_torch.eval")
    real = teval.indoor_eval

    def record(gt_annos, dt_annos, **kw):
        store["dt"] = dict(
            counts=torch.tensor([len(d["labels"]) for d in dt_annos]),
            **{k: torch.cat([torch.as_tensor(d[k]) for d in dt_annos])
               for k in ("boxes", "scores")})
        return real(gt_annos, dt_annos, **kw)

    teval.indoor_eval = record
    try:
        yield store
    finally:
        teval.indoor_eval = real


def ddp_cli_rank(args) -> dict:
    """A rank of ``ddp_phase``'s CLI runs (spawned): each argument list of
    ``args["train"]`` through the train CLI (path ``ddp_runner``), then
    ``args["test"]`` through the test CLI (path ``ddp_eval``). Returns
    the launch counts of each path, the runs' final steps, and rank 0's
    metrics and the detections they were computed from."""
    import torch

    from nesie_tpu_torch import parallel
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.tools import train as train_cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = parallel.make_mesh(device=args["device"])
    out = dict(backend=mesh.backend, steps=[], results=None)
    _build.reset_launch_counts()
    # ----- the ddp_runner path (in each rank)
    t0 = time.perf_counter()
    for argv in args["train"]:
        out["steps"].append(int(train_cli.main(argv).step))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["ddp_runner"] = _build.launch_counts()
    # ----- end of the ddp_runner path
    if args.get("test"):
        _build.reset_launch_counts()
        # ----- the ddp_eval path (in each rank)
        t0 = time.perf_counter()
        with recorded_detections({}) as seen:
            results = test_cli.main(args["test"])
        out["eval_s"] = time.perf_counter() - t0
        out["detections"] = seen.get("dt")
        out["ddp_eval"] = _build.launch_counts()
        # ----- end of the ddp_eval path
        if results is not None:
            out["results"] = {k: float(v) for k, v in results.items()}
    return out


def ddp_kernels(dev, scenes) -> dict:
    """K2, K3 and K4 at the shapes one rank of a 2-rank run gives them,
    each identical to its plain version, beside its bound. Returns the
    entries by kernel and shape."""
    import torch

    from nesie_tpu_torch.ops import pointops
    from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
    from nesie_tpu_torch.ops.fps import fps_onchip_cuda, fps_onchip_plan, fps_ref
    from nesie_tpu_torch.ops.three_nn import three_nn_cuda, three_nn_ref

    b_max = max(b for _, b, _, _ in DDP_K2_SHAPES)
    xyz = torch.from_numpy(np.stack(scenes[:b_max])).to(dev)
    centers = pointops.gather_points(
        xyz, fps_onchip_cuda(xyz, SA1["m"])).contiguous()
    seeds = centers[:, :SEEDS].contiguous()
    out = {"fps_onchip_small": {}, "ball_query": {}, "three_nn": {}}

    def record(name, tag, res, b_ms, b_by, **extra):
        out[name][tag] = dict(max_abs_err=res[0], ms=res[1], plain_ms=res[2],
                              bound_ms=b_ms, bound_by=b_by, **extra)
        print(f"[ddp] {name} {tag}: {res[1]:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), plain {res[2]:.4f} ms; identical to the plain "
              "version")

    for what, b, n, m in DDP_K2_SHAPES:
        x = (xyz[:b] if n == N_POINTS else
             (seeds[:b] + 0.05 * torch.randn(
                 (b, n, 3), generator=torch.Generator(dev).manual_seed(3),
                 device=dev)).contiguous())
        x = x.contiguous()
        tag = f"{what} B={b} N={n} M={m}"
        res = kernel_phase(f"fps_onchip_small {tag} [ddp]",
                           lambda: fps_onchip_cuda(x, m),
                           lambda: fps_ref(x, m), reps=5, plain_reps=1)
        record("fps_onchip_small", tag, res, *fps_bound(b, n, m),
               plan=fps_onchip_plan(b, n))
    for what, b in DDP_BQ_SHAPES:
        x, c = xyz[:b].contiguous(), centers[:b].contiguous()
        r, k = SA1["radius"], SA1["k"]
        tag = f"{what} B={b} N={N_POINTS} M={SA1['m']} r={r} K={k}"
        res = kernel_phase(f"ball_query {tag} [ddp]",
                           lambda: ball_query_cuda(x, c, r, k),
                           lambda: ball_query_ref(x, c, r, k))
        record("ball_query", tag, res,
               *ball_query_bound(ball_query_cuda(x, c, r, k), N_POINTS))
    for what, b, m, n in DDP_K4_SHAPES:
        if what.startswith("FP1"):
            q, src = centers[:b, :m].contiguous(), centers[:b, :n].contiguous()
        else:
            per_box = 96
            q = (seeds[:b, :m // per_box, None, :] + torch.rand(
                (b, m // per_box, per_box, 3),
                generator=torch.Generator(dev).manual_seed(b), device=dev)
                - 0.5).reshape(b, m, 3).contiguous()
            src = seeds[:b]
        tag = f"{what} B={b} M={m} N={n}"
        res = kernel_phase(f"three_nn {tag} [ddp]",
                           lambda: three_nn_cuda(q, src),
                           lambda: three_nn_ref(q, src))
        lib_ms = time_ms(
            lambda: torch.topk(torch.cdist(q, src), 3, largest=False), 5)
        record("three_nn", tag, res, *three_nn_bound(b, m, n),
               library_ms=lib_ms)
    return out


def _close(got: float, want: float, tol: dict) -> bool:
    return abs(got - want) <= tol["atol"] + tol["rtol"] * abs(want)


def ddp_compare(ranks: list, one: dict, what: str, control: dict) -> None:
    """The ranks' first semi and supervised steps against one process's:
    every loss term and the gradient norm within ``DDP_TOL`` of its dtype,
    the ranks' students and teachers bit-identical, ``UlbState`` equal in
    float64. ``control``: one process's float32 steps on the rows in
    another order, whose distance from ``one`` is printed beside."""
    import torch

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    for tag in ("64", "32"):
        for kind in ("semi", "sup"):
            key, want, tol = f"{kind}{tag}", one[f"{kind}{tag}"], DDP_TOL[tag]
            worst = 0.0
            for r, got in enumerate(ranks):
                if set(got[key]) != set(want):
                    raise AssertionError(f"{what} {key}: terms "
                                         f"{sorted(got[key])}, one process "
                                         f"{sorted(want)}")
                for k, v in want.items():
                    worst = max(worst, rel(got[key][k], v))
                    if not _close(got[key][k], v, tol):
                        raise AssertionError(
                            f"{what} {kind} step (float{tag}), rank {r}: "
                            f"{k} = {got[key][k]!r}, one process {v!r} "
                            f"(tolerance {tol})")
            if len({got[f"{key}_digest"] for got in ranks}) != 1:
                raise AssertionError(f"{what} {key}: the ranks' students "
                                     "and teachers differ after the step")
            note = ""
            if tag == "32":
                note = (f"; one process on the rows in another order: "
                        f"{max(rel(control[key][k], v) for k, v in want.items()):.3e}")
            print(f"[ddp] {what} {kind} step, float{tag}: every loss term "
                  f"and the gradient norm within atol {tol['atol']} + rtol "
                  f"{tol['rtol']} of one process (largest relative "
                  f"difference {worst:.3e}{note}); the ranks' students and "
                  f"teachers bit-identical after it")
    for r, got in enumerate(ranks):
        for a, b in zip(got["ulb64"], one["ulb64"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: rank {r}'s UlbState (float64) "
                                     "is not the one process's")
    same32 = all(torch.equal(a, b) for got in ranks
                 for a, b in zip(got["ulb32"], one["ulb32"]))
    print(f"[ddp] {what}: UlbState equal to one process's in float64 "
          f"(float32: {'equal' if same32 else 'differs'}); pseudo-labels "
          f"{one['semi64']['num_pseudo']} (float64), "
          f"{one['semi32']['num_pseudo']} (float32)")


def ddp_phase(dev, scenes, nesie: dict, smi: str) -> dict:
    """[ddp]: data parallelism on the card. The kernels at the per-rank
    shapes; one process's semi (4 + 8) and supervised (B=8) steps; the
    same steps at 2 ranks under gloo on this card (2 + 4 and 4 a rank;
    path ``ddp_train``), and under NCCL across 2 cards where the machine
    has them; the train CLI under NCCL at world size 1 and gloo at world
    size 2 (semi from ``[runner]``'s pretrain checkpoint, 2 epochs of 2
    steps, a checkpoint, a resume; path ``ddp_runner``); the test CLI at
    2 ranks on ``[runner]``'s semi checkpoint against one process
    (``ddp_eval``). ``nesie``: this run's bare step numbers. Returns the
    launches by path (summed over the ranks) and the kernel entries."""
    import shutil

    import torch

    from nesie_tpu_torch.data.synthetic import semi_batch
    from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_
    from nesie_tpu_torch.parallel.launch import spawn_ranks
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.train import runner

    t_phase = time.perf_counter()
    kernels = ddp_kernels(dev, scenes)
    torch.cuda.empty_cache()
    base = ROOT / "build" / "ddp_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)

    # the inputs every process starts from
    model = VoteNetNesie()
    init_weights_(model, torch.Generator().manual_seed(5))
    batch = semi_batch(np.random.default_rng(17), SEMI["n_labeled"],
                       SEMI["n_unlabeled"], N_POINTS, SEMI["max_gt"],
                       SEMI["n_boxes"], "cpu")
    batch = {k: v._asdict() if hasattr(v, "_asdict") else v
             for k, v in batch.items()}
    sup_batch = dict(points=batch["points_raw_s"][:SUP_B],
                     gt_boxes=batch["gt_boxes"][:SUP_B],
                     gt_labels=batch["gt_labels"][:SUP_B],
                     gt_valid=batch["gt_valid"][:SUP_B],
                     aug={f: a[:SUP_B] for f, a in batch["aug_s"].items()})
    gen = torch.Generator().manual_seed(11)
    p = model.bbox_head.num_proposal
    b_semi = SEMI["n_labeled"] + SEMI["n_unlabeled"]
    inputs = dict(
        state=model.state_dict(), semi_batch=batch, sup_batch=sup_batch,
        semi_noise=[torch.randn((b_semi, p, 3), generator=gen)
                    for _ in range(2)],
        sup_noise=[torch.randn((SUP_B, p, 3), generator=gen)
                   for _ in range(2)])
    torch.save(inputs, base / "inputs.pt")

    one = ddp_steps(inputs, dev, DDP_TIMED)
    control = ddp_steps(ddp_reordered(inputs), dev, 0, dtypes=("float32",))
    torch.cuda.empty_cache()
    step_args = dict(inputs=str(base / "inputs.pt"), timed=DDP_TIMED,
                     device=DEVICE)
    # every rank on this process's first card, whatever the machine has
    one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]}
    ranks = spawn_ranks(ddp_step_rank, DDP_WORLD, step_args, base / "steps",
                        DDP_TIMEOUT_S, env=one_card)
    launches = {"ddp_train": {k: sum(r["launches"][k] for r in ranks)
                              for k in ranks[0]["launches"]}}
    print(f"[ddp] launches during ddp_train (both ranks): "
          f"{launches['ddp_train']}")
    check_launches(launches["ddp_train"], "ddp_train")
    check_counts(launches["ddp_train"], "ddp_train", {"sa_mlp": 0})
    if launches["ddp_train"]["fps_onchip"] != 0:
        raise AssertionError("ddp_train: B > 16 FPS at the per-rank batch")
    backend = {r["backend"] for r in ranks}
    ddp_compare(ranks, one, f"{DDP_WORLD} ranks ({'/'.join(backend)}, "
                            f"one card)", control)
    for kind, rows in (("semi", f"{SEMI['n_labeled'] // DDP_WORLD} + "
                                f"{SEMI['n_unlabeled'] // DDP_WORLD}"),
                       ("sup", str(SUP_B // DDP_WORLD))):
        per_rank = [float(np.median(r[f"{kind}_ms"])) for r in ranks]
        print(f"[ddp] {kind} step, {rows} scenes a rank, {DDP_WORLD} ranks "
              f"sharing one card: median ms by rank {per_rank} (all "
              f"{[r[f'{kind}_ms'] for r in ranks]}), peak GiB by rank "
              f"{[round(r[f'{kind}_peak_gib'], 3) for r in ranks]}; one "
              f"process on the global batch {np.median(one[f'{kind}_ms']):.3f}"
              f" ms, peak {one[f'{kind}_peak_gib']:.3f} GiB (the training "
              f"path's bare {nesie[f'{kind}_ms']:.3f} ms); {smi}")
    print(f"[ddp] gradient sum over the ranks ({ranks[0]['grad_numel']} "
          f"float32, gloo through the host): ms by rank "
          f"{[float(np.median(r['allreduce_ms'])) for r in ranks]}; {smi}")
    cards = torch.cuda.device_count()
    if cards >= DDP_WORLD:
        nccl = spawn_ranks(ddp_step_rank, DDP_WORLD, step_args,
                           base / "steps_nccl", DDP_TIMEOUT_S)
        ddp_compare(nccl, one, f"{DDP_WORLD} ranks (NCCL, {DDP_WORLD} cards: "
                               f"{sorted({r['device'] for r in nccl})})",
                    control)
        print(f"[ddp] NCCL across cards: semi ms by rank "
              f"{[float(np.median(r['semi_ms'])) for r in nccl]}, gradient "
              f"sum ms by rank "
              f"{[float(np.median(r['allreduce_ms'])) for r in nccl]}")
    print(f"[ddp] cards used: {min(cards, DDP_WORLD)} of {cards}")
    del ranks
    torch.cuda.empty_cache()

    # ----- the CLIs: NCCL at world size 1, gloo at world size 2
    data = ROOT / "build" / "runner_smoke" / "data"
    rwork = ROOT / "build" / "runner_smoke" / "work"
    test_common = [RUNNER["semi"], str(rwork / RUNNER["semi"] / "checkpoints"),
                   "--data-root", str(data), "--device", DEVICE,
                   "--batch-size", str(DDP_EVAL_BATCH)]
    cli = {}
    for world, over in ((1, RUNNER_OVER),
                        (DDP_WORLD, DDP_RUNNER_OVER)):
        work = base / f"work{world}"
        common = ["--data-root", str(data), "--work-dir", str(work),
                  "--device", DEVICE, "--num-devices", str(world)]
        args = dict(device=DEVICE, train=[
            [RUNNER["semi"], *common, "--load-from",
             str(rwork / RUNNER["pretrain"] / "checkpoints"),
             "--cfg-options", *over],
            [RUNNER["semi"], *common, "--resume", "--cfg-options", *over,
             "optim.max_epochs=3"]])
        if world > 1:
            args["test"] = [*test_common, "--num-devices", str(world),
                            "--cfg-options", *RUNNER_OVER]
        cli[world] = spawn_ranks(ddp_cli_rank, world, args,
                                 base / f"cli{world}", DDP_TIMEOUT_S,
                                 env=one_card)
        run = cli[world]
        ckpt = runner.CheckpointManager(work / RUNNER["semi"]).load()
        rows = metric_rows(work / RUNNER["semi"])
        check_rows(rows, f"ddp train CLI at world size {world}")
        # make_mesh's rule: NCCL when each rank has a card of its own (the
        # ranks see one card here)
        backend = "nccl" if DEVICE == "cuda" and world == 1 else "gloo"
        if ({r["backend"] for r in run} != {backend}
                or any(r["steps"] != [4, 6] for r in run)
                or ckpt["step"] != 6 or ckpt["meta"] != {"mesh_size": world}):
            raise AssertionError(
                f"ddp train CLI at world size {world}: backends "
                f"{[r['backend'] for r in run]}, steps "
                f"{[r['steps'] for r in run]}, checkpoint step "
                f"{ckpt['step']} meta {ckpt['meta']}")
        print(f"[ddp] train CLI under {run[0]['backend']} at world size "
              f"{world}: semi from [runner]'s pretrain, 2 epochs of 2 steps, "
              f"checkpoint at step 4 (mesh_size {world}), resumed to step 6 "
              f"in {max(r['train_s'] for r in run):.2f} s; losses "
              f"{[round(r['loss'], 4) for r in rows]}")
    launches["ddp_runner"] = {
        k: sum(r["ddp_runner"][k] for w in cli for r in cli[w])
        for k in cli[1][0]["ddp_runner"]}
    launches["ddp_eval"] = {
        k: sum(r["ddp_eval"][k] for r in cli[DDP_WORLD])
        for k in cli[DDP_WORLD][0]["ddp_eval"]}
    print(f"[ddp] launches during ddp_runner (every rank of both runs): "
          f"{launches['ddp_runner']}; during ddp_eval (both ranks): "
          f"{launches['ddp_eval']}")
    check_launches(launches["ddp_runner"], "ddp_runner")
    check_counts(launches["ddp_runner"], "ddp_runner", {"sa_mlp": 0})
    check_launches(launches["ddp_eval"], "ddp_eval",
                   need=("fps_onchip_small", "ball_query", "three_nn",
                         "sa_mlp"))
    if launches["ddp_eval"]["fps_onchip"] != 0:
        raise AssertionError("ddp_eval: B > 16 FPS at 16 scenes a rank")

    # ----- the test CLI at 2 ranks against one process at 16 a batch
    got = cli[DDP_WORLD][0]["results"]
    if got is None or any(r["results"] is not None
                          for r in cli[DDP_WORLD][1:]):
        raise AssertionError("ddp test CLI: rank 0 alone returns metrics")
    with recorded_detections({}) as seen:
        want = test_cli.main([*test_common, "--cfg-options", *RUNNER_OVER])
    diff = max(abs(got[k] - float(want[k])) for k in want)
    if got.keys() != want.keys() or diff > DDP_EVAL_ATOL:
        raise AssertionError(f"ddp test CLI: metrics differ from one "
                             f"process's by {diff} (keys {sorted(got)})")
    dt, dt_want = cli[DDP_WORLD][0]["detections"], seen["dt"]
    if not torch.equal(dt["counts"], dt_want["counts"]):
        raise AssertionError(f"ddp test CLI: detections a scene "
                             f"{dt['counts'].tolist()}, one process "
                             f"{dt_want['counts'].tolist()}")
    dt_diff = max([(dt[k] - dt_want[k]).abs().max().item()
                   for k in ("boxes", "scores") if dt[k].numel()] or [0.0])
    if dt_diff > DDP_EVAL_ATOL:
        raise AssertionError(f"ddp test CLI: detections differ from one "
                             f"process's by {dt_diff}")
    print(f"[ddp] test CLI at {DDP_WORLD} ranks x {DDP_EVAL_BATCH} scenes "
          f"on [runner]'s checkpoint: {int(dt['counts'].sum())} detections "
          f"over {len(dt['counts'])} scenes and {len(want)} metrics within "
          f"{DDP_EVAL_ATOL} of one process at B={DDP_EVAL_BATCH} (largest "
          f"differences {dt_diff:.3e}, {diff:.3e}); mAP_0.25 "
          f"{got['mAP_0.25']:.4f}; "
          f"{max(r['eval_s'] for r in cli[DDP_WORLD]):.2f} s")
    print(f"[ddp] phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, kernels=kernels)


def seg_room(rng, n: int):
    """A generated room of ``n`` points with the height channel (n, 4) and
    per-point labels: 2 + (box index mod 18) inside an object's box, 1 on
    the floor, 0 elsewhere (walls), ``SEG['ignore']`` of them 255."""
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.synthetic import make_scene

    pts, boxes = make_scene(rng, n, with_boxes=True)
    labels = np.where(pts[:, 2] < 0.05, 1, 0)
    for i, (cx, cy, z0, dx, dy, dz, _) in enumerate(boxes):
        inside = ((np.abs(pts[:, 0] - cx) <= dx / 2 + 0.01)
                  & (np.abs(pts[:, 1] - cy) <= dy / 2 + 0.01)
                  & (pts[:, 2] >= z0 - 0.01) & (pts[:, 2] <= z0 + dz + 0.01))
        labels[inside] = 2 + i % 18
    labels[rng.uniform(size=n) < SEG["ignore"]] = 255
    return io.add_height(pts).astype(np.float32), labels


def seg_blocks(rng, b: int):
    """``b`` training blocks: a 1.5 m square window of a generated room,
    ``SEG['n']`` of its points (with replacement when fewer), x and y
    relative to the window's centre, as the segmentor takes them.
    Returns points (b, n, 4) float32 and labels (b, n) int64."""
    pts_out, lab_out = [], []
    while len(pts_out) < b:
        pts, labels = seg_room(rng, SEG["room_points"] // 4)
        lo = pts[:, :2].min(0)
        span = pts[:, :2].max(0) - lo - SEG["block"]
        corner = lo + rng.uniform(0, 1, 2) * span
        inside = np.all((pts[:, :2] >= corner)
                        & (pts[:, :2] <= corner + SEG["block"]), axis=1)
        idx = np.flatnonzero(inside)
        if len(idx) < 64:
            continue
        pick = rng.choice(idx, SEG["n"], replace=len(idx) < SEG["n"])
        block = pts[pick].copy()
        block[:, :2] -= corner + SEG["block"] / 2
        pts_out.append(block)
        lab_out.append(labels[pick])
    return np.stack(pts_out), np.stack(lab_out).astype(np.int64)


def tail_kernel_entry(name, tag, out, kernel, plain, bound_ms_by,
                      library=None):
    """One kernel shape beside its plain version (identical output) and
    its bound, and the PyTorch call's time where there is one."""
    err, k_ms, p_ms = kernel_phase(f"{name} {tag} [tail]", kernel, plain,
                                   reps=5, plain_reps=1)
    entry = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms_by[0],
                 bound_by=bound_ms_by[1], max_abs_err=err,
                 library_ms=None if library is None else time_ms(library, 3))
    out.setdefault(name, {})[tag] = entry
    lib = ("" if library is None
           else f", torch.topk(torch.cdist) {entry['library_ms']:.4f} ms")
    print(f"[tail] {name} {tag}: {k_ms:.4f} ms, bound "
          f"{bound_ms_by[0]:.4f} ms ({bound_ms_by[1]}), plain {p_ms:.4f} ms"
          f"{lib}")


def tail_kernels(dev, blocks, scenes) -> dict:
    """K1-K4 at the point tail's shapes, each identical to its plain
    version: the segmentor's FPS (16 and 24 blocks and one request of
    8192 -> 1024), its four ball queries and four FP three-NNs (B=16),
    SA1 and the last FP at slide_inference's 24 blocks; the VoteHead
    detector's SA1 FPS and ball query (8 x 40000), its seed / vote FPS
    (8 x 1024 -> 256), aggregation ball query and two FPs. Returns the
    entries by kernel and shape."""
    import torch

    from nesie_tpu_torch.ops import pointops
    from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
    from nesie_tpu_torch.ops.fps import fps_launch_name, fps_onchip_cuda, fps_ref
    from nesie_tpu_torch.ops.three_nn import three_nn_cuda, three_nn_ref

    out = {}

    def fps(x, m, what):
        b, n = x.shape[:2]
        tail_kernel_entry(fps_launch_name(b), f"{what} B={b} N={n} M={m}",
                          out, lambda: fps_onchip_cuda(x, m),
                          lambda: fps_ref(x, m), fps_bound(b, n, m))

    def bq(x, c, r, k, what):
        b, n, m = x.shape[0], x.shape[1], c.shape[1]
        idx = ball_query_cuda(x, c, r, k)
        tail_kernel_entry("ball_query", f"{what} B={b} N={n} M={m} r={r} "
                          f"K={k}", out, lambda: ball_query_cuda(x, c, r, k),
                          lambda: ball_query_ref(x, c, r, k),
                          ball_query_bound(idx, n))

    def nn3(q, s, what):
        b, m, n = q.shape[0], q.shape[1], s.shape[1]
        tail_kernel_entry("three_nn", f"{what} B={b} M={m} N={n}", out,
                          lambda: three_nn_cuda(q, s),
                          lambda: three_nn_ref(q, s), three_nn_bound(b, m, n),
                          library=lambda: torch.topk(torch.cdist(q, s), 3,
                                                     largest=False))

    # the segmentor: SA1 by FPS, SA2-SA4 the FPS prefix
    for b, what in ((SEG["b"], "segmentor training"),
                    (SEG["slide_batch"], "slide_inference"),
                    (1, "inference_segmentor")):
        x = torch.from_numpy(blocks[:b, :, :3]).to(dev).contiguous()
        fps(x, SEG_NET["num_points"][0], f"{what} SA1")
    x = torch.from_numpy(blocks[:SEG["slide_batch"], :, :3]).to(dev)
    x = x.contiguous()
    sa = [x, pointops.gather_points(
        x, fps_onchip_cuda(x, SEG_NET["num_points"][0])).contiguous()]
    for m in SEG_NET["num_points"][1:]:
        sa.append(sa[-1][:, :m].contiguous())
    sb = [s[:SEG["b"]].contiguous() for s in sa]
    for i, (r, k) in enumerate(zip(SEG_NET["radii"], SEG_NET["num_samples"])):
        bq(sb[i], sb[i + 1], r, k, f"segmentor SA{i + 1}")
    bq(sa[0], sa[1], SEG_NET["radii"][0], SEG_NET["num_samples"][0],
       "slide_inference SA1")
    for i in range(4, 0, -1):
        nn3(sb[i - 1], sb[i], f"segmentor FP{5 - i}")
    nn3(sa[0], sa[1], "slide_inference FP4")
    del x, sa, sb

    # the VoteHead detector at B=8 x 40000
    v = torch.from_numpy(np.stack(scenes[:VOTE_B])).to(dev)
    fps(v, 2048, "VoteHead SA1")
    c = pointops.gather_points(v, fps_onchip_cuda(v, 2048)).contiguous()
    bq(v, c, 0.2, 64, "VoteHead SA1")
    seeds = c[:, :1024].contiguous()
    votes = (seeds + 0.05 * torch.randn(
        seeds.shape, generator=torch.Generator(dev).manual_seed(11),
        device=dev)).contiguous()
    fps(votes, 256, "VoteHead vote FPS")
    agg = pointops.gather_points(votes, fps_onchip_cuda(votes, 256))
    bq(votes, agg.contiguous(), 0.3, 16, "VoteHead aggregation")
    nn3(seeds, c[:, :512].contiguous(), "VoteHead FP1")
    nn3(c[:, :512].contiguous(), c[:, :256].contiguous(), "VoteHead FP2")
    return out


def seg_per_forward(b: int) -> dict:
    """The segmentor's launches a forward of ``b`` blocks: FPS once (SA1;
    SA2-SA4 take the FPS prefix), the ball query at SA1-SA4, three-NN at
    the four FPs."""
    from nesie_tpu_torch.ops.fps import fps_launch_name

    want = {"fps_onchip": 0, "fps_onchip_small": 0, "ball_query": 4,
            "three_nn": 4}
    want[fps_launch_name(b)] = 1
    return want


def repeat_counts(want: dict, n: int) -> dict:
    """Launch counts of ``n`` forwards of ``want`` each."""
    return {k: v * n for k, v in want.items()}


def segmentor_phase(dev, blocks, labels) -> dict:
    """[segmentor]: ``PointNet2Segmentor()`` (mmdet3d's pointnet2_ssg
    ScanNet widths, with the auxiliary head) on 1.5 m blocks of 8192
    points. Paths, counts set to 0 before and read after each:
    ``segmentor_train`` (forward + encoder_decoder_loss with aux and
    Lovasz + backward at B=16, a warm-up and SEG['timed'] timed),
    ``segmentor_slide`` (slide_inference over one generated room at
    batch 24), ``segmentor_request`` (three inference_segmentor
    requests); then one block's forward on the card against the CPU."""
    import torch

    from nesie_tpu_torch.apis import inference_segmentor
    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.nn.segmentor import (
        PointNet2Segmentor,
        encoder_decoder_loss,
        segmentor_apply_fn,
        slide_inference,
    )
    from nesie_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(20)
    model = PointNet2Segmentor(with_aux=True)
    init_weights_flax_(model, gen)
    randomize_bn_(model, gen)
    model = model.to(dev)
    b = SEG["b"]
    pts = torch.from_numpy(blocks[:b]).to(dev)
    lab = torch.from_numpy(labels[:b]).to(dev)
    drop = torch.Generator(dev).manual_seed(21)
    out_info = {}

    def step():
        model.zero_grad(set_to_none=True)
        out = model(pts, generator=drop)
        loss = encoder_decoder_loss(out, lab, use_lovasz=True)
        loss.backward()
        return loss

    model.train()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms, loss = timed_steps(step, SEG["timed"])
    launches = {"segmentor_train": _build.launch_counts()}
    # ----- end of the segmentor_train path
    check_counts(launches["segmentor_train"], "segmentor_train",
                 repeat_counts(seg_per_forward(b), 1 + SEG["timed"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(loss):
        raise AssertionError(f"segmentor loss {loss.item()} is not finite")
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"segmentor: gradient of {name} missing or "
                                 "not finite")
    aux_grad = model.aux_cls.weight.grad.abs().sum().item()
    if not aux_grad > 0:
        raise AssertionError("the auxiliary head received no gradient")
    out_info["train_ms"] = float(np.median(step_ms))
    print(f"[segmentor] train step (forward + encoder_decoder_loss with aux "
          f"and Lovasz + backward) B={b} x {SEG['n']} x 4: median "
          f"{out_info['train_ms']:.3f} ms over {SEG['timed']} ({step_ms}), "
          f"loss {loss.item():.4f}, peak {peak:.3f} GiB, |aux grad| "
          f"{aux_grad:.4e}; every gradient finite")

    model.eval()
    room, room_labels = seg_room(np.random.default_rng(22),
                                 SEG["room_points"])
    calls = [0]
    apply_fn = segmentor_apply_fn(model, dev)

    def counted(chunk):
        calls[0] += 1
        return apply_fn(chunk)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits = slide_inference(room, counted, SEG["n"], SEG["block"],
                             sample_rate=SEG["sample_rate"],
                             batch_size=SEG["slide_batch"])
    slide_s = time.perf_counter() - t0
    launches["segmentor_slide"] = _build.launch_counts()
    # ----- end of the segmentor_slide path
    check_counts(launches["segmentor_slide"], "segmentor_slide",
                 repeat_counts(seg_per_forward(SEG["slide_batch"]), calls[0]))
    if logits.shape != (len(room), 20) or not np.isfinite(logits).all():
        raise AssertionError(f"slide_inference: logits {logits.shape} or "
                             "not finite")
    pred = logits.argmax(-1)
    out_info["slide_ms"] = slide_s * 1e3
    print(f"[segmentor] slide_inference over {len(room)} points (block "
          f"{SEG['block']}, sample_rate {SEG['sample_rate']}, batch "
          f"{SEG['slide_batch']}): {slide_s * 1e3:.1f} ms a scene, "
          f"{calls[0]} batches of {SEG['slide_batch']}; every point covered "
          f"(slide_inference checks it); "
          f"seg_eval mIoU {seg_eval_miou(pred, room_labels):.4f} (random "
          "weights)")

    requests = [seg_room(np.random.default_rng(30 + i), 50000)[0][:, :3]
                for i in range(SEG["requests"])]
    _build.reset_launch_counts()
    req_ms = []
    for cloud in requests:
        t0 = time.perf_counter()
        res = inference_segmentor(model, cloud, num_points=SEG["n"])
        req_ms.append((time.perf_counter() - t0) * 1e3)
        if res["seg_logits"].shape != (SEG["n"], 20) or not np.isfinite(
                res["seg_logits"]).all():
            raise AssertionError("inference_segmentor: bad logits")
    launches["segmentor_request"] = _build.launch_counts()
    # ----- end of the segmentor_request path
    check_counts(launches["segmentor_request"], "segmentor_request",
                 repeat_counts(seg_per_forward(1), SEG["requests"]))
    out_info["request_ms"] = req_ms
    print(f"[segmentor] inference_segmentor requests ({SEG['n']} points): "
          f"{', '.join(f'{t:.3f}' for t in req_ms)} ms")

    cpu_model = copy.deepcopy(model).cpu()  # BN statistics as trained
    with torch.inference_mode():
        one = pts[:1]
        g_feat = model.backbone(one)
        gpu = model(one)["seg_logits"][0].cpu()
        c_feat = cpu_model.backbone(one.cpu())
        cpu = cpu_model(one.cpu())["seg_logits"][0]
    for i, (g, c) in enumerate(zip(g_feat["sa_indices"], c_feat["sa_indices"])):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"segmentor SA{i} indices differ from the CPU")
    ok = ((gpu - cpu).abs() <= ATOL + RTOL * cpu.abs()).all(dim=1)
    share, worst = ok.float().mean().item(), (gpu - cpu).abs().max().item()
    print(f"[segmentor] one block on the card vs the CPU: indices identical, "
          f"{share:.4f} of points agree within atol {ATOL} + rtol {RTOL}, "
          f"max |diff| {worst:.3e}")
    if share < MIN_AGREE:
        raise AssertionError(f"segmentor: only {share:.4f} of points agree")
    out_info.update(peak_gib=peak, gpu_cpu_share=share, gpu_cpu_worst=worst)
    print(f"[segmentor] phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, info=out_info)


def seg_eval_miou(pred, gt) -> float:
    from nesie_tpu_torch.eval.seg_metrics import seg_eval

    return seg_eval([pred], [gt], 20)["mIoU"]


def vote_per_forward() -> dict:
    """The VoteHead detector's launches a forward at B=8: FPS at SA1 and
    the seed / vote FPS, the ball query at SA1-SA4 and the aggregation,
    three-NN at FP1 and FP2."""
    return {"fps_onchip": 0, "fps_onchip_small": 2, "ball_query": 5,
            "three_nn": 2}


def votehead_phase(dev, scenes) -> dict:
    """[votehead]: ``VoteNet()`` (PointNet2SASSG + the legacy VoteHead at
    VoteNet's ScanNet widths) at B=8 x 40000, counts set to 0 before and
    read after (path ``votehead``): the eval forward in ``vote`` mode
    (a warm-up and 5 timed) and in ``seed`` mode, ``BinBoxCoder.decode``;
    ``votehead_supervised_loss`` + backward on generated GT; two forwards
    of the same batch, the second under a recorded flip / rotation /
    scale, into ``consistency_losses`` with ``decode_votenet_size``."""
    import torch

    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.synthetic import class_size_prototypes, make_scene
    from nesie_tpu_torch.losses.consistency import (
        consistency_losses,
        decode_votenet_size,
    )
    from nesie_tpu_torch.nn.detector import init_weights_, randomize_bn_
    from nesie_tpu_torch.nn.vote_head import VoteNet
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.train.targets import get_targets
    from nesie_tpu_torch.train.votehead_loss import (
        VoteHeadLossConfig,
        votehead_supervised_loss,
    )

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(40)
    model = VoteNet()
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    model = model.to(dev).eval()
    mean_sizes = class_size_prototypes(18)
    coder = model.bbox_head.coder(mean_sizes)
    pts = torch.from_numpy(np.stack([io.add_height(s) for s in
                                     scenes[:VOTE_B]]).astype(np.float32))
    pts = pts.to(dev)
    info, forwards = {}, 0

    _build.reset_launch_counts()
    with torch.inference_mode():
        ms, out = timed_steps(lambda: model(pts, "vote"), 5)
        boxes = coder.decode(out["aggregated_points"], out)
        seed_out = model(pts, "seed")
        seed_boxes = coder.decode(seed_out["aggregated_points"], seed_out)
    forwards += 7
    for what, b in (("vote", boxes), ("seed", seed_boxes)):
        if b.shape != (VOTE_B, 256, 7) or not torch.isfinite(b).all() or not (
                b[..., 3:6] >= 0.1).all():
            raise AssertionError(f"VoteHead {what}: decoded boxes")
    info["eval_ms"] = float(np.median(ms))
    print(f"[votehead] eval forward B={VOTE_B} x {N_POINTS} x 4 (vote): "
          f"median {info['eval_ms']:.3f} ms over 5 ({ms}); decode and the "
          "seed mode's boxes finite")

    rng = np.random.default_rng(41)
    gt = np.zeros((VOTE_B, SEMI["max_gt"], 7), np.float32)
    gt_labels = np.zeros((VOTE_B, SEMI["max_gt"]), np.int64)
    gt_valid = np.zeros((VOTE_B, SEMI["max_gt"]), bool)
    for i in range(VOTE_B):
        _, bx = make_scene(np.random.default_rng(i), N_POINTS,
                           with_boxes=True)
        gt[i, :len(bx)] = bx
        gt_labels[i, :len(bx)] = rng.integers(0, 18, len(bx))
        gt_valid[i, :len(bx)] = True
    model.train()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(pts, "vote")
    forwards += 1
    targets = get_targets(pts, torch.from_numpy(gt).to(dev),
                          torch.from_numpy(gt_labels).to(dev),
                          torch.from_numpy(gt_valid).to(dev),
                          out["aggregated_points"])
    total, terms = votehead_supervised_loss(out, targets, mean_sizes,
                                            VoteHeadLossConfig())
    total.backward()
    torch.cuda.synchronize()
    info["loss_ms"] = (time.perf_counter() - t0) * 1e3
    check_finite({**terms, "total": total}, model, "votehead loss")
    print(f"[votehead] forward + votehead_supervised_loss + backward "
          f"(train mode): {info['loss_ms']:.3f} ms; terms "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in terms.items()))

    # consistency: the teacher on the batch, the student on it under a
    # recorded flip / rotation / scale
    flip_x = torch.from_numpy(rng.uniform(size=VOTE_B) < 0.5).to(dev)
    flip_y = torch.from_numpy(rng.uniform(size=VOTE_B) < 0.5).to(dev)
    ang = rng.uniform(-np.pi / 6, np.pi / 6, VOTE_B)
    rot = np.zeros((VOTE_B, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1] = np.cos(ang), -np.sin(ang)
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(ang), np.cos(ang)
    rot[:, 2, 2] = 1.0
    rot = torch.from_numpy(rot).to(dev)
    scale = torch.from_numpy(rng.uniform(0.85, 1.15, (VOTE_B, 1, 3)).astype(
        np.float32)).to(dev)
    xyz = pts[..., :3].clone()
    xyz[..., 0] = torch.where(flip_x[:, None], -xyz[..., 0], xyz[..., 0])
    xyz[..., 1] = torch.where(flip_y[:, None], -xyz[..., 1], xyz[..., 1])
    xyz = torch.einsum("bpj,bij->bpi", xyz, rot) * scale
    student_pts = torch.cat([xyz, pts[..., 3:]], -1).contiguous()
    model.eval()
    with torch.no_grad():
        teacher = model(pts, "vote")
    student = model(student_pts, "vote")
    forwards += 2
    size = decode_votenet_size(student["size_class"], student["size_res"],
                               mean_sizes)
    ema_size = decode_votenet_size(teacher["size_class"], teacher["size_res"],
                                   mean_sizes)
    ctotal, cterms = consistency_losses(
        student["aggregated_points"] + student["center_offset"],
        student["sem_scores"], size,
        teacher["aggregated_points"] + teacher["center_offset"],
        teacher["sem_scores"], ema_size, flip_x, flip_y, rot, scale)
    ctotal.backward()
    launches = {"votehead": _build.launch_counts()}
    # ----- end of the votehead path
    check_counts(launches["votehead"], "votehead",
                 repeat_counts(vote_per_forward(), forwards))
    for k, v in {**cterms, "total": ctotal}.items():
        if not torch.isfinite(v):
            raise AssertionError(f"consistency {k} = {v.item()}")
    print("[votehead] consistency_losses (teacher vs flipped / rotated / "
          "scaled student, decode_votenet_size): "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in cterms.items()))
    print(f"[votehead] {forwards} forwards; phase "
          f"{time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, info=info)


def paconv_phase(dev, blocks) -> dict:
    """[paconv]: ``PAConvSAModule`` at B=16 x 8192 -> 1024 centres (r 0.1,
    K 32, PAConv layers 4 -> 32 -> 32 -> 64 with 16 kernels each,
    scorenet (16, 16, 16), ``w_neighbor`` / ``w_neighbor_dist``): the
    forward in eval and in train mode + backward; ``PointSAModuleMSG`` at
    the same centres with two scales. Counts set to 0 before and read
    after (path ``paconv``)."""
    import torch

    from nesie_tpu_torch.nn.detector import init_weights_flax_, randomize_bn_
    from nesie_tpu_torch.nn.pointnet2 import PAConvSAModule, PointSAModuleMSG
    from nesie_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(50)
    pa = PAConvSAModule(1024, 0.1, 32, (1, 32, 32, 64), (16, 16, 16))
    msg = PointSAModuleMSG(1024, (0.1, 0.2), (16, 32), 1,
                           ((16, 16, 32), (32, 32, 64)))
    for m in (pa, msg):
        init_weights_flax_(m, gen)
        randomize_bn_(m, gen)
    pa, msg = pa.to(dev), msg.to(dev)
    x = torch.from_numpy(blocks[:SEG["b"]]).to(dev)
    xyz, feats = x[..., :3].contiguous(), x[..., 3:].contiguous()
    info = {}

    def train_step():
        pa.zero_grad(set_to_none=True)
        _, out, _ = pa(xyz, feats)
        out.square().mean().backward()
        return out

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pa.eval()
    with torch.inference_mode():
        eval_ms, out = timed_steps(lambda: pa(xyz, feats)[1], 3)
    pa.train()
    train_ms, out_t = timed_steps(train_step, 3)
    msg.eval()
    with torch.inference_mode():
        msg_ms, out_m = timed_steps(lambda: msg(xyz, feats)[1], 3)
    launches = {"paconv": _build.launch_counts()}
    # ----- end of the paconv path
    check_counts(launches["paconv"], "paconv",
                 {"fps_onchip": 0, "fps_onchip_small": 12, "ball_query": 16,
                  "three_nn": 0})
    peak = torch.cuda.max_memory_allocated() / 2**30
    for what, o, c in (("eval", out, 64), ("train", out_t, 64),
                       ("MSG", out_m, 96)):
        if o.shape != (SEG["b"], 1024, c) or not torch.isfinite(o).all():
            raise AssertionError(f"PAConv {what}: {tuple(o.shape)} or not "
                                 "finite")
    for name, p in pa.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"PAConv: gradient of {name}")
    info.update(eval_ms=float(np.median(eval_ms)),
                train_ms=float(np.median(train_ms)),
                msg_ms=float(np.median(msg_ms)), peak_gib=peak)
    print(f"[paconv] PAConvSAModule B={SEG['b']} x {SEG['n']} -> 1024: eval "
          f"{info['eval_ms']:.3f} ms, train forward + backward "
          f"{info['train_ms']:.3f} ms (medians of 3), peak {peak:.3f} GiB; "
          f"PointSAModuleMSG (2 scales) eval {info['msg_ms']:.3f} ms; "
          f"phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=launches, info=info)


def tta_phase(dev, weights) -> dict:
    """[tta]: the flagship ``Detector`` over ``make_tta_views(flip=True)``
    (4 views of one 40000-point scene) merged by ``merge_aug_bboxes_3d``,
    counts set to 0 before and read after (path ``tta``: 4 x a request's
    launches), beside one plain request."""
    import torch

    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.data.synthetic import make_scene
    from nesie_tpu_torch.eval.tta import apply_view_np, make_tta_views, merge_aug_bboxes_3d
    from nesie_tpu_torch.ops import _build

    detector = init_detector(weights, device=dev)
    cloud = make_scene(np.random.default_rng(60), N_POINTS)
    detector(cloud)  # warm-up
    t0 = time.perf_counter()
    plain = detector(cloud)
    plain_ms = (time.perf_counter() - t0) * 1e3
    views = make_tta_views(flip=True)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = []
    for view in views:
        r = detector(apply_view_np(cloud, *view))
        results.append(dict(boxes=r["boxes_3d"], scores=r["scores_3d"],
                            labels=r["labels_3d"]))
    views_ms = (time.perf_counter() - t0) * 1e3
    merged = merge_aug_bboxes_3d(results, views)
    tta_ms = (time.perf_counter() - t0) * 1e3
    launches = {"tta": _build.launch_counts()}
    # ----- end of the tta path
    check_counts(launches["tta"], "tta",
                 {"fps_onchip": 0, "fps_onchip_small": len(views),
                  "ball_query": SAQE_BQ_PER_FORWARD * len(views),
                  "three_nn": 4 * len(views)})
    if not (np.isfinite(merged["boxes"]).all()
            and np.isfinite(merged["scores"]).all()):
        raise AssertionError("TTA: non-finite merged boxes")
    print(f"[tta] {len(views)} views: {views_ms:.3f} ms of requests, "
          f"{tta_ms:.3f} ms with merge_aug_bboxes_3d "
          f"({sum(len(r['boxes']) for r in results)} boxes in, "
          f"{len(merged['boxes'])} merged) against one plain request "
          f"{plain_ms:.3f} ms ({len(plain['boxes_3d'])} boxes)")
    return dict(launches=launches, info=dict(tta_ms=tta_ms,
                                             views_ms=views_ms,
                                             plain_ms=plain_ms))


def tail_phase(dev, scenes, weights) -> dict:
    """The point tail's kernels and its four phases. Returns the launches
    by path, the kernel entries by shape and the phases' numbers."""
    import torch

    t0 = time.perf_counter()
    blocks, labels = seg_blocks(np.random.default_rng(70), SEG["slide_batch"])
    print(f"[tail] {len(blocks)} blocks generated: "
          f"{time.perf_counter() - t0:.2f} s")
    kernels = tail_kernels(dev, blocks, scenes)
    torch.cuda.empty_cache()
    launches, info = {}, {}
    for name, run in (("segmentor", lambda: segmentor_phase(dev, blocks,
                                                            labels)),
                      ("votehead", lambda: votehead_phase(dev, scenes)),
                      ("paconv", lambda: paconv_phase(dev, blocks)),
                      ("tta", lambda: tta_phase(dev, weights))):
        res = run()
        launches.update(res["launches"])
        info[name] = res["info"]
        torch.cuda.empty_cache()
    print(f"[tail] launches by path: {launches}")
    return dict(launches=launches, kernels=kernels, info=info)


def _instance_ids(xyz, boxes) -> np.ndarray:
    """Per point the 1-based index of the first (yaw-free,
    bottom-centered) box whose surface holds it within 0.1 mm (the
    generated objects are box surfaces), 0 for none (the floor)."""
    half = boxes[:, 3:6] / 2
    local = np.abs(xyz[:, None] - (boxes[:, :3] + [0.0, 0.0, 1.0] * half))
    on = ((local <= half + 1e-4).all(-1)
          & (np.abs(local - half) <= 1e-4).any(-1))
    return np.where(on.any(1), on.argmax(1) + 1, 0)


def write_raw_scannet(root, scenes, splits=None) -> Path:
    """A raw ScanNet tree from generated scenes (``make_synthetic_scenes``;
    numpy only): ``<root>/scans/<id>/`` with ``<id>_vh_clean_2.ply``
    (binary vertices: unaligned xyz and seeded colours),
    ``<id>_vh_clean_2.0.010000.segs.json`` (segment 0 the floor, one a
    box), ``<id>.aggregation.json`` (one instance a box labelled with its
    class name, and the floor as ``floor``) and ``<id>.txt`` (an
    ``axisAlignment`` of its own: a yaw and a shift that take the vertices
    back to the scene's frame); ``<root>/scannetv2-labels.combined.tsv``
    (class name -> nyu40 id, ``floor`` -> 2, not a detection class); and
    for each ``splits`` entry (name -> scene ids)
    ``<root>/meta/scannetv2_<name>.txt``. Returns ``<root>/scans``."""
    from nesie_tpu_torch.data.scannet_meta import CLASS_NAMES, VALID_CAT_IDS

    root = Path(root)
    scans = root / "scans"
    rng = np.random.default_rng(17)
    vertex = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for scene in scenes:
        sid, d = scene.scene_id, scans / scene.scene_id
        d.mkdir(parents=True, exist_ok=True)
        yaw, shift = rng.uniform(-np.pi, np.pi), rng.uniform(-3, 3, 3)
        c, s = np.cos(yaw), np.sin(yaw)
        aam = np.eye(4)
        aam[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        aam[:3, 3] = shift
        xyz = scene.points[:, :3].astype(np.float64)
        v = np.empty(len(xyz), vertex)
        raw = (xyz - shift) @ aam[:3, :3]  # the inverse alignment
        v["x"], v["y"], v["z"] = raw.T
        for ch in ("red", "green", "blue"):
            v[ch] = rng.integers(0, 256, len(xyz))
        with open(d / f"{sid}_vh_clean_2.ply", "wb") as f:
            f.write((f"ply\nformat binary_little_endian 1.0\ncomment "
                     f"generated\nelement vertex {len(v)}\n"
                     "property float x\nproperty float y\nproperty float z\n"
                     "property uchar red\nproperty uchar green\n"
                     "property uchar blue\nend_header\n").encode("ascii"))
            f.write(v.tobytes())
        seg = _instance_ids(xyz, scene.boxes)
        (d / f"{sid}_vh_clean_2.0.010000.segs.json").write_text(json.dumps(
            {"sceneId": sid, "segIndices": seg.tolist()}))
        groups = [{"id": 0, "objectId": 0, "segments": [0], "label": "floor"}]
        groups += [{"id": j, "objectId": j, "segments": [j],
                    "label": CLASS_NAMES[int(lab)]}
                   for j, lab in enumerate(scene.labels, start=1)]
        (d / f"{sid}.aggregation.json").write_text(json.dumps(
            {"sceneId": sid, "segGroups": groups}))
        (d / f"{sid}.txt").write_text(
            "axisAlignment = " + " ".join(f"{x:.9f}" for x in aam.ravel())
            + "\nsceneType = generated\n")
    rows = ["raw_category\tcategory\tnyu40id", "floor\tfloor\t2"]
    rows += [f"{n}\t{n}\t{cid}" for n, cid in zip(CLASS_NAMES, VALID_CAT_IDS)]
    (root / "scannetv2-labels.combined.tsv").write_text("\n".join(rows) + "\n")
    for name, ids in (splits or {}).items():
        (root / "meta").mkdir(exist_ok=True)
        (root / "meta" / f"scannetv2_{name}.txt").write_text(
            "\n".join(ids) + "\n")
    return scans


def write_raw_sunrgbd(root, scenes, splits=None) -> Path:
    """A raw SUN RGB-D ``sunrgbd_trainval`` tree from generated scenes
    (numpy only): for sample ``i`` (id ``i + 1``, six digits)
    ``depth/<id>.npy`` (the extracted xyz cloud), ``calib/<id>.txt``
    (Rtilt and K, column-major) and ``label/<id>.txt`` (VoteNet format: a
    SUN RGB-D class name, a 2D box, the gravity center, half sizes and the
    heading's direction); for each ``splits`` entry (name -> sample
    indices) ``<name>_data_idx.txt``. Returns ``root``."""
    from nesie_tpu_torch.data.scannet_meta import SUNRGBD_CLASS_NAMES

    root = Path(root)
    for sub in ("depth", "calib", "label"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    k = np.array([[529.5, 0.0, 365.0], [0.0, 529.5, 265.0], [0.0, 0.0, 1.0]])
    for i, scene in enumerate(scenes):
        sid = f"{i + 1:06d}"
        np.save(root / "depth" / f"{sid}.npy",
                scene.points[:, :3].astype(np.float32))
        (root / "calib" / f"{sid}.txt").write_text(
            " ".join(f"{x:.9f}" for x in np.eye(3).ravel(order="F")) + "\n"
            + " ".join(f"{x:.6f}" for x in k.ravel(order="F")) + "\n")
        lines = []
        for box, lab in zip(scene.boxes, scene.labels):
            cx, cy, cz = box[0], box[1], box[2] + box[5] / 2
            lines.append(
                f"{SUNRGBD_CLASS_NAMES[int(lab) % 10]} 0 0 10 10 {cx:.6f} "
                f"{cy:.6f} {cz:.6f} {box[3] / 2:.6f} {box[4] / 2:.6f} "
                f"{box[5] / 2:.6f} {np.cos(-box[6]):.6f} "
                f"{np.sin(-box[6]):.6f}")
        (root / "label" / f"{sid}.txt").write_text("\n".join(lines) + "\n")
    for name, idx in (splits or {}).items():
        (root / f"{name}_data_idx.txt").write_text(
            "\n".join(str(i + 1) for i in idx) + "\n")
    return root


def migrate_model():
    """The flagship at full width, as ``init_detector``'s keyword form
    builds it."""
    from nesie_tpu_torch.nn.detector import VoteNetNesie

    return VoteNetNesie()


def reference_pth(path: Path) -> dict:
    """A reference-layout ``.pth`` of the flagship: seeded weights with
    randomised BN, 1x1 convolution weights with their unit dim restored
    (``(out, in, 1)``), ``ema_*`` buffers of every parameter from a second
    seed, ``meta`` and ``optimizer``. Returns the student's and the EMA
    model's state_dicts."""
    import torch

    from nesie_tpu_torch.nn.detector import init_weights_, randomize_bn_

    gen = torch.Generator().manual_seed(0)
    student, ema = migrate_model(), migrate_model()
    init_weights_(student, gen)
    randomize_bn_(student, gen)
    init_weights_(ema, torch.Generator().manual_seed(1))

    def conv(v):
        return v[..., None] if v.dim() == 2 else v

    sd = {k: conv(v) for k, v in student.state_dict().items()}
    sd.update({f"ema_{k.replace('.', '_')}": conv(v.detach())
               for k, v in ema.named_parameters()})
    torch.save({"meta": {"epoch": 36, "iter": 36 * 100},
                "state_dict": sd,
                "optimizer": {"state": {}, "param_groups": []}}, path)
    return student.state_dict(), ema.state_dict()


def per_forward(train: int = 0, eval_small: int = 0, eval_large: int = 0
                ) -> dict:
    """Launches of ``train`` training forwards and ``eval_small`` /
    ``eval_large`` eval forwards at B <= 16 / B > 16."""
    return {
        "fps_onchip_small": TRAIN_FORWARD["fps"] * train
        + EVAL_FORWARD["fps"] * eval_small,
        "fps_onchip": EVAL_FORWARD["fps"] * eval_large,
        "ball_query": TRAIN_FORWARD["ball_query"] * train
        + EVAL_FORWARD["ball_query"] * (eval_small + eval_large),
        "three_nn": TRAIN_FORWARD["three_nn"] * train
        + EVAL_FORWARD["three_nn"] * (eval_small + eval_large),
    }


def knn_agree(got, want, src, qry, rel: float = 1e-5) -> int:
    """``knn`` indices of two devices: equal except where the two
    candidates' distances (float64) are within ``rel``, and the sorted k
    distances within ``rel``. Returns the number of differing indices."""
    import torch

    def dist(idx):
        s = src.double()[torch.arange(src.shape[0])[:, None, None],
                         idx.long()]
        return ((s - qry.double()[:, :, None]) ** 2).sum(-1)

    dg, dw = dist(got), dist(want)
    differ = got != want
    scale = dw.abs().clamp(min=1e-12)
    if ((dg - dw).abs() > rel * scale)[differ].any() or not torch.allclose(
            dg.sort(-1).values, dw.sort(-1).values, rtol=rel, atol=0):
        raise AssertionError("knn: the card and the CPU rank differently")
    return int(differ.sum())


def migrate_phase(dev) -> dict:
    """[migrate]: a port user's way from raw data and a reference
    checkpoint to detections on the card, with no jax (path ``migrate``,
    counts set to 0 before and read after, each kernel's launches
    predicted from the forwards the path runs). Then the point-op
    helpers against their plain versions and the CPU, and their times.
    Returns the launch counts and the numbers printed."""
    import contextlib as ctx
    import io as stdio
    import shutil

    import torch

    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.config import get_config
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.dataset import PresampledScanNetScenes
    from nesie_tpu_torch.data.synthetic import make_scene, make_synthetic_scenes
    from nesie_tpu_torch.eval.visualize import Visualizer
    from nesie_tpu_torch.ops import _build, pointops
    from nesie_tpu_torch.ops.fps import fps_ref
    from nesie_tpu_torch.tools import create_data, demo, dump_eval_set
    from nesie_tpu_torch.tools import import_torch_ckpt
    from nesie_tpu_torch.tools import test as test_cli
    from nesie_tpu_torch.tools import train as train_cli
    from nesie_tpu_torch.train import runner

    t_phase = time.perf_counter()
    m = MIGRATE
    base = ROOT / "build" / "migrate_smoke"
    shutil.rmtree(base, ignore_errors=True)
    size = dict(floor_points=m["floor_points"],
                points_per_object=m["points_per_object"])
    rooms = make_synthetic_scenes(m["scenes"], seed=m["seed"], **size)
    ids = [s.scene_id for s in rooms]
    train_ids, val_ids = ids[:m["train"]], ids[m["train"]:]
    scans = write_raw_scannet(base / "raw_scannet", rooms,
                              {"train": train_ids, "val": val_ids})
    n_sun = m["sun_samples"]
    sun_rooms = make_synthetic_scenes(n_sun, seed=m["seed"] + 1,
                                      num_classes=10, yaw_range=np.pi, **size)
    sun_raw = write_raw_sunrgbd(base / "raw_sunrgbd", sun_rooms, {
        "train": range(n_sun), "val": range(n_sun // 2, n_sun)})
    print(f"[migrate] raw trees: {len(rooms)} ScanNet scans of "
          f"{min(len(s.points) for s in rooms)}-"
          f"{max(len(s.points) for s in rooms)} vertices, {n_sun} SUN RGB-D "
          "samples with .npy depth")
    scannet, sun, work = base / "scannet", base / "sunrgbd", base / "work"
    pth = base / "reference.pth"
    student_sd, ema_sd = reference_pth(pth)
    gen = np.random.default_rng(m["seed"])
    dfps_in = [torch.from_numpy(np.stack([
        make_scene(gen, n) for _ in range(b)])).to(dev)
        for b, n, _ in MIGRATE_DFPS]
    f = MIGRATE_FFPS
    ffps_xyz = torch.from_numpy(np.stack([make_scene(gen, f["n"])
                                          for _ in range(f["b"])])).to(dev)
    ffps_feat = torch.from_numpy(gen.uniform(
        size=(f["b"], f["n"], f["d"])).astype(np.float32)).to(dev)
    k = MIGRATE_KNN
    knn_src = torch.from_numpy(np.stack([make_scene(gen, k["n"])
                                         for _ in range(k["b"])])).to(dev)
    knn_q = (knn_src[:, :k["m"]] + 0.05 * torch.randn(
        (k["b"], k["m"], 3), generator=torch.Generator(dev).manual_seed(5),
        device=dev)).contiguous()

    _build.reset_launch_counts()
    # ----- the migration path: prepare, train, import, evaluate, serve
    t0 = time.perf_counter()
    create_data.main(["scannet", "--raw-dir", str(scans), "--splits-dir",
                      str(scans.parent / "meta"), "--out-dir", str(scannet)])
    scannet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    create_data.main(["sunrgbd", "--raw-dir", str(sun_raw), "--out-dir",
                      str(sun)])
    sun_s = time.perf_counter() - t0
    (scannet / "meta_data").mkdir()
    (scannet / "meta_data" / "scannetv2_train_0.5.txt").write_text(
        "\n".join(train_ids) + "\n")
    (sun / "sunrgbd_trainval").mkdir()
    (sun / "sunrgbd_trainval" / "sunrgbd_v1_train_0.5.txt").write_text(
        "\n".join(f"{i + 1:06d}" for i in range(n_sun)) + "\n")

    common = ["--work-dir", str(work), "--device", str(dev)]
    train_cli.main([m["pretrain"], "--data-root", str(scannet), *common,
                    "--cfg-options", *MIGRATE_OVER,
                    f"data.repeat={m['repeat']}"])
    train_cli.main([m["sun_pretrain"], "--data-root", str(sun), *common,
                    "--cfg-options", *MIGRATE_OVER,
                    f"data.repeat={m['sun_repeat']}"])

    t0 = time.perf_counter()
    ckpt_dir = import_torch_ckpt.main([
        m["pretrain"], str(pth), "--work-dir", str(base / "imported"),
        "--device", str(dev), "--cfg-options", *MIGRATE_OVER])
    import_s = time.perf_counter() - t0
    presampled = dump_eval_set.main([
        "--data-root", str(scannet), "--out", str(base / "presampled"),
        "--num-points", str(m["eval_points"])])
    test_args = [m["pretrain"], str(ckpt_dir), "--data-root", str(scannet),
                 "--device", str(dev), "--batch-size", str(m["eval_batch"]),
                 "--presampled", str(presampled), "--cfg-options",
                 *MIGRATE_OVER]
    t0 = time.perf_counter()
    metrics = {"student": test_cli.main(
        test_args + ["--dump-raw", str(base / "raw_out")])}
    test_s = time.perf_counter() - t0
    metrics["teacher"] = test_cli.main(test_args + ["--teacher"])
    detector = init_detector(pth, device=dev)
    val = PresampledScanNetScenes(presampled)
    with torch.inference_mode():
        direct = [{key: v[0].float().cpu().numpy() for key, v in
                   detector.model(torch.from_numpy(s.points)[None].to(dev),
                                  "seed", with_jitter=False).items()}
                  for s in val.scenes]

    cloud = scannet / "points" / f"{val_ids[0]}.bin"
    shown = stdio.StringIO()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(shown):
        served = demo.main([m["pretrain"], str(cloud), "--checkpoint",
                            str(ckpt_dir), "--out-dir", str(base / "demo"),
                            "--score-thr", "0.0", "--device", str(dev)])
    demo_s = time.perf_counter() - t0

    b32, b8 = (pointops.points_sampler(x, None, mm, "D-FPS")
               for x, (_, _, mm) in zip(dfps_in, MIGRATE_DFPS))
    ffps = pointops.points_sampler(ffps_xyz, ffps_feat, f["m"], "F-FPS")
    fs = pointops.points_sampler(ffps_xyz, ffps_feat, f["m"], "FS")
    knn_idx = pointops.knn(k["k"], knn_src, knn_q)
    torch.cuda.synchronize()
    launches = {"migrate": _build.launch_counts()}
    # ----- end of the migration path
    print(f"[migrate] launches during the migration path: "
          f"{launches['migrate']}")
    steps_want = [n * r // get_config(name).data.samples_per_step
                  for n, r, name in ((m["train"], m["repeat"], m["pretrain"]),
                                     (n_sun, m["sun_repeat"],
                                      m["sun_pretrain"]))]
    want = per_forward(train=sum(steps_want),
                       eval_small=len(val.scenes) + 1, eval_large=2)
    want["fps_onchip"] += 1  # points_sampler's D-FPS at 32 rows (K1)
    want["fps_onchip_small"] += 2  # D-FPS at 8 rows and FS's, 16 (K2)
    check_counts(launches["migrate"], "migrate", want)

    # the prepared data
    for root, kind, n_train, n_val in ((scannet, "scannet", m["train"],
                                        len(val_ids)),
                                       (sun, "sunrgbd", n_sun, n_sun // 2)):
        for split, n in (("train", n_train), ("val", n_val)):
            infos = io.load_infos(root / f"{kind}_infos_{split}.pkl")
            if len(infos) != n:
                raise AssertionError(f"{kind} {split}: {len(infos)} infos")
            for info in infos:
                ann = info["annos"]
                nb, cols = ann["gt_boxes_upright_depth"].shape
                size_b = (root / info["pts_path"]).stat().st_size
                if not (nb == ann["gt_num"] == len(ann["class"]) > 0
                        and cols == (6 if kind == "scannet" else 7)
                        and size_b == 50000 * 6 * 4):
                    raise AssertionError(
                        f"{kind} {info['pts_path']}: boxes {nb} x {cols}, "
                        f"{len(ann['class'])} labels, {size_b} bytes")
    for name in (m["pretrain"], m["sun_pretrain"]):
        rows = metric_rows(work / name)
        check_rows(rows, name)
    steps = [len(metric_rows(work / name))
             for name in (m["pretrain"], m["sun_pretrain"])]
    if steps != steps_want:
        raise AssertionError(f"train CLI steps {steps} (want {steps_want})")
    # the import: the student is the .pth's, the teacher its ema_* buffers
    # with the student's BN statistics
    ckpt = runner.CheckpointManager(ckpt_dir.parent).load()
    params = {name for name, _ in migrate_model().named_parameters()}
    for key, v in student_sd.items():
        teacher = ema_sd[key] if key in params else v
        if not (torch.equal(ckpt["model"][key], v)
                and torch.equal(ckpt["teacher"][key], teacher)):
            raise AssertionError(f"import: {key} differs from the .pth")
    for who, res in metrics.items():
        for key in ("mAP_0.25", "mAR_0.25"):
            if not 0.0 <= res.get(key, -1.0) <= 1.0:
                raise AssertionError(f"presampled {who} {key} = {res.get(key)}")
    worst = 0.0
    for s, d in zip(val.scenes, direct):
        raw = np.load(base / "raw_out" / f"{s.scene_id}.npz")
        for key in ("bbox_preds", "obj_scores", "sem_scores", "iou_scores"):
            if raw[key].shape != d[key].shape:
                raise AssertionError(f"{s.scene_id} {key}: shapes differ")
            worst = max(worst, float(np.abs(raw[key] - d[key]).max()))
    if not worst <= MIGRATE_ATOL:
        raise AssertionError(f"test CLI vs init_detector(.pth): max |diff| "
                             f"{worst:.3e} > {MIGRATE_ATOL}")
    lines = shown.getvalue().splitlines()
    stem = cloud.stem
    objs = [base / "demo" / stem / f"{stem}_{part}.obj"
            for part in ("points", "pred")]
    n_det = int(lines[0].split()[0])
    if not (n_det == len(served["boxes_3d"]) > 0
            and all(p.stat().st_size > 0 for p in objs)):
        raise AssertionError(f"demo: {lines[:1]}, {[str(p) for p in objs]}")
    top = np.argsort(-served["scores_3d"])[:8]
    boxes = served["boxes_3d"][top].copy()
    boxes[:, 2] -= boxes[:, 5] / 2  # Visualizer takes bottom centers
    t0 = time.perf_counter()
    image = Visualizer(io.load_points_bin(cloud), bbox3d=boxes).render()
    render_s = time.perf_counter() - t0
    if image.shape != (600, 800, 3) or image.dtype != np.uint8:
        raise AssertionError(f"render: {image.shape} {image.dtype}")

    # the point-op helpers: D-FPS against fps_ref on the card, F-FPS, FS
    # and knn against the CPU
    for (b, n, mm), x, got in zip(MIGRATE_DFPS, dfps_in, (b32, b8)):
        if not torch.equal(got, fps_ref(x, mm)):
            raise AssertionError(f"points_sampler D-FPS {b} x {n}: differs "
                                 "from fps_ref")
    x_cpu, f_cpu = ffps_xyz.cpu(), ffps_feat.cpu()
    for mode, got in (("F-FPS", ffps), ("FS", fs)):
        if not torch.equal(got.cpu(), pointops.points_sampler(
                x_cpu, f_cpu, f["m"], mode)):
            raise AssertionError(f"points_sampler {mode}: card and CPU differ")
    knn_differ = knn_agree(knn_idx.cpu(), pointops.knn(
        k["k"], knn_src.cpu(), knn_q.cpu()), knn_src.cpu(), knn_q.cpu())
    times = {}
    for (b, n, mm), x in zip(MIGRATE_DFPS, dfps_in):
        times[f"D-FPS {b} x {n} -> {mm}"] = time_ms(
            lambda: pointops.points_sampler(x, None, mm, "D-FPS"), 5)
    tag = f"{f['b']} x {f['n']} x (3 + {f['d']}) -> {f['m']}"
    for mode in ("F-FPS", "FS"):
        times[f"{mode} {tag}"] = time_ms(lambda: pointops.points_sampler(
            ffps_xyz, ffps_feat, f["m"], mode), 5)
    times[f"knn k={k['k']} {k['b']} x {k['m']} over {k['n']}"] = time_ms(
        lambda: pointops.knn(k["k"], knn_src, knn_q), 3)
    request_ms = []
    served_det = init_detector(m["pretrain"], ckpt_dir, device=dev,
                               cfg_options=MIGRATE_OVER)
    for _ in range(m["requests"]):
        t0 = time.perf_counter()
        served_det(cloud)  # ends in a host copy: synchronised
        request_ms.append((time.perf_counter() - t0) * 1e3)
    del detector, served_det, dfps_in, ffps_xyz, knn_src, knn_q

    out = dict(
        create_data_s_a_scene=scannet_s / len(rooms),
        sunrgbd_s_a_sample=sun_s / n_sun, import_s=import_s,
        test_scenes_per_s=len(val.scenes) / test_s,
        demo_s=demo_s, request_ms=request_ms, times=times,
        phase_s=time.perf_counter() - t_phase)
    print(f"[migrate] create_data scannet: {scannet_s:.3f} s for "
          f"{len(rooms)} scans ({out['create_data_s_a_scene']:.4f} s a "
          f"scan); sunrgbd: {sun_s:.3f} s for {n_sun} samples; train CLI "
          f"steps {steps}; losses "
          f"{[round(r['loss'], 4) for r in metric_rows(work / m['pretrain'])]}"
          f" (ScanNet), {[round(r['loss'], 4) for r in metric_rows(work / m['sun_pretrain'])]}"
          " (SUN RGB-D)")
    print(f"[migrate] import_torch_ckpt: {import_s:.3f} s, student and "
          f"teacher (ema_* buffers, the student's BN statistics) exactly the "
          f".pth's; test CLI --presampled ({len(val.scenes)} scenes x "
          f"{m['eval_points']}, batch {m['eval_batch']}): {test_s:.3f} s, "
          f"{out['test_scenes_per_s']:.3f} scenes/s, student mAP_0.25 "
          f"{metrics['student']['mAP_0.25']:.4f}, teacher "
          f"{metrics['teacher']['mAP_0.25']:.4f}; raw outputs against "
          f"init_detector(.pth) on the same clouds: max |diff| {worst:.3e} "
          f"(atol {MIGRATE_ATOL})")
    print(f"[migrate] demo: {demo_s:.3f} s (model, weights, one request, "
          f"the .obj files), {n_det} detections above 0.0; Visualizer."
          f"render {render_s:.3f} s -> {image.shape}; requests from the "
          f"imported checkpoint (ms): {[round(t, 3) for t in request_ms]}")
    print(f"[migrate] point-op helpers (ms): "
          f"{ {key: round(v, 4) for key, v in times.items()} }; D-FPS "
          f"identical to fps_ref, F-FPS and FS identical to the CPU, knn "
          f"{knn_differ} indices differing from the CPU within the tie rule")
    print(f"[migrate] phase: {out['phase_s']:.2f} s")
    return dict(launches=launches, **out)


def roi_off_faces(rois, pts, out_size, margin: float):
    """Mask of the points farther than ``margin`` (m, in float64) from
    every face of the voxel grid of every roi they lie in or near, in
    ``roiaware_pool3d``'s frame: the outer faces in x, y and z and the
    planes between the voxels. A nearer point can change voxel where
    ``cos`` / ``sin`` differ by an ulp between two devices or packages."""
    r, p = np.asarray(rois, np.float64), np.asarray(pts, np.float64)
    s = p[None, :, :3] - r[:, None, :3]
    rot = r[:, 6:7] + np.pi / 2
    # offsets from the grid's low corner along its x (length), y (width)
    # and z (height) axes, (rois, points) each
    u = (s[..., 0] * np.cos(rot) - s[..., 1] * np.sin(rot) + r[:, 4:5] / 2,
         s[..., 0] * np.sin(rot) + s[..., 1] * np.cos(rot) + r[:, 3:4] / 2,
         s[..., 2])
    ext = (r[:, 4:5], r[:, 3:4], r[:, 5:6])
    around = np.ones(u[0].shape, bool)
    for ui, ei in zip(u, ext):
        around &= (ui > -margin) & (ui < ei + margin)
    near = np.zeros(u[0].shape, bool)
    for ui, ei, n in zip(u, ext, out_size):
        cell = ei / n
        near |= np.abs(ui - np.round(ui / cell) * cell) < margin
    return ~(around & near).any(0)


def lidar_scene(rng, n: int, n_objects: int):
    """A seeded LiDAR-like scene in KITTI's frame: (n, 4) float32 points
    (x, y, z, intensity) and the objects' bottom-centred boxes (K, 7),
    (x, y, z, w, l, h, yaw) with KITTI's car size. Ground returns over the
    front half-plane thin out with range (uniform in log r, as a spinning
    LiDAR's rings do); 20% of the points lie in the objects, 3% outside
    the range."""
    ground = -1.73  # KITTI's sensor height
    centers = []
    while len(centers) < n_objects:  # objects at least 6 m apart
        c = rng.uniform([5.0, -35.0], [65.0, 35.0])
        if all(np.hypot(*(c - o)) >= 6.0 for o in centers):
            centers.append(c)
    centers = np.array(centers)
    dims = np.array([1.6, 3.9, 1.56]) * rng.uniform(0.9, 1.1, (n_objects, 3))
    yaw = rng.uniform(-np.pi, np.pi, n_objects)
    boxes = np.concatenate([centers, np.full((n_objects, 1), ground), dims,
                            yaw[:, None]], 1)
    n_obj, n_out = n // 5, 3 * n // 100
    n_ground = n - n_obj - n_out
    r = np.exp(rng.uniform(np.log(2.0), np.log(80.0), n_ground))
    th = rng.uniform(-np.pi / 2, np.pi / 2, n_ground)
    grd = np.stack([r * np.cos(th), r * np.sin(th),
                    ground + rng.normal(0.0, 0.03, n_ground)], 1)
    k = rng.integers(0, n_objects, n_obj)
    loc = rng.uniform(-0.5, 0.5, (n_obj, 3)) * dims[k]
    c, s = np.cos(yaw[k]), np.sin(yaw[k])
    obj = np.stack([centers[k, 0] + c * loc[:, 0] - s * loc[:, 1],
                    centers[k, 1] + s * loc[:, 0] + c * loc[:, 1],
                    ground + dims[k, 2] / 2 + loc[:, 2]], 1)
    out = rng.uniform([-20.0, -60.0, -5.0], [0.0, 60.0, 3.0], (n_out, 3))
    xyz = np.concatenate([grd, obj, out])
    pts = np.concatenate([xyz, rng.uniform(0, 1, (n, 1))], 1)
    return (pts[rng.permutation(n)].astype(np.float32),
            boxes.astype(np.float32))


def detection_clusters(rng, objects, n: int, n_classes: int):
    """``n`` detections in clusters around ``objects`` (bottom boxes at
    least 6 m apart): centres within 0.15 m, sizes within 5%, yaw within
    0.05, so two boxes of one cluster overlap far above a 0.01 IoU and two
    of different clusters not at all. Gravity-centred (n, 7) boxes and
    (n, n_classes + 1) scores, the background last."""
    k = rng.integers(0, len(objects), n)
    b = objects[k].astype(np.float64)
    b[:, :2] += rng.uniform(-0.15, 0.15, (n, 2))
    b[:, 3:6] *= rng.uniform(0.95, 1.05, (n, 3))
    b[:, 6] += rng.uniform(-0.05, 0.05, n)
    b[:, 2] += b[:, 5] / 2
    return (b.astype(np.float32),
            rng.uniform(size=(n, n_classes + 1)).astype(np.float32))


def median_ms(fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls after one warm-up,
    each call between its own CUDA events; ``setup()``, run before each
    call outside the events, gives ``fn``'s argument."""
    import torch

    setup = setup or (lambda: None)
    fn(setup())
    times = []
    for _ in range(reps):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def held(name, got, want, kind: str = "forward") -> float:
    """Card vs CPU: integer (and bool) tensors identical, float ones within
    ``VOXEL_TOL[kind]`` times the CPU's largest magnitude (at least 1).
    Returns the float error over that scale."""
    import torch

    got = got.detach().cpu()
    want = want.detach()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"[voxel] {name}: {got.shape} {got.dtype} on "
                             f"the card, {want.shape} {want.dtype} on the CPU")
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"[voxel] {name}: card and CPU differ")
        return 0.0
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = float((got - want).abs().max()) / scale if want.numel() else 0.0
    if not err <= VOXEL_TOL[kind]:
        raise AssertionError(f"[voxel] {name}: card vs CPU {err:.3e} of "
                             f"{scale:.3g} > {VOXEL_TOL[kind]}")
    return err


def device_profile(fn, runs: int = 2) -> dict:
    """``runs`` calls of ``fn`` under ``torch.profiler`` after one
    warm-up: wall ms a call, device busy ms (the union of the device
    events' intervals), idle share and device ms by kernel group
    (``profile_train_step.GROUPS``)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nesie_tpu_torch.tools.profile_train_step import (
        GROUPS,
        kernel_times,
        timeline,
    )

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / runs
    groups: dict = {}
    for name, us in kernel_times(prof).items():
        label = next((g for g, pat in GROUPS if re.search(pat, name)),
                     "other")
        groups[label] = groups.get(label, 0.0) + us / 1e3 / runs
    busy = timeline(prof)["busy_ms"] / runs
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                groups=dict(sorted(groups.items(), key=lambda kv: -kv[1])))


def voxel_phase(dev, prepared: Path) -> dict:
    """[voxel]: the voxel and outdoor stack on the card at public configs'
    shapes, every step again on the CPU from the same seeded inputs (see
    ``VOXEL``); counts set to 0 before and read after (path ``voxel``:
    the stack launches no kernel of the port). ``prepared``: a ScanNet
    tree written by ``create_data`` ([migrate]'s), for the GT-paste
    database. Prints each step's median ms of ``VOXEL["timed"]`` calls
    after a warm-up and its peak GiB."""
    import torch

    from nesie_tpu_torch.core import coders
    from nesie_tpu_torch.core import multiclass_nms as mnms
    from nesie_tpu_torch.core import pcdet_nms
    from nesie_tpu_torch.core.anchors import Anchor3DRangeGenerator
    from nesie_tpu_torch.core.coders import (
        centerpoint_decode,
        delta_xyzwhlr_decode,
        delta_xyzwhlr_encode,
    )
    from nesie_tpu_torch.core.gaussian import (
        draw_heatmap_gaussian,
        gaussian_radius,
    )
    from nesie_tpu_torch.core.np_box_ops import (
        box_collision_test,
        center_to_corner_box2d,
        points_in_rbbox,
    )
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.dbsampler import DataBaseSampler
    from nesie_tpu_torch.data.outdoor_transforms import object_sample
    from nesie_tpu_torch.data.scannet_meta import CLASS_NAMES
    from nesie_tpu_torch.data.voxel_generator import VoxelGenerator
    from nesie_tpu_torch.nn.sparse_block import SparseBasicBlock, SparseConv3d
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.ops.roiaware_pool import roiaware_pool3d
    from nesie_tpu_torch.ops.spconv import (
        SparseTensor,
        sparse_conv_transpose3d,
        sparse_inverse_conv3d,
        sparse_maxpool3d,
    )
    from nesie_tpu_torch.ops.voxel import dynamic_scatter, voxelize
    from nesie_tpu_torch.tools import create_data

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    v, reps = VOXEL, VOXEL["timed"]
    rng = np.random.default_rng(v["seed"])
    cloud_np, objects = lidar_scene(rng, v["points"], v["objects"])
    cloud = torch.from_numpy(cloud_np)
    steps, identical = {}, {}

    def step(name, fn, setup=None, host=False):
        """Median of ``reps`` calls after a warm-up (device time; host
        clock for the host-side steps) and the peak GiB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if host:
            fn(None)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(None)
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times))
        else:
            ms = median_ms(fn, reps, setup)
        steps[name] = dict(ms=ms, host=host, peak_gib=torch.cuda
                           .max_memory_allocated() / 2**30)

    _build.reset_launch_counts()
    # ----- the voxel path
    # voxelization: SECOND's voxel layer, train and test caps
    cloud_d = cloud.to(dev)
    vox_args = (v["voxel_size"], KITTI_RANGE, v["max_points"])
    for cap, tag in zip(v["max_voxels"], ("train", "test")):
        got = voxelize(cloud_d, *vox_args, cap)
        want = voxelize(cloud, *vox_args, cap)
        for field in got._fields:
            held(f"voxelize {tag} {field}", getattr(got, field),
                 getattr(want, field))
        step(f"voxelize {tag} ({cap})",
             lambda _, c=cap: voxelize(cloud_d, *vox_args, c))
    test_vox = want  # the test cap's voxels feed the sparse network
    n_occupied = int(voxelize(cloud_d, *vox_args, len(cloud)).num_voxels)
    # VoxelGenerator (host numpy): first-arrival order; each of its voxels
    # holds the same points, in the same order, as voxelize's row of that
    # voxel
    full = voxelize(cloud, *vox_args, len(cloud))
    n_full = int(full.num_voxels)
    _, gh, gw = v["grid"]

    def lin_of(zyx):  # increasing in voxelize's row order
        zyx = zyx.astype(np.int64)
        return (zyx[:, 0] * gh + zyx[:, 1]) * gw + zyx[:, 2]

    full_lin = lin_of(full.coords[:n_full].numpy())
    for cap in v["max_voxels"]:
        gen = VoxelGenerator(v["voxel_size"], KITTI_RANGE, v["max_points"],
                             cap)
        g_vox, g_coords, g_num = gen.generate(cloud_np)
        step(f"VoxelGenerator ({cap})", lambda _, g=gen: g.generate(cloud_np),
             host=True)
        rows = np.searchsorted(full_lin, lin_of(g_coords))
        if not (len(g_coords) == min(cap, n_full)
                and np.array_equal(full.coords.numpy()[rows], g_coords)
                and np.array_equal(full.num_points.numpy()[rows], g_num)
                and np.array_equal(full.voxels.numpy()[rows], g_vox)):
            raise AssertionError(f"[voxel] VoxelGenerator ({cap}): its "
                                 "voxels differ from voxelize's")
    # dynamic scatter on the same voxel ids (the uncapped voxel of each
    # point, out-of-range points -1)
    lo, hi = torch.tensor(KITTI_RANGE[:3]), torch.tensor(KITTI_RANGE[3:])
    size = torch.tensor(v["voxel_size"])
    grid_f = torch.floor((cloud[:, :3] - lo) / size).long()
    dims = torch.ceil((hi - lo) / size).long()  # x, y, z as voxelize's
    inside = ((grid_f >= 0) & (grid_f < dims)).all(1)
    lin = (grid_f[:, 2] * dims[1] + grid_f[:, 1]) * dims[0] + grid_f[:, 0]
    occupied = torch.unique(lin[inside])
    if len(occupied) != n_full:
        raise AssertionError(f"[voxel] {len(occupied)} voxel ids, "
                             f"voxelize found {n_full}")
    ids = torch.where(inside, torch.searchsorted(occupied, lin), -1)
    ids_d = ids.to(dev)
    for mode in ("mean", "max"):
        held(f"dynamic_scatter {mode}",
             dynamic_scatter(cloud_d, ids_d, n_full, mode),
             dynamic_scatter(cloud, ids, n_full, mode))
        step(f"dynamic_scatter {mode}",
             lambda _, m=mode: dynamic_scatter(cloud_d, ids_d, n_full, m))

    # the sparse network at SECOND's grid, V = 40000, float32, TF32 off
    feats = test_vox.voxels.sum(1) / test_vox.num_points.clamp(min=1)[:, None]
    torch.manual_seed(v["seed"])
    mods = torch.nn.ModuleList([SparseBasicBlock(4, 16),
                                SparseBasicBlock(16, 16),
                                SparseConv3d(16, 32, stride=2),
                                SparseBasicBlock(32, 32)]).train()
    w_up = torch.nn.ParameterList([
        torch.nn.Parameter(torch.randn(27, 32, 16) * 0.05) for _ in range(2)])
    net = {cpu: (mods, w_up)}
    net[dev] = (copy.deepcopy(mods).to(dev), copy.deepcopy(w_up).to(dev))

    def sparse_net(d):
        m, w = net[d]
        x = SparseTensor(feats.to(d), test_vox.coords.to(d),
                         test_vox.valid.to(d), v["grid"])
        b1 = m[0](x)
        b2 = m[1](b1)
        down = m[2](b2)
        b3 = m[3](down)
        pooled = sparse_maxpool3d(b3)
        inv = sparse_inverse_conv3d(b3, w[0], b2)
        up = sparse_conv_transpose3d(pooled, w[1])
        loss = (inv.features ** 2).sum() + (up.features ** 2).sum()
        return loss, dict(block1=b1, block2=b2, down=down, block3=b3,
                          maxpool=pooled, inverse=inv, transpose=up)

    outs = {}
    for d in (cpu, dev):
        loss, layers = sparse_net(d)
        loss.backward()
        m, w = net[d]
        grads = {n: p.grad for n, p in m.named_parameters()}
        grads.update({f"w_up.{i}": p.grad for i, p in enumerate(w)})
        outs[d] = (loss, layers, grads)
    sp_err = 0.0
    for name, g in outs[dev][1].items():
        c = outs[cpu][1][name]
        held(f"sparse {name} coords", g.coords, c.coords)
        held(f"sparse {name} valid", g.valid, c.valid)
        sp_err = max(sp_err, held(f"sparse {name} features", g.features,
                                  c.features))
    sp_grad_err = max(held(f"sparse grad {n}", g, outs[cpu][2][n], "grad")
                      for n, g in outs[dev][2].items())
    held("sparse loss", outs[dev][0], outs[cpu][0], "grad")
    sites = {n: int(t.valid.sum()) for n, t in outs[cpu][1].items()}
    step("sparse net forward", lambda _: sparse_net(dev))
    step("sparse net backward", lambda loss_: loss_.backward(),
         setup=lambda: sparse_net(dev)[0])
    profiles = {"sparse net forward + backward":
                device_profile(lambda: sparse_net(dev)[0].backward())}
    del outs, net

    # RoI-aware pooling: PartA2's extractors, 128 rois over 16384 points
    r = VOXEL_ROI
    pick = rng.choice(np.flatnonzero(points_in_rbbox(
        cloud_np[:, :3], objects * np.float32([1, 1, 1, 1.5, 1.5, 1.2, 1]))
        .any(1) | (rng.uniform(size=len(cloud_np)) < 0.05)), r["points"],
        replace=False)
    k = rng.integers(0, len(objects), r["rois"])
    rois = objects[k].copy()
    rois[:, :2] += rng.uniform(-0.5, 0.5, (r["rois"], 2))
    rois[:, 3:6] *= rng.uniform(0.9, 1.2, (r["rois"], 3))
    rois[:, 6] += rng.uniform(-0.2, 0.2, r["rois"])
    size = (r["out_size"],) * 3
    ok = roi_off_faces(rois, cloud_np[pick], size, r["face_margin"])
    roi_pts = torch.from_numpy(cloud_np[pick][ok, :3])
    roi_feat = torch.from_numpy(rng.normal(
        size=(len(roi_pts), r["channels"])).astype(np.float32))
    rois_t = torch.from_numpy(rois)
    for mode in ("max", "avg"):
        res = {}
        for d in (cpu, dev):
            f = roi_feat.to(d).detach().requires_grad_()
            pooled = roiaware_pool3d(rois_t.to(d), roi_pts.to(d), f, size,
                                     r["max_pts"], mode)
            (pooled ** 2).sum().backward()
            res[d] = (pooled, f.grad)
        held(f"roiaware {mode}", res[dev][0], res[cpu][0])
        identical[f"roiaware {mode}"] = torch.equal(
            res[dev][0].detach().cpu(), res[cpu][0].detach())
        held(f"roiaware {mode} grad", res[dev][1], res[cpu][1], "grad")
        filled = int((res[cpu][0].detach().abs().sum(-1) > 0).sum())
        f_d = roi_feat.to(dev).detach().requires_grad_()
        args_d = (rois_t.to(dev), roi_pts.to(dev))
        step(f"roiaware {mode} forward", lambda _, m=mode: roiaware_pool3d(
            *args_d, f_d, size, r["max_pts"], m))
        step(f"roiaware {mode} backward", lambda out: out.backward(),
             setup=lambda m=mode: (roiaware_pool3d(
                 *args_d, f_d, size, r["max_pts"], m) ** 2).sum())
    del res

    # anchors and the residual coder: SECOND's 3-class anchors
    a = VOXEL_ANCHORS
    anchors = {}
    for d in (cpu, dev):
        gen = Anchor3DRangeGenerator(ranges=a["ranges"], sizes=a["sizes"],
                                     rotations=a["rotations"],
                                     reshape_out=False, device=d)
        anchors[d] = gen.grid_anchors([a["featmap"]])[0]
    held("anchors", anchors[dev], anchors[cpu])
    identical["anchors"] = torch.equal(anchors[dev].cpu(), anchors[cpu])
    flat = anchors[cpu].reshape(-1, 7)
    gt = flat.clone()
    gt[:, :3] += torch.from_numpy(rng.normal(0, 0.4, (len(gt), 3))
                                  .astype(np.float32))
    gt[:, 3:6] *= torch.from_numpy(rng.uniform(0.8, 1.25, (len(gt), 3))
                                   .astype(np.float32))
    gt[:, 6] += torch.from_numpy(rng.normal(0, 0.3, len(gt))
                                 .astype(np.float32))
    enc = {d: delta_xyzwhlr_encode(flat.to(d), gt.to(d)) for d in (cpu, dev)}
    held("delta_xyzwhlr_encode", enc[dev], enc[cpu])
    dec = {d: delta_xyzwhlr_decode(flat.to(d), enc[d]) for d in (cpu, dev)}
    held("delta_xyzwhlr_decode", dec[dev], dec[cpu])
    trip = float((dec[cpu] - gt).abs().max())
    if not trip <= 1e-4 * max(1.0, float(gt.abs().max())):
        raise AssertionError(f"[voxel] encode/decode round trip {trip:.3e}")
    flat_d, gt_d = flat.to(dev), gt.to(dev)
    step("anchors (200 x 176, 3 classes x 2 rotations)", lambda _: (
        Anchor3DRangeGenerator(ranges=a["ranges"], sizes=a["sizes"],
                               rotations=a["rotations"], reshape_out=False,
                               device=dev).grid_anchors([a["featmap"]])))
    step("delta_xyzwhlr encode + decode", lambda _: delta_xyzwhlr_decode(
        flat_d, delta_xyzwhlr_encode(flat_d, gt_d)))

    # SECOND's test-time NMS on 1000 boxes of 3 classes, and pcdet's
    n = VOXEL_NMS
    boxes, scores = detection_clusters(rng, objects, n["boxes"], n["classes"])
    boxes_t, scores_t = torch.from_numpy(boxes), torch.from_numpy(scores)
    bev = boxes_t[:, [0, 1, 3, 4, 6]]
    for what, iou in (
            ("box3d_multiclass_nms", mnms._rotated_iou_matrix(
                mnms._reference_bev(bev))),
            ("pcdet nms", pcdet_nms.boxes_iou_bev(boxes_t, boxes_t))):
        nonzero = iou[iou > 0]
        if not bool((nonzero > 10 * n["nms_thr"]).all()):
            raise AssertionError(f"[voxel] {what}: an IoU near the "
                                 "threshold makes the keep list ill-posed")
    nms_args = (n["score_thr"], n["nms_thr"], n["max_num"])
    mc = {d: mnms.box3d_multiclass_nms(boxes_t.to(d), scores_t.to(d),
                                       *nms_args) for d in (cpu, dev)}
    for name, g, c in zip(("boxes", "scores", "labels", "valid"), mc[dev],
                          mc[cpu]):
        held(f"box3d_multiclass_nms {name}", g, c)
    best = scores_t[:, :-1].max(1).values
    keep = {d: pcdet_nms.nms(boxes_t.to(d), best.to(d), n["nms_thr"])[0]
            for d in (cpu, dev)}
    held("pcdet nms keep", keep[dev], keep[cpu])
    boxes_d, scores_d, best_d = (t.to(dev) for t in (boxes_t, scores_t, best))
    step("box3d_multiclass_nms", lambda _: mnms.box3d_multiclass_nms(
        boxes_d, scores_d, *nms_args))
    profiles["box3d_multiclass_nms"] = device_profile(
        lambda: mnms.box3d_multiclass_nms(boxes_d, scores_d, *nms_args))
    step("pcdet nms", lambda _: pcdet_nms.nms(boxes_d, best_d, n["nms_thr"]))

    # CenterPoint nuScenes: decode a 2-class task with velocity, then
    # circle NMS; the gaussian heatmap targets on the same map
    cp = CENTERPOINT
    B, C, H = cp["b"], cp["classes"], cp["size"]
    maps = dict(
        heat=1 / (1 + np.exp(-(rng.normal(size=(B, C, H, H)) - 2.0))),
        rot_sine=rng.normal(size=(B, 1, H, H)),
        rot_cosine=rng.normal(size=(B, 1, H, H)),
        hei=rng.normal(size=(B, 1, H, H)),
        dim=rng.uniform(0.5, 3.0, (B, 3, H, H)),
        vel=rng.normal(size=(B, 2, H, H)),
        reg=rng.uniform(0, 1, (B, 2, H, H)))
    maps = {key: torch.from_numpy(val.astype(np.float32))
            for key, val in maps.items()}
    dec_kw = dict(pc_range=cp["pc_range"], out_size_factor=cp["out_size_factor"],
                  voxel_size=cp["voxel_size"],
                  post_center_range=cp["post_center_range"],
                  max_num=cp["max_num"], score_threshold=cp["score_threshold"])

    def centerpoint(d, mp):
        out = centerpoint_decode(**mp, **dec_kw)
        keep_ = [mnms.circle_nms(torch.cat([out.bboxes[b, :, :2],
                                            out.scores[b, :, None]], 1),
                                 cp["min_radius"], out.valid[b])
                 for b in range(B)]
        return out, torch.stack(keep_)

    maps_d = {key: val.to(dev) for key, val in maps.items()}
    (cp_c, keep_c), (cp_d, keep_d) = (centerpoint(cpu, maps),
                                     centerpoint(dev, maps_d))
    for name, g, c in zip(cp_c._fields, cp_d, cp_c):
        held(f"centerpoint_decode {name}", g, c)
    held("circle_nms keep", keep_d, keep_c)
    for name, g, c in zip(("scores", "inds", "classes", "ys", "xs"),
                          coders._topk_heatmap(maps_d["heat"], cp["max_num"]),
                          coders._topk_heatmap(maps["heat"], cp["max_num"])):
        held(f"centerpoint top-k {name}", g, c)
    step("centerpoint_decode + circle_nms", lambda _: centerpoint(dev, maps_d))
    centres = np.stack([rng.integers(8, H - 8, cp["gaussians"]),
                        rng.integers(8, H - 8, cp["gaussians"])], 1).tolist()
    # CenterPoint's radius for a car in map cells, at least 2
    radius = max(2, int(gaussian_radius(
        (3.9 / (cp["voxel_size"][0] * cp["out_size_factor"]),
         1.6 / (cp["voxel_size"][1] * cp["out_size_factor"])), 0.1)))

    def heatmap(d):
        hm = torch.zeros((H, H), device=d)
        for centre in centres:
            hm = draw_heatmap_gaussian(hm, centre, radius)
        return hm

    held("draw_heatmap_gaussian", heatmap(dev), heatmap(cpu))
    step(f"draw_heatmap_gaussian x {cp['gaussians']}", lambda _: heatmap(dev))

    # GT-paste: the database of [migrate]'s ScanNet tree, one scene pasted
    gt_db_args = ["scannet", "--gt-db", "--out-dir", str(prepared)]
    with contextlib.redirect_stdout(None):
        db = create_data.main(gt_db_args)
        step("create_data --gt-db", lambda _: create_data.main(gt_db_args),
             host=True)
    info = io.load_infos(prepared / "scannet_infos_train.pkl")[0]
    scene = io.load_points_bin(prepared / info["pts_path"], load_dim=6,
                               use_dim=range(6))
    raw = np.asarray(info["annos"]["gt_boxes_upright_depth"], np.float32)
    gt_boxes = np.zeros((len(raw), 7), np.float32)
    gt_boxes[:, :6] = raw
    gt_boxes[:, 2] -= gt_boxes[:, 5] / 2
    gt_labels = np.asarray(info["annos"]["class"]).reshape(-1)

    def paste(_=None):
        sampler = DataBaseSampler(
            db, prepared, rate=1.0,
            prepare={"filter_by_min_points": dict.fromkeys(CLASS_NAMES, 5)},
            sample_groups=dict.fromkeys(CLASS_NAMES, 3), classes=CLASS_NAMES,
            point_dims=3, rng=np.random.default_rng(v["seed"]))
        return object_sample(scene, gt_boxes, gt_labels, sampler)

    pasted = paste()
    for a_, b_ in zip(paste(), pasted):
        if not np.array_equal(a_, b_):
            raise AssertionError("[voxel] GT-paste: two runs from one seed "
                                 "differ")
    step("DataBaseSampler + sample_all + object_sample", paste, host=True)
    new_pts, new_boxes, _ = pasted
    n_pasted = len(new_boxes) - len(gt_boxes)
    corners = center_to_corner_box2d(new_boxes[:, :2], new_boxes[:, 3:5],
                                     new_boxes[:, 6])
    coll = box_collision_test(corners, corners)
    np.fill_diagonal(coll, False)
    coll[:len(gt_boxes), :len(gt_boxes)] = False  # the scene's own boxes
    inside = points_in_rbbox(new_pts[:, :3], new_boxes[len(gt_boxes):])
    if not (n_pasted > 0 and not coll.any() and inside.any(0).all()):
        raise AssertionError(f"[voxel] GT-paste: {n_pasted} boxes pasted, "
                             f"collisions {int(coll.sum())}")
    paste_range = (*(np.floor(new_pts[:, :3].min(0)) - 0.1),
                   *(np.ceil(new_pts[:, :3].max(0)) + 0.1))
    paste_args = ((0.05, 0.05, 0.05), paste_range, 5, 40000)
    pasted_t = torch.from_numpy(new_pts)
    pv = {d: voxelize(pasted_t.to(d), *paste_args) for d in (cpu, dev)}
    for field in pv[cpu]._fields:
        held(f"GT-paste voxelize {field}", getattr(pv[dev], field),
             getattr(pv[cpu], field))
    torch.cuda.synchronize()
    launches = {"voxel": _build.launch_counts()}
    # ----- end of the voxel path
    print(f"[voxel] launches during the voxel path: {launches['voxel']}")
    if any(launches["voxel"].values()):
        raise AssertionError("[voxel] the stack launched a kernel of the port")

    print(f"[voxel] cloud: {v['points']} points x 4 in KITTI's range "
          f"{KITTI_RANGE}, {v['objects']} objects; {n_occupied} occupied "
          f"voxels at {v['voxel_size']}; VoxelGenerator's voxels identical "
          "to voxelize's")
    print(f"[voxel] sparse net on {v['grid']}, V={v['max_voxels'][1]}: "
          f"active sites {sites}; "
          f"card vs CPU: sites identical, features within {sp_err:.2e}, "
          f"weight gradients within {sp_grad_err:.2e} of their scale")
    print(f"[voxel] roiaware_pool3d: {r['rois']} rois over {len(roi_pts)} "
          f"points ({int((~ok).sum())} of {r['points']} dropped within "
          f"{r['face_margin']} m of a voxel face), C={r['channels']}, "
          f"out {r['out_size']}, {filled} voxels filled")
    print(f"[voxel] NMS: box3d_multiclass_nms keeps "
          f"{int(mc[cpu][3].sum())} of {n['boxes']} x {n['classes']}, pcdet "
          f"nms {len(keep[cpu])}; centerpoint_decode {int(cp_c.valid.sum())} "
          f"valid of {B} x {cp['max_num']}, circle_nms keeps "
          f"{int(keep_c.sum())}; identical on the card")
    print(f"[voxel] GT-paste on {prepared.name}'s first training scan: "
          f"{n_pasted} boxes pasted, {len(new_pts)} points, no collision; "
          "voxelized identically on the card")
    print(f"[voxel] floats bit-identical on the card: {identical}")
    for name, st in steps.items():
        clock = " (host clock)" if st["host"] else ""
        print(f"[voxel] {name}: median {st['ms']:.4f} ms of {reps}{clock}, "
              f"peak {st['peak_gib']:.4f} GiB")
    for name, prof in profiles.items():
        top = ", ".join(f"{g} {ms:.3f}" for g, ms in
                        list(prof["groups"].items())[:4])
        print(f"[voxel] {name} under the profiler: wall "
              f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f}"
              f" ms, idle share {prof['idle_share']:.3f}; device ms: {top}")
    out = dict(launches=launches, steps=steps, profiles=profiles,
               phase_s=time.perf_counter() - t_phase)
    print(f"[voxel] phase: {out['phase_s']:.2f} s")
    return out


def overfit_path(dev) -> dict:
    """Path ``overfit``: ``overfit_check`` with ``OVERFIT`` (its defaults)
    on the card, its floor checked by the tool; then the trained model's
    head outputs decoded again on the CPU (``decode_and_nms``), every keep
    list and box identical and every score within ``OVERFIT_SCORE_TOL``,
    and ``indoor_eval`` of the CPU's detections within ``OVERFIT_MAP_TOL``
    of the card's."""
    import torch

    from nesie_tpu_torch.data.scannet_meta import CLASS_NAMES
    from nesie_tpu_torch.eval import decode_and_nms, indoor_eval
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import overfit_check

    o = OVERFIT
    argv = ["--device", str(dev), "--steps", str(o["steps"]), "--batch",
            str(o["batch"]), "--scenes", str(o["scenes"]), "--num-points",
            str(o["num_points"]), "--lr", str(o["lr"]), "--seed",
            str(o["seed"])] + (["--tiny"] if o["tiny"] else [])
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    # ----- the overfit path
    res = overfit_check.run(overfit_check.parse_args(argv))
    launches = _build.launch_counts()
    # ----- end of the overfit path
    path_s = time.perf_counter() - t0
    forwards = -(-o["scenes"] // o["batch"])
    want = per_forward(train=o["steps"], eval_small=forwards)
    print(f"[diagnose] overfit launches: {launches} (predicted {want})")
    check_counts(launches, "overfit", want)

    ev, log = res["eval"], res["log"]
    marks = sorted(set(range(0, o["steps"], 50)) | {o["steps"] - 1})
    print("[diagnose] overfit loss at steps " + ", ".join(
        f"{i}: {log['losses'][i]:.4f}" for i in marks))
    gts, dts, worst = [], [], 0.0
    for b in ev["batches"]:
        raw = {k: torch.from_numpy(v) for k, v in b["raw"].items()}
        cpu = {k: v.numpy() for k, v in decode_and_nms(
            raw, torch.from_numpy(b["points"])).items()}
        card = b["decoded"]
        for k in ("selected", "bbox"):
            if not np.array_equal(cpu[k], card[k]):
                raise AssertionError(f"[diagnose] overfit decode: {k} "
                                     "differs between the card and the CPU")
        for k in ("obj_scores", "sem_scores"):
            worst = max(worst, float(np.abs(cpu[k] - card[k]).max()))
        gts += b["gt"]
        dts += overfit_check.dt_annos(cpu, b["n_real"])
    if not worst <= OVERFIT_SCORE_TOL:
        raise AssertionError(f"[diagnose] overfit decode scores: card vs CPU "
                             f"{worst:.3e} > {OVERFIT_SCORE_TOL}")
    cpu_res = indoor_eval(gts, dts, class_names=list(CLASS_NAMES))
    map_err = max(0.0 if np.isnan(v) and np.isnan(cpu_res[k])
                  else abs(cpu_res[k] - v) for k, v in ev["results"].items())
    if not map_err <= OVERFIT_MAP_TOL:
        raise AssertionError(f"[diagnose] overfit indoor_eval: card vs CPU "
                             f"{map_err:.3e} > {OVERFIT_MAP_TOL}")
    r = ev["results"]
    kept_boxes = sum(len(d["boxes"]) for d in dts)
    print(f"[diagnose] overfit ({'tiny' if o['tiny'] else 'flagship'}, "
          f"B={o['batch']} x {o['num_points']}, {o['scenes']} scenes, "
          f"{o['steps']} steps, lr {o['lr']}): mAP_0.25 {r['mAP_0.25']:.4f}, "
          f"mAP_0.5 {r['mAP_0.50']:.4f}, mAR_0.25 {r['mAR_0.25']:.4f}, "
          f"mAR_0.5 {r['mAR_0.50']:.4f} (floor mAP_0.25 > "
          f"{overfit_check.MAP_FLOOR}); {ev['kept']} proposals kept after NMS "
          f"({kept_boxes} per-class boxes); median step "
          f"{np.median(log['step_ms']):.3f} ms, median host batch "
          f"{np.median(log['batch_ms']):.3f} ms; the path {path_s:.2f} s")
    print(f"[diagnose] overfit decode on the CPU from the card's head "
          f"outputs: keep lists and boxes identical, scores within "
          f"{worst:.3e}, indoor_eval within {map_err:.3e}")
    return dict(launches=launches, results=r, kept=ev["kept"],
                kept_boxes=kept_boxes,
                step_ms=float(np.median(log["step_ms"])),
                batch_ms=float(np.median(log["batch_ms"])),
                losses=[log["losses"][i] for i in marks], path_s=path_s)


def diagnose_path(dev) -> dict:
    """Path ``diagnose``: ``diagnose_teacher`` at ``DIAGNOSE``'s cut regime
    (data and work dirs under ``build/diagnose_smoke/``), then
    ``probe_thresholds`` and ``jitter_delta`` on the pretrain it leaves;
    each tool's JSON printed, the launches against the forwards the tools
    run."""
    import shutil

    from nesie_tpu_torch.data.dataset import read_split_file
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import diagnose_teacher, jitter_delta
    from nesie_tpu_torch.tools import probe_thresholds

    d = DIAGNOSE
    base = ROOT / "build" / "diagnose_smoke"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--device", str(dev), "--num-points", str(d["num_points"])]
    print(f"[diagnose] reduced: {DIAGNOSE_REDUCED}")
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    # ----- the diagnose path
    report = diagnose_teacher.run(diagnose_teacher.parse_args(
        ["--out", str(base), "--n-train", str(d["n_train"]), "--n-val",
         str(d["n_val"]), "--pretrain-epochs", str(d["pretrain_epochs"]),
         "--semi-epochs", str(d["semi_epochs"]), "--eval-every", "1"]
        + common))
    t_diag = time.perf_counter() - t0
    probe = probe_thresholds.run(probe_thresholds.parse_args(
        ["--out", str(base), "--pretrain-dir",
         str(base / "work" / diagnose_teacher.PRETRAIN), "--split", "010",
         "--pretrain-epochs", str(d["pretrain_epochs"]), "--pretrain-repeat",
         "10", "--model-overrides"] + common))
    jitter = jitter_delta.run(jitter_delta.parse_args(
        ["--root", str(base), "--batches", str(d["jitter_batches"])]
        + common))
    launches = _build.launch_counts()
    # ----- end of the diagnose path
    path_s = time.perf_counter() - t0
    # diagnose_teacher's configs: 10 repeats of the labeled scenes, 4 a
    # pretrain step and 2 a semi step (teacher and student forwards)
    labeled = len(read_split_file(base / "data" / "meta_data"
                                  / "scannetv2_train_0.1.txt"))
    pre_steps = max(labeled * 10 // 4, 1) * d["pretrain_epochs"]
    semi_steps = max(labeled * 10 // 2, 1) * d["semi_epochs"]
    evals = (2 + 2 * d["semi_epochs"] + 5) * -(-d["n_val"] // d["eval_batch"])
    want = per_forward(
        train=pre_steps + 2 * semi_steps + 2 * d["jitter_batches"],
        eval_small=evals + 1)
    print(f"[diagnose] diagnose launches: {launches} (predicted {want}: "
          f"{pre_steps} pretrain and {semi_steps} semi steps, {evals} eval "
          f"forwards, 1 probe and {2 * d['jitter_batches']} jitter_delta "
          f"forwards)")
    check_counts(launches, "diagnose", want)
    print("[diagnose] diagnose_teacher probes: " + json.dumps(report["probes"]))
    print("[diagnose] diagnose_teacher curve: " + json.dumps(report["curve"]))
    print("[diagnose] probe_thresholds: " + json.dumps(probe))
    print("[diagnose] jitter_delta: " + json.dumps(jitter))
    print(f"[diagnose] the path {path_s:.2f} s (diagnose_teacher "
          f"{t_diag:.2f} s)")
    return dict(launches=launches, path_s=path_s, probes=report["probes"],
                probe=probe, jitter=jitter)


def mono3d_modules(seed: int):
    """(backbone, head) for ``SingleStageMono3DDetector`` at FCOS3D's
    output layout, seeded: every weight and bias ~ N(0, 0.05^2)."""
    import torch
    from torch import nn

    f, w = FCOS3D, FCOS3D["width"]

    class Backbone(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2d(3, w, 8, stride=8)
            self.down = nn.ModuleList(nn.Conv2d(w, w, 3, stride=2, padding=1)
                                      for _ in f["strides"][1:])

        def forward(self, img):
            x = [torch.relu(self.stem(img))]
            for conv in self.down:
                x.append(torch.relu(conv(x[-1])))
            return x

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.shared = nn.Conv2d(w, w, 3, padding=1)
            self.outs = nn.ModuleList(
                nn.Conv2d(w, f[k], 1)
                for k in ("classes", "reg", "dir", "attr", "centerness"))

        def forward(self, feats):
            hs = [torch.relu(self.shared(x)) for x in feats]
            return tuple([conv(h) for h in hs] for conv in self.outs)

    gen = torch.Generator().manual_seed(seed)
    backbone, head = Backbone(), Head()
    with torch.no_grad():
        for p in list(backbone.parameters()) + list(head.parameters()):
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return backbone, head


def _mono3d_tta(det, img):
    """The reference's flip test-time augmentation on the shell: the
    image and its mirror, the mirror's outputs flipped back, merged."""
    import torch

    from nesie_tpu_torch.nn.mono3d import (
        flip_mono3d_outputs,
        merge_aug_mono3d_outputs,
    )

    outs = det(img)
    flipped = det(torch.flip(img, dims=(3,)))
    cls, reg, extra = flip_mono3d_outputs(flipped[0], flipped[1],
                                          list(flipped[2:]), pred_velo=True)
    return merge_aug_mono3d_outputs([outs, (cls, reg, *extra)])


def _held_maps(name, got, want, tol=None) -> float:
    """Card maps against CPU maps: identical, or with ``tol`` within it
    times the CPU's largest magnitude (at least 1); the error over that
    scale."""
    worst = 0.0
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            g = g.detach().cpu()
            w = w.detach()
            if g.shape != w.shape:
                raise AssertionError(f"[diagnose] {name}: shapes {g.shape} "
                                     f"and {w.shape}")
            if tol is None:
                if not bool((g == w).all()):
                    raise AssertionError(f"[diagnose] {name}: card and CPU "
                                         "differ")
                continue
            scale = max(1.0, float(w.abs().max()))
            worst = max(worst, float((g - w).abs().max()) / scale)
    if tol is not None and not worst <= tol:
        raise AssertionError(f"[diagnose] {name}: card vs CPU {worst:.3e} > "
                             f"{tol}")
    return worst


def mono3d_path(dev) -> dict:
    """Path ``mono3d`` (no kernel of the port): the flip and merge of
    dense maps at FCOS3D's shapes, identical card against CPU, with their
    times; the shell's forward and flip TTA with ``mono3d_modules``, card
    against CPU within ``MONO3D_TOL``."""
    import copy as cp

    import torch

    from nesie_tpu_torch.nn.mono3d import (
        SingleStageMono3DDetector,
        flip_mono3d_outputs,
        merge_aug_mono3d_outputs,
    )

    f = FCOS3D
    b, (h, w) = f["batch"], f["pad"]
    sizes = [(-(-h // s), -(-w // s)) for s in f["strides"]]
    gen = torch.Generator().manual_seed(f["seed"])

    def view():
        def maps(c, uniform=False):
            draw = torch.rand if uniform else torch.randn
            return [draw((b, c) + hw, generator=gen) for hw in sizes]
        return (maps(f["classes"]), maps(f["reg"], uniform=True),
                maps(f["dir"]), maps(f["attr"]), maps(f["centerness"]))

    views = [view(), view()]

    def flip_merge(vs):
        cls, reg, extra = flip_mono3d_outputs(vs[1][0], vs[1][1],
                                              list(vs[1][2:]), pred_velo=True)
        return merge_aug_mono3d_outputs([vs[0], (cls, reg, *extra)])

    card_views = [tuple([m.to(dev) for m in g] for g in v) for v in views]
    merged_cpu = flip_merge(views)
    merged_card = flip_merge(card_views)
    _held_maps("mono3d flip + merge", merged_card, merged_cpu)
    card_ms = median_ms(lambda _: flip_merge(card_views), 5)
    t0 = time.perf_counter()
    flip_merge(views)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    n_vals = sum(m.numel() for g in views[0] for m in g)

    backbone, head = mono3d_modules(f["seed"] + 1)
    det_cpu = SingleStageMono3DDetector(backbone=backbone, bbox_head=head)
    det = cp.deepcopy(det_cpu).to(dev).eval()
    det_cpu.eval()
    img = torch.randn((b, 3, h, w), generator=gen)
    img_card = img.to(dev)
    with torch.no_grad():
        fwd_err = _held_maps("mono3d shell forward", det(img_card),
                             det_cpu(img), MONO3D_TOL)
        tta_err = _held_maps("mono3d shell flip TTA",
                             _mono3d_tta(det, img_card),
                             _mono3d_tta(det_cpu, img), MONO3D_TOL)
        fwd_ms = median_ms(lambda _: det(img_card), 5)
        tta_ms = median_ms(lambda _: _mono3d_tta(det, img_card), 5)
    print(f"[diagnose] mono3d: FCOS3D nuScenes maps ({b} x {h} x {w}, "
          f"strides {f['strides']}: {sizes}; {n_vals} values a view): flip + "
          f"merge of 2 views identical on the card, {card_ms:.4f} ms (CPU "
          f"{cpu_ms:.1f} ms, host clock); the shell (width {f['width']}) "
          f"forward within {fwd_err:.2e}, flip TTA within {tta_err:.2e} of "
          f"the CPU's scale; forward {fwd_ms:.4f} ms, TTA {tta_ms:.4f} ms")
    return dict(flip_merge_ms=card_ms, forward_ms=fwd_ms, tta_ms=tta_ms,
                fwd_err=fwd_err, tta_err=tta_err)


def instance_benchmark() -> dict:
    """``scannet_instance_benchmark`` on the instance ids of [migrate]'s
    generated ScanNet scans (``_instance_ids``: a box surface's points its
    instance, the floor unannotated; nyu40 id x 1000 + instance), against
    masks perturbed from ``INSTANCE``'s seed (each instance's points kept
    with probability ``keep``, ``spill`` of the scan's points added, every
    ``dup_every``-th instance predicted twice, ``false_pos`` random masks a
    scan), and on the GT masks themselves, whose all_ap must be 1."""
    from nesie_tpu_torch.data.scannet_meta import VALID_CAT_IDS
    from nesie_tpu_torch.data.synthetic import make_synthetic_scenes
    from nesie_tpu_torch.eval.instance_seg import scannet_instance_benchmark

    m, c = MIGRATE, INSTANCE
    rooms = make_synthetic_scenes(m["scenes"], seed=m["seed"],
                                  floor_points=m["floor_points"],
                                  points_per_object=m["points_per_object"])
    rng = np.random.default_rng(c["seed"])
    nyu = np.asarray(VALID_CAT_IDS)
    gts, preds, perfect = [], [], []
    for room in rooms:
        seg = _instance_ids(room.points[:, :3].astype(np.float64), room.boxes)
        cls = np.concatenate([[0], nyu[room.labels.astype(int)]])[seg]
        gt = np.where(seg > 0, cls * 1000 + seg, 0)
        n = len(gt)
        masks, labels, confs = [], [], []
        inst = [j for j in range(1, seg.max() + 1) if (seg == j).any()]
        for j in inst:
            for _ in range(2 if j % c["dup_every"] == 0 else 1):
                masks.append(((seg == j) & (rng.uniform(size=n) < c["keep"]))
                             | (rng.uniform(size=n) < c["spill"]))
                labels.append(int(cls[seg == j][0]))
                confs.append(float(rng.uniform()))
        for _ in range(c["false_pos"]):
            masks.append(rng.uniform(size=n) < 0.02)
            labels.append(int(rng.choice(nyu)))
            confs.append(float(rng.uniform()))
        gts.append(gt)
        preds.append(dict(mask=np.stack(masks), label_id=np.array(labels),
                          conf=np.array(confs)))
        perfect.append(dict(mask=np.stack([seg == j for j in inst]),
                            label_id=np.array([cls[seg == j][0] for j in inst]),
                            conf=np.linspace(1.0, 0.5, len(inst))))
    t0 = time.perf_counter()
    res = scannet_instance_benchmark(gts, preds)
    host_ms = (time.perf_counter() - t0) * 1e3
    oracle = scannet_instance_benchmark(gts, perfect)
    if oracle["all_ap"] != 1.0 or oracle["all_ap_25%"] != 1.0:
        raise AssertionError(f"[diagnose] instance benchmark on the GT masks: "
                             f"all_ap {oracle['all_ap']}, not 1")
    for k in ("all_ap", "all_ap_50%", "all_ap_25%"):
        if not 0.0 < res[k] <= 1.0:
            raise AssertionError(f"[diagnose] instance benchmark: {k} "
                                 f"{res[k]}")
    n_pred = sum(len(p["conf"]) for p in preds)
    print(f"[diagnose] scannet_instance_benchmark: {len(gts)} scans of "
          f"{min(map(len, gts))}-{max(map(len, gts))} vertices, {n_pred} "
          f"predicted masks: all_ap {res['all_ap']:.4f}, ap50 "
          f"{res['all_ap_50%']:.4f}, ap25 {res['all_ap_25%']:.4f}, host "
          f"{host_ms:.1f} ms; on the GT masks all_ap 1")
    return dict(host_ms=host_ms, all_ap=res["all_ap"],
                ap50=res["all_ap_50%"], ap25=res["all_ap_25%"])


def flops_path(dev) -> dict:
    """Path ``flops``: ``flops_analysis`` with ``FLOPS_ARGV`` (its
    defaults: the B=8 x 40000 eval forward, the 4 + 8 semi step), its
    point-kernel launches against the counts."""
    from nesie_tpu_torch.ops import _build
    from nesie_tpu_torch.tools import flops_analysis

    _build.reset_launch_counts()
    # ----- the flops path
    out = flops_analysis.run(flops_analysis.parse_args(
        ["--device", str(dev), *FLOPS_ARGV]))
    launches = _build.launch_counts()
    # ----- end of the flops path
    want = per_forward(train=2, eval_small=1)  # semi: teacher + student
    check_counts(launches, "flops", want)
    seen = {k: sum(v["point_ops"][k]["launches"] for v in out.values())
            for k in ("fps", "ball_query", "three_nn")}
    if seen != {"fps": want["fps_onchip_small"],
                "ball_query": want["ball_query"],
                "three_nn": want["three_nn"]}:
        raise AssertionError(f"[diagnose] flops_analysis counted {seen} "
                             f"point-kernel calls, the card {launches}")
    print("[diagnose] flops: " + ", ".join(
        f"{k} {v['flops']:.6e} FLOPs" for k, v in out.items()))
    return dict(launches=launches,
                flops={k: v["flops"] for k, v in out.items()},
                point_ops={k: v["point_ops"] for k, v in out.items()})


def diagnose_phase(dev) -> dict:
    """[diagnose]: paths ``overfit``, ``diagnose``, ``mono3d`` (with the
    instance benchmark; neither launches a kernel of the port) and
    ``flops``, counts set to 0 before and read after each. Returns the
    launches and the numbers printed."""
    import torch

    from nesie_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    launches = {}
    overfit = overfit_path(dev)
    launches["overfit"] = overfit.pop("launches")
    torch.cuda.empty_cache()
    diag = diagnose_path(dev)
    launches["diagnose"] = diag.pop("launches")
    _build.reset_launch_counts()
    # ----- the mono3d path (and the instance benchmark, on the host)
    mono = mono3d_path(dev)
    inst = instance_benchmark()
    launches["mono3d"] = _build.launch_counts()
    # ----- end of the mono3d path
    check_counts(launches["mono3d"], "mono3d",
                 dict.fromkeys(per_forward(), 0))
    torch.cuda.empty_cache()
    flops = flops_path(dev)
    launches["flops"] = flops.pop("launches")
    out = dict(launches=launches, overfit=overfit, diagnose=diag,
               mono3d=mono, instance=inst, flops=flops,
               phase_s=time.perf_counter() - t_phase)
    print(f"[diagnose] phase: {out['phase_s']:.2f} s")
    return out


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
    from nesie_tpu_torch.ops.decode_nms import keep_mask_cuda, keep_mask_ref
    from nesie_tpu_torch.ops.fps import (
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
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds.get('kernels')} s)")

    # ---- 3. kernel phases ---------------------------------------------
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, N_POINTS) for _ in range(B)]
    xyz = torch.from_numpy(np.stack(scenes)).to(dev)  # (B, 40000, 3)
    results, bounds, library = {}, {}, dict.fromkeys(_build.KERNELS)

    fps_idx = fps_onchip_cuda(xyz, SA1["m"])
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
        if not torch.equal(fps_onchip_cuda(x, m),
                           fps_onchip_cuda(x, m, exchange="barrier")):
            raise AssertionError(f"{name}: fps_onchip.cu's exchanges differ")
        barrier_plan = fps_onchip_plan(b, n, exchange="barrier")
        barrier_ms = time_ms(
            lambda: fps_onchip_cuda(x, m, exchange="barrier"), 5)
        b_ms, b_by = fps_bound(b, n, m)
        print(f"[kernel] {name}: plan {plan}; fps_onchip {res[1]:.4f} ms "
              f"({res[1] * 1e3 / (m - 1):.4f} us a step); the barrier "
              f"exchange {barrier_ms:.4f} ms (plan {barrier_plan}); plain "
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
        tag = f"B={b} N={n} M={m}"
        reps = 3 if n > N_POINTS else 5
        res = kernel_phase(f"fps_onchip {tag} ({what})",
                           lambda: fps_onchip_cuda(x, m),
                           lambda: fps_ref(x, m), reps=reps, plain_reps=1)
        if not torch.equal(fps_onchip_cuda(x, m),
                           fps_onchip_cuda(x, m, exchange="barrier")):
            raise AssertionError(f"fps {tag}: fps_onchip.cu and its barrier "
                                 "exchange differ")
        barrier_ms = time_ms(lambda: fps_onchip_cuda(x, m, exchange="barrier"),
                             reps)
        b_ms, b_by = fps_bound(b, n, m)
        k2_ms[tag] = dict(ms=res[1], barrier_ms=barrier_ms, plain_ms=res[2],
                          bound_ms=b_ms, bound_by=b_by, plan=plan)
        print(f"[kernel] fps {tag} ({what}): fps_onchip {res[1]:.4f} ms "
              f"(plan {plan}); the barrier exchange {barrier_ms:.4f} ms "
              f"(plan {barrier_plan}); plain {res[2]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); identical to fps_ref and to each "
              "other")
        if i == K2_MAIN:
            results["fps_onchip_small"] = res
            bounds["fps_onchip_small"] = (b_ms, b_by)
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

    # the decode's keep mask: selected and counts stacked as int32
    decode_ms = {}
    for what, b, p in DECODE_SHAPES:
        case = decode_case(xyz[:b], p, seed=b)
        tag = f"B={b} N={N_POINTS} P={p}"

        def both(fn, case=case):
            sel, counts = fn(*case, **DECODE_THR)
            return torch.stack([sel.to(torch.int32), counts])

        res = kernel_phase(f"decode_nms {tag} ({what})",
                           lambda: both(keep_mask_cuda),
                           lambda: both(keep_mask_ref), reps=20)
        kept = int(keep_mask_cuda(*case, **DECODE_THR)[0].sum())
        b_ms, b_by = decode_nms_bound(b, N_POINTS, p)
        decode_ms[tag] = dict(ms=res[1], plain_ms=res[2], bound_ms=b_ms,
                              bound_by=b_by, selected=kept)
        print(f"[kernel] decode_nms {tag} ({what}): {res[1]:.4f} ms, plain "
              f"{res[2]:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {kept} of "
              f"{b * p} proposals selected")
        if b == B:
            results["decode_nms"] = res
            bounds["decode_nms"] = (b_ms, b_by)
    del xyz, centers, seeds, bq_shapes, q, src, case

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
    sa_ms, results["sa_mlp"], bounds["sa_mlp"] = sa_mlp_phase(model, points)
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
    # two decodes of the batch and one a request, two launches each; the
    # eval SA kernel five times a forward (six of the batch, one a request)
    check_counts(launches["eval"], "eval",
                 {"decode_nms": 2 * (2 + len(requests)),
                  "sa_mlp": 5 * (6 + len(requests))})
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
    check_counts(launches["train"], "training",
                 {"decode_nms": 0, "sa_mlp": 0})

    # ---- 6. one training step, card vs CPU ------------------------------
    gpu_vs_cpu_training_step(dev)

    # ---- 7. the runner and the CLIs -----------------------------------
    torch.cuda.empty_cache()
    runner_out = runner_phase(dev, bare)
    launches.update(runner_out["launches"])

    # ---- 8. the SAQE family -------------------------------------------
    torch.cuda.empty_cache()
    saqe = saqe_phase(dev, scenes, requests, dict(eval_ms=ms, **bare))
    launches.update(saqe["launches"])
    k4_ms.update(saqe["k4"])

    # ---- 9. the head, training and eval options -------------------------
    torch.cuda.empty_cache()
    options = options_phase(dev, scenes, dict(
        eval_ms=ms, eval_scenes_per_s=runner_out["eval_scenes_per_s"],
        **bare))
    launches.update(options["launches"])

    # ---- 10. data parallelism ------------------------------------------
    torch.cuda.empty_cache()
    ddp = ddp_phase(dev, scenes, bare, smi)
    launches.update(ddp["launches"])

    # ---- 11. the point-based tail ---------------------------------------
    torch.cuda.empty_cache()
    tail = tail_phase(dev, scenes, weights)
    launches.update(tail["launches"])

    # ---- 12. data preparation, checkpoint import, the demo --------------
    torch.cuda.empty_cache()
    migrate = migrate_phase(dev)
    launches.update(migrate["launches"])

    # ---- 13. the voxel and outdoor stack --------------------------------
    torch.cuda.empty_cache()
    voxel = voxel_phase(dev, ROOT / "build" / "migrate_smoke" / "scannet")
    launches.update(voxel["launches"])

    # ---- 14. the last modules: overfit, diagnostics, mono3d, FLOPs ------
    torch.cuda.empty_cache()
    diagnose = diagnose_phase(dev)
    launches.update(diagnose["launches"])

    sources = {
        "fps_onchip": ("nesie_tpu_torch/csrc/fps_onchip.cu",
                       "nesie_tpu/ops/pallas_fps.py:73"),
        "fps_onchip_small": ("nesie_tpu_torch/csrc/fps_onchip.cu",
                             "nesie_tpu/ops/pallas_fps.py:25"),
        "ball_query": ("nesie_tpu_torch/csrc/ball_query.cu",
                       "nesie_tpu/ops/pallas_ball_query.py:39"),
        "three_nn": ("nesie_tpu_torch/csrc/three_nn.cu",
                     "nesie_tpu/ops/pallas_three_nn.py:35"),
        "decode_nms": ("nesie_tpu_torch/csrc/decode_nms.cu",
                       "none (the JAX package decodes in XLA: "
                       "nesie_tpu/eval/postprocess.py)"),
        "sa_mlp": ("nesie_tpu_torch/csrc/sa_mlp.cu",
                   "none (the JAX package leaves the SA modules' shared "
                   "MLP to XLA: nesie_tpu/nn/pointnet2.py PointMLP)"),
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
        if name == "fps_onchip_small":
            entry["role"] = "fps_onchip.cu at B <= 16 (K2's regime)"
            entry["by_shape"] = {tag: r["ms"] for tag, r in k2_ms.items()}
        if name == "ball_query":
            entry["by_shape"] = bq_ms
        if name == "three_nn":
            entry["by_shape"] = k4_ms
        if name == "decode_nms":
            entry["by_shape"] = decode_ms
        if name == "sa_mlp":
            entry["role"] = ("ms, plain_ms and bound_ms: the five calls of "
                             f"a B={B} eval forward; a launch count is a "
                             "call (two kernels: W1's padding, the MLP)")
            entry["by_shape"] = sa_ms
        if name in options["kernels"]:
            entry["options_by_shape"] = options["kernels"][name]
        if name in ddp["kernels"]:
            entry["ddp_by_shape"] = ddp["kernels"][name]
        if name in tail["kernels"]:
            entry["tail_by_shape"] = tail["kernels"][name]
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
