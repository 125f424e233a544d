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
4. slice phase: the flagship VoteNetNesie (seeded random weights, BN
   running stats randomised) runs the batched eval forward at
   B=32 x 40000 x 4 and serves three ``Detector`` requests, with every
   kernel's launch count read around that run; then one scene's GPU
   forward is held against the same forward on the CPU, which runs the
   plain versions.

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

B, N_POINTS = 32, 40000
# the main path's kernel shapes (flagship VoteNetNesie, sample_mod="seed")
SA1 = dict(n=N_POINTS, m=2048, radius=0.2, k=64)
AGG = dict(n=1024, m=256, radius=0.3, k=16)
SIDE_GRID = dict(m=256 * 96, n=1024)  # side-grid queries vs seeds
FP1 = dict(m=1024, n=512)
LARGE_FPS = dict(b=2, scenes_per_row=5, m=2048)  # rows of 200000 points
# CPU-vs-GPU rule for one scene: float outputs within atol + rtol*|x|,
# and a proposal agrees when all its box, objectness and IoU outputs do
ATOL = RTOL = 1e-3
MIN_AGREE = 0.95


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_scene(rng: np.random.Generator, n: int) -> np.ndarray:
    """An indoor-like cloud: floor, four walls and box-shaped objects,
    points on their surfaces. (n, 3) float32, metres."""
    room = rng.uniform([4.0, 4.0, 2.5], [8.0, 8.0, 3.0])
    n_floor, n_wall = int(0.3 * n), int(0.3 * n)
    n_obj = n - n_floor - n_wall
    floor = rng.uniform([0, 0, 0], [room[0], room[1], 0.02], (n_floor, 3))
    wall = rng.uniform([0, 0, 0], room, (n_wall, 3))
    side = rng.integers(0, 4, n_wall)
    wall[side == 0, 0] = 0.0
    wall[side == 1, 0] = room[0]
    wall[side == 2, 1] = 0.0
    wall[side == 3, 1] = room[1]
    k = int(rng.integers(6, 13))
    size = rng.uniform(0.3, 1.5, (k, 3))
    lo = rng.uniform(0, 1, (k, 3)) * (room - size)
    lo[:, 2] = 0.0
    which = rng.integers(0, k, n_obj)
    p = rng.uniform(0, 1, (n_obj, 3))
    axis = rng.integers(0, 3, n_obj)  # snap one coordinate onto a face
    p[np.arange(n_obj), axis] = rng.integers(0, 2, n_obj)
    obj = lo[which] + p * size[which]
    pts = np.concatenate([floor, wall, obj]) + rng.normal(0, 0.005, (n, 3))
    return pts[rng.permutation(n)].astype(np.float32)


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
    from nesie_tpu_torch.eval.postprocess import decode_and_nms
    from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
    from nesie_tpu_torch.ops import _build, pointops
    from nesie_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_ref
    from nesie_tpu_torch.ops.fps import fps_cuda, fps_ref
    from nesie_tpu_torch.ops.three_nn import three_nn_cuda, three_nn_ref

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
    dev = torch.device("cuda")
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
    results = {}

    fps_idx = fps_cuda(xyz, SA1["m"])
    results["fps"] = kernel_phase(
        f"fps B={B} N={N_POINTS} M={SA1['m']}",
        lambda: fps_cuda(xyz, SA1["m"]), lambda: fps_ref(xyz, SA1["m"]),
        reps=5, plain_reps=1)
    big = torch.from_numpy(np.stack([
        np.concatenate([make_scene(rng, N_POINTS)
                        for _ in range(LARGE_FPS["scenes_per_row"])])
        for _ in range(LARGE_FPS["b"])])).to(dev)
    kernel_phase(
        f"fps B={big.shape[0]} N={big.shape[1]} M={LARGE_FPS['m']} "
        "(the TPU's single-row regime)",
        lambda: fps_cuda(big, LARGE_FPS["m"]),
        lambda: fps_ref(big, LARGE_FPS["m"]), reps=2, plain_reps=1)
    del big

    centers = pointops.gather_points(xyz, fps_idx).contiguous()
    results["ball_query"] = kernel_phase(
        f"ball_query SA1 B={B} N={SA1['n']} M={SA1['m']} r={SA1['radius']} "
        f"K={SA1['k']}",
        lambda: ball_query_cuda(xyz, centers, SA1["radius"], SA1["k"]),
        lambda: ball_query_ref(xyz, centers, SA1["radius"], SA1["k"]))
    seeds = centers[:, :AGG["n"]].contiguous()
    votes = (seeds + 0.05 * torch.randn(
        seeds.shape, generator=torch.Generator(dev).manual_seed(1),
        device=dev)).contiguous()
    agg_centers = votes[:, :AGG["m"]].contiguous()
    kernel_phase(
        f"ball_query aggregation B={B} N={AGG['n']} M={AGG['m']} "
        f"r={AGG['radius']} K={AGG['k']}",
        lambda: ball_query_cuda(votes, agg_centers, AGG["radius"], AGG["k"]),
        lambda: ball_query_ref(votes, agg_centers, AGG["radius"], AGG["k"]))

    # side-grid queries: 96 face points in each of 256 boxes around seeds
    box_c = seeds[:, :256]
    grid = (box_c[:, :, None, :] + torch.rand(
        (B, 256, 96, 3), generator=torch.Generator(dev).manual_seed(2),
        device=dev) - 0.5).reshape(B, SIDE_GRID["m"], 3).contiguous()
    results["three_nn"] = kernel_phase(
        f"three_nn side grid B={B} M={SIDE_GRID['m']} N={SIDE_GRID['n']}",
        lambda: three_nn_cuda(grid, seeds), lambda: three_nn_ref(grid, seeds))
    fp_src = centers[:, :FP1["n"]].contiguous()
    kernel_phase(
        f"three_nn FP1 B={B} M={FP1['m']} N={FP1['n']}",
        lambda: three_nn_cuda(seeds, fp_src),
        lambda: three_nn_ref(seeds, fp_src))
    del xyz, centers, seeds, votes, agg_centers, grid, fp_src

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
    launches = _build.launch_counts()
    # ----- end of the main path
    print(f"[slice] launches during the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the "
                                 "main path")
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
    agree = torch.ones(256, dtype=torch.bool)
    worst = 0.0
    for key in ("bbox_preds", "obj_scores", "iou_scores"):
        g, c = gpu[key][0].cpu(), cpu[key][0]
        ok = (g - c).abs() <= ATOL + RTOL * c.abs()
        agree &= ok.reshape(256, -1).all(dim=1)
        worst = max(worst, (g - c).abs().max().item())
    share = agree.float().mean().item()
    print(f"[slice] CPU vs GPU, one scene (CPU forward {cpu_s:.2f} s): FPS "
          f"and backbone ball-query indices identical; {share:.4f} of "
          f"proposals agree within atol {ATOL} + rtol {RTOL}; max |diff| "
          f"{worst:.3e}")
    if share < MIN_AGREE:
        raise AssertionError(f"only {share:.4f} of proposals agree (need "
                             f">= {MIN_AGREE})")

    sources = {
        "fps": ("nesie_tpu_torch/csrc/fps.cu",
                "nesie_tpu/ops/pallas_fps.py:73"),
        "ball_query": ("nesie_tpu_torch/csrc/ball_query.cu",
                       "nesie_tpu/ops/pallas_ball_query.py:39"),
        "three_nn": ("nesie_tpu_torch/csrc/three_nn.cu",
                     "nesie_tpu/ops/pallas_three_nn.py:35"),
    }
    kernels = []
    for name in _build.KERNELS:
        err, k_ms, p_ms = results[name]
        src, replaces = sources[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=err, ms=k_ms, plain_ms=p_ms))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
