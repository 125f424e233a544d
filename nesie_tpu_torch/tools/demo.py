#!/usr/bin/env python
"""Single-cloud inference demo of the port (counterpart of
``tools/demo.py``; reference mmdet3d/apis/inference.py usage): run a
detector on one .bin/.npy point cloud, print the detections above
``--score-thr`` and dump MeshLab-viewable .obj files::

    python -m nesie_tpu_torch.tools.demo nesie-votenet-scannet-train-010 \\
        scene.bin --checkpoint work_dirs/<config>/checkpoints
    python -m nesie_tpu_torch.tools.demo nesie-votenet-scannet-train-010 \\
        scene.bin --checkpoint epoch_36.pth

``--checkpoint`` is a runner's checkpoints directory or a reference
``.pth`` (``apis.init_detector``); without it the config's seeded
initial weights serve.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run inference on one point cloud")
    p.add_argument("config")
    p.add_argument("points", help=".bin or .npy point cloud")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoints dir (<work>/checkpoints) or a reference .pth")
    p.add_argument("--out-dir", default="demo_out")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from nesie_tpu_torch.apis import init_detector
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.eval.visualize import show_result

    det = init_detector(args.config, args.checkpoint, device=args.device)
    result = det(args.points)
    keep = result["scores_3d"] > args.score_thr
    boxes = result["boxes_3d"][keep]
    print(f"{keep.sum()} detections above {args.score_thr}")
    for b, s, l in zip(boxes, result["scores_3d"][keep],
                       result["labels_3d"][keep]):
        print(f"  class={int(l):2d} score={s:.3f} box={np.round(b, 3).tolist()}")

    pts = (np.load(args.points)[:, :3] if str(args.points).endswith(".npy")
           else io.load_points_bin(args.points))
    out = show_result(args.out_dir, Path(args.points).stem, points=pts,
                      pred_boxes=boxes)
    print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
