#!/usr/bin/env python
"""Dump a reference-identical pre-sampled eval set (a copy of
``tools/dump_eval_set.py``, numpy only).

The reference's eval pipeline subsamples each cloud with
``IndoorPointSample`` (transforms_3d.py:819-861): ONE
``np.random.choice(n, num_points, replace=(n < num_points))`` drawn from
the legacy GLOBAL ``np.random`` state per scene, scenes visited in info
order. This tool replays that call sequence, ``np.random.seed(seed)``
once and then one legacy ``choice`` per scene in info order, and writes
the post-sample clouds (aligned, with the height channel) to disk:

    python -m nesie_tpu_torch.tools.dump_eval_set --data-root DATA \\
        --out DATA/presampled --num-points 40000 --seed 0
    python -m nesie_tpu_torch.tools.test <config> <checkpoints> \\
        --data-root DATA --presampled DATA/presampled

``data.dataset.PresampledScanNetScenes`` reads the dump. Global alignment
and shift_height are per-point and keep the row order, so selecting rows
after them gives the reference's post-``IndoorPointSample`` points.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def reference_choice(n: int, num_points: int) -> np.ndarray:
    """The exact draw IndoorPointSample.points_random_sampling makes
    (transforms_3d.py:833-861): legacy global RandomState, replacement
    only when the cloud is smaller than the target."""
    replace = n < num_points
    return np.random.choice(n, num_points, replace=replace)


def dump_eval_set(data_root, ann_file, out_dir, num_points: int, seed: int):
    from nesie_tpu_torch.data import io
    from nesie_tpu_torch.data.dataset import ScanNetScenes

    out_dir = Path(out_dir)
    (out_dir / "points").mkdir(parents=True, exist_ok=True)
    ds = ScanNetScenes(data_root, ann_file)
    infos = io.load_infos(ann_file)

    np.random.seed(seed)  # the reference runner's set_random_seed
    manifest = []
    for i, scene in enumerate(ds.scenes):
        pts = io.load_points_bin(scene.pts_path)
        pts = io.global_alignment(pts, scene.axis_align)
        pts = io.add_height(pts).astype(np.float32)
        choices = reference_choice(len(pts), num_points)
        sampled = pts[choices]
        rel = f"points/{scene.scene_id}.npy"
        np.save(out_dir / rel, sampled)
        manifest.append(
            dict(scene_id=scene.scene_id, pts_file=rel, num_raw=len(pts),
                 info=infos[i])
        )
    meta = dict(num_points=num_points, seed=seed,
                source_ann_file=str(ann_file), scenes=manifest)
    with open(out_dir / "presampled_infos.pkl", "wb") as f:
        pickle.dump(meta, f)
    return out_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--ann-file", default=None,
                   help="defaults to <data-root>/scannet_infos_val.pkl")
    p.add_argument("--out", required=True)
    p.add_argument("--num-points", type=int, default=40000)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ann = args.ann_file or str(Path(args.data_root) / "scannet_infos_val.pkl")
    out = dump_eval_set(args.data_root, ann, args.out, args.num_points,
                        args.seed)
    print(f"pre-sampled eval set written to {out}")
    return out


if __name__ == "__main__":
    main()
