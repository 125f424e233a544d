"""Host-side data loading primitives (numpy only).

A copy of ``nesie_tpu/data/io.py``, so that the port does not import the
JAX package. The reference pipeline stages that run before augmentation
(mmdet3d/datasets/pipelines/loading.py + transforms_3d.py):

  * ``load_points_bin``: float32 .bin files, ``load_dim`` columns, keep xyz
    (loading.py:333, use_dim=[0,1,2]);
  * ``global_alignment``: apply the 4x4 axis-align matrix
    (transforms_3d.py:410, rotation_axis=2);
  * ``add_height``: the shift_height feature, z minus the 1st-percentile
    floor (loading.py:86-92);
  * ``sample_points``: IndoorPointSample's random choice of N points, with
    replacement iff the cloud has fewer than N (transforms_3d.py:821).

Also reads mmdet3d-format ``scannet_infos_*.pkl`` files.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def load_points_bin(path, load_dim: int = 6, use_dim=(0, 1, 2)):
    pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, load_dim)
    return pts[:, list(use_dim)]


def global_alignment(points, axis_align_matrix):
    """Apply the scene's 4x4 axis-alignment to xyz columns."""
    m = np.asarray(axis_align_matrix, np.float32)
    xyz = points[:, :3] @ m[:3, :3].T + m[:3, 3]
    return np.concatenate([xyz, points[:, 3:]], axis=1)


def add_height(points):
    """Append the shift_height channel (z minus the 1%-percentile floor)."""
    floor = np.percentile(points[:, 2], 0.99)
    height = points[:, 2] - floor
    return np.concatenate([points, height[:, None]], axis=1)


def sample_points(points, num_points: int, rng: np.random.Generator):
    n = points.shape[0]
    choice = rng.choice(n, num_points, replace=n < num_points)
    return points[choice]


def load_infos(path):
    """Read an mmdet3d scannet_infos pkl: a list of per-scene dicts."""
    with open(path, "rb") as f:
        return pickle.load(f)


def scene_from_info(info, data_root):
    """Extract (pts_path, boxes (K,7) bottom-centered, labels (K,),
    axis_align_matrix) from one mmdet3d info dict."""
    pts_path = Path(data_root) / info["pts_path"]
    ann = info.get("annos", {})
    if ann.get("gt_num", 0) > 0:
        boxes = np.asarray(ann["gt_boxes_upright_depth"], np.float32).copy()
        if boxes.shape[1] == 6:
            boxes = np.concatenate(
                [boxes, np.zeros((len(boxes), 1), np.float32)], axis=1
            )
        # stored z is the gravity center (ScanNetDataset passes
        # origin=(0.5, 0.5, 0.5), scannet_dataset.py:97-101); the batch
        # convention is bottom-centered
        boxes[:, 2] -= boxes[:, 5] / 2.0
        labels = np.asarray(ann["class"], np.int64)
    else:
        boxes = np.zeros((0, 7), np.float32)
        labels = np.zeros((0,), np.int64)
    aam = ann.get("axis_align_matrix", np.eye(4, dtype=np.float32))
    return pts_path, boxes, labels, np.asarray(aam, np.float32)
