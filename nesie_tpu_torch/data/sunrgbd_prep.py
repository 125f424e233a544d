"""SUN RGB-D preprocessing — Python replacement for the reference's MATLAB
extraction (data/sunrgbd/matlab/extract_rgbd_data_v2.m) + the mmdet3d info
converter it feeds.

Per sample (VoteNet/mmdet3d ``sunrgbd_trainval`` layout):
  * depth: 16-bit png in the raw SUN RGB-D bit-packing, or an already
    extracted ``.npy``/``.bin`` point cloud;
  * calib txt: line 1 = Rtilt (9 floats row-major), line 2 = K (9 floats);
  * label txt (VoteNet format): per line
    ``classname xmin ymin xmax ymax cx cy cz w/2 l/2 h/2 ox oy``.

Depth -> gravity-aligned point cloud (SUNRGBD toolbox ``read3dPoints``):
  d = (raw >> 3) | (raw << 13), in millimeters, clipped at 8m;
  camera frame: x = (u - cx) d / fx, y = (v - cy) d / fy, z = d;
  depth frame: [x, z, -y] @ Rtilt^T.

A copy of ``nesie_tpu/data/sunrgbd_prep.py`` (numpy only; ``imageio``
only for ``.png`` depth).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from nesie_tpu_torch.data.scannet_meta import SUNRGBD_CLASS_NAMES as CLASS_NAMES

CLASS_TO_IDX = {n: i for i, n in enumerate(CLASS_NAMES)}
NUM_CLASSES = len(CLASS_NAMES)


def decode_sunrgbd_depth(raw: np.ndarray) -> np.ndarray:
    """Raw 16-bit SUN RGB-D depth -> meters (toolbox bit-shuffle)."""
    raw = raw.astype(np.uint16)
    d = np.bitwise_or(np.right_shift(raw, 3), np.left_shift(raw, 16 - 3))
    d = d.astype(np.float32) / 1000.0
    d[d > 8.0] = 8.0
    return d


def depth_to_points(depth_m: np.ndarray, K: np.ndarray, rtilt: np.ndarray):
    """Depth map (H, W) in meters -> (N, 3) gravity-aligned points."""
    h, w = depth_m.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    valid = depth_m > 0
    d = depth_m[valid]
    x = (u[valid] - K[0, 2]) * d / K[0, 0]
    y = (v[valid] - K[1, 2]) * d / K[1, 1]
    cam = np.stack([x, d, -y], axis=1)  # [x, z, -y] upright-camera frame
    return (cam @ rtilt.T).astype(np.float32)


def read_calib(path):
    lines = [l.split() for l in open(path)]
    rtilt = np.array(lines[0], np.float64).reshape(3, 3, order="F")
    K = np.array(lines[1], np.float64).reshape(3, 3, order="F")
    return rtilt, K


def read_label(path):
    """VoteNet-format label txt -> (boxes (K, 7) gravity-centered,
    labels (K,)); unknown classes are skipped."""
    boxes, labels = [], []
    for line in open(path):
        parts = line.split()
        if not parts or parts[0] not in CLASS_TO_IDX:
            continue
        cx, cy, cz = (float(x) for x in parts[5:8])
        # half-sizes stored; mmdet3d doubles them (sunrgbd_data_utils)
        w2, l2, h2 = (float(x) for x in parts[8:11])
        ox, oy = float(parts[11]), float(parts[12])
        heading = -np.arctan2(oy, ox)
        boxes.append([cx, cy, cz, w2 * 2, l2 * 2, h2 * 2, heading])
        labels.append(CLASS_TO_IDX[parts[0]])
    if not boxes:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.int64)
    return np.asarray(boxes, np.float32), np.asarray(labels, np.int64)


def export_sample(root, idx: str, rng=None, max_points: int = 50000):
    """Process one sunrgbd_trainval sample id (e.g. '000001')."""
    root = Path(root)
    rng = rng or np.random.default_rng(0)
    rtilt, K = read_calib(root / "calib" / f"{idx}.txt")

    depth_dir = root / "depth"
    npy = depth_dir / f"{idx}.npy"
    if npy.exists():
        points = np.load(npy)[:, :3].astype(np.float32)
    else:
        import imageio.v3 as iio  # optional dependency, gated

        raw = iio.imread(depth_dir / f"{idx}.png")
        points = depth_to_points(decode_sunrgbd_depth(raw), K, rtilt)

    if len(points) > max_points:
        points = points[rng.choice(len(points), max_points, replace=False)]
    boxes, labels = read_label(root / "label" / f"{idx}.txt")
    return dict(points=points, boxes=boxes, labels=labels)


def write_infos(samples, out_dir, split_name: str):
    """samples: iterable of (sample_id, export_sample() dict)."""
    out_dir = Path(out_dir)
    (out_dir / "points").mkdir(parents=True, exist_ok=True)
    infos = []
    for sid, data in samples:
        pts_path = f"points/{sid}.bin"
        pts = data["points"].astype(np.float32)
        if pts.shape[1] == 3:  # pad rgb columns for load_dim=6 readers
            pts = np.concatenate([pts, np.zeros_like(pts)], axis=1)
        pts.tofile(out_dir / pts_path)
        infos.append(
            dict(
                point_cloud=dict(num_features=6, lidar_idx=sid),
                pts_path=pts_path,
                annos={
                    "gt_num": len(data["boxes"]),
                    "gt_boxes_upright_depth": data["boxes"],
                    "class": data["labels"],
                    "axis_align_matrix": np.eye(4, dtype=np.float32),
                },
            )
        )
    with open(out_dir / f"sunrgbd_infos_{split_name}.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos
