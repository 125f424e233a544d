"""Coordinate-mode conversions between Depth / LiDAR / Camera box frames
(reference mmdet3d/core/bbox/structures/box_3d_mode.py +
coord_3d_mode.py). Counterpart of ``nesie_tpu/core/box_modes.py``. Boxes
are plain (..., 7) tensors.

Conventions (reference box_3d_mode.py:85-131):
  DEPTH -> LIDAR: p' = (y, -x, z);      sizes (sy, sx, sz); yaw unchanged
  LIDAR -> DEPTH: p' = (-y, x, z);      sizes (sy, sx, sz); yaw unchanged
  DEPTH -> CAM:   p' = (x, z, -y);      sizes (sx, sz, sy); yaw unchanged
  CAM  -> DEPTH:  p' = (x, -z, y);      sizes (sx, sz, sy); yaw unchanged
  LIDAR -> CAM:   p' = (-y, -z, x);     sizes (sy, sz, sx); yaw unchanged
  CAM  -> LIDAR:  p' = (z, -x, -y);     sizes (sz, sx, sy); yaw unchanged

Two reference quirks kept as they are: the direct LIDAR<->CAM matrices are
not the composition through DEPTH, and DEPTH<->CAM for boxes is the
inverse of DEPTH<->CAM for points (``convert_points`` follows the points
convention). Every conversion only permutes and negates, so round trips
are exact.
"""
from __future__ import annotations

import torch


def _swap(b, perm, signs):
    xyz = torch.stack([signs[i] * b[..., perm[i]] for i in range(3)], dim=-1)
    size = torch.stack([b[..., p + 3] for p in perm], dim=-1)
    return torch.cat([xyz, size, b[..., 6:7]], dim=-1)


def depth_to_lidar(boxes):
    return _swap(boxes, (1, 0, 2), (1.0, -1.0, 1.0))


def lidar_to_depth(boxes):
    return _swap(boxes, (1, 0, 2), (-1.0, 1.0, 1.0))


def depth_to_cam(boxes):
    return _swap(boxes, (0, 2, 1), (1.0, 1.0, -1.0))


def cam_to_depth(boxes):
    return _swap(boxes, (0, 2, 1), (1.0, -1.0, 1.0))


def lidar_to_cam(boxes):
    return _swap(boxes, (1, 2, 0), (-1.0, -1.0, 1.0))


def cam_to_lidar(boxes):
    return _swap(boxes, (2, 0, 1), (1.0, -1.0, -1.0))


def convert_points(points, src: str, dst: str):
    """Convert (..., >=3) point xyz between frames (Coord3DMode.convert)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    key = (src.upper(), dst.upper())
    if key == ("DEPTH", "LIDAR"):
        out = torch.stack([y, -x, z], dim=-1)
    elif key == ("LIDAR", "DEPTH"):
        out = torch.stack([-y, x, z], dim=-1)
    elif key == ("DEPTH", "CAM"):
        out = torch.stack([x, -z, y], dim=-1)
    elif key == ("CAM", "DEPTH"):
        out = torch.stack([x, z, -y], dim=-1)
    elif key == ("LIDAR", "CAM"):
        out = torch.stack([-y, -z, x], dim=-1)
    elif key == ("CAM", "LIDAR"):
        out = torch.stack([z, -x, -y], dim=-1)
    elif src.upper() == dst.upper():
        out = points[..., :3]
    else:
        raise ValueError(f"unsupported conversion {src}->{dst}")
    if points.shape[-1] > 3:
        out = torch.cat([out, points[..., 3:]], dim=-1)
    return out
