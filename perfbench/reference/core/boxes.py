"""3D box geometry in the Depth convention.

Counterpart of ``nesie_tpu/core/boxes.py``. A box is ``(cx, cy, cz, sx,
sy, sz, yaw)`` with a gravity center unless a function says otherwise.
Box frame -> world is a clockwise rotation by yaw about +z:
``world_x = c*lx + s*ly``, ``world_y = -s*lx + c*ly``.
"""
from __future__ import annotations

import torch

# corner order of the reference (depth_box3d.py:56)
_CORNER_SIGNS = (
    (-0.5, -0.5, -0.5), (-0.5, -0.5, 0.5), (-0.5, 0.5, 0.5),
    (-0.5, 0.5, -0.5), (0.5, -0.5, -0.5), (0.5, -0.5, 0.5),
    (0.5, 0.5, 0.5), (0.5, 0.5, -0.5),
)


def limit_period(val, offset: float = 0.5, period: float = torch.pi):
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    """Box-frame -> world rotation matrices, ``angle.shape + (3, 3)``,
    applied as ``out_i = sum_j p_j R[j, i]``."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def rotate_points_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points (..., P, 3) in the box frame, angle (...) -> world frame."""
    return torch.einsum("...pj,...ji->...pi", points, rotation_z(angle))


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) gravity-centered boxes -> (..., 8, 3) corners."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype, device=boxes.device)
    local = signs * boxes[..., None, 3:6]
    return rotate_points_z(local, boxes[..., 6]) + boxes[..., None, :3]


def corners_minmax(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) corners -> (..., 6) axis-aligned (min_xyz, max_xyz)."""
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def gravity_center_of(bottom_boxes: torch.Tensor) -> torch.Tensor:
    """Gravity centers of bottom-centered boxes (..., >=6) -> (..., 3)."""
    return torch.stack([bottom_boxes[..., 0], bottom_boxes[..., 1],
                        bottom_boxes[..., 2] + 0.5 * bottom_boxes[..., 5]],
                       dim=-1)


def box_to_surface(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes -> the 6 face coordinates ``(x1, y1, z1, x2, y2, z2)`` of the
    axis-aligned box around the center, yaw ignored (reference
    ``Bbox2Surface``, surface_loss.py:90)."""
    c, s = boxes[..., :3], boxes[..., 3:6]
    return torch.cat([c - 0.5 * s, c + 0.5 * s], dim=-1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor, *,
                    bottom_center: bool = True) -> torch.Tensor:
    """Which box every point falls into: points (..., N, 3), boxes
    (..., K, 7) -> (..., N, K) bool. z test inclusive of the faces, xy
    test exclusive; offsets rotated counterclockwise by +yaw into the box
    frame (reference points_in_boxes_cuda.cu:34-49)."""
    centers = boxes[..., :3]
    if bottom_center:
        centers = torch.cat([centers[..., :2],
                             centers[..., 2:3] + 0.5 * boxes[..., 5:6]], -1)
    d = points[..., :, None, :3] - centers[..., None, :, :]  # (..., N, K, 3)
    yaw = boxes[..., 6]
    c = torch.cos(yaw)[..., None, :]
    s = torch.sin(yaw)[..., None, :]
    local_x = c * d[..., 0] - s * d[..., 1]
    local_y = s * d[..., 0] + c * d[..., 1]
    half = 0.5 * boxes[..., None, :, 3:6]
    return ((local_x.abs() < half[..., 0]) & (local_y.abs() < half[..., 1])
            & (d[..., 2].abs() <= half[..., 2]))
