"""NumPy box math (reference mmdet3d/core/bbox/box_np_ops.py — the host
-side helpers used by data prep and offline tooling).

A copy of ``nesie_tpu/core/np_box_ops.py``, so that the port does not
import the JAX package.
"""
from __future__ import annotations

import numpy as np


def rotation_points_single_angle(points, angle, axis: int = 2):
    """Rotate (N, 3) points about one axis (box_np_ops semantics: clockwise
    for axis=2 with the depth convention, matching rotation_3d_in_axis)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 2:
        # applied as points @ rot: world = clockwise-by-angle (matches
        # core.boxes.rotate_points_z)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    elif axis == 1:
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    else:
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return points @ rot


def center_to_corner_box3d(centers, dims, angles, origin=(0.5, 0.5, 0.5)):
    """(N, 3) centers + (N, 3) dims + (N,) yaw -> (N, 8, 3) corners."""
    signs = np.stack(
        np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), -1
    ).reshape(8, 3)[[0, 1, 3, 2, 4, 5, 7, 6]]
    local = (signs - np.asarray(origin)) * dims[:, None, :]
    out = np.empty((len(centers), 8, 3))
    for i in range(len(centers)):
        out[i] = rotation_points_single_angle(local[i], angles[i]) + centers[i]
    return out


def corner_to_standup_nd(corners):
    """(N, 8, 3) corners -> (N, 6) axis-aligned minmax boxes."""
    return np.concatenate([corners.min(1), corners.max(1)], axis=1)


def points_in_rbbox(points, boxes, origin=(0.5, 0.5, 0)):
    """(N, >=3) points x (K, 7) boxes -> (N, K) bool (numpy mirror of
    core.boxes.points_in_boxes; z faces inclusive, xy exclusive)."""
    centers = boxes[:, :3].copy()
    if origin[2] == 0:  # bottom-centered input
        centers[:, 2] += boxes[:, 5] / 2
    d = points[:, None, :3] - centers[None]
    c = np.cos(boxes[:, 6])[None]
    s = np.sin(boxes[:, 6])[None]
    lx = c * d[..., 0] - s * d[..., 1]
    ly = s * d[..., 0] + c * d[..., 1]
    half = boxes[None, :, 3:6] / 2
    return (
        (np.abs(lx) < half[..., 0])
        & (np.abs(ly) < half[..., 1])
        & (np.abs(d[..., 2]) <= half[..., 2])
    )


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    return val - np.floor(val / period + offset) * period


def center_to_corner_box2d(centers, dims, angles):
    """(N, 2) BEV centers + (N, 2) dims + (N,) yaw -> (N, 4, 2) corners
    in consistent winding (the 2D slice of center_to_corner_box3d)."""
    local = (
        np.array([[-1, -1], [-1, 1], [1, 1], [1, -1]], np.float64) / 2
    )[None] * dims[:, None, :]
    c, s = np.cos(angles), np.sin(angles)
    # clockwise-by-yaw, matching rotation_points_single_angle(axis=2)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2
    )  # (N, 2, 2), applied as local @ rot
    return np.einsum("nkj,nji->nki", local, rot) + centers[:, None, :]


def _cross2(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]
    ) * (b[..., 0] - o[..., 0])


def box_collision_test(corners_a, corners_b, literal_reference=False):
    """(N, 4, 2) x (M, 4, 2) rotated BEV corner collision matrix.

    Reference semantics (data_augment_utils.box_collision_test): standup
    prefilter, then convex-quad overlap = any proper edge intersection or
    either quad's vertex inside the other. Exact edge-touching (shared
    boundary, zero-area overlap) is treated as non-colliding.

    The reference's complete-containment branch is dead code: its cross-sign
    convention assumes the opposite winding from what the reference's own
    ``center_to_corner_box2d`` produces, so a box fully inside another is
    never flagged (verified against the reference in
    tests/test_reference_oracle.py; see REFERENCE_QUIRKS.md). The default
    here fixes that (containment counts as collision); pass
    ``literal_reference=True`` for bit-parity with the reference.
    """
    corners_a = np.asarray(corners_a, np.float64)
    corners_b = np.asarray(corners_b, np.float64)
    N, M = len(corners_a), len(corners_b)
    if N == 0 or M == 0:
        return np.zeros((N, M), bool)

    lo_a, hi_a = corners_a.min(1), corners_a.max(1)  # (N, 2)
    lo_b, hi_b = corners_b.min(1), corners_b.max(1)
    standup = np.all(
        (np.minimum(hi_a[:, None], hi_b[None])
         - np.maximum(lo_a[:, None], lo_b[None])) > 0,
        axis=-1,
    )  # (N, M)

    nxt = [1, 2, 3, 0]
    a1 = corners_a[:, None, :, None, :]          # (N, 1, 4, 1, 2)
    a2 = corners_a[:, nxt][:, None, :, None, :]
    b1 = corners_b[None, :, None, :, :]          # (1, M, 1, 4, 2)
    b2 = corners_b[:, nxt][None, :, None, :, :]
    d1 = _cross2(a1, a2, b1)
    d2 = _cross2(a1, a2, b2)
    d3 = _cross2(b1, b2, a1)
    d4 = _cross2(b1, b2, a2)
    edge_hit = np.any(
        (d1 * d2 < 0) & (d3 * d4 < 0), axis=(2, 3)
    )  # proper segment crossings, (N, M)

    def _contains(quads, pts):
        # quads (Q, 4, 2), pts (P, 4, 2) -> (Q, P) any point inside quad
        e0 = quads[:, :, None, None, :]                 # (Q, 4, 1, 1, 2)
        e1 = quads[:, nxt][:, :, None, None, :]
        p = pts[None, None, :, :, :]                    # (1, 1, P, 4, 2)
        cr = _cross2(e0, e1, p)                         # (Q, 4, P, 4)
        inside = np.all(cr > 0, axis=1) | np.all(cr < 0, axis=1)  # (Q, P, 4)
        return np.any(inside, axis=-1)

    if literal_reference:
        return standup & edge_hit
    contain = _contains(corners_a, corners_b) | _contains(
        corners_b, corners_a
    ).T
    return standup & (edge_hit | contain)
