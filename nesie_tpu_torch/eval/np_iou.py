"""NumPy pairwise rotated 3D IoU for offline evaluation.

Mirrors reference ``BaseInstance3DBoxes.overlaps`` (base_box3d.py:387):
rotated BEV polygon intersection x height overlap / union, computed for the
full (N, M) pair matrix, with the 24-candidate-vertex clipping algorithm
of the box IoU, in vectorized numpy (eval runs on the host). A copy of
``nesie_tpu/eval/np_iou.py``.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _bev_corners(b5):
    x, y, w, h, a = (b5[..., i] for i in range(5))
    sx = np.array([0.5, -0.5, -0.5, 0.5]) * w[..., None]
    sy = np.array([0.5, 0.5, -0.5, -0.5]) * h[..., None]
    c, s = np.cos(a)[..., None], np.sin(a)[..., None]
    return np.stack([sx * c - sy * s + x[..., None], sx * s + sy * c + y[..., None]], -1)


def _pair_intersection_area(c1, c2):
    """c1, c2: (..., 4, 2) -> (...,) intersection polygon area."""
    roll = [1, 2, 3, 0]
    l1 = np.concatenate([c1, c1[..., roll, :]], -1)[..., :, None, :]
    l2 = np.concatenate([c2, c2[..., roll, :]], -1)[..., None, :, :]
    x1, y1, x2, y2 = (l1[..., i] for i in range(4))
    x3, y3, x4, y4 = (l2[..., i] for i in range(4))
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_raw = den_t / (num + _EPS)
        t = np.where(num == 0, -1.0, t_raw)
        den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
        u = np.where(num == 0, -1.0, -den_u / (num + _EPS))
    mask_i = (t > 0) & (t < 1) & (u > 0) & (u < 1)
    inter = np.stack([x1 + t_raw * (x2 - x1), y1 + t_raw * (y2 - y1)], -1)
    inter = inter * mask_i[..., None]

    def in_box(ca, cb):
        a = cb[..., 0:1, :]
        ab = cb[..., 1:2, :] - a
        ad = cb[..., 3:4, :] - a
        am = ca - a
        pab = np.sum(ab * am, -1) / np.maximum(np.sum(ab * ab, -1), _EPS)
        pad = np.sum(ad * am, -1) / np.maximum(np.sum(ad * ad, -1), _EPS)
        return (pab > -1e-6) & (pab < 1 + 1e-6) & (pad > -1e-6) & (pad < 1 + 1e-6)

    batch = c1.shape[:-2]
    verts = np.concatenate([c1, c2, inter.reshape(batch + (16, 2))], -2)
    mask = np.concatenate([in_box(c1, c2), in_box(c2, c1), mask_i.reshape(batch + (16,))], -1)

    nv = mask.sum(-1)
    denom = np.maximum(nv, 1)[..., None]
    mean = (verts * mask[..., None]).sum(-2) / denom
    centered = verts - mean[..., None, :]
    ang = np.arctan2(centered[..., 1], centered[..., 0])
    key = np.where(mask, ang, np.inf)
    order = np.argsort(key, -1)
    sv = np.take_along_axis(centered, order[..., None], -2)
    sm = np.take_along_axis(mask, order, -1)
    sv = sv * sm[..., None]
    x, y = sv[..., 0], sv[..., 1]
    partial = np.sum(x[..., :-1] * y[..., 1:] - y[..., :-1] * x[..., 1:], -1)
    last = np.maximum(nv - 1, 0)
    xl = np.take_along_axis(x, last[..., None], -1)[..., 0]
    yl = np.take_along_axis(y, last[..., None], -1)[..., 0]
    area = np.abs(partial + xl * y[..., 0] - yl * x[..., 0]) / 2
    return np.where(nv > 0, area, 0.0)


def pairwise_iou3d(boxes1, boxes2, bev: str = "ccw"):
    """(N, 7) x (M, 7) gravity-centered boxes -> (N, M) rotated 3D IoU.

    ``bev`` selects the BEV rotation convention:
      * ``"ccw"`` — corners rotated counterclockwise by +yaw, matching the
        box classes / the reference's differentiable ``cal_iou_3d``.
      * ``"cw_kernel"`` — the reference's iou3d CUDA kernel
        (iou3d_kernel.cu:111-117 rotates corners by R(-yaw)), which
        ``BaseInstance3DBoxes.overlaps`` (base_box3d.py:387) and
        ``nms_gpu`` feed at eval time; equivalent to ccw on yaw-negated
        boxes. Identical for axis-aligned (yaw=0) boxes; a mirror image
        for yawed ones (REFERENCE_QUIRKS.md item 11).
    """
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    if bev == "cw_kernel":
        boxes1 = np.concatenate([boxes1[:, :6], -boxes1[:, 6:7]], 1)
        boxes2 = np.concatenate([boxes2[:, :6], -boxes2[:, 6:7]], 1)
    a = np.repeat(boxes1[:, None], m, 1)  # (N, M, 7)
    b = np.repeat(boxes2[None], n, 0)
    c1 = _bev_corners(a[..., [0, 1, 3, 4, 6]])
    c2 = _bev_corners(b[..., [0, 1, 3, 4, 6]])
    inter2d = _pair_intersection_area(c1, c2)
    top = np.minimum(a[..., 2] + a[..., 5] / 2, b[..., 2] + b[..., 5] / 2)
    bot = np.maximum(a[..., 2] - a[..., 5] / 2, b[..., 2] - b[..., 5] / 2)
    hz = np.clip(top - bot, 0, None)
    inter = inter2d * hz
    v1 = a[..., 3] * a[..., 4] * a[..., 5]
    v2 = b[..., 3] * b[..., 4] * b[..., 5]
    return inter / np.maximum(v1 + v2 - inter, 1e-8)
