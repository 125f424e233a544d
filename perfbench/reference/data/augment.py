"""Geometric augmentations with an explicit parameter record.

Counterpart of ``nesie_tpu/data/augment.py`` (the reference's RandomFlip3D
/ GlobalRotScaleTrans stages and the teacher-to-student pseudo-box
reprojection). Each sample's augmentation is a function of an
``AugParams`` record, so the inverse and forward replay run on the device.

Order as in the reference pipelines: flips first (horizontal, then
vertical), then rotate -> scale -> translate. Boxes are (..., 7) with a
bottom-centered z.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AugParams(NamedTuple):
    """Per-sample augmentation record; leading dims broadcast over points
    and boxes."""

    flip_h: torch.Tensor  # (...,) bool
    flip_v: torch.Tensor  # (...,) bool
    rot: torch.Tensor     # (...,) radians
    scale: torch.Tensor   # (...,)
    trans: torch.Tensor   # (..., 3)

    @staticmethod
    def identity(batch_shape=(), device="cpu") -> "AugParams":
        shape = tuple(batch_shape)
        return AugParams(
            flip_h=torch.zeros(shape, dtype=torch.bool, device=device),
            flip_v=torch.zeros(shape, dtype=torch.bool, device=device),
            rot=torch.zeros(shape, device=device),
            scale=torch.ones(shape, device=device),
            trans=torch.zeros(shape + (3,), device=device),
        )

    @staticmethod
    def sample(generator: torch.Generator, batch_shape=(),
               flip_ratio_h: float = 0.5, flip_ratio_v: float = 0.5,
               rot_range: float = math.pi / 36,
               scale_range: tuple = (0.85, 1.15),
               translation_std: float = 0.1) -> "AugParams":
        """Random params of the strong train pipeline
        (configs/Nesie/...train-010.py:198-208), drawn from ``generator``
        on its device."""
        shape = tuple(batch_shape)
        kw = dict(generator=generator, device=generator.device)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(shape, **kw)

        return AugParams(
            flip_h=torch.rand(shape, **kw) < flip_ratio_h,
            flip_v=torch.rand(shape, **kw) < flip_ratio_v,
            rot=uniform(-rot_range, rot_range),
            scale=uniform(*scale_range),
            trans=torch.randn(shape + (3,), **kw) * translation_std,
        )

    def to(self, device) -> "AugParams":
        return AugParams(*(t.to(device) for t in self))

    def slice(self, start: int, end: int) -> "AugParams":
        return AugParams(*(t[start:end] for t in self))


def _expand(aug: AugParams, ndim: int):
    """The record's fields with trailing unit dims up to ``ndim`` (the
    rank of a coordinate such as x of (..., N))."""
    fh, fv, rot, scale, trans = aug
    while fh.dim() < ndim:
        fh, fv, rot, scale = fh[..., None], fv[..., None], rot[..., None], \
            scale[..., None]
        trans = trans[..., None, :]
    return fh, fv, rot, scale, trans


def _rot_xy(x, y, angle):
    """Counterclockwise rotation of world points."""
    c, s = torch.cos(angle), torch.sin(angle)
    return x * c - y * s, x * s + y * c


def augment_points(points, aug: AugParams, *, shift_height: bool = False):
    """Flips, R, S, T of (..., N, C>=3) points (xyz first). With
    ``shift_height`` the 4th channel (the height feature) is scaled too."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    fh, fv, rot, scale, trans = _expand(aug, x.dim())
    x = torch.where(fh, -x, x)
    y = torch.where(fv, -y, y)
    x, y = _rot_xy(x, y, rot)
    x = x * scale + trans[..., 0]
    y = y * scale + trans[..., 1]
    z = z * scale + trans[..., 2]
    xyz = torch.stack([x, y, z], dim=-1)
    if points.shape[-1] == 3:
        return xyz
    rest = points[..., 3:]
    if shift_height:
        rest = torch.cat([rest[..., :1] * scale[..., None], rest[..., 1:]],
                         dim=-1)
    return torch.cat([xyz, rest], dim=-1)


def _boxes(cx, cy, cz, size, yaw):
    return torch.cat([torch.stack([cx, cy, cz], -1), size, yaw[..., None]],
                     dim=-1)


def augment_boxes(boxes, aug: AugParams):
    """Flips, R, S, T of (..., K, 7) bottom-centered boxes."""
    cx, cy, cz = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    size, yaw = boxes[..., 3:6], boxes[..., 6]
    fh, fv, rot, scale, trans = _expand(aug, cx.dim())
    cx = torch.where(fh, -cx, cx)
    yaw = torch.where(fh, math.pi - yaw, yaw)
    cy = torch.where(fv, -cy, cy)
    yaw = torch.where(fv, -yaw, yaw)
    cx, cy = _rot_xy(cx, cy, rot)
    yaw = yaw - rot
    cx = cx * scale + trans[..., 0]
    cy = cy * scale + trans[..., 1]
    cz = cz * scale + trans[..., 2]
    return _boxes(cx, cy, cz, size * scale[..., None], yaw)


def unaugment_boxes(boxes, aug: AugParams):
    """Inverse of ``augment_boxes`` (T^-1, S^-1, R^-1, then the flips)."""
    cx, cy, cz = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    size, yaw = boxes[..., 3:6], boxes[..., 6]
    fh, fv, rot, scale, trans = _expand(aug, cx.dim())
    cx = (cx - trans[..., 0]) / scale
    cy = (cy - trans[..., 1]) / scale
    cz = (cz - trans[..., 2]) / scale
    size = size / scale[..., None]
    cx, cy = _rot_xy(cx, cy, -rot)
    yaw = yaw + rot
    cy = torch.where(fv, -cy, cy)
    yaw = torch.where(fv, -yaw, yaw)
    cx = torch.where(fh, -cx, cx)
    yaw = torch.where(fh, math.pi - yaw, yaw)
    return _boxes(cx, cy, cz, size, yaw)


def reproject_boxes(boxes, src_aug: AugParams, dst_aug: AugParams):
    """Teacher-frame -> student-frame pseudo-box reprojection (reference
    transformation_bbox_preds, votenet_nesie.py:310)."""
    return augment_boxes(unaugment_boxes(boxes, src_aug), dst_aug)
