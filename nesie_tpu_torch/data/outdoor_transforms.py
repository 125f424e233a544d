"""Outdoor-style augmentations (reference pipelines/transforms_3d.py's
ObjectSample / ObjectNoise / PointsRangeFilter / ObjectRangeFilter —
unused by the indoor configs, kept for capability parity). Numpy
host-side ops like the reference; GT-paste sampling lives in
data/dbsampler.py. A copy of ``nesie_tpu/data/outdoor_transforms.py``, so
that the port does not import the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..core.np_box_ops import points_in_rbbox


def object_sample(points, boxes, labels, sampler):
    """GT-paste: add database objects, drop original points inside them
    (reference ObjectSample.__call__ transforms_3d.py:273-328: sampled
    points are prepended, pasted boxes/labels appended).

    Args:
        points: (N, C); boxes: (K, 7) bottom-centered; labels: (K,) int;
        sampler: a data.dbsampler.DataBaseSampler.
    Returns:
        new_points, new_boxes, new_labels.
    """
    ret = sampler.sample_all(boxes, labels)
    if ret is None:
        return points, boxes, labels
    s_boxes = ret["gt_bboxes_3d"]
    s_points = ret["points"]
    keep = ~points_in_rbbox(points[:, :3], s_boxes).any(-1)
    points = points[keep]
    if s_points.shape[1] < points.shape[1]:  # pad extra feature channels
        pad = np.zeros(
            (len(s_points), points.shape[1] - s_points.shape[1]), points.dtype
        )
        s_points = np.concatenate([s_points, pad], axis=1)
    else:
        s_points = s_points[:, :points.shape[1]]
    return (
        np.concatenate([s_points.astype(points.dtype), points], axis=0),
        np.concatenate([boxes, s_boxes], axis=0),
        np.concatenate([labels, ret["gt_labels_3d"].astype(labels.dtype)]),
    )


def points_range_filter(points, point_range):
    """Keep points inside (x0, y0, z0, x1, y1, z1)."""
    lo = np.asarray(point_range[:3])
    hi = np.asarray(point_range[3:])
    m = np.all((points[:, :3] >= lo) & (points[:, :3] <= hi), axis=1)
    return points[m]


def object_range_filter(boxes, labels, bev_range):
    """Drop boxes whose centers leave the BEV range (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = bev_range
    m = (
        (boxes[:, 0] >= x0) & (boxes[:, 0] <= x1)
        & (boxes[:, 1] >= y0) & (boxes[:, 1] <= y1)
    )
    return boxes[m], labels[m]


def object_noise(points, boxes, rng, translation_std=(0.25, 0.25, 0.25),
                 rot_range=(-0.157, 0.157), num_try: int = 1):
    """Per-object jitter: translate/rotate each GT box and the points inside
    it (reference ObjectNoise semantics, simplified to the accepted-move
    case; collision rejection between boxes is not modeled).

    Args:
        points: (N, >=3); boxes: (K, 7) bottom-centered.
    Returns:
        new_points, new_boxes.
    """
    points = points.copy()
    boxes = boxes.copy()
    for k in range(len(boxes)):
        t = rng.normal(scale=translation_std, size=3)
        a = rng.uniform(*rot_range)
        c, s = np.cos(a), np.sin(a)
        cx, cy = boxes[k, 0], boxes[k, 1]
        d = points[:, :3] - boxes[k, :3]
        half = boxes[k, 3:6] / 2
        lx = np.cos(boxes[k, 6]) * d[:, 0] - np.sin(boxes[k, 6]) * d[:, 1]
        ly = np.sin(boxes[k, 6]) * d[:, 0] + np.cos(boxes[k, 6]) * d[:, 1]
        inside = (
            (np.abs(lx) < half[0]) & (np.abs(ly) < half[1])
            & (d[:, 2] >= 0) & (d[:, 2] <= boxes[k, 5])
        )
        p = points[inside, :3]
        # rotate around the box center, then translate
        px = p[:, 0] - cx
        py = p[:, 1] - cy
        points[inside, 0] = cx + px * c - py * s + t[0]
        points[inside, 1] = cy + px * s + py * c + t[1]
        points[inside, 2] = p[:, 2] + t[2]
        boxes[k, :3] += t
        boxes[k, 6] -= a
    return points, boxes
