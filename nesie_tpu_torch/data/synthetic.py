"""Synthetic indoor scenes for smoke runs and profiles (numpy, seeded).

``make_scene`` draws a room (floor, four walls, box-shaped objects) as a
surface point cloud; ``semi_batch`` puts such rooms into the batch layout
of the semi-supervised train step.
"""
from __future__ import annotations

import numpy as np
import torch

from nesie_tpu_torch.data import io
from nesie_tpu_torch.data.augment import AugParams


def make_scene(rng: np.random.Generator, n: int, k: int | None = None,
               with_boxes: bool = False):
    """An indoor-like cloud: floor, four walls and ``k`` (6 to 12 when not
    given) box-shaped objects, points on their surfaces. (n, 3) float32,
    metres; with ``with_boxes`` also the objects' (k, 7) bottom-centered
    axis-aligned boxes."""
    room = rng.uniform([4.0, 4.0, 2.5], [8.0, 8.0, 3.0])
    n_floor, n_wall = int(0.3 * n), int(0.3 * n)
    n_obj = n - n_floor - n_wall
    floor = rng.uniform([0, 0, 0], [room[0], room[1], 0.02], (n_floor, 3))
    wall = rng.uniform([0, 0, 0], room, (n_wall, 3))
    side = rng.integers(0, 4, n_wall)
    wall[side == 0, 0] = 0.0
    wall[side == 1, 0] = room[0]
    wall[side == 2, 1] = 0.0
    wall[side == 3, 1] = room[1]
    if k is None:
        k = int(rng.integers(6, 13))
    size = rng.uniform(0.3, 1.5, (k, 3))
    lo = rng.uniform(0, 1, (k, 3)) * (room - size)
    lo[:, 2] = 0.0
    which = rng.integers(0, k, n_obj)
    p = rng.uniform(0, 1, (n_obj, 3))
    axis = rng.integers(0, 3, n_obj)  # snap one coordinate onto a face
    p[np.arange(n_obj), axis] = rng.integers(0, 2, n_obj)
    obj = lo[which] + p * size[which]
    pts = np.concatenate([floor, wall, obj]) + rng.normal(0, 0.005, (n, 3))
    pts = pts[rng.permutation(n)].astype(np.float32)
    if not with_boxes:
        return pts
    boxes = np.concatenate([lo[:, :2] + size[:, :2] / 2, lo[:, 2:3], size,
                            np.zeros((k, 1))], axis=1).astype(np.float32)
    return pts, boxes


def semi_batch(rng, n_labeled: int, n_unlabeled: int, n_points: int,
                max_gt: int, n_boxes: int, dev):
    """A semi-step batch (``train.semi.make_semi_train_step``'s layout) of
    ``make_scene`` rooms on ``dev``: two independent samples of each room
    (the strong and the weak view), ``n_boxes`` GT boxes with random
    classes in the first of ``max_gt`` slots, strong-view augmentation
    drawn from a generator on ``dev`` seeded with 1, identity for the weak
    view; unlabeled slot i draws scan i."""
    b = n_labeled + n_unlabeled
    views, boxes = [], np.zeros((b, max_gt, 7), np.float32)
    labels = np.zeros((b, max_gt), np.int64)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        pts, bx = make_scene(rng, 2 * n_points, k=n_boxes, with_boxes=True)
        views.append((io.add_height(pts[:n_points]),
                      io.add_height(pts[n_points:])))
        boxes[i, :n_boxes] = bx
        labels[i, :n_boxes] = rng.integers(0, 18, n_boxes)
        valid[i, :n_boxes] = True
    gen = torch.Generator(dev).manual_seed(1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dict(
        points_raw_s=t(np.stack([v[0] for v in views]).astype(np.float32)),
        points_raw_t=t(np.stack([v[1] for v in views]).astype(np.float32)),
        gt_boxes=t(boxes), gt_labels=t(labels), gt_valid=t(valid),
        aug_s=AugParams.sample(gen, (b,)),
        aug_t=AugParams.identity((b,), device=dev),
        ulb_scan_idx=t(np.array([0] * n_labeled + list(range(n_unlabeled)))))
