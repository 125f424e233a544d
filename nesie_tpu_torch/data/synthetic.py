"""Synthetic indoor scenes for smoke runs, profiles, tests and studies
(numpy, seeded).

``make_scene`` draws a room (floor, four walls, box-shaped objects) as a
surface point cloud; ``semi_batch`` puts such rooms into the batch layout
of the semi-supervised train step.

``make_synthetic_scene(s)`` and ``write_synthetic_scannet`` are copies of
``nesie_tpu/data/synthetic.py``: rooms with class-sized box objects over
a floor, written in the on-disk ScanNet format by
``scannet_prep.write_infos`` (``points/*.bin``, infos pkls, split
lists), so that a machine without the JAX package can
make a dataset the runner and the CLIs read.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch.data import io
from nesie_tpu_torch.data.augment import AugParams
from nesie_tpu_torch.data.dataset import Scene
from nesie_tpu_torch.data.scannet_meta import VALID_CAT_IDS
from nesie_tpu_torch.data.scannet_prep import write_infos


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


def class_size_prototypes(num_classes: int = 18):
    """Deterministic per-class size prototypes, spread over [0.3, 1.2]^3
    on independent cycles so classes are geometrically distinguishable —
    without this, class labels are noise and *held-out* mAP is zero by
    construction (only memorization could ever score)."""
    i = np.arange(num_classes)
    return np.stack(
        [
            0.3 + 0.9 * ((i * 5) % num_classes) / max(num_classes - 1, 1),
            0.3 + 0.9 * ((i * 7 + 3) % num_classes) / max(num_classes - 1, 1),
            0.3 + 0.9 * ((i * 11 + 6) % num_classes) / max(num_classes - 1, 1),
        ],
        axis=1,
    )


def make_synthetic_scene(
    rng: np.random.Generator,
    scene_id: str,
    num_classes: int = 18,
    num_objects=(3, 8),
    room: float = 6.0,
    points_per_object: int = 600,
    floor_points: int = 4000,
    class_sizes: bool = True,
    yaw_range: float = 0.0,
):
    """Returns a Scene with pre-loaded (N, 6) points and GT boxes.

    With ``class_sizes`` (default) object dimensions come from per-class
    prototypes plus ±15% noise, so semantic classification is learnable
    across scenes; with ``class_sizes=False`` sizes and labels are
    independent.

    ``yaw_range > 0`` rotates each object (points + box yaw) uniformly in
    [-yaw_range, yaw_range] — the SUN RGB-D with_yaw=True regime."""
    protos = class_size_prototypes(num_classes)
    k = int(rng.integers(*num_objects))
    boxes, labels, clusters = [], [], []
    for _ in range(k):
        label = int(rng.integers(0, num_classes))
        if class_sizes:
            size = protos[label] * rng.uniform(0.85, 1.15, 3)
        else:
            size = rng.uniform(0.3, 1.2, 3)
        center = np.array(
            [
                rng.uniform(-room / 2 + 1, room / 2 - 1),
                rng.uniform(-room / 2 + 1, room / 2 - 1),
                size[2] / 2,
            ]
        )
        # surface samples of the box
        p = rng.uniform(-0.5, 0.5, (points_per_object, 3))
        axis = rng.integers(0, 3, points_per_object)
        sign = rng.choice([-0.5, 0.5], points_per_object)
        p[np.arange(points_per_object), axis] = sign
        yaw = float(rng.uniform(-yaw_range, yaw_range)) if yaw_range else 0.0
        local = p * size
        if yaw:
            # box-frame -> world is clockwise by yaw (core/boxes.py)
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            local = local @ rot.T
        pts = center + local
        boxes.append(np.concatenate([center, size, [yaw]]))
        labels.append(label)
        clusters.append(pts)

    floor = np.stack(
        [
            rng.uniform(-room / 2, room / 2, floor_points),
            rng.uniform(-room / 2, room / 2, floor_points),
            np.abs(rng.normal(0, 0.01, floor_points)),
        ],
        axis=1,
    )
    xyz = np.concatenate([floor] + clusters).astype(np.float32)
    rgb = np.zeros_like(xyz)
    points = np.concatenate([xyz, rgb], axis=1)

    boxes = np.stack(boxes).astype(np.float32)
    boxes[:, 2] -= boxes[:, 5] / 2  # bottom-centered, dataset convention
    return Scene(
        scene_id=scene_id,
        pts_path=None,
        boxes=boxes,
        labels=np.asarray(labels, np.int64),
        axis_align=np.eye(4, dtype=np.float32),
        points=points,
    )


def make_synthetic_scenes(n: int, seed: int = 0, prefix: str = "synth", **kw):
    rng = np.random.default_rng(seed)
    return [
        make_synthetic_scene(rng, f"{prefix}{i:04d}", **kw) for i in range(n)
    ]


def scene_to_scannet_export(scene):
    """Convert a synthetic Scene to the ScanNet export dict layout
    (gravity-centered boxes, nyu40 category id in column 6) that
    ``write_infos`` takes."""
    boxes = scene.boxes.copy()
    boxes[:, 2] += boxes[:, 5] / 2  # bottom-center -> gravity center
    cat = np.array([VALID_CAT_IDS[int(l)] for l in scene.labels], np.float32)
    boxes = np.concatenate([boxes[:, :6], cat[:, None]], axis=1)
    return dict(
        points=scene.points.astype(np.float32),
        boxes=boxes.astype(np.float32),
        axis_align_matrix=scene.axis_align.astype(np.float32),
    )


def write_synthetic_scannet(out_dir, n_train: int, n_val: int, seed: int = 0,
                            **scene_kw):
    """Write a synthetic dataset in on-disk ScanNet format (points/*.bin +
    infos pkls + meta_data split lists) so the full file-backed data path
    is exercised. Returns the out_dir Path."""
    out_dir = Path(out_dir)
    train = make_synthetic_scenes(n_train, seed=seed, **scene_kw)
    # distinct val ids — train and val .bin files share one points/ dir,
    # so reusing the id pattern would silently overwrite train scenes
    val = make_synthetic_scenes(n_val, seed=seed + 1, prefix="synthval",
                                **scene_kw)
    if {s.scene_id for s in train} & {s.scene_id for s in val}:
        raise ValueError("train and val scene ids overlap")
    write_infos([(s.scene_id, scene_to_scannet_export(s)) for s in train],
                out_dir, "train")
    write_infos([(s.scene_id, scene_to_scannet_export(s)) for s in val],
                out_dir, "val")
    meta = out_dir / "meta_data"
    meta.mkdir(exist_ok=True)
    names = [s.scene_id for s in train]
    for frac_name, frac in (("0.05", 0.05), ("0.1", 0.1), ("0.2", 0.2),
                            ("0.5", 0.5)):
        k = max(2, int(round(len(names) * frac)))
        (meta / f"scannetv2_train_{frac_name}.txt").write_text(
            "\n".join(names[:k]) + "\n")
    (meta / "scannetv2_train_all.txt").write_text("\n".join(names) + "\n")
    return out_dir
