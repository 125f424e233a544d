"""GT-paste ("copy-paste") augmentation from a ground-truth database.

Host-side numpy, like the rest of the data layer: this runs in the input
pipeline, never on the card. A copy of ``nesie_tpu/data/dbsampler.py``,
so that the port does not import the JAX package. Mirrors the reference's sampler semantics
(mmdet3d/datasets/pipelines/dbsampler.py):

- ``BatchSampler`` (dbsampler.py:12-77): shuffled round-robin *without*
  replacement; when a request crosses the end of the pool it returns only
  the remainder and reshuffles.
- ``DataBaseSampler.sample_all`` (dbsampler.py:190-283): per class,
  target count = round(rate * (max_sample_num - #existing of that class));
  classes are processed sequentially and every accepted box joins the
  avoid-collision set for later classes.
- ``sample_class_v2`` (dbsampler.py:285-330): greedy rejection against a
  BEV rotated-polygon collision matrix; a rejected sample's row/column is
  zeroed so later samples colliding only with rejected ones survive.
- Per-object point files store coordinates relative to the box (bottom)
  center; pasting translates them back (dbsampler.py:252-259).

Database creation follows the reference's
tools/data_converter/create_gt_database.py: crop each annotated box's
points, store them box-relative, and record
``{name, path, box3d_lidar, num_points_in_gt, difficulty}`` per object.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..core.np_box_ops import (
    box_collision_test,
    center_to_corner_box2d,
    points_in_rbbox,
)
from .io import load_points_bin


class BatchSampler:
    """Shuffled round-robin sampling without replacement over one class."""

    def __init__(self, sampled_list, rng: np.random.Generator | None = None):
        self._list = sampled_list
        self._rng = rng if rng is not None else np.random.default_rng()
        self._indices = np.arange(len(sampled_list))
        self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num: int):
        """May return fewer than ``num`` when the pool wraps (reference
        BatchSampler._sample returns the remainder and reshuffles)."""
        n = len(self._list)
        if n == 0:
            return []
        if self._idx + num >= n:
            picked = self._indices[self._idx:].copy()
            self._rng.shuffle(self._indices)
            self._idx = 0
        else:
            picked = self._indices[self._idx:self._idx + num]
            self._idx += num
        return [self._list[i] for i in picked]


class DataBaseSampler:
    """Samples GT objects from a database, avoiding BEV collisions.

    Args:
        info_path: pickle of {class_name: [info, ...]}.
        data_root: root that info['path'] entries are relative to.
        rate: fraction of the per-class deficit actually sampled.
        prepare: {"filter_by_min_points": {cls: n}, and/or
            "filter_by_difficulty": [levels]} applied at load time.
        sample_groups: {class_name: max_sample_num}.
        classes: ordered class names (label = index).
        point_dims: feature width of the stored per-object point files.
    """

    def __init__(self, info_path, data_root, rate, prepare, sample_groups,
                 classes, point_dims: int = 4,
                 rng: np.random.Generator | None = None):
        self.data_root = Path(data_root) if data_root else None
        self.rate = float(rate)
        self.classes = list(classes)
        self.cat2label = {n: i for i, n in enumerate(self.classes)}
        self.point_dims = int(point_dims)
        self._rng = rng if rng is not None else np.random.default_rng()

        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        for fn_name, val in (prepare or {}).items():
            db_infos = getattr(self, fn_name)(db_infos, val)
        self.db_infos = db_infos

        self.sample_classes = list(sample_groups.keys())
        self.sample_max_nums = [int(v) for v in sample_groups.values()]
        self.sampler_dict = {
            k: BatchSampler(v, self._rng) for k, v in db_infos.items()
        }

    @staticmethod
    def filter_by_difficulty(db_infos, removed_difficulty):
        return {
            k: [i for i in v if i["difficulty"] not in removed_difficulty]
            for k, v in db_infos.items()
        }

    @staticmethod
    def filter_by_min_points(db_infos, min_gt_points_dict):
        for name, min_num in min_gt_points_dict.items():
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    i for i in db_infos[name]
                    if i["num_points_in_gt"] >= min_num
                ]
        return db_infos

    def sample_all(self, gt_bboxes, gt_labels):
        """gt_bboxes (K, 7) bottom-centered, gt_labels (K,) int ->
        dict(gt_bboxes_3d, gt_labels_3d, points, group_ids) or None."""
        gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 7)
        gt_labels = np.asarray(gt_labels).reshape(-1)

        sampled, sampled_boxes = [], []
        avoid = gt_bboxes
        for name, max_num in zip(self.sample_classes, self.sample_max_nums):
            label = self.cat2label[name]
            deficit = int(max_num - int(np.sum(gt_labels == label)))
            num = int(np.round(self.rate * deficit))
            if num <= 0:
                continue
            picked = self._sample_class(name, num, avoid)
            if picked:
                sampled += picked
                boxes = np.stack([s["box3d_lidar"] for s in picked])
                sampled_boxes.append(boxes)
                avoid = np.concatenate([avoid, boxes], axis=0)

        if not sampled:
            return None
        sampled_boxes = np.concatenate(sampled_boxes, axis=0)

        pts_list = []
        for info in sampled:
            path = (
                self.data_root / info["path"]
                if self.data_root else Path(info["path"])
            )
            pts = load_points_bin(
                path, load_dim=self.point_dims,
                use_dim=tuple(range(self.point_dims)),
            ).copy()
            pts[:, :3] += np.asarray(info["box3d_lidar"][:3], np.float32)
            pts_list.append(pts)

        return dict(
            gt_bboxes_3d=sampled_boxes.astype(np.float32),
            gt_labels_3d=np.array(
                [self.cat2label[s["name"]] for s in sampled], np.int64
            ),
            points=np.concatenate(pts_list, axis=0),
            group_ids=np.arange(
                len(gt_bboxes), len(gt_bboxes) + len(sampled)
            ),
        )

    def _sample_class(self, name, num, gt_bboxes):
        """Greedy BEV collision rejection (reference sample_class_v2)."""
        if name not in self.sampler_dict:
            return []
        sampled = self.sampler_dict[name].sample(num)
        if not sampled:
            return []
        num_gt = len(gt_bboxes)
        sp_boxes = np.stack([s["box3d_lidar"] for s in sampled])
        boxes = np.concatenate([gt_bboxes, sp_boxes], axis=0)
        corners = center_to_corner_box2d(
            boxes[:, :2], boxes[:, 3:5], boxes[:, 6]
        )
        coll = box_collision_test(corners, corners)
        diag = np.arange(len(boxes))
        coll[diag, diag] = False

        valid = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll[i].any():
                coll[i] = False
                coll[:, i] = False
            else:
                valid.append(sampled[i - num_gt])
        return valid


def create_gt_database(
    info_path,
    data_root,
    out_dir,
    classes,
    load_dim: int = 6,
    use_dim=(0, 1, 2),
    db_prefix: str = "scannet",
):
    """Build the per-object point database from an infos pickle.

    Boxes in the infos are gravity-centered ``(cx, cy, cz, dx, dy, dz)``
    (+ optional yaw); stored per-object points are relative to the box
    *bottom* center, matching what ``DataBaseSampler.sample_all`` adds
    back (reference create_gt_database.py:244-247).
    """
    data_root = Path(data_root)
    out_dir = Path(out_dir)
    gt_dir = out_dir / f"{db_prefix}_gt_database"
    gt_dir.mkdir(parents=True, exist_ok=True)

    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    db_infos: dict[str, list] = {}
    for info in infos:
        scan = info["point_cloud"]["lidar_idx"]
        pts = load_points_bin(
            data_root / info["pts_path"], load_dim=load_dim, use_dim=use_dim
        )
        annos = info["annos"]
        if annos["gt_num"] == 0:
            continue
        raw = np.asarray(annos["gt_boxes_upright_depth"], np.float32)
        boxes = np.zeros((len(raw), 7), np.float32)
        boxes[:, :raw.shape[1]] = raw
        boxes[:, 2] -= boxes[:, 5] / 2  # gravity -> bottom center
        labels = np.asarray(annos["class"]).reshape(-1)
        mask = points_in_rbbox(pts[:, :3], boxes)  # (N, K)
        for k in range(len(boxes)):
            name = classes[int(labels[k])]
            obj = pts[mask[:, k]].astype(np.float32).copy()
            obj[:, :3] -= boxes[k, :3]
            rel = f"{db_prefix}_gt_database/{scan}_{name}_{k}.bin"
            obj.tofile(str(out_dir / rel))
            db_infos.setdefault(name, []).append(
                dict(
                    name=name,
                    path=rel,
                    gt_idx=k,
                    box3d_lidar=boxes[k],
                    num_points_in_gt=int(mask[:, k].sum()),
                    difficulty=0,
                )
            )

    db_path = out_dir / f"{db_prefix}_dbinfos_train.pkl"
    with open(db_path, "wb") as f:
        pickle.dump(db_infos, f)
    return db_path
