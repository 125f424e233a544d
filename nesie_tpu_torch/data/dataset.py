"""Datasets producing static-shape host batches. A copy of
``nesie_tpu/data/dataset.py``: the same numpy draws in the same order, so
that one seed gives the JAX package's batches byte for byte.

Rebuilds the reference's dataset stack (mmdet3d/datasets/):
  * ``ScanNetScenes``: eval/test scenes (scannet_dataset.py).
  * ``SubScanNetScenes``: labeled-subset pretrain dataset (sub_dataset.py) —
    only scans listed in the split file.
  * ``SimiScanNetScenes``: semi-supervised dataset (simi_dataset.py:16 /
    simi_scannet_dataset.py): labeled scans from the split file, unlabeled
    pool = ALL train scans (simi_dataset.py:124); each item is one labeled
    scene + ``ratio`` random unlabeled scenes, every scene sampled
    independently for the strong and weak views (two pipeline runs,
    simi_scannet_dataset.py:318-323).

Augmentation parameters are *recorded*, not applied: the train steps apply
them on the device (``data/augment.py``). Batches are numpy;
``batch_to_device`` moves one to the device and makes its aug arrays the
port's ``AugParams``.

GT arrays are padded to MAX_GT with zeros + validity masks (static shapes).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import io
from .augment import AugParams
from .scannet_meta import MAX_GT, NUM_POINTS


@dataclass
class Scene:
    scene_id: str
    pts_path: Optional[Path]
    boxes: np.ndarray   # (K, 7) bottom-centered, axis-aligned frame
    labels: np.ndarray  # (K,)
    axis_align: np.ndarray
    points: Optional[np.ndarray] = None  # pre-loaded (synthetic/test) points


class ScanNetScenes:
    """Scene collection from an mmdet3d infos pkl (or injected scenes)."""

    def __init__(self, data_root=None, ann_file=None, scenes=None):
        if scenes is not None:
            self.scenes = list(scenes)
        else:
            infos = io.load_infos(ann_file)
            self.scenes = []
            for info in infos:
                pts_path, boxes, labels, aam = io.scene_from_info(info, data_root)
                sid = info["point_cloud"]["lidar_idx"] if "point_cloud" in info else str(len(self.scenes))
                self.scenes.append(Scene(sid, pts_path, boxes, labels, aam))

    def __len__(self):
        return len(self.scenes)

    use_native_loader: bool = True
    cache_scenes: bool = True  # keep aligned+height clouds in host RAM

    def load_points(self, scene: Scene, rng, num_points: int = NUM_POINTS):
        """Full load pipeline -> (num_points, 4) float32 [xyz, height].

        Scenes are cached post-align/post-height on first access, so the
        dual strong/weak views of the semi loop pay one disk read per
        scene. Without the cache, reads use the C++ one-pass loader
        (native/dataio.cpp) when it builds."""
        if scene.points is not None:
            pts = io.add_height(scene.points[:, :3])
            return io.sample_points(pts, num_points, rng).astype(np.float32)

        if not self.cache_scenes and self.use_native_loader:
            from .native_loader import load_scene_native

            out = load_scene_native(
                scene.pts_path, scene.axis_align, num_points,
                seed=int(rng.integers(1, 2**63 - 1)),
            )
            if out is not None:
                return out

        cache = getattr(self, "_cache", None)
        if cache is None:
            cache = self._cache = {}
        cached = cache.get(scene.scene_id)
        if cached is None:
            pts = io.load_points_bin(scene.pts_path)  # use_dim=[0,1,2]
            pts = io.global_alignment(pts, scene.axis_align)
            cached = io.add_height(pts).astype(np.float32)
            if self.cache_scenes:
                cache[scene.scene_id] = cached
        return io.sample_points(cached, num_points, rng).astype(np.float32)

    @staticmethod
    def pad_gt(boxes, labels, max_gt: int = MAX_GT):
        k = min(len(boxes), max_gt)
        out_boxes = np.zeros((max_gt, 7), np.float32)
        out_labels = np.zeros((max_gt,), np.int32)
        out_valid = np.zeros((max_gt,), bool)
        out_boxes[:k] = boxes[:k]
        out_labels[:k] = labels[:k]
        out_valid[:k] = True
        return out_boxes, out_labels, out_valid

    def eval_batch(self, indices, rng, num_points: int = NUM_POINTS):
        """Static eval batch: points + padded GT."""
        pts, gb, gl, gv, sids = [], [], [], [], []
        for i in indices:
            s = self.scenes[i]
            pts.append(self.load_points(s, rng, num_points))
            b, l, v = self.pad_gt(s.boxes, s.labels)
            gb.append(b)
            gl.append(l)
            gv.append(v)
            sids.append(s.scene_id)
        return dict(
            points=np.stack(pts),
            gt_boxes=np.stack(gb),
            gt_labels=np.stack(gl),
            gt_valid=np.stack(gv),
            scene_ids=sids,
        )


class PresampledScanNetScenes(ScanNetScenes):
    """Eval scenes from a ``tools/dump_eval_set.py`` dump: clouds are
    already subsampled with the reference's exact seeded
    ``IndoorPointSample`` permutation (transforms_3d.py:819-861), so an
    evaluation here and a reference evaluation on the same dump see
    bit-identical inputs."""

    def __init__(self, presampled_dir):
        import pickle

        self.dir = Path(presampled_dir)
        with open(self.dir / "presampled_infos.pkl", "rb") as f:
            meta = pickle.load(f)
        self.num_points = meta["num_points"]
        self.scenes = []
        for entry in meta["scenes"]:
            pts = np.load(self.dir / entry["pts_file"])
            _, boxes, labels, aam = io.scene_from_info(entry["info"], self.dir)
            self.scenes.append(
                Scene(entry["scene_id"], None, boxes, labels, aam, points=pts)
            )

    def load_points(self, scene: Scene, rng, num_points: int = NUM_POINTS):
        if num_points != scene.points.shape[0]:
            raise ValueError(
                f"pre-sampled dump holds {scene.points.shape[0]} points/scene, "
                f"eval asked for {num_points}")
        return scene.points  # fixed cloud: alignment+height already applied


def read_split_file(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


@dataclass(frozen=True)
class AugConfig:
    flip_ratio_h: float = 0.5
    flip_ratio_v: float = 0.5
    rot_range: float = float(np.pi / 36)
    scale_range: tuple = (0.85, 1.15)
    translation_std: float = 0.1


WEAK_AUG = AugConfig(rot_range=0.0, scale_range=(1.0, 1.0), translation_std=0.0)


def sample_aug(rng: np.random.Generator, cfg: AugConfig) -> dict:
    """Host-side AugParams sampling (numpy) for one sample."""
    return dict(
        flip_h=bool(rng.uniform() < cfg.flip_ratio_h),
        flip_v=bool(rng.uniform() < cfg.flip_ratio_v),
        rot=float(rng.uniform(-cfg.rot_range, cfg.rot_range)),
        scale=float(rng.uniform(*cfg.scale_range)),
        trans=rng.normal(size=3) * cfg.translation_std,
    )


def stack_aug(augs) -> dict:
    """Per-sample draws -> numpy arrays, one per ``AugParams`` field."""
    return dict(
        flip_h=np.array([a["flip_h"] for a in augs]),
        flip_v=np.array([a["flip_v"] for a in augs]),
        rot=np.array([a["rot"] for a in augs], np.float32),
        scale=np.array([a["scale"] for a in augs], np.float32),
        trans=np.stack([a["trans"] for a in augs]).astype(np.float32),
    )


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch -> tensors on ``device``; every ``aug*`` entry becomes
    an ``AugParams``. On a CUDA device the arrays go through pinned host
    memory with ``non_blocking`` copies. Entries that are not arrays (the
    scene ids) stay as they are."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def move(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    out = {}
    for k, v in batch.items():
        if k.startswith("aug"):
            out[k] = AugParams(**{f: move(a) for f, a in v.items()})
        elif isinstance(v, np.ndarray):
            out[k] = move(v)
        else:
            out[k] = v
    return out


class SubScanNetScenes(ScanNetScenes):
    """Labeled-subset pretrain dataset: keep scans in the split file."""

    def __init__(self, data_root=None, ann_file=None, label_list_file=None,
                 scenes=None, labeled_ids=None):
        super().__init__(data_root, ann_file, scenes)
        ids = set(labeled_ids if labeled_ids is not None
                  else read_split_file(label_list_file))
        self.scenes = [s for s in self.scenes if s.scene_id in ids]

    def train_batch(self, indices, rng, aug_cfg: AugConfig = AugConfig(),
                    num_points: int = NUM_POINTS):
        batch = self.eval_batch(indices, rng, num_points)
        augs = [sample_aug(rng, aug_cfg) for _ in indices]
        batch["aug"] = stack_aug(augs)
        return batch


class SimiScanNetScenes(ScanNetScenes):
    """Semi-supervised dataset with labeled/unlabeled bookkeeping.

    ``labeled_idx``/``unlabeled_idx`` index into ``self.scenes``; the
    unlabeled pool is every train scan, including labeled ones (the
    reference's choice, simi_dataset.py:124).
    """

    def __init__(self, data_root=None, ann_file=None, label_list_file=None,
                 ratio: int = 2, scenes=None, labeled_ids=None):
        super().__init__(data_root, ann_file, scenes)
        ids = set(labeled_ids if labeled_ids is not None
                  else read_split_file(label_list_file))
        self.labeled_idx = [i for i, s in enumerate(self.scenes)
                            if s.scene_id in ids]
        self.unlabeled_idx = list(range(len(self.scenes)))
        self.ratio = ratio

    @property
    def num_labeled(self):
        return len(self.labeled_idx)

    @property
    def num_unlabeled(self):
        return len(self.unlabeled_idx)

    def labeled_class_histogram(self, num_classes: int):
        """The runner's lb_list (simi_epoch_based_runner.py:72-86)."""
        hist = np.zeros((self.num_labeled, num_classes), np.float32)
        for row, i in enumerate(self.labeled_idx):
            for c in self.scenes[i].labels:
                hist[row, int(c)] += 1
        return hist

    def semi_batch(self, labeled_indices, rng,
                   strong_cfg: AugConfig = AugConfig(),
                   weak_cfg: AugConfig = WEAK_AUG,
                   num_points: int = NUM_POINTS,
                   n_unlabeled: int | None = None):
        """One step's batch: ``len(labeled_indices)`` labeled scenes followed
        by ``n_unlabeled`` (default ``ratio * len(labeled_indices)``) random
        unlabeled scenes.

        Strong and weak views of the same scene are *independent* point
        subsamples (two pipeline runs in the reference).
        """
        scene_rows = [self.labeled_idx[i] for i in labeled_indices]
        n_l = len(scene_rows)
        if n_unlabeled is None:
            n_unlabeled = self.ratio * n_l
        ulb_rows = [
            int(rng.integers(0, self.num_unlabeled))
            for _ in range(n_unlabeled)
        ]
        all_rows = scene_rows + [self.unlabeled_idx[r] for r in ulb_rows]

        pts_s, pts_t, gb, gl, gv = [], [], [], [], []
        for row in all_rows:
            s = self.scenes[row]
            pts_s.append(self.load_points(s, rng, num_points))
            pts_t.append(self.load_points(s, rng, num_points))
            b, l, v = self.pad_gt(s.boxes, s.labels)
            gb.append(b)
            gl.append(l)
            gv.append(v)

        B = len(all_rows)
        aug_s = stack_aug([sample_aug(rng, strong_cfg) for _ in range(B)])
        aug_t = stack_aug([sample_aug(rng, weak_cfg) for _ in range(B)])
        ulb_scan_idx = np.zeros((B,), np.int32)
        ulb_scan_idx[n_l:] = np.asarray(ulb_rows, np.int32)
        return dict(
            points_raw_s=np.stack(pts_s),
            points_raw_t=np.stack(pts_t),
            gt_boxes=np.stack(gb),
            gt_labels=np.stack(gl),
            gt_valid=np.stack(gv),
            aug_s=aug_s,
            aug_t=aug_t,
            ulb_scan_idx=ulb_scan_idx,
        )


# SUN RGB-D uses the same loading mechanics with its own infos file
# (10 classes, yawed boxes, identity axis-align): the reference's
# SUNRGBDDataset / SubSUNRGBDDataset / SimiSUNRGBDDataset differ from the
# ScanNet variants only in metadata, which lives in the infos pickle here.
SUNRGBDScenes = ScanNetScenes
SubSUNRGBDScenes = SubScanNetScenes
SimiSUNRGBDScenes = SimiScanNetScenes
