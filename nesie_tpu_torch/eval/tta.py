"""Test-time augmentation. A numpy copy of ``nesie_tpu/eval/tta.py``
(reference MultiScaleFlipAug3D,
pipelines/test_time_aug.py + merge_aug_bboxes_3d, core/post_processing/
merge_augs.py): run the detector over flipped/scaled views, map boxes back
to the original frame, merge per class with rotated NMS.

Each view is one forward on the model's device (``Detector``); the merge
runs on the host, in numpy, on the views' detections.
"""
from __future__ import annotations

import numpy as np

from nesie_tpu_torch.eval.np_iou import pairwise_iou3d


def make_tta_views(flip: bool = True, scales=(1.0,)):
    """View descriptors: (h_flip, v_flip, scale). The reference's
    MultiScaleFlipAug3D with flip=True enumerates both flips."""
    views = []
    for s in scales:
        views.append((False, False, s))
        if flip:
            views.append((True, False, s))
            views.append((False, True, s))
            views.append((True, True, s))
    return views


def apply_view_np(points, h_flip, v_flip, scale):
    pts = points.copy()
    if h_flip:
        pts[..., 0] = -pts[..., 0]
    if v_flip:
        pts[..., 1] = -pts[..., 1]
    pts[..., :3] *= scale
    return pts


def mapping_back_np(boxes, h_flip, v_flip, scale):
    """Invert a TTA view on (S, 7) boxes (reference bbox3d_mapping_back,
    transforms.py:4-23: flip horizontal, then vertical, then scale^-1 —
    flip order matters for the exact yaw value when both apply)."""
    b = boxes.copy()
    if h_flip:
        b[:, 0] = -b[:, 0]
        b[:, 6] = np.pi - b[:, 6]
    if v_flip:
        b[:, 1] = -b[:, 1]
        b[:, 6] = -b[:, 6]
    b[:, :6] /= scale
    return b


def merge_aug_bboxes_3d(view_results, views, nms_thr: float = 0.25,
                        max_num: int = 500):
    """Merge per-view detections (reference merge_augs.py:7).

    Args:
        view_results: list of dicts with boxes (S, 7), scores (S,),
            labels (S,) — one per view, in the augmented frames.
        views: matching list of (h_flip, v_flip, scale).
    Returns:
        dict(boxes, scores, labels) merged via per-class rotated NMS,
        score-sorted, capped at max_num.
    """
    boxes, scores, labels = [], [], []
    for res, (hf, vf, sc) in zip(view_results, views):
        if len(res["boxes"]) == 0:
            continue
        boxes.append(mapping_back_np(np.asarray(res["boxes"]), hf, vf, sc))
        scores.append(np.asarray(res["scores"]))
        labels.append(np.asarray(res["labels"]))
    if not boxes:
        return dict(boxes=np.zeros((0, 7)), scores=np.zeros((0,)),
                    labels=np.zeros((0,), np.int64))
    boxes = np.concatenate(boxes)
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)

    # the reference NMS-merges on *BEV* rotated IoU (merge_augs.py:47
    # xywhr2xyxyr(bev) -> nms_gpu), not 3D IoU: equalize the z extent so
    # pairwise_iou3d reduces exactly to the BEV overlap ratio. nms_gpu's
    # kernel rotates corners clockwise (iou3d_kernel.cu:111-117) — the
    # "cw_kernel" convention (REFERENCE_QUIRKS.md item 11).
    nms_boxes = boxes.copy()
    nms_boxes[:, 2] = 0.0
    nms_boxes[:, 5] = 1.0

    keep_all = []
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        order = idx[np.argsort(-scores[idx])]
        iou = pairwise_iou3d(nms_boxes[order], nms_boxes[order],
                             bev="cw_kernel")
        alive = np.ones(len(order), bool)
        for i in range(len(order)):
            if not alive[i]:
                continue
            keep_all.append(order[i])
            alive &= ~(iou[i] > nms_thr)
            alive[i] = False
    keep = np.asarray(sorted(keep_all, key=lambda i: -scores[i]))[:max_num]
    return dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep])
