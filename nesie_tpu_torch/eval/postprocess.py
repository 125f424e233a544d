"""Test-time decode + NMS (reference NesieHead.get_bboxes).

Counterpart of ``nesie_tpu/eval/postprocess.py``: ``decode_and_nms``
gives the keep mask on the device; ``expand_per_class`` expands the kept
proposals per class on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from nesie_tpu_torch.core.boxes import box_corners, corners_minmax, points_in_boxes
from nesie_tpu_torch.core.nms import aligned_3d_nms_mask
from nesie_tpu_torch.utils import span


def decode_and_nms(results: dict, points: torch.Tensor, nms_thr: float = 0.25,
                   score_thr: float = 0.05,
                   use_iou_for_nms: bool = True) -> dict:
    """Batched decode + class-aware NMS.

    results: head results (obj_scores or SAQE's R_obj_scores, sem_scores,
    bbox_preds, iou_scores);
    points: (B, N, >=3) the input clouds, for the non-empty-box filter.
    Returns bbox (B, P, 7), obj_scores (B, P), sem_scores (B, P, C) and
    selected (B, P) bool. The point-in-box test runs one scene at a time,
    an (N, P) mask each.
    """
    with span("postprocess.decode_and_nms", b=points.shape[0]):
        return _decode_and_nms(results, points, nms_thr, score_thr,
                               use_iou_for_nms)


def _decode_and_nms(results, points, nms_thr, score_thr, use_iou_for_nms):
    # SAQE's get_bboxes scores objectness from the quality module's R_obj
    # branch (saqe_head.py:434); Nesie's from the prediction head's
    obj_logits = results.get("R_obj_scores", results["obj_scores"])
    obj = torch.softmax(obj_logits, dim=-1)[..., -1]
    sem = torch.softmax(results["sem_scores"], dim=-1)
    bbox = results["bbox_preds"]
    if use_iou_for_nms:
        sem_argmax = results["sem_scores"].argmax(dim=-1, keepdim=True)
        obj = obj * results["iou_scores"].gather(-1, sem_argmax)[..., 0]

    selected = []
    for bbox_b, obj_b, sem_b, pts_b in zip(bbox, obj, sem, points):
        inside = points_in_boxes(pts_b[:, :3], bbox_b, bottom_center=False)
        nonempty = inside.sum(dim=0) > 5
        mm = corners_minmax(box_corners(bbox_b))
        keep = aligned_3d_nms_mask(mm, obj_b, sem_b.argmax(dim=-1), nms_thr,
                                   valid_mask=nonempty)
        selected.append(keep & (obj_b > score_thr))
    return dict(bbox=bbox, obj_scores=obj, sem_scores=sem,
                selected=torch.stack(selected))


def expand_per_class(decoded_b: dict):
    """Per-class proposal expansion for one scene (numpy arrays: bbox
    (P, 7), obj_scores (P,), sem_scores (P, C), selected (P,)) -> boxes
    (S*C, 7), scores (S*C,), labels (S*C,)."""
    sel = np.asarray(decoded_b["selected"]).astype(bool)
    bbox = np.asarray(decoded_b["bbox"])[sel]
    obj = np.asarray(decoded_b["obj_scores"])[sel]
    sem = np.asarray(decoded_b["sem_scores"])[sel]
    C = sem.shape[-1]
    boxes = np.concatenate([bbox] * C, 0)
    scores = np.concatenate([obj * sem[:, k] for k in range(C)], 0)
    labels = np.concatenate([np.full(len(bbox), k, np.int64)
                             for k in range(C)], 0)
    return boxes, scores, labels
