"""Multi-class BEV-rotated NMS (reference
mmdet3d/core/post_processing/box3d_nms.py:8 ``box3d_multiclass_nms``):
per-class score thresholding + rotated NMS, used by anchor-based heads.
Counterpart of ``nesie_tpu/core/multiclass_nms.py``; built on the port's
polygon clipping (``core.iou``) and greedy fixpoint (``core.nms``).
"""
from __future__ import annotations

import torch

from .coders import topk
from .iou import bev_corners, rotated_intersection_area_2d
from .nms import greedy_keep_fixpoint


def _rotated_iou_matrix(boxes5, eps=1e-8):
    """(N, 5) xywhr -> (N, N) BEV IoU via pairwise polygon clipping."""
    n = boxes5.shape[0]
    c = bev_corners(boxes5)
    inter = rotated_intersection_area_2d(
        c[:, None].expand(n, n, 4, 2).reshape(n * n, 4, 2),
        c[None, :].expand(n, n, 4, 2).reshape(n * n, 4, 2),
    ).reshape(n, n)
    area = boxes5[:, 2] * boxes5[:, 3]
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=eps)


def _reference_bev(boxes5):
    """The reference kernel's clockwise corner rotation (iou3d_kernel.cu:
    111-117, yaw as-is from ``.bev``): the angle negated before the CCW
    polygon clip; identical for axis-aligned boxes (REFERENCE_QUIRKS.md
    item 11)."""
    return torch.cat([boxes5[:, :4], -boxes5[:, 4:5]], dim=1)


def nms_bev_rotated(boxes5, scores, thresh: float, valid_mask=None,
                    literal_reference_bev: bool = True):
    """Greedy rotated-BEV NMS keep mask (reference iou3d nms_gpu analog).
    ``literal_reference_bev`` (default): see ``_reference_bev``."""
    n = boxes5.shape[0]
    if literal_reference_bev:
        boxes5 = _reference_bev(boxes5)
    iou = _rotated_iou_matrix(boxes5)
    valid = (torch.ones((n,), dtype=torch.bool, device=boxes5.device)
             if valid_mask is None else valid_mask)
    return greedy_keep_fixpoint(iou > thresh, scores, valid)


def circle_nms(centers_scores, thresh: float, valid_mask=None):
    """Center-distance NMS (reference box3d_nms.py:180 ``circle_nms``,
    CenterPoint-legacy): suppress detections whose BEV center lies within
    ``thresh`` (squared distance) of a higher-scored kept detection.

    Args:
        centers_scores: (N, 3) rows ``(x, y, score)``.
    Returns:
        (N,) bool keep mask.
    """
    n = centers_scores.shape[0]
    xy = centers_scores[:, :2]
    scores = centers_scores[:, 2]
    d2 = torch.sum((xy[:, None] - xy[None, :]) ** 2, dim=-1)
    valid = (torch.ones((n,), dtype=torch.bool, device=xy.device)
             if valid_mask is None else valid_mask)
    # the reference suppresses at dist <= thresh (box3d_nms.py:217)
    return greedy_keep_fixpoint(d2 <= thresh, scores, valid)


def box3d_multiclass_nms(
    boxes7,
    scores,
    score_thr: float,
    nms_thr: float,
    max_num: int,
):
    """Multi-class rotated NMS with static output size.

    Args:
        boxes7: (P, 7) gravity-centered boxes.
        scores: (P, C+1) class scores (last column = background, as in the
            reference's mlvl_scores convention).
    Returns:
        (boxes (max_num, 7), scores (max_num,), labels (max_num,) int32,
         valid (max_num,)) — padded with zeros.
    """
    P, C1 = scores.shape
    C = C1 - 1
    bev = boxes7[:, [0, 1, 3, 4, 6]]
    # every class clips the same boxes: one IoU matrix serves them all
    sup = _rotated_iou_matrix(_reference_bev(bev)) > nms_thr

    all_scores, all_keep = [], []
    for k in range(C):
        s = scores[:, k]
        keep = greedy_keep_fixpoint(sup, s, s > score_thr)
        all_scores.append(torch.where(keep, s, -torch.inf))
        all_keep.append(keep)

    flat_scores = torch.cat(all_scores)
    flat_labels = torch.arange(C, dtype=torch.int32,
                               device=scores.device).repeat_interleave(P)
    flat_keep = torch.cat(all_keep)
    flat_boxes = boxes7.repeat(C, 1)

    top_scores, idx = topk(flat_scores, max_num)
    out_boxes = flat_boxes[idx]
    out_labels = flat_labels[idx]
    out_valid = flat_keep[idx] & torch.isfinite(top_scores)
    out_scores = torch.where(out_valid, top_scores, 0.0)
    return (
        out_boxes * out_valid[:, None],
        out_scores,
        out_labels * out_valid,
        out_valid,
    )
