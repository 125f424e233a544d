"""Semantic-segmentation metrics. A numpy copy of
``nesie_tpu/eval/seg_metrics.py`` (reference mmdet3d/models/utils/utils.py:
38-50 ``intersectionAndUnion``).

Per-class intersection/union/target histograms over a predicted vs GT
label array, with an ignore index that removes points from BOTH sides —
the reference overwrites prediction entries with ``ignore_index`` where
the target is ignored, so they fall outside every class bin. mIoU is then
``mean(intersection / union)`` accumulated over scenes.
"""
from __future__ import annotations

import numpy as np


def intersection_and_union(output, target, num_classes: int,
                           ignore_index: int = 255):
    """Per-class areas for one (or a batch of) prediction(s).

    Args:
        output: int array of predicted labels, any shape.
        target: int array of GT labels, same shape.
        num_classes: K; labels must lie in [0, K) except ``ignore_index``.

    Returns:
        (intersection, union, target_area): three (K,) int64 arrays.
    """
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    assert output.shape == target.shape
    output[target == ignore_index] = ignore_index
    intersection = output[output == target]
    bins = np.arange(num_classes + 1)
    area_intersection, _ = np.histogram(intersection, bins=bins)
    area_output, _ = np.histogram(output, bins=bins)
    area_target, _ = np.histogram(target, bins=bins)
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target


def seg_eval(pred_list, gt_list, num_classes: int, ignore_index: int = 255):
    """Accumulate :func:`intersection_and_union` over scenes and report
    mIoU / mAcc / allAcc (the reference training scripts' aggregation)."""
    inter = np.zeros(num_classes, np.int64)
    union = np.zeros(num_classes, np.int64)
    target = np.zeros(num_classes, np.int64)
    for pred, gt in zip(pred_list, gt_list):
        i, u, t = intersection_and_union(pred, gt, num_classes, ignore_index)
        inter += i
        union += u
        target += t
    iou = inter / np.maximum(union, 1)
    acc = inter / np.maximum(target, 1)
    return {
        "mIoU": float(iou[union > 0].mean()) if (union > 0).any() else 0.0,
        "mAcc": float(acc[target > 0].mean()) if (target > 0).any() else 0.0,
        "allAcc": float(inter.sum() / max(target.sum(), 1)),
        "iou_per_class": iou,
        "acc_per_class": acc,
    }
