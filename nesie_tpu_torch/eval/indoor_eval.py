"""VOC-style indoor mAP evaluation (reference
mmdet3d/core/evaluation/indoor_eval.py): per-class greedy TP/FP matching at
IoU 0.25 / 0.5 with area-mode average precision.

All boxes here are gravity-centered 7-dof numpy arrays. A copy of
``nesie_tpu/eval/indoor_eval.py``.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .np_iou import pairwise_iou3d


def average_precision(recalls, precisions):
    """Area under the (monotonized) precision-recall curve
    (indoor_eval.py:7, mode='area')."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred_by_scene, gt_by_scene, iou_thrs, bev: str = "cw_kernel"):
    """Per-class evaluation.

    Args:
        pred_by_scene: {scene_id: (boxes (S,7), scores (S,))}.
        gt_by_scene: {scene_id: boxes (G,7)}.
        iou_thrs: list of IoU thresholds.
    Returns:
        list of (recall_curve, precision_curve, ap) per threshold.
    """
    npos = sum(len(g) for g in gt_by_scene.values())
    matched = {
        t: {sid: np.zeros(len(g), bool) for sid, g in gt_by_scene.items()}
        for t in iou_thrs
    }

    scene_ids, confidences, ious = [], [], []
    for sid, (boxes, scores) in pred_by_scene.items():
        if len(boxes) == 0:
            continue
        gt = gt_by_scene.get(sid, np.zeros((0, 7)))
        # the reference's matching IoU goes through overlaps ->
        # iou3d_cuda.boxes_overlap_bev_gpu, the CW-rotating kernel
        # (base_box3d.py:387); identical for yaw=0 (ScanNet), a mirrored
        # BEV for yawed SUN RGB-D boxes — see REFERENCE_QUIRKS.md item 11.
        iou = (pairwise_iou3d(boxes, gt, bev=bev)
               if len(gt) else np.zeros((len(boxes), 1)))
        for i in range(len(boxes)):
            scene_ids.append(sid)
            confidences.append(scores[i])
            ious.append(iou[i])

    order = np.argsort(-np.asarray(confidences)) if confidences else []
    nd = len(order)
    tp = {t: np.zeros(nd) for t in iou_thrs}
    fp = {t: np.zeros(nd) for t in iou_thrs}

    for d, oi in enumerate(order):
        sid = scene_ids[oi]
        iou_row = ious[oi]
        gt = gt_by_scene.get(sid, np.zeros((0, 7)))
        if len(gt):
            jmax = int(np.argmax(iou_row))
            iou_max = iou_row[jmax]
        else:
            iou_max = -np.inf
            jmax = -1
        for t in iou_thrs:
            if iou_max > t:
                if not matched[t][sid][jmax]:
                    tp[t][d] = 1.0
                    matched[t][sid][jmax] = True
                else:
                    fp[t][d] = 1.0
            else:
                fp[t][d] = 1.0

    out = []
    for t in iou_thrs:
        fpc = np.cumsum(fp[t])
        tpc = np.cumsum(tp[t])
        recall = tpc / max(float(npos), 1e-8)
        precision = tpc / np.maximum(tpc + fpc, np.finfo(np.float64).eps)
        out.append((recall, precision, average_precision(recall, precision)))
    return out


def indoor_eval(gt_annos, dt_annos, iou_thrs=(0.25, 0.5), class_names=None,
                bev: str = "cw_kernel"):
    """Full-dataset evaluation.

    Args:
        gt_annos: list (one per scene) of dicts with
            ``boxes`` (G, 7) gravity-centered and ``labels`` (G,).
        dt_annos: list of dicts with ``boxes`` (S, 7), ``scores`` (S,),
            ``labels`` (S,).
        bev: matching-IoU BEV convention (default ``"cw_kernel"``, the
            reference's eval behavior; ``"ccw"`` for the geometrically
            consistent rotation — differs only for yawed boxes).
    Returns:
        dict of metrics incl. per-class AP/recall and mAP/mAR per threshold.
    """
    pred = defaultdict(dict)  # class -> scene -> (boxes, scores)
    gt = defaultdict(dict)
    for sid, (g, d) in enumerate(zip(gt_annos, dt_annos)):
        for cls in np.unique(np.concatenate([g["labels"], d["labels"]])).astype(int):
            gm = g["labels"] == cls
            dm = d["labels"] == cls
            gt[cls][sid] = g["boxes"][gm]
            pred[cls][sid] = (d["boxes"][dm], d["scores"][dm])

    results = {}
    aps = {t: [] for t in iou_thrs}
    recalls = {t: [] for t in iou_thrs}
    for cls in sorted(gt.keys()):
        if sum(len(v) for v in gt[cls].values()) == 0:
            continue
        ret = eval_det_cls(pred[cls], gt[cls], iou_thrs, bev=bev)
        name = class_names[cls] if class_names else str(cls)
        for t, (rec, prec, ap) in zip(iou_thrs, ret):
            results[f"{name}_AP_{t:.2f}"] = ap
            results[f"{name}_rec_{t:.2f}"] = float(rec[-1]) if len(rec) else 0.0
            aps[t].append(ap)
            recalls[t].append(float(rec[-1]) if len(rec) else 0.0)
    for t in iou_thrs:
        results[f"mAP_{t:.2f}"] = float(np.mean(aps[t])) if aps[t] else 0.0
        results[f"mAR_{t:.2f}"] = float(np.mean(recalls[t])) if recalls[t] else 0.0
    return results
