"""ScanNet instance-segmentation benchmark. Counterpart of
``nesie_tpu/eval/instance_seg.py``: a numpy copy, names and layout kept.

The reference's standalone benchmark (reference
mmdet3d/models/utils/eval.py:28-322 + utils_3d.py, itself the official
ScanNet ``evaluate_semantic_instance.py`` protocol), on the host:

* GT instances are encoded as ``label_id * 1000 + index`` per vertex;
  ids < 1000 are *group* instances (evaluated as ignore regions, never
  as targets), id 0 is unannotated.
* GT instances smaller than ``min_region_size`` (100) vertices are
  filtered from the targets but still ignore overlapping predictions.
* Matching per (class, overlap) is greedy in GT order over each GT's
  candidate predictions in prediction order; a second prediction
  matching an already-matched GT contributes a false positive with the
  *lower* of the two confidences (eval.py:79-92).
* A GT with no passing candidate is a hard false negative added to the
  recall denominator at every threshold point (eval.py:94-97).
* An unmatched prediction is ignored (not an FP) when the void +
  group + small-GT portion of its mask exceeds the overlap threshold
  (eval.py:105-121).
* AP integrates the precision/unique-score-threshold curve with the
  reference's [-0.5, 0, 0.5] convolution step widths, with the
  artificial (precision 1, recall 0) endpoint (eval.py:126-177).
* ``all_ap`` averages overlaps 0.50:0.05:0.95 (0.25 reported
  separately), classes with no GT anywhere are NaN-skipped
  (eval.py:185-200).

``evaluate_instance_segmentation`` (mask-AP on per-scene boolean masks)
is the lightweight entry; the full benchmark is
``scannet_instance_benchmark``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .indoor_eval import average_precision

# nyu40 ids of the 18 benchmark classes, in benchmark order
SCANNET_BENCHMARK_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                         33, 34, 36, 39)
SCANNET_BENCHMARK_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "otherfurniture")

# 0.50:0.05:0.95 plus the separately-reported 0.25
BENCHMARK_OVERLAPS = tuple(np.arange(0.5, 0.95, 0.05)) + (0.25,)
MIN_REGION_SIZE = 100


@dataclass
class _GT:
    instance_id: int
    vert_count: int
    # candidates: (pred_uid, confidence, pred_vert_count, intersection)
    cands: list = field(default_factory=list)


@dataclass
class _Pred:
    uid: int
    confidence: float
    vert_count: int
    void_intersection: int
    # (gt_vert_count, intersection, is_small) per overlapped same-class GT
    gt_overlaps: list = field(default_factory=list)


def assign_scan(gt_ids, pred_masks, pred_labels, pred_confs,
                valid_ids=SCANNET_BENCHMARK_IDS,
                min_region_size=MIN_REGION_SIZE, uid_base=0):
    """Associate one scan's predictions with its GT instances.

    Args:
        gt_ids: (N,) int per-vertex ``label*1000 + idx`` instance ids.
        pred_masks: (P, N) bool / {0,1} predicted instance masks.
        pred_labels: (P,) int nyu40 class ids.
        pred_confs: (P,) float confidences.
        uid_base: offset making prediction uids unique across scans.
    Returns:
        (gts, preds): {class_id: [_GT]}, {class_id: [_Pred]} for the
        benchmark classes, mirroring eval.py assign_instances_for_scan.
    """
    gt_ids = np.asarray(gt_ids)
    valid = np.asarray(valid_ids)
    gt_label = gt_ids // 1000
    # group instances (id < 1000 -> label 0) and unannotated vertices are
    # both outside the valid-class set, so the void mask covers them; the
    # reference's per-instance `instance_id < 1000` ignore branch
    # (eval.py:111-112) is dead code because get_instances never admits
    # ids < 1000 into matched_gt — group mass enters ONLY via the void
    # count, which we replicate.
    is_void = ~np.isin(gt_label, valid)

    inst_ids, inv = np.unique(gt_ids, return_inverse=True)
    counts = np.bincount(inv)

    gts = {c: [] for c in valid_ids}
    small_rows = defaultdict(list)  # class -> [(instance_id, vert_count)]
    for iid, cnt in zip(inst_ids.tolist(), counts.tolist()):
        if iid < 1000:  # unannotated (0) or group — never a target
            continue
        lbl = iid // 1000
        if lbl in gts:
            if cnt >= min_region_size:
                gts[lbl].append(_GT(iid, cnt))
            else:
                small_rows[lbl].append((iid, cnt))

    preds = {c: [] for c in valid_ids}
    uid = uid_base
    for mask, lbl, conf in zip(pred_masks, pred_labels, pred_confs):
        lbl = int(lbl)
        if lbl not in preds:
            continue
        mask = np.asarray(mask) != 0
        n = int(mask.sum())
        if n < min_region_size:
            continue
        masked_ids = gt_ids[mask]
        p = _Pred(uid, float(conf), n,
                  int(np.count_nonzero(is_void[mask])))
        uid += 1
        # intersections with same-class GT instances — targets AND small
        # ones: the reference's matched_gt holds both, so a small GT can
        # satisfy found_gt (suppressing the FP) and otherwise contributes
        # its intersection to the ignore mass (eval.py:101-117)
        for g in gts[lbl]:
            inter = int(np.count_nonzero(masked_ids == g.instance_id))
            if inter > 0:
                g.cands.append((p.uid, p.confidence, p.vert_count, inter))
                p.gt_overlaps.append((g.vert_count, inter, False))
        for iid, cnt in small_rows.get(lbl, ()):
            inter = int(np.count_nonzero(masked_ids == iid))
            if inter > 0:
                p.gt_overlaps.append((cnt, inter, True))
        preds[lbl].append(p)
    return gts, preds


def _ap_from_curve(y_true, y_score, hard_false_negatives):
    """The reference's step-width AP integration (eval.py:126-177)."""
    order = np.argsort(y_score, kind="stable")
    y_score = y_score[order]
    y_true = y_true[order]
    cum = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n_curve = len(unique_idx) + 1
    n = len(y_score)
    n_true = cum[-1] if len(cum) else 0

    precision = np.zeros(n_curve)
    recall = np.zeros(n_curve)
    cum_ext = np.append(cum, 0)  # idx -1 wraps to 0 like the reference
    for row, idx in enumerate(unique_idx):
        below = cum_ext[idx - 1]
        tp = n_true - below
        fp = n - idx - tp
        fn = below + hard_false_negatives
        precision[row] = tp / (tp + fp)
        recall[row] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0

    r = np.concatenate([recall[:1], recall, [0.0]])
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def _class_overlap_ap(scans, cls, overlap_th):
    """AP for one (class, overlap) over all scans; NaN when no GT."""
    pred_matched = set()  # uids consumed by a GT match, global like
    # eval.py's pred_visited (uids are unique across scans)
    y_true, y_score = [], []
    hard_fns = 0
    has_gt = has_pred = False
    for gts, preds in scans:
        gl = gts[cls]
        pl = preds[cls]
        has_gt |= bool(gl)
        has_pred |= bool(pl)

        for g in gl:
            found, matched_score = False, None
            for uid, conf, pvc, inter in g.cands:
                if uid in pred_matched:
                    continue
                ov = inter / (g.vert_count + pvc - inter)
                if ov > overlap_th:
                    if matched_score is not None:
                        # duplicate: lower of the two scores becomes FP
                        lo, hi = sorted((matched_score, conf))
                        matched_score = hi
                        y_true.append(0.0)
                        y_score.append(lo)
                    else:
                        found = True
                        matched_score = conf
                        pred_matched.add(uid)
            if matched_score is not None:
                y_true.append(1.0)
                y_score.append(matched_score)
            if not found:
                hard_fns += 1

        for p in pl:
            # found_gt considers ALL same-class GTs, small ones included
            # (reference matched_gt semantics, eval.py:101-107)
            found_gt = any(
                inter / (gvc + p.vert_count - inter) > overlap_th
                for gvc, inter, _small in p.gt_overlaps)
            if found_gt:
                continue
            num_ignore = p.void_intersection + sum(
                inter for _, inter, small in p.gt_overlaps if small)
            if num_ignore / p.vert_count <= overlap_th:
                y_true.append(0.0)
                y_score.append(p.confidence)

    if has_gt and has_pred:
        return _ap_from_curve(np.asarray(y_true), np.asarray(y_score),
                              hard_fns)
    if has_gt:
        return 0.0
    return float("nan")


def scannet_instance_benchmark(gt_ids_per_scan, pred_infos,
                               valid_ids=SCANNET_BENCHMARK_IDS,
                               class_names=SCANNET_BENCHMARK_CLASSES,
                               overlaps=BENCHMARK_OVERLAPS,
                               min_region_size=MIN_REGION_SIZE):
    """The full benchmark over scans.

    Args:
        gt_ids_per_scan: list of (N_i,) per-vertex GT instance-id arrays.
        pred_infos: list of dicts with ``mask`` (P, N_i), ``label_id``
            (P,), ``conf`` (P,) — the reference's pred_info layout.
    Returns:
        dict with ``all_ap`` (mean over 0.50:0.05:0.95), ``all_ap_50%``,
        ``all_ap_25%`` and a ``classes`` table, exactly like
        eval.py compute_averages.
    """
    scans = []
    uid_base = 0
    for gt_ids, info in zip(gt_ids_per_scan, pred_infos):
        scans.append(assign_scan(
            gt_ids, info["mask"], info["label_id"], info["conf"],
            valid_ids, min_region_size, uid_base=uid_base))
        uid_base += len(info["label_id"])

    ap = np.full((len(valid_ids), len(overlaps)), np.nan)
    for li, cls in enumerate(valid_ids):
        for oi, th in enumerate(overlaps):
            ap[li, oi] = _class_overlap_ap(scans, cls, th)

    overlaps = np.asarray(overlaps)
    is25 = np.isclose(overlaps, 0.25)
    with np.errstate(invalid="ignore"):
        out = {
            "all_ap": float(np.nanmean(ap[:, ~is25])),
            "all_ap_50%": float(np.nanmean(ap[:, np.isclose(overlaps, 0.5)])),
            "all_ap_25%": float(np.nanmean(ap[:, is25])),
            "classes": {},
        }
        for li, name in enumerate(class_names):
            out["classes"][name] = {
                "ap": float(np.mean(ap[li, ~is25])),
                "ap50%": float(np.mean(ap[li, np.isclose(overlaps, 0.5)])),
                "ap25%": float(np.mean(ap[li, is25])),
            }
    return out


def mask_iou(pred_mask, gt_mask):
    inter = np.logical_and(pred_mask, gt_mask).sum()
    union = np.logical_or(pred_mask, gt_mask).sum()
    return inter / max(union, 1)


def evaluate_instance_segmentation(
    gt_annos,
    dt_annos,
    iou_thrs=(0.25, 0.5),
    class_names=None,
):
    """Lightweight mask-AP (greedy per-class matching, VOC-style AP) for
    in-pipeline smoke evaluation. For reference-protocol numbers use
    ``scannet_instance_benchmark``.

    Args:
        gt_annos: per scene: dict(masks (G, N) bool, labels (G,)).
        dt_annos: per scene: dict(masks (S, N) bool, scores (S,), labels (S,)).
    Returns:
        dict of per-class AP + mAP per threshold.
    """
    per_class = defaultdict(lambda: {"npos": 0, "dets": []})

    for sid, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
        gt_by_cls = defaultdict(list)
        for m, l in zip(gt["masks"], gt["labels"]):
            gt_by_cls[int(l)].append(m)
            per_class[int(l)]["npos"] += 1
        for m, s, l in zip(dt["masks"], dt["scores"], dt["labels"]):
            ious = [mask_iou(m, g) for g in gt_by_cls.get(int(l), [])]
            per_class[int(l)]["dets"].append(
                (float(s), sid, np.asarray(ious))
            )

    results = {}
    maps = {t: [] for t in iou_thrs}
    for cls, data in sorted(per_class.items()):
        if data["npos"] == 0:
            continue
        dets = sorted(data["dets"], key=lambda d: -d[0])
        for t in iou_thrs:
            matched = defaultdict(set)
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (score, sid, ious) in enumerate(dets):
                jbest, best = -1, t
                for j, iou in enumerate(ious):
                    if iou > best and j not in matched[sid]:
                        jbest, best = j, iou
                if jbest >= 0:
                    tp[i] = 1
                    matched[sid].add(jbest)
                else:
                    fp[i] = 1
            rec = np.cumsum(tp) / data["npos"]
            prec = np.cumsum(tp) / np.maximum(
                np.cumsum(tp) + np.cumsum(fp), 1e-9
            )
            ap = average_precision(rec, prec) if len(dets) else 0.0
            name = class_names[cls] if class_names else str(cls)
            results[f"{name}_AP_{t:.2f}"] = ap
            maps[t].append(ap)
    for t in iou_thrs:
        results[f"mAP_{t:.2f}"] = float(np.mean(maps[t])) if maps[t] else 0.0
    return results
