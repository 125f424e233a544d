"""The numbers that decide ``correct``, each worked out from the
program's readings and the reference's.

Training (the first steps of the object the window then drives): the
loss of each step; the first gradient as the optimizer got it (AdamW's
first moment after one step over 1 - beta1); the change of every leaf of
the student and of the EMA teacher after the checked steps; the entries
of the unlabeled scans' state (class histograms and first-visit flags)
that differ. A norm is compared by the worst leaf: the gap between the
program's norm and the reference's, against the reference's norm of that
leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
round-off alone and are left out of both changes.

Detections (eval batches and requests): the widest gap of a decoded
score and of a decoded box coordinate, and the proposals whose kept-or-
dropped decision differs from the reference's where the reference's
decision is not within ``tol`` of one of its thresholds.
"""
from __future__ import annotations

import math

import numpy as np

SMALL_GRAD = 1e-3  # of the median leaf's gradient norm


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    if not keys:
        return math.inf
    ref_n = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(ref_n.values())))
    worst = 0.0
    for k in keys:
        if k not in prog or prog[k].shape != ref[k].shape:
            return math.inf
        p = float(prog[k].double().norm())
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref_n[k]) / max(ref_n[k], med, 1e-30))
    return worst


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: dict(losses [float], grads {leaf: tensor}, changes
    {leaf: tensor}, teacher_changes {leaf: tensor}, ulb (histograms,
    flags)) -> dict(loss_gap, grad_gap, change_gap, teacher_change_gap,
    ulb_gap)."""
    lp, lr = prog.get("losses", []), ref["losses"]
    if len(lp) != len(lr) or not all(map(math.isfinite, lp)):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(lp, lr))
    grads = ref["grads"]
    out = dict(loss_gap=loss_gap,
               grad_gap=_leaf_gap(prog.get("grads", {}), grads, list(grads)))
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    for key, name in (("changes", "change_gap"),
                      ("teacher_changes", "teacher_change_gap")):
        counted = [k for k in ref[key]
                   if k not in norms or norms[k] >= SMALL_GRAD * med]
        out[name] = _leaf_gap(prog.get(key, {}), ref[key], counted)
    out["ulb_gap"] = _entries_differ(prog.get("ulb", ()), ref["ulb"])
    return out


def _entries_differ(prog, ref) -> float:
    """Entries of tensors that differ, or inf where the shapes differ."""
    if len(prog) != len(ref) or any(a.shape != b.shape
                                    for a, b in zip(prog, ref)):
        return math.inf
    return float(sum(int((a.cpu() != b.cpu()).sum())
                     for a, b in zip(prog, ref)))


def _iou_matrix(boxes6: np.ndarray) -> np.ndarray:
    lt = np.maximum(boxes6[:, None, :3], boxes6[None, :, :3])
    rb = np.minimum(boxes6[:, None, 3:], boxes6[None, :, 3:])
    inter = np.clip(rb - lt, 0.0, None).prod(-1)
    vol = (boxes6[:, 3:] - boxes6[:, :3]).prod(-1)
    union = vol[:, None] + vol[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def near_decisions(ref: dict, score_thr: float, nms_thr: float,
                   inside_thr: float, tol: float) -> np.ndarray:
    """(P,) bool: proposals of one scene whose kept-or-dropped decision in
    the reference lies within ``tol`` of one of its thresholds: the score
    threshold, a near tie of the top two classes, an inside count next to
    the non-empty threshold, an IoU near the NMS threshold with a box of
    the same class, or a near tie of scores with an overlapping box of
    the same class. A decision that follows from such a one (a box that
    an excused one suppressed) is not excused: under the control (TF32)
    that excuse took every proposal of an eval batch. ref: obj (P,), sem
    (P, C) probabilities, minmax (P, 6), inside (P,)."""
    obj, sem = ref["obj"], ref["sem"]
    top2 = np.sort(sem, -1)[:, -2:]
    cls = sem.argmax(-1)
    near = (np.abs(obj - score_thr) <= tol) | (top2[:, 1] - top2[:, 0] <= tol)
    near |= np.abs(ref["inside"] - inside_thr) <= 1.5
    iou = _iou_matrix(ref["minmax"])
    same = (cls[:, None] == cls[None, :]) & ~np.eye(len(obj), dtype=bool)
    overlap = same & (iou > nms_thr - tol)
    near |= (same & (np.abs(iou - nms_thr) <= tol)).any(1)
    near |= (overlap & (np.abs(obj[:, None] - obj[None, :]) <= tol)).any(1)
    return near
