"""What the eval and serving kinds share: the reference's decode of a
batch of clouds, and the comparison of the program's detections with it."""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.harness import compare

INSIDE_THR = 5.5  # decode_and_nms keeps a box with more than 5 points


def reference_decode(net, pts: torch.Tensor, test: dict) -> dict:
    """The reference's eval forward and decode of ``pts`` (B, N, 4) on its
    device, with what ``compare.near_decisions`` needs; numpy, per scene."""
    from perfbench.reference.core.boxes import box_corners, corners_minmax, points_in_boxes
    from perfbench.reference.eval.postprocess import decode_and_nms

    with torch.no_grad():
        out = net(pts, test["sample_mod"])
        dec = decode_and_nms(out, pts, nms_thr=test["nms_thr"],
                             score_thr=test["score_thr"],
                             use_iou_for_nms=test["use_iou_for_nms"])
        inside = torch.stack([points_in_boxes(p[:, :3], b, bottom_center=False
                                              ).sum(0)
                              for p, b in zip(pts, dec["bbox"])])
        minmax = corners_minmax(box_corners(dec["bbox"]))
    return dict(bbox=dec["bbox"].cpu().numpy(),
                obj=dec["obj_scores"].cpu().numpy(),
                sem=dec["sem_scores"].cpu().numpy(),
                selected=dec["selected"].cpu().numpy(),
                inside=inside.cpu().numpy(), minmax=minmax.cpu().numpy())


def decoded_numbers(prog: list, ref: list, test: dict, tol: float) -> dict:
    """prog: per scene dict(bbox (P, 7), obj (P,), sem (P, C), selected
    (P,)) as the program returned them; ref: ``reference_decode``'s, per
    scene. -> dict(score_gap, box_gap, keep_flips)."""
    score_gap = box_gap = 0.0
    flips = raw = kept = excused = 0
    if len(prog) != len(ref):
        return dict(score_gap=math.inf, box_gap=math.inf, keep_flips=math.inf)
    for p, r in zip(prog, ref):
        if any(np.shape(p[k]) != np.shape(r[k])
               for k in ("bbox", "obj", "sem", "selected")):
            return dict(score_gap=math.inf, box_gap=math.inf,
                        keep_flips=math.inf)
        score_gap = max(score_gap, _gap(p["obj"], r["obj"]),
                        _gap(p["sem"], r["sem"]))
        box_gap = max(box_gap, _gap(p["bbox"], r["bbox"]))
        near = compare.near_decisions(r, test["score_thr"], test["nms_thr"],
                                      INSIDE_THR, tol)
        differ = np.asarray(p["selected"], bool) != np.asarray(
            r["selected"], bool)
        flips += int((differ & ~near).sum())
        raw += int(differ.sum())
        kept += int(np.asarray(r["selected"], bool).sum())
        excused += int(near.sum())
    # the last three are readings for control.py, not compared
    return dict(score_gap=score_gap, box_gap=box_gap, keep_flips=flips,
                flips_all=raw, kept=kept, near=excused)


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.isfinite(a).all():
        return math.inf
    return float(np.abs(a - b).max()) if a.size else 0.0


def scene_rows(ref: dict, i: int) -> dict:
    return {k: v[i] for k, v in ref.items()}


def merge(a: dict, b: dict) -> dict:
    """Two readings as one: the wider gap, the summed counts."""
    return {k: (max(a.get(k, 0), v) if k.endswith("_gap")
                else a.get(k, 0) + v) for k, v in b.items()}
