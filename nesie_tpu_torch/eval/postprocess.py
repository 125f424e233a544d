"""Test-time decode + NMS (reference NesieHead.get_bboxes).

Counterpart of ``nesie_tpu/eval/postprocess.py``: ``decode_and_nms``
gives the keep mask on the device; ``expand_per_class`` expands the kept
proposals per class on the host.

The keep mask dispatches on the device of the clouds: a CPU tensor takes
the plain per-scene loop (``ops.decode_nms.keep_mask_ref``), a CUDA tensor
the hand-written kernels (``keep_mask_cuda``: the whole batch, no host
sync, counted as ``launch.decode_nms``), which raise rather than fall
back. The kernels round every operation as the plain version's separate
PyTorch ops do, so both make the same float32 decisions on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from nesie_tpu_torch.ops.decode_nms import keep_mask_cuda, keep_mask_ref
from nesie_tpu_torch.utils import span


def decode_and_nms(results: dict, points: torch.Tensor, nms_thr: float = 0.25,
                   score_thr: float = 0.05,
                   use_iou_for_nms: bool = True) -> dict:
    """Batched decode + class-aware NMS.

    results: head results (obj_scores or SAQE's R_obj_scores, sem_scores,
    bbox_preds, iou_scores);
    points: (B, N, >=3) the input clouds, for the non-empty-box filter.
    Returns bbox (B, P, 7), obj_scores (B, P), sem_scores (B, P, C) and
    selected (B, P) bool.
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

    classes = sem.argmax(dim=-1)
    if points.device.type == "cpu":
        selected, _ = keep_mask_ref(points, bbox, obj, classes, nms_thr,
                                    score_thr)
    else:
        selected, _ = keep_mask_cuda(points.contiguous(), bbox.contiguous(),
                                     obj.contiguous(), classes, nms_thr,
                                     score_thr)
    return dict(bbox=bbox, obj_scores=obj, sem_scores=sem, selected=selected)


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
