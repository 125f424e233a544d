"""Class-aware axis-aligned 3D NMS. Counterpart of
``nesie_tpu/core/nms.py``.

``greedy_keep_fixpoint`` solves greedy NMS as the fixpoint of
``k[j] = valid[j] & ~any(k[i] & sup[i, j] for i < j)`` in sorted-score
order, iterated as a whole-vector update until it stops changing.
"""
from __future__ import annotations

import torch


def greedy_keep_fixpoint(sup: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """sup (N, N) bool (``sup[i, j]``: a kept ``i`` suppresses ``j``),
    scores (N,), valid (N,) bool -> (N,) bool keep mask, equal to the
    sequential greedy loop (equal scores keep index order)."""
    n = scores.shape[0]
    if n == 0:
        return valid
    order = torch.argsort(-scores, stable=True)
    S = sup[order][:, order]
    iot = torch.arange(n, device=scores.device)
    S = S & (iot[:, None] < iot[None, :])  # only earlier boxes suppress
    v = valid[order]
    k, k_prev = v, ~v
    while bool((k != k_prev).any()):
        suppressed = (S & k[:, None]).any(dim=0)
        k, k_prev = v & ~suppressed, k
    keep = torch.zeros_like(k)
    keep[order] = k
    return keep


def _aligned_iou_matrix(boxes6: torch.Tensor, eps: float = 1e-12):
    """(N, 6) minmax boxes -> (N, N) IoU matrix."""
    lt = torch.maximum(boxes6[:, None, :3], boxes6[None, :, :3])
    rb = torch.minimum(boxes6[:, None, 3:], boxes6[None, :, 3:])
    whd = torch.clamp(rb - lt, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    d = boxes6[:, 3:] - boxes6[:, :3]
    vol = d[:, 0] * d[:, 1] * d[:, 2]
    union = vol[:, None] + vol[None, :] - inter
    return inter / torch.clamp(union, min=eps)


def aligned_3d_nms_mask(boxes6: torch.Tensor, scores: torch.Tensor,
                        classes: torch.Tensor, thresh: float,
                        valid_mask: torch.Tensor | None = None):
    """Greedy class-aware NMS: a box is suppressed iff IoU > thresh with a
    higher-scored kept box of the same class. Returns (N,) bool."""
    iou = _aligned_iou_matrix(boxes6)
    iou = iou * (classes[:, None] == classes[None, :])
    valid = (torch.ones_like(scores, dtype=torch.bool)
             if valid_mask is None else valid_mask)
    return greedy_keep_fixpoint(iou > thresh, scores, valid)
