"""Elementary losses with torch / mmdet reductions. Counterpart of
``nesie_tpu/losses/basic.py``."""
from __future__ import annotations

import torch


def weight_reduce(loss, weight=None, reduction: str = "mean",
                  avg_factor=None):
    """mmdet-style weighted reduction."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is not None:
        return loss.sum() / avg_factor
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(pred, target):
    return (pred - target) ** 2


def l1_loss(pred, target):
    return torch.abs(pred - target)


def smooth_l1_loss(pred, target, beta: float = 1.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def softmax_cross_entropy(logits, labels, class_weight=None):
    """Per-element CE with integer labels (``F.cross_entropy(...,
    weight=class_weight, reduction='none')``): logits (..., C), labels
    (...,) -> (...,)."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=logits.dtype,
                             device=logits.device)
        loss = loss * cw[labels.long()]
    return loss


def binary_cross_entropy(prob, target, eps: float = 1e-12):
    """BCE on probabilities, clamped (``F.binary_cross_entropy``)."""
    prob = torch.clamp(prob, eps, 1.0 - eps)
    return -(target * torch.log(prob) + (1.0 - target) * torch.log(1.0 - prob))


def weighted_smooth_l1(pred, target, beta: float = 1.0 / 9.0,
                       code_weights=None, weights=None):
    """PCDet-style code-weighted smooth-L1 (reference
    weighted_smooth_l1_loss.py:8-69): NaN targets are ignored (replaced
    by the prediction), code weights scale the *diff* before the kernel,
    ``beta < 1e-5`` degrades to pure L1, and the per-anchor ``weights``
    multiply the unreduced loss.

    pred/target (B, A, C), code_weights (C,) or None, weights (B, A) or
    None -> (B, A, C) unreduced loss."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device).reshape(1, 1, -1)
    n = torch.abs(diff)
    if beta < 1e-5:
        loss = n
    else:
        loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


# The axis-aligned corner template of the reference's
# box_utils.boxes_to_corners_3d (box_utils.py:27-30). The reference never
# rotates these corners by the heading (upstream PCDet does); that quirk is
# kept (REFERENCE_QUIRKS.md).
_CORNER_TEMPLATE = (
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
)


def corner_loss_lidar(pred_boxes, gt_boxes):
    """Corner-distance smooth-L1 (reference weighted_smooth_l1_loss.py:
    71-90 + box_utils.boxes_to_corners_3d), heading (column 6) ignored as
    in the reference: (N, 7) [x, y, z, dx, dy, dz, heading] pairs ->
    (N,) mean corner loss a box."""
    template = torch.tensor(_CORNER_TEMPLATE, dtype=pred_boxes.dtype,
                            device=pred_boxes.device) / 2.0

    def corners(b):
        return b[:, None, 0:3] + b[:, None, 3:6] * template

    dist = torch.linalg.vector_norm(corners(pred_boxes) - corners(gt_boxes),
                                    dim=2)
    return smooth_l1_loss(dist, torch.zeros_like(dist), beta=1.0).mean(dim=1)
