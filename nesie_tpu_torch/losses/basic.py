"""Elementary losses with torch / mmdet reductions. Counterpart of
``nesie_tpu/losses/basic.py`` (the pieces the Nesie losses use)."""
from __future__ import annotations

import torch


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
