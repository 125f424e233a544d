"""Generalized Focal Loss pieces (reference gfocal_loss.py). Counterpart
of ``nesie_tpu/losses/gfocal.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .basic import binary_cross_entropy, softmax_cross_entropy


def quality_focal_loss(pred, label, score, beta: float = 2.0,
                       use_sigmoid: bool = True):
    """QFL (gfocal_loss.py:9): negatives towards 0, positives towards the
    quality score at their class slot. pred (N, C) logits (probabilities
    when not ``use_sigmoid``), label (N,) with ids outside [0, C) as
    background, score (N,) -> (N,) summed over classes."""
    num_classes = pred.shape[-1]
    prob = torch.sigmoid(pred) if use_sigmoid else pred
    if use_sigmoid:  # BCE-with-logits against 0 == softplus(logit)
        zero_bce = torch.clamp(pred, min=0) + torch.log1p(torch.exp(-pred.abs()))
    else:
        zero_bce = binary_cross_entropy(prob, torch.zeros_like(prob))
    loss = zero_bce * prob ** beta

    label = label.long()
    pos = (label >= 0) & (label < num_classes)
    safe = torch.clamp(label, 0, num_classes - 1)
    p_at = prob.gather(-1, safe[..., None])[..., 0]
    if use_sigmoid:
        logit_at = pred.gather(-1, safe[..., None])[..., 0]
        pos_bce = (torch.clamp(logit_at, min=0) - logit_at * score
                   + torch.log1p(torch.exp(-logit_at.abs())))
    else:
        pos_bce = binary_cross_entropy(p_at, score)
    pos_loss = pos_bce * torch.abs(score - p_at) ** beta

    replace = pos[..., None] & (F.one_hot(safe, num_classes) > 0)
    loss = torch.where(replace, pos_loss[..., None], loss)
    return loss.sum(-1)


def distribution_focal_loss(pred_logits, label):
    """DFL over the discrete distribution (gfocal_loss.py:55): logits
    (N, n+1), label (N,) in [0, n] -> (N,)."""
    n = pred_logits.shape[-1] - 1
    left = torch.clamp(torch.floor(label).long(), 0, n - 1)
    right = left + 1
    wl = right.to(label.dtype) - label
    wr = label - left.to(label.dtype)
    return (softmax_cross_entropy(pred_logits, left) * wl
            + softmax_cross_entropy(pred_logits, right) * wr)
