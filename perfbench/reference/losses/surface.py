"""Surface (per-side) regression losses (reference surface_loss.py).
Counterpart of ``nesie_tpu/losses/surface.py``."""
from __future__ import annotations

import torch

from .basic import mse_loss, smooth_l1_loss, softmax_cross_entropy


def bbox_to_surface(bbox):
    """(..., >=6) center-size box -> (..., 6) face coords (Bbox2Surface)."""
    c, s = bbox[..., :3], bbox[..., 3:6]
    return torch.cat([c - 0.5 * s, c + 0.5 * s], dim=-1)


def transform_surface(surface, center, scale):
    """World face coords -> normalised per-side offsets (TransformSurface)."""
    return torch.cat([center - surface[..., :3], surface[..., 3:] - center],
                     dim=-1) / scale


def surface_to_prob(target, reg_max: int):
    """Continuous offsets -> two bin targets and weights (Surface2Prob);
    out-of-range targets take the reference's bin 0 / bin 1 fallback.
    Returns (left, right) int64 and (left_w, right_w)."""
    step = 1.0 / reg_max
    left = torch.floor(target / step)
    right = left + 1
    right_w = torch.remainder(target, step) / step
    left_w = 1.0 - right_w
    under, over = left < 0, right > reg_max
    bad = under | over
    left = torch.where(bad, 0.0, left)
    right = torch.where(bad, 1.0, right)
    left_w = torch.where(under, 1.0, torch.where(over, 0.0, left_w))
    right_w = torch.where(under, 0.0, torch.where(over, 1.0, right_w))
    return left.long(), right.long(), left_w, right_w


def surface_loss_mse(pred_surface, target_bbox):
    """Elementwise MSE against Bbox2Surface(target), the shipped config's
    mode: (..., 6) unreduced."""
    return mse_loss(pred_surface, bbox_to_surface(target_bbox))


def surface_loss_smooth_l1(pred_surface, target_bbox, beta: float = 5.0):
    return smooth_l1_loss(pred_surface, bbox_to_surface(target_bbox), beta)


def surface_loss_ce(prob_logits, target_bbox, center, scale, reg_max: int,
                    weight=None):
    """CE on the side distribution against the soft-binned target:
    logits (N, 6, reg_max+1), target_bbox (N, >=6), center (N, 3), scale
    (N, 6) -> scalar sum."""
    target = transform_surface(bbox_to_surface(target_bbox), center, scale)
    lb, rb, lw, rw = surface_to_prob(target, reg_max)
    loss = (softmax_cross_entropy(prob_logits, lb) * lw
            + softmax_cross_entropy(prob_logits, rb) * rw)
    if weight is not None:
        loss = loss * weight
    return loss.sum()
