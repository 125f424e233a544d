"""Self-distilled side-quality loss (reference side_pred_loss.py).
Counterpart of ``nesie_tpu/losses/side_pred.py``."""
from __future__ import annotations

import torch

from .basic import l1_loss, mse_loss, smooth_l1_loss
from .surface import bbox_to_surface


def side_pred_loss(pred_side, pred_surface, target_bbox, weight=None,
                   label_scale: float = 4.0, beta: float = 5.0,
                   label_func: str = "l1", loss_func: str = "mse"):
    """Label = the clipped, scaled surface error (no gradient); loss = MSE
    of the side score against it (side_pred_loss.py:64-82). The shipped
    config's ``label_func_type='SmoothL1Loss'`` is an L1 in the reference,
    hence ``label_func='l1'``. pred_side, pred_surface (N, 6), target_bbox
    (N, >=6) -> (N, 6) unreduced."""
    target = bbox_to_surface(target_bbox)
    crit = l1_loss if label_func == "l1" else mse_loss
    label = torch.clamp(label_scale * crit(pred_surface, target),
                        max=1.0).detach()
    if loss_func == "mse":
        loss = mse_loss(pred_side, label)
    else:
        loss = smooth_l1_loss(pred_side, label, beta)
    if weight is not None:
        loss = loss * weight
    return loss
