"""Rotated and axis-aligned IoU losses (reference iou3d_loss.py).
Counterpart of ``nesie_tpu/losses/iou_loss.py``."""
from __future__ import annotations

from perfbench.reference.core.iou import axis_aligned_iou_3d, iou3d


def iou_3d_loss(pred, target):
    """1 - rotated IoU of (..., 7) gravity-centered boxes, unreduced."""
    return 1.0 - iou3d(pred, target)


def axis_aligned_iou_loss(pred, target):
    """1 - axis-aligned IoU of center-size boxes, unreduced."""
    return 1.0 - axis_aligned_iou_3d(pred, target, aligned=True)
