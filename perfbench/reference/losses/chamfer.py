"""Chamfer distance with argmin indices (reference
chamfer_distance.py:8), with masked targets for padded GT. Counterpart of
``nesie_tpu/losses/chamfer.py``."""
from __future__ import annotations

import torch

from .basic import l1_loss, mse_loss, smooth_l1_loss

_CRITERIA = {"l1": l1_loss, "l2": mse_loss, "smooth_l1": smooth_l1_loss}


def chamfer_distance(src, dst, src_weight=1.0, dst_weight=1.0,
                     mode: str = "l2", dst_valid=None):
    """Bidirectional nearest-point distances: src (B, N, C), dst (B, M, C).

    ``dst_valid`` (B, M) bool keeps invalid dst rows out of the src->dst
    argmin (a row with no valid dst falls back to all of them); the
    dst->src direction is not masked. Returns loss_src (B, N), loss_dst
    (B, M), idx_src (B, N), idx_dst (B, M); argmins take the first index
    of equal values.
    """
    distance = _CRITERIA[mode](src[:, :, None, :], dst[:, None, :, :]).sum(-1)
    d_for_src = distance
    if dst_valid is not None:
        masked = torch.where(dst_valid[:, None, :], distance, torch.inf)
        any_valid = dst_valid.any(dim=-1)[:, None, None]
        d_for_src = torch.where(any_valid, masked, distance)
    src2dst, idx_src = d_for_src.min(dim=2)
    dst2src, idx_dst = distance.min(dim=1)
    return src2dst * src_weight, dst2src * dst_weight, idx_src, idx_dst
