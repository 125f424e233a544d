"""Loss of the legacy VoteHead. Counterpart of
``nesie_tpu/train/votehead_loss.py`` (reference vote_head.py:loss and
PartialBinBasedBBoxCoder.encode): bin-based direction and size targets
on the Nesie head's target assignment (``targets.get_targets``), with its
vote and centre losses.

Kept from the JAX package: the size residual is divided by the cluster's
mean size on both sides, and the size cluster is the semantic class (the
indoor convention).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from nesie_tpu_torch.losses import smooth_l1_loss, softmax_cross_entropy
from .sup_loss import NesieLossConfig, center_loss, vote_loss_fn
from .targets import HeadTargets


@dataclass(frozen=True)
class VoteHeadLossConfig(NesieLossConfig):
    dir_class_weight: float = 1.0
    dir_res_weight: float = 10.0
    size_class_weight: float = 1.0
    size_res_weight: float = 10.0
    num_dir_bins: int = 1
    with_rot: bool = False


def votehead_supervised_loss(preds, targets: HeadTargets, mean_sizes,
                             cfg: VoteHeadLossConfig = VoteHeadLossConfig()):
    """Returns (total, dict of scalar terms). ``mean_sizes``: (num_sizes,
    3)."""
    w = targets.box_loss_weights  # (B, P)
    losses = {"vote_loss": vote_loss_fn(preds, targets, cfg)}

    obj_ce = softmax_cross_entropy(preds["obj_scores"],
                                   targets.objectness_targets,
                                   class_weight=cfg.objectness_class_weight)
    losses["objectness_loss"] = cfg.objectness_weight * (
        obj_ce * targets.objectness_weights).sum()
    decoded_center = preds["aggregated_points"] + preds["center_offset"]
    losses["center_loss"] = center_loss({"bbox_preds": decoded_center},
                                        targets, cfg)

    zero = w.new_zeros(())
    gt_yaw = torch.remainder(targets.bbox_targets[..., 6], 2 * torch.pi)
    if cfg.with_rot and cfg.num_dir_bins > 1:
        bin_width = 2 * torch.pi / cfg.num_dir_bins
        shifted = torch.remainder(gt_yaw + bin_width / 2, 2 * torch.pi)
        dir_bin = torch.floor(shifted / bin_width).long()
        dir_res_t = shifted - (dir_bin.to(gt_yaw.dtype) + 0.5) * bin_width
        losses["dir_class_loss"] = cfg.dir_class_weight * (
            softmax_cross_entropy(preds["dir_class"], dir_bin) * w).sum()
        res_pred = preds["dir_res"].gather(-1, dir_bin[..., None])[..., 0]
        losses["dir_res_loss"] = cfg.dir_res_weight * (
            smooth_l1_loss(res_pred, dir_res_t) * w).sum()
    else:
        losses["dir_class_loss"] = zero
        losses["dir_res_loss"] = zero

    size_cls_t = targets.mask_targets.long()
    losses["size_class_loss"] = cfg.size_class_weight * (
        softmax_cross_entropy(preds["size_class"], size_cls_t) * w).sum()
    res = preds["size_res"]
    mean = torch.as_tensor(mean_sizes, dtype=res.dtype,
                           device=res.device)[size_cls_t]  # (B, P, 3)
    scale = torch.clamp(mean, min=1e-6)
    size_res_t = (targets.bbox_targets[..., 3:6] - mean) / scale
    res_pred = res.gather(
        -2, size_cls_t[..., None, None].expand(*size_cls_t.shape, 1, 3)
    )[..., 0, :] / scale
    losses["size_res_loss"] = cfg.size_res_weight * (
        smooth_l1_loss(res_pred, size_res_t).mean(-1) * w).sum()

    sem_ce = softmax_cross_entropy(preds["sem_scores"], targets.mask_targets)
    losses["semantic_loss"] = cfg.semantic_weight * (sem_ce * w).sum()
    return sum(losses.values()), losses
