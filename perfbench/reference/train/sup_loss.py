"""Supervised Nesie loss. Counterpart of ``nesie_tpu/train/sup_loss.py``
(reference NesieHead.loss, nesie_head.py:277-412, and
VoteModule.get_loss, vote_module.py:149): every reduction, weight and the
sigma attenuation as there, on the head's results dict and HeadTargets.
Normalisers are global-batch sums (see ``targets``), so each rank's terms
are its share of the global loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.reference import parallel
from perfbench.reference.core.iou import iou3d
from perfbench.reference.losses import (
    iou_3d_loss,
    l1_loss,
    mse_loss,
    quality_focal_loss,
    side_pred_loss,
    softmax_cross_entropy,
    surface_loss_mse,
)
from .targets import HeadTargets


@dataclass(frozen=True)
class NesieLossConfig:
    num_classes: int = 18
    alpha: float = 1.0
    vote_dst_weight: float = 10.0
    objectness_weight: float = 5.0
    objectness_class_weight: tuple = (0.2, 0.8)
    center_src_weight: float = 10.0
    center_dst_weight: float = 10.0
    surface_weight: float = 10.0
    semantic_weight: float = 1.0
    iou_weight: float = 3.0
    iou_pred_weight: float = 1.0
    iou_pred_beta: float = 2.0
    side_weight: float = 1.0
    gt_per_seed: int = 3


def sigma_poly(side_scores):
    """sigma(s) = 0.8 s^2 - 1.8 s + 1 (nesie_head.py:347)."""
    return 0.8 * side_scores * side_scores - 1.8 * side_scores + 1.0


def vote_loss_fn(results, targets: HeadTargets, cfg: NesieLossConfig):
    """Min-over-GT-votes L1 chamfer (vote_module.py:149-180)."""
    seed_idx = results["seed_indices"].long()  # (B, S)
    mask = targets.vote_target_masks.gather(1, seed_idx).float()
    g = cfg.gt_per_seed
    vt = targets.vote_targets.gather(
        1, seed_idx[..., None].expand(-1, -1, 3 * g))
    B, S = seed_idx.shape
    gt_votes = (vt + results["seed_points"].repeat(1, 1, g)).reshape(B, S, g, 3)
    dist = l1_loss(results["vote_points"][:, :, None, :], gt_votes).sum(-1)
    weight = mask / (parallel.all_reduce_sum(mask.sum()) + 1e-6)
    dist = dist * weight[..., None] * cfg.vote_dst_weight
    return dist.amin(-1).sum()


def center_loss_fn(results, targets: HeadTargets, cfg: NesieLossConfig):
    """Bidirectional L2 chamfer between proposal centers and the padded GT
    centers (the padded zeros take part in the proposal->GT min)."""
    src = results["bbox_preds"][..., :3]
    d = mse_loss(src[:, :, None], targets.center_targets[:, None]).sum(-1)
    s2d = d.amin(2) * targets.box_loss_weights * cfg.center_src_weight
    d2s = d.amin(1) * targets.valid_gt_weights * cfg.center_dst_weight
    return s2d.sum() + d2s.sum()


def _at_class(side, cls):
    """side (F, 6, C), cls (F,) -> (F, 6): each row's side scores at cls."""
    return side.gather(2, cls.long()[:, None, None].expand(-1, 6, 1))[..., 0]


def nesie_supervised_loss(results, targets: HeadTargets,
                          cfg: NesieLossConfig = NesieLossConfig()):
    """Returns (total, dict of scalar terms)."""
    C = cfg.num_classes
    B, P = results["obj_scores"].shape[:2]
    flat = B * P
    losses = {"vote_loss": vote_loss_fn(results, targets, cfg)}

    obj_ce = softmax_cross_entropy(results["obj_scores"],
                                   targets.objectness_targets,
                                   class_weight=cfg.objectness_class_weight)
    losses["objectness_loss"] = cfg.objectness_weight * (
        obj_ce * targets.objectness_weights).sum()
    losses["center_loss"] = center_loss_fn(results, targets, cfg)

    # surface loss with sigma attenuation
    bbox_targets = targets.bbox_targets.reshape(flat, -1)
    surface_pred = results["surface_pred"].reshape(flat, 6)
    box_w = targets.box_loss_weights.reshape(flat)
    surface_weight = box_w[:, None].expand(-1, 6)
    raw_surface = cfg.surface_weight * surface_loss_mse(
        surface_pred, bbox_targets) * surface_weight
    side_all = results["side_scores"].reshape(flat, 6, C)
    sem_argmax = results["sem_scores"].argmax(-1).reshape(flat)
    sigma = sigma_poly(_at_class(side_all, sem_argmax))
    losses["surface_loss"] = (torch.exp(-sigma) * raw_surface
                              + cfg.alpha * sigma * surface_weight).sum()

    sem_ce = softmax_cross_entropy(results["sem_scores"], targets.mask_targets)
    losses["semantic_loss"] = cfg.semantic_weight * (
        sem_ce * targets.box_loss_weights).sum()

    # rotated IoU loss with sigma-mean attenuation
    bbox_pred_flat = results["bbox_preds"].reshape(flat, 7)
    raw_iou = cfg.iou_weight * iou_3d_loss(bbox_pred_flat, bbox_targets) \
        * box_w
    sigma_mean = sigma.mean(-1)
    losses["iou_loss"] = (torch.exp(-sigma_mean) * raw_iou
                          + cfg.alpha * sigma_mean * box_w).sum()

    # IoU-prediction QFL on the main and the jittered proposals
    label_cls = targets.mask_targets.reshape(flat)
    with torch.no_grad():
        label_iou = iou3d(bbox_pred_flat, bbox_targets)
        label_iou_j = iou3d(results["jitter_bbox_preds"].reshape(flat, 7),
                            bbox_targets)
    qfl = [quality_focal_loss(results[key].reshape(flat, C), label_cls, lab,
                              beta=cfg.iou_pred_beta, use_sigmoid=False)
           for key, lab in (("iou_scores", label_iou),
                            ("iou_scores_jitter", label_iou_j))]
    losses["iou_pred_loss"] = cfg.iou_pred_weight * (
        (qfl[0] * box_w).sum() + (qfl[1] * box_w).sum())

    # side prediction loss (self-distilled)
    losses["side_loss"] = cfg.side_weight * side_pred_loss(
        _at_class(side_all, label_cls), surface_pred.detach(), bbox_targets,
        weight=surface_weight).sum()

    return sum(losses.values()), losses
