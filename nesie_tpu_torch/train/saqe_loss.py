"""SAQE losses. Counterpart of ``nesie_tpu/train/saqe_loss.py``: the
reference SAQEHead.loss (pretrain, saqe_head.py:331-521), sup_loss (the
semi phase's labeled part, :524-705) and unsup_loss (:706-800).

Where they differ from the Nesie losses:

* objectness also supervises the quality module's R_obj branches (main
  and jitter, x0.5);
* the angle: SmoothL1 on sin and cos (x10), and in pretrain only a
  self-distilled angle quality (MSE on rotate_scores, x1) whose label is
  divided by the batch's largest box-loss weight (saqe_head.py:427; the
  global batch's, over every rank under a process group);
* pretrain applies no sigma attenuation; the semi phase applies
  ``exp(-sigma)`` with sigma detached and no ``+ alpha * sigma`` term;
* the side loss also supervises the jittered side scores against the
  jittered surfaces.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from nesie_tpu_torch import parallel
from nesie_tpu_torch.core.iou import iou3d
from nesie_tpu_torch.losses import (
    iou_3d_loss,
    mse_loss,
    quality_focal_loss,
    side_pred_loss,
    smooth_l1_loss,
    softmax_cross_entropy,
    surface_loss_mse,
)
from .sup_loss import (
    NesieLossConfig,
    _at_class,
    center_loss_fn,
    sigma_poly,
    vote_loss_fn,
)
from .targets import HeadTargets


@dataclass(frozen=True)
class SAQELossConfig(NesieLossConfig):
    angle_weight: float = 10.0
    angle_beta: float = 1.0
    angle_pred_weight: float = 1.0


def _at(scores, cls):
    """scores (F, C), cls (F,) -> (F,): each row's score at its class."""
    return scores.gather(1, cls.long()[:, None])[:, 0]


def saqe_supervised_loss(results, targets: HeadTargets,
                         cfg: SAQELossConfig = SAQELossConfig(),
                         phase: str = "pretrain"):
    """phase: "pretrain" (no attenuation) or "semi" (detached sigma).
    Returns (total, dict of scalar terms)."""
    C = cfg.num_classes
    B, P = results["obj_scores"].shape[:2]
    flat = B * P
    losses = {"vote_loss": vote_loss_fn(results, targets, cfg)}

    def obj_ce(scores):
        ce = softmax_cross_entropy(scores, targets.objectness_targets,
                                   class_weight=cfg.objectness_class_weight)
        return cfg.objectness_weight * (ce * targets.objectness_weights).sum()

    losses["objectness_loss"] = obj_ce(results["obj_scores"]) + 0.5 * (
        obj_ce(results["R_obj_scores"])
        + obj_ce(results["R_obj_scores_jitter"]))
    losses["center_loss"] = center_loss_fn(results, targets, cfg)

    bbox_targets = targets.bbox_targets.reshape(flat, -1)
    surface_pred = results["surface_pred"].reshape(flat, 6)
    w = targets.box_loss_weights.reshape(flat)
    surface_weight = w[:, None].expand(-1, 6)
    raw_surface = cfg.surface_weight * surface_loss_mse(
        surface_pred, bbox_targets) * surface_weight

    sem_argmax = results["sem_scores"].argmax(-1).reshape(flat)
    side_all = results["side_scores"].reshape(flat, 6, C)
    sigma = sigma_poly(_at_class(side_all, sem_argmax)).detach()
    if phase == "semi":
        losses["surface_loss"] = (torch.exp(-sigma) * raw_surface).sum()
    else:
        losses["surface_loss"] = raw_surface.sum()

    # the angle
    pred_angle = results["bbox_preds"][..., 6].reshape(flat)
    target_angle = bbox_targets[..., 6]
    sin_l = smooth_l1_loss(torch.sin(pred_angle), torch.sin(target_angle),
                           cfg.angle_beta)
    cos_l = smooth_l1_loss(torch.cos(pred_angle), torch.cos(target_angle),
                           cfg.angle_beta)
    angle_elem = cfg.angle_weight * (sin_l + cos_l) * w
    rot_at = _at(results["rotate_scores"].reshape(flat, C), sem_argmax)
    if phase == "semi":
        angle_sigma = sigma_poly(rot_at).detach()
        losses["angle_loss"] = (torch.exp(-angle_sigma) * angle_elem).sum()
    else:
        losses["angle_loss"] = angle_elem.sum()

    # self-distilled angle quality, pretrain only: the semi phase's
    # sup_loss (saqe_head.py:524-705) never trains rotate_scores
    if phase != "semi":
        angle_label = (angle_elem / torch.clamp(parallel.all_reduce_max(
            targets.box_loss_weights.max()), min=1e-12)).detach()
        rot_j_at = _at(results["rotate_scores_jitter"].reshape(flat, C),
                       sem_argmax)
        losses["angle_pred_loss"] = cfg.angle_pred_weight * (
            (mse_loss(rot_at, angle_label) * w).sum()
            + (mse_loss(rot_j_at, angle_label) * w).sum())

    sem_ce = softmax_cross_entropy(results["sem_scores"], targets.mask_targets)
    losses["semantic_loss"] = cfg.semantic_weight * (
        sem_ce * targets.box_loss_weights).sum()

    bbox_pred_flat = results["bbox_preds"].reshape(flat, 7)
    raw_iou = cfg.iou_weight * iou_3d_loss(bbox_pred_flat, bbox_targets) * w
    if phase == "semi":
        losses["iou_loss"] = (torch.exp(-sigma.mean(-1)) * raw_iou).sum()
    else:
        losses["iou_loss"] = raw_iou.sum()

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
        (qfl[0] * w).sum() + (qfl[1] * w).sum())

    # side prediction, main and jittered proposals (self-distilled)
    side_main = side_pred_loss(
        _at_class(side_all, label_cls), surface_pred.detach(), bbox_targets,
        weight=surface_weight).sum()
    side_jit = side_pred_loss(
        _at_class(results["side_scores_jitter"].reshape(flat, 6, C),
                  label_cls),
        results["jitter_surface_preds"].reshape(flat, 6).detach(),
        bbox_targets, weight=surface_weight).sum()
    losses["side_loss"] = cfg.side_weight * (side_main + side_jit)

    return sum(losses.values()), losses


def saqe_unsup_loss(results, targets: HeadTargets, pseudo_quality,
                    cfg: SAQELossConfig = SAQELossConfig(),
                    un_label_weight: float = 2.0):
    """SAQE's unsupervised losses (saqe_head.py:706-800): Nesie's, with
    sigma detached and no ``+ alpha * sigma`` term; pseudo_quality
    (B, MAX_OBJ, 6), zero on invalid slots."""
    C = cfg.num_classes
    B, P = results["obj_scores"].shape[:2]
    flat = B * P
    quality_side = pseudo_quality.gather(
        1, targets.assignment.long()[..., None].expand(-1, -1, 6))
    quality_mean = quality_side.mean(-1)

    losses = {"unsup_center_loss": center_loss_fn(results, targets, cfg)}
    sem_ce = softmax_cross_entropy(results["sem_scores"], targets.mask_targets)
    losses["unsup_semantic_loss"] = cfg.semantic_weight * (
        sem_ce * targets.box_loss_weights).sum()

    sem_argmax = results["sem_scores"].argmax(-1).reshape(flat)
    sigma = sigma_poly(_at_class(results["side_scores"].reshape(flat, 6, C),
                                 sem_argmax)).detach()
    bbox_targets = targets.bbox_targets.reshape(flat, -1)

    iou_weight = (targets.box_loss_weights * quality_mean).reshape(flat)
    raw_iou = cfg.iou_weight * iou_3d_loss(
        results["bbox_preds"].reshape(flat, 7), bbox_targets) * iou_weight
    losses["unsup_iou_loss"] = (torch.exp(-sigma.mean(-1)) * raw_iou).sum()

    surface_weight = (targets.box_loss_weights.reshape(flat)[:, None]
                      * quality_side.reshape(flat, 6))
    raw_surface = cfg.surface_weight * surface_loss_mse(
        results["surface_pred"].reshape(flat, 6), bbox_targets) \
        * surface_weight
    losses["unsup_surface_loss"] = (torch.exp(-sigma) * raw_surface).sum()

    losses = {k: un_label_weight * v for k, v in losses.items()}
    return sum(losses.values()), losses
