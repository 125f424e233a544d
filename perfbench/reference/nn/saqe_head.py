"""SAQEHead: the side-aware quality estimation head (reference
mmdet3d/models/dense_heads/saqe_head.py). Counterpart of
``nesie_tpu/nn/saqe_head.py``.

Differences from NesieHead (saqe_head.py:191-328):

* the box branch emits 3 more channels, learned per-axis log-scales
  (``exp``), in place of the fixed sizes ``[3, 3, 2.5]``;
* the heading is a 12-bin angle distribution (``AngleIntegral``), decoded
  to an angle in (-pi, pi];
* stronger jitter (0.5 noise, +0.2 size bias) and a
  ``jitter_surface_preds`` output;
* QualityEstimation replaces SidePooling, adding the rotate_scores and
  R_obj_scores outputs; R_obj_scores stay logits (decode takes its
  objectness from them).
"""
from __future__ import annotations

from typing import Sequence

import torch

from perfbench.reference.losses.surface import bbox_to_surface
from .heads import (
    ReliableConvBboxHead,
    angle_integral_expectation,
    integral_expectation,
)
from .nesie_head import ProposalHead
from .pointnet2 import PointSAModule
from .quality_estimation import QualityEstimation
from .vote import VoteModule


def side2box(aggregated_points, reg_pred, reg_max: int):
    """Learned-scale integral decode (saqe_head.py:191-218).

    aggregated_points (B, P, 3), reg_pred (B, P, 6*(reg_max+1) + 3 + n)
    -> surface_pred (B, P, 6) ``(x1,y1,z1,x2,y2,z2)``, surface_scale
    (B, P, 6), bbox_pred (B, P, 7) and the side-distribution logits
    (B, P, 6, reg_max+1)."""
    B, P = reg_pred.shape[:2]
    n_reg = 6 * (reg_max + 1)
    dist_logits = reg_pred[..., :n_reg].reshape(B, P, 6, reg_max + 1)
    offsets = integral_expectation(dist_logits, reg_max)  # (B, P, 6)
    scale3 = torch.exp(reg_pred[..., n_reg:n_reg + 3])
    scale = torch.cat([scale3, scale3], dim=-1)
    lo = aggregated_points - offsets[..., :3] * scale3
    hi = aggregated_points + offsets[..., 3:] * scale3
    surface_pred = torch.cat([lo, hi], dim=-1)
    angles = angle_integral_expectation(reg_pred[..., n_reg + 3:])
    center = 0.5 * (lo + hi)
    size = hi - lo
    bbox_pred = torch.cat([center, size, angles[..., None]], dim=-1)
    return surface_pred, scale, bbox_pred, dist_logits


class SAQEHead(ProposalHead):
    """Forward pass of the SAQE detection head. Returns NesieHead's keys
    (side2box above), plus rotate_scores (B,P,C) (sigmoided) and
    R_obj_scores (B,P,2) (logits); with jitter also jitter_bbox_preds,
    jitter_surface_preds (B,P,6) and the ``_jitter`` halves of the four
    quality outputs."""

    def __init__(
        self,
        num_classes: int = 18,
        reg_max: int = 32,
        num_heading_out: int = 12,
        num_proposal: int = 256,
        seed_feat_dim: int = 256,
        vote_conv_channels: Sequence[int] = (256, 256),
        agg_radius: float = 0.3,
        agg_num_sample: int = 16,
        agg_mlp_channels: Sequence[int] = (128, 128, 128),
        pred_shared_channels: Sequence[int] = (128, 128),
        dataset_name: str = "ScanNet",
        jitter_scale: float = 0.5,
        jitter_size_bias: float = 0.2,
        seed_fps_prefix_opt: bool = True,
    ):
        super().__init__()
        self.seed_fps_prefix_opt = seed_fps_prefix_opt
        self.jitter_scale = jitter_scale
        self.jitter_size_bias = jitter_size_bias
        self.reg_max = reg_max
        self.num_proposal = num_proposal
        self.dataset_name = dataset_name
        self.vote_module = VoteModule(seed_feat_dim, vote_conv_channels)
        self.vote_aggregation = PointSAModule(
            num_proposal, agg_radius, agg_num_sample, seed_feat_dim,
            agg_mlp_channels)
        self.conv_pred = ReliableConvBboxHead(
            agg_mlp_channels[-1], pred_shared_channels,
            num_cls_out=num_classes + 2,
            num_bbox_out=6 * (reg_max + 1) + 3,  # +3 learned log-scales
            num_heading_out=num_heading_out)
        self.grid_conv = QualityEstimation(num_classes, seed_feat_dim,
                                           reg_max=reg_max)

    def forward(self, feat_dict: dict, sample_mod: str = "seed",
                with_jitter: bool = False, noise=None,
                generator: torch.Generator | None = None,
                sample_indices: torch.Tensor | None = None,
                rows=None) -> dict:
        """As ``NesieHead.forward``."""
        self._check(sample_mod, with_jitter, noise, generator,
                    sample_indices)
        results, features = self._aggregate(feat_dict, sample_mod,
                                            generator, sample_indices, rows)

        cls_pred, reg_pred = self.conv_pred(features)
        results["obj_scores"] = cls_pred[..., :2]
        results["sem_scores"] = cls_pred[..., 2:]
        surface_pred, surface_scale, bbox_pred, dist_logits = side2box(
            results["aggregated_points"], reg_pred, self.reg_max)
        P = bbox_pred.shape[1]
        results["surface_pred"] = surface_pred
        results["surface_scale"] = surface_scale
        results["bbox_preds"] = bbox_pred
        results["bbox_probs"] = torch.softmax(dist_logits, dim=-1)

        both, heading = self._quality_boxes(bbox_pred, results, with_jitter,
                                            noise, generator, rows)
        if with_jitter:
            results["jitter_surface_preds"] = bbox_to_surface(
                results["jitter_bbox_preds"])
        side_scores, iou_scores, rotate_scores, r_obj_scores = \
            self.grid_conv(both[..., :3], both[..., 3:6], heading,
                           results["seed_points"].detach(),
                           results["seed_features"].detach(),
                           results["bbox_probs"].detach())
        outputs = dict(iou_scores=torch.sigmoid(iou_scores),
                       side_scores=torch.sigmoid(side_scores),
                       rotate_scores=torch.sigmoid(rotate_scores),
                       R_obj_scores=r_obj_scores)
        for key, v in outputs.items():
            results[key] = v[:, :P]
            if with_jitter:
                results[f"{key}_jitter"] = v[:, P:]
        return results
