"""NesieHead: per-side distribution box regression + quality estimation.

Counterpart of ``nesie_tpu/nn/nesie_head.py``: vote -> aggregate (SA
module, by ``sample_mod``) -> shared conv head -> integral side decode
(``side2box``) -> jittered proposal copies (``with_jitter``) ->
SidePooling quality module.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch import parallel
from nesie_tpu_torch.ops import furthest_point_sample
from .heads import ReliableConvBboxHead, integral_expectation
from .layers import device_constant
from .pointnet2 import PointSAModule
from .side_pooling import SidePooling
from .vote import VoteModule

SAMPLE_MODS = ("vote", "seed", "random", "spec")


def side2box(aggregated_points, side_offsets, heading_pred, sizes):
    """Decode per-side offsets into 7-dof boxes.

    aggregated_points (B, P, 3), side_offsets (B, P, 6) in [0, 1],
    heading_pred (B, P, 2), sizes (3,) -> surface_pred (B, P, 6)
    ``(x1,y1,z1,x2,y2,z2)``, surface_scale (B, P, 6), bbox_pred (B, P, 7).
    """
    sizes = tuple(sizes)
    scale = device_constant(
        ("side2box", sizes), side_offsets.device,
        lambda: torch.tensor(sizes + sizes, dtype=torch.float32))
    scale = scale.expand_as(side_offsets)
    lo = aggregated_points - side_offsets[..., :3] * scale[..., :3]
    hi = aggregated_points + side_offsets[..., 3:] * scale[..., 3:]
    surface_pred = torch.cat([lo, hi], dim=-1)

    h0, h1 = heading_pred[..., 0], heading_pred[..., 1]
    norm = torch.clamp(torch.sqrt(h0 * h0 + h1 * h1), min=1e-12)
    heading = torch.atan2(h0 / norm, h1 / norm)

    center = 0.5 * (lo + hi)
    size = hi - lo
    bbox_pred = torch.cat([center, size, heading[..., None]], dim=-1)
    return surface_pred, scale, bbox_pred


def jitter_noise(shape, generator: torch.Generator, device: torch.device,
                 rows: parallel.RowLayout | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two standard-normal draws of ``jitter_boxes``, from
    ``generator`` (on the generator's device, then moved to ``device``);
    with ``rows``, this rank's rows of the global batch's draws."""
    def draw(s):
        return torch.randn(s, generator=generator, device=generator.device)

    n1 = parallel.draw_rows(rows, draw, shape)
    n2 = parallel.draw_rows(rows, draw, shape)
    return n1.to(device), n2.to(device)


def jitter_boxes(bbox_pred, noise, noise_scale: float = 0.3,
                 size_bias: float = 0.0):
    """Jittered copies of the decoded boxes (reference nesie_head.py:178):
    bbox_pred (B, P, 7), noise two (B, P, 3) standard-normal tensors ->
    (B, P, 7), heading copied."""
    n1, n2 = noise
    center, size = bbox_pred[..., :3], bbox_pred[..., 3:6]
    center_j = center + size * n1 * noise_scale
    size_j = torch.clamp(size + size * (n2 * noise_scale + size_bias),
                         min=1e-8)
    return torch.cat([center_j, size_j, bbox_pred[..., 6:7]], dim=-1)


def random_sample_indices(shape, num_seed: int, generator: torch.Generator,
                          device: torch.device,
                          rows: parallel.RowLayout | None = None
                          ) -> torch.Tensor:
    """``sample_mod="random"``'s draw: (B, P) int32 seed indices uniform
    in [0, num_seed), from ``generator`` (on the generator's device, then
    moved to ``device``); with ``rows``, this rank's rows of the global
    batch's draw."""
    def draw(s):
        return torch.randint(0, num_seed, s, generator=generator,
                             device=generator.device, dtype=torch.int32)

    return parallel.draw_rows(rows, draw, shape).to(device)


class ProposalHead(nn.Module):
    """The forward steps NesieHead and SAQEHead share: vote, aggregate
    (``sample_mod``), and the detached (and jittered) proposal boxes that
    the quality module scores. A subclass sets ``vote_module``,
    ``vote_aggregation``, ``num_proposal``, ``dataset_name``,
    ``seed_fps_prefix_opt`` and the jitter's ``jitter_scale`` and
    ``jitter_size_bias``.

    Sample modes: ``vote`` runs FPS over the votes; ``seed`` takes the
    seeds' FPS (an ``arange`` by prefix consistency, or the real FPS with
    ``seed_fps_prefix_opt=False``); ``random`` draws seed indices
    (``sample_indices``, or from the generator); each of these aggregates
    the votes around the sampled votes. ``spec`` aggregates the seeds
    around every vote, so P is the seed count."""

    @staticmethod
    def _check(sample_mod: str, with_jitter: bool, noise, generator,
               sample_indices) -> None:
        if sample_mod not in SAMPLE_MODS:
            raise ValueError(f"sample_mod={sample_mod!r}: not one of "
                             f"{SAMPLE_MODS}")
        if with_jitter and noise is None and generator is None:
            raise ValueError("with_jitter needs noise or a generator")
        if (sample_mod == "random" and sample_indices is None
                and generator is None):
            raise ValueError("sample_mod='random' needs sample_indices or "
                             "a generator")

    def _aggregate(self, feat_dict: dict, sample_mod: str,
                   generator: torch.Generator | None = None,
                   sample_indices: torch.Tensor | None = None,
                   rows: parallel.RowLayout | None = None):
        """Returns the results dict (seed, vote and aggregated tensors) and
        the aggregated features."""
        seed_points = feat_dict["fp_xyz"][-1]
        seed_features = feat_dict["fp_features"][-1]
        vote_points, vote_features, vote_offset = self.vote_module(
            seed_points, seed_features)
        results = dict(
            seed_points=seed_points,
            seed_features=seed_features,
            seed_indices=feat_dict["fp_indices"][-1],
            vote_points=vote_points,
            vote_features=vote_features,
            vote_offset=vote_offset,
        )

        B, num_seed = seed_points.shape[:2]
        if sample_mod == "spec":
            agg = self.vote_aggregation(seed_points, seed_features,
                                        target_xyz=vote_points)
        else:
            if sample_mod == "vote":  # FPS over the votes
                sample_indices = None
            elif sample_mod == "seed":
                if self.seed_fps_prefix_opt:
                    # seeds are the FPS-ordered SA2 points: by FPS prefix
                    # consistency the head's seed FPS is an arange
                    sample_indices = torch.arange(
                        self.num_proposal, dtype=torch.int32,
                        device=seed_points.device).expand(B, -1)
                else:
                    sample_indices = furthest_point_sample(
                        seed_points, self.num_proposal)
            elif sample_indices is None:  # random
                sample_indices = random_sample_indices(
                    (B, self.num_proposal), num_seed, generator,
                    seed_points.device, rows)
            agg = self.vote_aggregation(vote_points, vote_features,
                                        indices=sample_indices)
        aggregated_points, features, aggregated_indices = agg
        results["aggregated_points"] = aggregated_points
        results["aggregated_features"] = features
        results["aggregated_indices"] = aggregated_indices
        return results, features

    def _quality_boxes(self, bbox_pred, results: dict, with_jitter: bool,
                       noise, generator, rows=None):
        """The quality module's boxes: ``bbox_pred`` and, with jitter, its
        jittered copies (stored as ``jitter_bbox_preds``), detached;
        returns (boxes (B, P or 2P, 7), heading), the heading 0 for
        ScanNet."""
        if with_jitter:
            if noise is None:
                noise = jitter_noise(bbox_pred[..., :3].shape, generator,
                                     bbox_pred.device, rows)
            jitter = jitter_boxes(bbox_pred, noise, self.jitter_scale,
                                  self.jitter_size_bias)
            results["jitter_bbox_preds"] = jitter
            both = torch.cat([bbox_pred, jitter], dim=1).detach()
        else:
            both = bbox_pred.detach()
        if self.dataset_name == "ScanNet":
            heading = torch.zeros_like(both[..., 6])
        else:
            heading = both[..., 6]
        return both, heading


class NesieHead(ProposalHead):
    """Forward pass of the Nesie detection head. Returns obj_scores
    (B,P,2), sem_scores (B,P,C), bbox_preds (B,P,7), surface_pred/scale
    (B,P,6), bbox_probs (B,P,6,n+1), iou_scores (B,P,C) and side_scores
    (B,P,6,C) (both sigmoided), plus the seed, vote and aggregated
    tensors; with jitter also jitter_bbox_preds (B,P,7),
    iou_scores_jitter and side_scores_jitter."""

    def __init__(
        self,
        num_classes: int = 18,
        reg_max: int = 32,
        num_proposal: int = 256,
        seed_feat_dim: int = 256,
        sizes: Sequence[float] = (3.0, 3.0, 2.5),
        vote_conv_channels: Sequence[int] = (256, 256),
        agg_radius: float = 0.3,
        agg_num_sample: int = 16,
        agg_mlp_channels: Sequence[int] = (128, 128, 128),
        pred_shared_channels: Sequence[int] = (128, 128),
        dataset_name: str = "ScanNet",
        jitter_scale: float = 0.3,
        jitter_size_bias: float = 0.0,
        seed_fps_prefix_opt: bool = True,
    ):
        super().__init__()
        self.seed_fps_prefix_opt = seed_fps_prefix_opt
        self.jitter_scale = jitter_scale
        self.jitter_size_bias = jitter_size_bias
        self.reg_max = reg_max
        self.num_proposal = num_proposal
        self.sizes = tuple(sizes)
        self.dataset_name = dataset_name
        self.n_reg_outs = 6 * (reg_max + 1)
        self.vote_module = VoteModule(seed_feat_dim, vote_conv_channels)
        self.vote_aggregation = PointSAModule(
            num_proposal, agg_radius, agg_num_sample, seed_feat_dim,
            agg_mlp_channels)
        self.conv_pred = ReliableConvBboxHead(
            agg_mlp_channels[-1], pred_shared_channels,
            num_cls_out=num_classes + 2, num_bbox_out=self.n_reg_outs,
            num_heading_out=2)
        self.grid_conv = SidePooling(num_classes, seed_feat_dim,
                                     reg_max=reg_max)

    def forward(self, feat_dict: dict, sample_mod: str = "seed",
                with_jitter: bool = False, noise=None,
                generator: torch.Generator | None = None,
                sample_indices: torch.Tensor | None = None,
                rows: parallel.RowLayout | None = None) -> dict:
        """``with_jitter`` adds the jittered proposal copies; their noise
        is ``noise`` (two (B, P, 3) tensors) or drawn from ``generator``
        (with ``rows``, this rank's rows of the global batch's draws, as
        for ``random``'s indices).
        In train mode the quality module's BN statistics then cover all
        2P proposals, as in the reference. ``sample_mod="random"`` takes
        ``sample_indices`` (B, P) or draws them from ``generator`` first,
        before the jitter noise."""
        self._check(sample_mod, with_jitter, noise, generator,
                    sample_indices)
        results, features = self._aggregate(feat_dict, sample_mod,
                                            generator, sample_indices, rows)
        aggregated_points = results["aggregated_points"]
        B = aggregated_points.shape[0]

        cls_pred, reg_pred = self.conv_pred(features)
        results["obj_scores"] = cls_pred[..., :2]
        results["sem_scores"] = cls_pred[..., 2:]

        P = reg_pred.shape[1]
        dist_logits = reg_pred[..., :self.n_reg_outs].reshape(
            B, P, 6, self.reg_max + 1)
        side_offsets = integral_expectation(dist_logits, self.reg_max)
        surface_pred, surface_scale, bbox_pred = side2box(
            aggregated_points, side_offsets, reg_pred[..., self.n_reg_outs:],
            self.sizes)
        results["surface_pred"] = surface_pred
        results["surface_scale"] = surface_scale
        results["bbox_preds"] = bbox_pred
        results["bbox_probs"] = torch.softmax(dist_logits, dim=-1)

        # quality module on the detached (and jittered) boxes
        both, heading = self._quality_boxes(bbox_pred, results, with_jitter,
                                            noise, generator, rows)
        side_scores, iou_scores = self.grid_conv(
            both[..., :3], both[..., 3:6], heading,
            results["seed_points"].detach(),
            results["seed_features"].detach(), results["bbox_probs"].detach())
        iou_scores = torch.sigmoid(iou_scores)
        side_scores = torch.sigmoid(side_scores)
        results["iou_scores"] = iou_scores[:, :P]
        results["side_scores"] = side_scores[:, :P]
        if with_jitter:
            results["iou_scores_jitter"] = iou_scores[:, P:]
            results["side_scores_jitter"] = side_scores[:, P:]
        return results
