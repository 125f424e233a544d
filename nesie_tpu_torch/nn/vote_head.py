"""The legacy VoteNet head with the partial-bin box coder. Counterpart of
``nesie_tpu/nn/vote_head.py`` (reference mmdet3d vote_head.py and
partial_bin_based_bbox_coder.py); the Nesie configs do not use it.

Prediction layout of a proposal, after objectness (2):
  centre offset (3) | dir class (Nd) | dir res (Nd) | size class (Ns) |
  size res (Ns * 3) | semantic (C)

``VoteNet`` is the PointNet++ SSG backbone with this head: the VoteNet
ScanNet widths at its defaults.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch.ops import furthest_point_sample
from .layers import PointMLP
from .pointnet2 import PointNet2SASSG, PointSAModule
from .vote import VoteModule

SAMPLE_MODS = ("vote", "seed")


class BinBoxCoder:
    """The partial-bin coder's constants and its decode."""

    def __init__(self, num_dir_bins: int, num_sizes: int, mean_sizes,
                 with_rot: bool):
        self.num_dir_bins = num_dir_bins
        self.num_sizes = num_sizes
        self.mean_sizes = torch.as_tensor(mean_sizes, dtype=torch.float32)
        self.with_rot = with_rot

    def decode(self, aggregated_points: torch.Tensor, preds: dict):
        """The head's preds -> (B, P, 7) gravity-centred boxes: the argmax
        direction bin (the first on ties) plus its residual, the argmax
        size cluster's mean size plus its residual, at least 0.1."""
        center = aggregated_points + preds["center_offset"]
        if self.with_rot:
            dir_cls = preds["dir_class"].argmax(-1)
            dir_res = preds["dir_res"].gather(-1, dir_cls[..., None])[..., 0]
            angle = (dir_cls.to(center.dtype)
                     * (2 * torch.pi / self.num_dir_bins) + dir_res)
        else:
            angle = center.new_zeros(center.shape[:-1])
        size_cls = preds["size_class"].argmax(-1)
        size_res = preds["size_res"].gather(
            -2, size_cls[..., None, None].expand(*size_cls.shape, 1, 3)
        )[..., 0, :]
        base = self.mean_sizes.to(center.device, center.dtype)[size_cls]
        size = torch.clamp(base + size_res, min=0.1)
        return torch.cat([center, size, angle[..., None]], dim=-1)


class VoteHead(nn.Module):
    """Vote, aggregate (its own FPS over the votes with ``sample_mod=
    "vote"``, over the seeds with ``"seed"``), a shared conv trunk and one
    Linear for every output."""

    def __init__(self, num_classes: int = 18, num_dir_bins: int = 1,
                 num_sizes: int = 18, num_proposal: int = 256,
                 seed_feat_dim: int = 256, with_rot: bool = False,
                 agg_radius: float = 0.3, agg_num_sample: int = 16,
                 agg_mlp_channels: Sequence[int] = (128, 128, 128),
                 pred_conv_channels: Sequence[int] = (128, 128)):
        super().__init__()
        self.num_classes = num_classes
        self.num_dir_bins = num_dir_bins
        self.num_sizes = num_sizes
        self.num_proposal = num_proposal
        self.with_rot = with_rot
        self.vote_module = VoteModule(seed_feat_dim,
                                      (seed_feat_dim, seed_feat_dim))
        self.vote_aggregation = PointSAModule(
            num_proposal, agg_radius, agg_num_sample, seed_feat_dim,
            agg_mlp_channels)
        self.trunk = PointMLP(agg_mlp_channels[-1], pred_conv_channels,
                              bias=True)
        out_dim = 2 + 3 + num_dir_bins * 2 + num_sizes * 4 + num_classes
        self.conv_out = nn.Linear(pred_conv_channels[-1], out_dim)

    def coder(self, mean_sizes) -> BinBoxCoder:
        return BinBoxCoder(self.num_dir_bins, self.num_sizes, mean_sizes,
                           self.with_rot)

    def forward(self, feat_dict: dict, sample_mod: str = "vote") -> dict:
        if sample_mod not in SAMPLE_MODS:
            raise ValueError(f"sample_mod={sample_mod!r} is not one of "
                             f"{SAMPLE_MODS}")
        seed_points = feat_dict["fp_xyz"][-1]
        seed_features = feat_dict["fp_features"][-1]
        vote_points, vote_features, vote_offset = self.vote_module(
            seed_points, seed_features)
        idx = (furthest_point_sample(seed_points, self.num_proposal)
               if sample_mod == "seed" else None)
        aggregated_points, features, aggregated_indices = \
            self.vote_aggregation(vote_points, vote_features, indices=idx)

        out = self.conv_out(self.trunk(features))
        nd, ns = self.num_dir_bins, self.num_sizes
        widths = (2, 3, nd, nd, ns, ns * 3, self.num_classes)
        names = ("obj_scores", "center_offset", "dir_class", "dir_res_norm",
                 "size_class", "size_res", "sem_scores")
        preds = dict(zip(names, out.split(widths, dim=-1)))
        preds["size_res"] = preds["size_res"].reshape(
            *out.shape[:-1], ns, 3)
        preds["dir_res"] = preds["dir_res_norm"] * (torch.pi / nd)
        preds.update(
            seed_points=seed_points, seed_features=seed_features,
            seed_indices=feat_dict["fp_indices"][-1],
            vote_points=vote_points, vote_features=vote_features,
            vote_offset=vote_offset, aggregated_points=aggregated_points,
            aggregated_features=features,
            aggregated_indices=aggregated_indices)
        return preds


class VoteNet(nn.Module):
    """PointNet++ SSG backbone + the legacy VoteHead: points (B, N,
    in_channels) -> the head's preds. The defaults are VoteNet's ScanNet
    widths (18 classes, 18 size clusters, 256 proposals, 256-wide
    seeds)."""

    def __init__(self, num_classes: int = 18, num_sizes: int = 18,
                 num_proposal: int = 256, in_channels: int = 4,
                 num_points: Sequence[int] = (2048, 1024, 512, 256),
                 radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 num_samples: Sequence[int] = (64, 32, 16, 16),
                 sa_channels: Sequence[Sequence[int]] = (
                     (64, 64, 128), (128, 128, 256), (128, 128, 256),
                     (128, 128, 256)),
                 fp_channels: Sequence[Sequence[int]] = ((256, 256),
                                                         (256, 256)),
                 num_dir_bins: int = 1, with_rot: bool = False):
        super().__init__()
        self.backbone = PointNet2SASSG(in_channels, num_points, radii,
                                       num_samples, sa_channels, fp_channels)
        self.bbox_head = VoteHead(
            num_classes=num_classes, num_dir_bins=num_dir_bins,
            num_sizes=num_sizes, num_proposal=num_proposal,
            seed_feat_dim=fp_channels[-1][-1], with_rot=with_rot)

    def forward(self, points: torch.Tensor, sample_mod: str = "vote") -> dict:
        return self.bbox_head(self.backbone(points), sample_mod)
