"""Position-adaptive convolution. Counterpart of ``nesie_tpu/ops/paconv.py``
(reference mmdet3d/ops/paconv/paconv.py, the non-CUDA formulation):

* ``ScoreNet`` maps per-pair xyz features through 1x1 conv + BN + ReLU
  layers to M mixing scores (the last layer with a bias and no ReLU, BN
  only with ``last_bn``), normalised by a softmax or a sigmoid with a
  temperature;
* ``PAConv`` builds the kernel input (``w_neighbor``: the concatenation
  of (feature - centre feature, feature), K slot 0 being the centre),
  multiplies it by the ``(kernel_mul * in_c, M * out_c)`` weight bank,
  mixes the M outputs with the scores, then BN + ReLU.

Channels-last: grouped tensors are ``(B, npoint, K, C)``. The BNs are
``nn.layers.BatchNorm`` (flax's semantics and the data-parallel sums).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch.nn.layers import BatchNorm, ConvModule

SCORE_NORMS = ("softmax", "sigmoid", "identity")


def assign_score_withk(scores, point_feats, center_feats, knn_idx):
    """Score-weighted mixing of gathered (neighbour - centre) features
    (reference assign_score_withk_cuda.cu, aggregate='sum').

    scores (B, N, K, M); point_feats, center_feats (B, Npoint, M, C) each
    already multiplied by the M bank matrices; knn_idx (B, N, K) indices
    into Npoint -> (B, N, K, C)."""
    B, N, K, M = scores.shape
    C = point_feats.shape[-1]
    idx = knn_idx.reshape(B, N * K).long()[..., None, None].expand(-1, -1, M, C)
    gathered = point_feats.gather(1, idx).reshape(B, N, K, M, C)
    centers = center_feats[:, :, None]
    diff = gathered - centers[:, :N if centers.shape[1] >= N else None]
    return torch.einsum("bnkm,bnkmc->bnkc", scores, diff)


class ScoreNet(nn.Module):
    """Per-pair xyz features -> weight-bank scores. ``mlp_channels`` is the
    whole chain, the input width first and M last; layers
    ``mlps.layer{i}``."""

    def __init__(self, mlp_channels: Sequence[int], last_bn: bool = False,
                 score_norm: str = "softmax", temp_factor: float = 1.0):
        super().__init__()
        if score_norm not in SCORE_NORMS:
            raise ValueError(f"score_norm={score_norm!r} is not one of "
                             f"{SCORE_NORMS}")
        self.score_norm = score_norm
        self.temp_factor = temp_factor
        n = len(mlp_channels)
        layers = OrderedDict(
            (f"layer{i}", ConvModule(mlp_channels[i], mlp_channels[i + 1]))
            for i in range(n - 2))
        layers[f"layer{n - 2}"] = ConvModule(
            mlp_channels[-2], mlp_channels[-1], bias=not last_bn,
            norm="bn" if last_bn else "none", act=False)
        self.mlps = nn.Sequential(layers)

    def forward(self, xyz_features: torch.Tensor) -> torch.Tensor:
        """(B, npoint, K, C_in) -> scores (B, npoint, K, M)."""
        h = self.mlps(xyz_features)
        if self.score_norm == "softmax":
            return torch.softmax(h / self.temp_factor, dim=-1)
        if self.score_norm == "sigmoid":
            return torch.sigmoid(h / self.temp_factor)
        return h


class PAConv(nn.Module):
    """Position-adaptive conv over grouped neighbourhoods.

    forward(features (B, npoint, K, in_c), points_xyz (B, npoint, K, 3))
    -> (B, npoint, K, out_c); K slot 0 is taken as the centre (after a
    ball query: the lowest in-radius index, not necessarily the sample).
    ``weight_bank`` keeps the reference's ``(kernel_mul * in_c,
    num_kernels * out_c)`` layout, multiplied from the right."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_kernels: int = 8,
                 scorenet_input: str = "w_neighbor_dist",
                 kernel_input: str = "w_neighbor",
                 scorenet_mlp: Sequence[int] = (8, 16, 16),
                 score_norm: str = "softmax", temp_factor: float = 1.0,
                 last_bn: bool = False, with_norm: bool = True,
                 with_act: bool = True):
        super().__init__()
        if scorenet_input not in ("identity", "w_neighbor", "w_neighbor_dist"):
            raise ValueError(f"scorenet_input={scorenet_input!r}")
        if kernel_input not in ("identity", "w_neighbor"):
            raise ValueError(f"kernel_input={kernel_input!r}")
        self.out_channels = out_channels
        self.num_kernels = num_kernels
        self.scorenet_input = scorenet_input
        self.kernel_input = kernel_input
        self.with_act = with_act
        kernel_mul = 2 if kernel_input == "w_neighbor" else 1
        score_in = {"identity": 3, "w_neighbor": 6, "w_neighbor_dist": 7}
        self.scorenet = ScoreNet(
            (score_in[scorenet_input], *scorenet_mlp, num_kernels),
            last_bn=last_bn, score_norm=score_norm, temp_factor=temp_factor)
        self.weight_bank = nn.Parameter(torch.empty(
            kernel_mul * in_channels, num_kernels * out_channels))
        # as nn.Linear draws its weight at construction; the port's
        # init_weights_* redraw it from an explicit generator
        bound = 1.0 / math.sqrt(kernel_mul * in_channels)
        nn.init.uniform_(self.weight_bank, -bound, bound)
        self.bn = BatchNorm(out_channels) if with_norm else None

    def forward(self, features: torch.Tensor,
                points_xyz: torch.Tensor) -> torch.Tensor:
        center_xyz = points_xyz[..., :1, :]
        xyz_diff = points_xyz - center_xyz
        if self.scorenet_input == "identity":
            xyz_features = xyz_diff
        elif self.scorenet_input == "w_neighbor":
            xyz_features = torch.cat([xyz_diff, points_xyz], dim=-1)
        else:  # the centre, the offset and its euclidean length
            dist = torch.linalg.vector_norm(xyz_diff, dim=-1, keepdim=True)
            xyz_features = torch.cat(
                [center_xyz.expand_as(points_xyz), xyz_diff, dist], dim=-1)
        if self.kernel_input == "w_neighbor":
            features = torch.cat([features - features[..., :1, :], features],
                                 dim=-1)
        scores = self.scorenet(xyz_features)
        B, npoint, K, _ = features.shape
        new_features = (features @ self.weight_bank).reshape(
            B, npoint, K, self.num_kernels, self.out_channels)
        out = torch.einsum("bnkm,bnkmc->bnkc", scores, new_features)
        if self.bn is not None:
            out = self.bn(out)
        return torch.relu(out) if self.with_act else out
