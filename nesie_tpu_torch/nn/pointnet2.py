"""PointNet++ set abstraction, feature propagation and the SSG backbone.

Counterpart of ``nesie_tpu/nn/pointnet2.py`` (PointSAModule,
PointFPModule, PointNet2SASSG): sample (FPS) -> group (ball query,
duplicate fill) -> shared MLP -> max-pool, channels-last. ``dtype`` /
``compute_dtype``: the shared MLPs' compute dtype (``nn.layers``); the
neighbour searches always take float32 coordinates.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)
from .layers import PointMLP


class PointSAModule(nn.Module):
    """Single-scale-grouping set abstraction with max-pooling.

    ``input_fps_ordered``: FPS is prefix-consistent, so when the input is
    itself an FPS output in selection order, FPS(X, m) is the first m
    points and the sample is an ``arange``.
    """

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 input_fps_ordered: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.input_fps_ordered = input_fps_ordered
        # grouped input: relative xyz (3) + features
        self.mlps = nn.ModuleList([PointMLP(in_channels + 3, mlp_channels,
                                            dtype=dtype)])

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                indices: torch.Tensor | None = None,
                target_xyz: torch.Tensor | None = None):
        """xyz (B, N, 3), features (B, N, C) or None; indices (B, M)
        precomputed samples (the head's ``seed`` and ``random`` modes) or
        target_xyz (B, M, 3) explicit centres (``spec``) or neither (FPS).
        Returns new_xyz (B, M, 3), new_features (B, M, mlp[-1]) and
        indices (B, M) int32, None with ``target_xyz``."""
        if target_xyz is not None:
            new_xyz = target_xyz
        else:
            if indices is None:
                if self.input_fps_ordered:
                    B = xyz.shape[0]
                    indices = torch.arange(
                        self.num_point, dtype=torch.int32, device=xyz.device
                    ).expand(B, -1)
                else:
                    indices = furthest_point_sample(xyz, self.num_point)
            new_xyz = gather_points(xyz, indices)

        idx = ball_query(xyz, new_xyz, self.radius, self.num_sample)
        # relative offsets, normalised by the radius
        grouped_xyz = (group_points(xyz, idx) - new_xyz[:, :, None, :]) \
            / self.radius
        if features is not None:
            grouped = torch.cat([grouped_xyz, group_points(features, idx)],
                                dim=-1)
        else:
            grouped = grouped_xyz
        out = self.mlps[0](grouped).amax(dim=2)
        return new_xyz, out, indices


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation + MLP."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.mlps = PointMLP(in_channels, mlp_channels, dtype=dtype)

    def forward(self, target_xyz, source_xyz, target_feats, source_feats):
        """target_xyz (B, n, 3), source_xyz (B, m, 3), target_feats
        (B, n, C1) or None, source_feats (B, m, C2) -> (B, n, mlp[-1])."""
        dist, idx = three_nn(target_xyz, source_xyz)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(dim=2, keepdim=True)
        interp = three_interpolate(source_feats, idx, weight)
        if target_feats is not None:
            interp = torch.cat([interp, target_feats], dim=-1)
        return self.mlps(interp)


class PointNet2SASSG(nn.Module):
    """PointNet++ SSG backbone. Returns fp_xyz / fp_features / fp_indices
    (the last entries are the seeds of the vote head) and the sa_*
    pyramids.

    ``fps_prefix_opt``: SA2-SA4 take their samples as an ``arange``
    (their inputs are FPS outputs in selection order); False runs the
    FPS there for real. ``compute_dtype``: the SA and FP MLPs' compute
    dtype (e.g. ``torch.bfloat16``)."""

    def __init__(
        self,
        in_channels: int = 4,
        num_points: Sequence[int] = (2048, 1024, 512, 256),
        radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
        num_samples: Sequence[int] = (64, 32, 16, 16),
        sa_channels: Sequence[Sequence[int]] = (
            (64, 64, 128), (128, 128, 256), (128, 128, 256), (128, 128, 256),
        ),
        fp_channels: Sequence[Sequence[int]] = ((256, 256), (256, 256)),
        compute_dtype: torch.dtype | None = None,
        fps_prefix_opt: bool = True,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.SA_modules = nn.ModuleList()
        feat = in_channels - 3
        sa_out = [feat]
        for i, chans in enumerate(sa_channels):
            self.SA_modules.append(PointSAModule(
                num_points[i], radii[i], num_samples[i], feat, chans,
                input_fps_ordered=fps_prefix_opt and i > 0,
                dtype=compute_dtype))
            feat = chans[-1]
            sa_out.append(feat)
        self.FP_modules = nn.ModuleList()
        num_sa = len(sa_channels)
        for i, chans in enumerate(fp_channels):
            skip = sa_out[num_sa - i - 1]
            self.FP_modules.append(PointFPModule(feat + skip, chans,
                                                 dtype=compute_dtype))
            feat = chans[-1]

    def forward(self, points: torch.Tensor) -> dict:
        """points: (B, N, in_channels), xyz first."""
        xyz = points[..., :3]
        features = points[..., 3:] if self.in_channels > 3 else None
        B, N = xyz.shape[:2]
        indices = torch.arange(N, dtype=torch.int32,
                               device=points.device).expand(B, -1)

        sa_xyz, sa_features, sa_indices = [xyz], [features], [indices]
        for sa in self.SA_modules:
            cur_xyz, cur_feat, cur_idx = sa(sa_xyz[-1], sa_features[-1])
            sa_xyz.append(cur_xyz)
            sa_features.append(cur_feat)
            sa_indices.append(sa_indices[-1].gather(1, cur_idx.long()))

        num_sa = len(self.SA_modules)
        fp_xyz, fp_features = [sa_xyz[-1]], [sa_features[-1]]
        fp_indices = [sa_indices[-1]]
        for i, fp in enumerate(self.FP_modules):
            tgt = num_sa - i - 1
            fp_features.append(fp(sa_xyz[tgt], sa_xyz[tgt + 1],
                                  sa_features[tgt], fp_features[-1]))
            fp_xyz.append(sa_xyz[tgt])
            fp_indices.append(sa_indices[tgt])

        return dict(fp_xyz=fp_xyz, fp_features=fp_features,
                    fp_indices=fp_indices, sa_xyz=sa_xyz,
                    sa_features=sa_features, sa_indices=sa_indices)
