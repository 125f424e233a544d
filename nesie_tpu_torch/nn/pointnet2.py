"""PointNet++ set abstraction, feature propagation and the SSG backbone.

Counterpart of ``nesie_tpu/nn/pointnet2.py`` (PointSAModule,
PointSAModuleMSG, PAConvSAModule, PointFPModule, PointNet2SASSG): sample
(FPS) -> group (ball query, duplicate fill) -> shared MLP -> pool,
channels-last. ``dtype`` /
``compute_dtype``: the shared MLPs' compute dtype (``nn.layers``); the
neighbour searches always take float32 coordinates.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    three_interpolate,
    three_nn,
)
from nesie_tpu_torch.ops.sa_mlp import (
    group_by_index,
    kernel_shape_ok,
    mlp_layers,
    pool_neighbours,
    sa_mlp_cuda,
    sa_mlp_ref,
)
from nesie_tpu_torch.utils import count
from .layers import PointMLP


def sample_centers(xyz, num_point, indices=None, target_xyz=None,
                   input_fps_ordered=False):
    """The SA modules' centres: ``target_xyz`` (B, M, 3) as given
    (``spec``), else ``xyz`` at ``indices`` (B, M) or at the FPS samples
    (an ``arange`` when ``input_fps_ordered``). Returns (new_xyz,
    indices); the indices as given with ``target_xyz``."""
    if target_xyz is not None:
        return target_xyz, indices
    if indices is None:
        if input_fps_ordered:
            indices = torch.arange(
                num_point, dtype=torch.int32, device=xyz.device
            ).expand(xyz.shape[0], -1)
        else:
            indices = furthest_point_sample(xyz, num_point)
    return gather_points(xyz, indices), indices


def group(xyz, new_xyz, features, radius, num_sample, use_xyz=True,
          normalize_xyz=True):
    """Ball-query grouping: (grouped (B, M, K, C'), relative xyz
    (B, M, K, 3)). The relative offsets, divided by the radius with
    ``normalize_xyz``, lead the grouped features with ``use_xyz`` and
    stand alone without features."""
    idx = ball_query(xyz, new_xyz, radius, num_sample)
    return group_by_index(xyz, new_xyz, features, idx, radius, use_xyz,
                          normalize_xyz)


def _grouped_channels(in_channels: int, use_xyz: bool) -> int:
    """Width of a grouped input: the features (``in_channels``, 0 for
    none), with the 3 relative coordinates in front under ``use_xyz`` or
    alone without features."""
    return in_channels + 3 if use_xyz or in_channels == 0 else in_channels


class PointSAModule(nn.Module):
    """Single-scale-grouping set abstraction: sample, group, shared MLP,
    pool. ``use_xyz``: the relative coordinates lead the grouped features;
    ``normalize_xyz``: they are divided by the radius; ``pool``: ``"max"``
    or ``"avg"`` over the neighbourhood.

    ``input_fps_ordered``: FPS is prefix-consistent, so when the input is
    itself an FPS output in selection order, FPS(X, m) is the first m
    points and the sample is an ``arange``.

    On CUDA tensors, the grouping, MLP and pool run as one kernel
    (``ops.sa_mlp.sa_mlp_cuda``) when the module can see that the kernel
    computes them: eval mode, no grad, float32, max pool, and widths and K
    the kernel takes. Otherwise they run as torch ops (``sa_mlp_ref``) and
    the call counts ``sa.unfused.<reason>`` (``unfused_reason``).
    """

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 input_fps_ordered: bool = False,
                 dtype: torch.dtype | None = None, use_xyz: bool = True,
                 normalize_xyz: bool = True, pool: str = "max"):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.input_fps_ordered = input_fps_ordered
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.pool = pool
        self.mlps = nn.ModuleList([PointMLP(
            _grouped_channels(in_channels, use_xyz), mlp_channels,
            dtype=dtype)])

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                indices: torch.Tensor | None = None,
                target_xyz: torch.Tensor | None = None):
        """xyz (B, N, 3), features (B, N, C) or None; indices (B, M)
        precomputed samples (the head's ``seed`` and ``random`` modes) or
        target_xyz (B, M, 3) explicit centres (``spec``) or neither (FPS).
        Returns new_xyz (B, M, 3), new_features (B, M, mlp[-1]) and
        indices (B, M) int32, None with ``target_xyz``."""
        new_xyz, indices = sample_centers(xyz, self.num_point, indices,
                                          target_xyz, self.input_fps_ordered)
        idx = ball_query(xyz, new_xyz, self.radius, self.num_sample)
        mlp = self.mlps[0]
        if xyz.device.type == "cuda":
            reason = self.unfused_reason(xyz, features)
            if reason is None:
                return new_xyz, sa_mlp_cuda(
                    xyz, new_xyz.contiguous(), features, idx, self.radius,
                    mlp_layers(mlp), self.normalize_xyz), indices
            count(f"sa.unfused.{reason}")
        return new_xyz, sa_mlp_ref(
            xyz, new_xyz, features, idx, self.radius, mlp, self.use_xyz,
            self.normalize_xyz, self.pool), indices

    def unfused_reason(self, xyz: torch.Tensor,
                       features: torch.Tensor | None) -> str | None:
        """Why the kernel does not compute this call, or None:
        ``train_mode`` (a BN takes batch statistics), ``grad`` (autograd
        records), ``dtype`` (not float32 throughout) or ``shape`` (the
        pool, the layers' form, their widths or K)."""
        mlp = self.mlps[0]
        if self.training or any(m.training for m in mlp.modules()):
            return "train_mode"
        if torch.is_grad_enabled():
            return "grad"
        if mlp.dtype is not None or any(
                t is not None and t.dtype != torch.float32
                for t in (xyz, features, mlp[0].conv.weight)):
            return "dtype"
        if not (self.pool == "max" and self.use_xyz
                and all(m.norm == "bn" and m.act and m.conv.bias is None
                        for m in mlp)
                and kernel_shape_ok([m.conv.out_features for m in mlp],
                                    self.num_sample)):
            return "shape"
        return None


class PointSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (JAX ``PointSAModuleMSG``): one
    sample of centres, a ball query and shared MLP (``mlps.{i}``) at each
    radius, the pooled features concatenated."""

    def __init__(self, num_point: int, radii: Sequence[float],
                 sample_nums: Sequence[int], in_channels: int,
                 mlp_channels: Sequence[Sequence[int]], use_xyz: bool = True,
                 normalize_xyz: bool = True, pool: str = "max",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_point = num_point
        self.radii = tuple(radii)
        self.sample_nums = tuple(sample_nums)
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.pool = pool
        cin = _grouped_channels(in_channels, use_xyz)
        self.mlps = nn.ModuleList(PointMLP(cin, chans, dtype=dtype)
                                  for chans in mlp_channels)

    def forward(self, xyz, features, indices=None, target_xyz=None):
        """As ``PointSAModule.forward``; new_features (B, M, sum of the
        scales' last widths)."""
        new_xyz, indices = sample_centers(xyz, self.num_point, indices,
                                          target_xyz)
        outs = []
        for radius, k, mlp in zip(self.radii, self.sample_nums, self.mlps):
            grouped, _ = group(xyz, new_xyz, features, radius, k,
                               self.use_xyz, self.normalize_xyz)
            outs.append(pool_neighbours(mlp(grouped), self.pool))
        return new_xyz, torch.cat(outs, dim=-1), indices


class PAConvSAModule(nn.Module):
    """Single-scale set abstraction with PAConv layers as the shared MLP
    (JAX ``PAConvSAModule``, reference paconv_sa_module.py): sample,
    group, a chain of PAConv layers (``mlps.0.layer{i}``) that each take
    the grouped features and the relative xyz, pool. The relative xyz are
    not divided by the radius by default, and lead the grouped features
    under ``use_xyz`` (the first layer's input width + 3).

    ``mlp_channels``: the widths of the chain, the first being the input
    features' (replaced by the grouped width)."""

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 mlp_channels: Sequence[int],
                 paconv_num_kernels: Sequence[int], use_xyz: bool = True,
                 normalize_xyz: bool = False, pool: str = "max",
                 kernel_input: str = "w_neighbor",
                 scorenet_input: str = "w_neighbor_dist",
                 scorenet_mlp: Sequence[int] = (16, 16, 16)):
        super().__init__()
        from nesie_tpu_torch.ops.paconv import PAConv

        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.pool = pool
        chain = [_grouped_channels(mlp_channels[0], use_xyz),
                 *mlp_channels[1:]]
        layers = OrderedDict(
            (f"layer{i}", PAConv(chain[i], chain[i + 1],
                                 paconv_num_kernels[i],
                                 scorenet_input=scorenet_input,
                                 kernel_input=kernel_input,
                                 scorenet_mlp=scorenet_mlp))
            for i in range(len(chain) - 1))
        self.mlps = nn.ModuleList([nn.ModuleDict(layers)])

    def forward(self, xyz, features, indices=None, target_xyz=None):
        """As ``PointSAModule.forward``."""
        new_xyz, indices = sample_centers(xyz, self.num_point, indices,
                                          target_xyz)
        h, grouped_xyz = group(xyz, new_xyz, features, self.radius,
                               self.num_sample, self.use_xyz,
                               self.normalize_xyz)
        for layer in self.mlps[0].values():
            h = layer(h, grouped_xyz)
        return new_xyz, pool_neighbours(h, self.pool), indices


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
