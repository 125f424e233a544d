"""Side-aware quality estimation module (Nesie variant).

Counterpart of ``nesie_tpu/nn/side_pooling.py``: a grid_size^3 grid in
each predicted box, its six face grids, seed features interpolated at
every grid point by 3-NN inverse-distance weighting, a MiniPointNet per
face and one per box, then per-class side scores and an IoU score. Face
order ``[x-, x+, z+, z-, y-, y+]`` as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nesie_tpu_torch.core.boxes import rotate_points_z
from nesie_tpu_torch.ops import group_points, three_nn
from .layers import BatchNorm, MiniPointNet, device_constant


def _face_indices(g: int) -> np.ndarray:
    """Indices into the flattened g^3 grid of the 6 faces, concatenated."""
    idx = np.arange(g * g * g).reshape(g, g, g)  # [ix, iy, iz]
    return np.concatenate([
        idx[0].reshape(-1), idx[-1].reshape(-1),
        idx[:, :, -1].reshape(-1), idx[:, :, 0].reshape(-1),
        idx[:, 0].reshape(-1), idx[:, -1].reshape(-1),
    ])


def face_indices(g: int, device: torch.device) -> torch.Tensor:
    """``_face_indices(g)`` as an int64 tensor on ``device``, made once."""
    return device_constant(("face_indices", g), device,
                           lambda: torch.from_numpy(_face_indices(g)))


def make_box_grids(center, size, heading, grid_size: int):
    """center, size (B, K, 3), heading (B, K) -> bbox_grid (B, K, g^3, 3),
    side_grid (B, K, 6*g^2, 3) in world space."""
    g = grid_size
    step = torch.linspace(-1.0, 1.0, g, dtype=center.dtype,
                          device=center.device)
    gx, gy, gz = torch.meshgrid(step, step, step, indexing="ij")
    local = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    local = local[None, None] * (size[..., None, :] / 2.0)  # (B, K, g^3, 3)
    faces = local[:, :, face_indices(g, center.device)]
    bbox_grid = rotate_points_z(local, heading) + center[:, :, None, :]
    side_grid = rotate_points_z(faces, heading) + center[:, :, None, :]
    return bbox_grid, side_grid


def interpolate_grid_features(seed_xyz, seed_feats, grid, center):
    """3-NN inverse-distance interpolation of seed features at the grid
    points, with the box-relative offsets prepended: seed_xyz (B, N, 3),
    seed_feats (B, N, C), grid (B, K, G, 3), center (B, K, 3) ->
    (B, K, G, 3 + C)."""
    B, K, G, _ = grid.shape
    dist, idx = three_nn(grid.reshape(B, K * G, 3), seed_xyz)
    weight = 1.0 / (dist + 1e-8)
    weight = weight / weight.sum(dim=-1, keepdim=True)
    interp = (group_points(seed_feats, idx) * weight[..., None]).sum(dim=2)
    interp = interp.reshape(B, K, G, -1)
    return torch.cat([grid - center[:, :, None, :], interp], dim=-1)


def _head(cin: int, out: int) -> nn.Sequential:
    """Linear-BN-ReLU x2 + Linear, indices as the reference's
    ``mlps_head.{i}`` Sequential (0, 1, 3, 4, 6 carry weights)."""
    return nn.Sequential(
        nn.Linear(cin, 128), BatchNorm(128), nn.ReLU(),
        nn.Linear(128, 128), BatchNorm(128), nn.ReLU(),
        nn.Linear(128, out))


class SidePooling(nn.Module):
    """Quality module: 6 side heads + 1 box IoU head. ``mlps_before``
    holds the six face MiniPointNets then the box one; ``mlps_head`` the
    six side heads then the IoU head. ``iou_class_depend=False`` gives
    every head one output in place of one a class."""

    def __init__(self, num_classes: int = 18, seed_feat_dim: int = 256,
                 grid_size: int = 4, reg_topk: int = 4, reg_max: int = 32,
                 iou_class_depend: bool = True):
        super().__init__()
        self.grid_size = grid_size
        self.reg_topk = reg_topk
        iou_size = num_classes if iou_class_depend else 1
        stat = (reg_max + 1) + reg_topk + 1
        self.mlps_before = nn.ModuleList(
            [MiniPointNet(3 + seed_feat_dim, 128) for _ in range(7)])
        self.mlps_head = nn.ModuleList(
            [_head(128 + stat, iou_size) for _ in range(6)]
            + [_head(128, iou_size)])

    def forward(self, center, size, heading, seed_xyz, seed_feats,
                bbox_probs):
        """center/size (B, K2, 3), heading (B, K2), seed_xyz (B, N, 3),
        seed_feats (B, N, C), bbox_probs (B, P, 6, reg_max+1) with K2 a
        multiple of P. Returns raw side_scores (B, K2, 6, iou_size)
        and iou_scores (B, K2, iou_size), iou_size num_classes or 1."""
        K2, P = size.shape[1], bbox_probs.shape[1]
        g = self.grid_size
        bbox_grid, side_grid = make_box_grids(center, size, heading, g)
        side_feats = interpolate_grid_features(seed_xyz, seed_feats,
                                               side_grid, center)
        bbox_feats = interpolate_grid_features(seed_xyz, seed_feats,
                                               bbox_grid, center)

        topk = torch.topk(bbox_probs, self.reg_topk, dim=-1, sorted=True).values
        var = torch.var(bbox_probs, dim=-1, keepdim=True, correction=0)
        stat = torch.cat([bbox_probs, topk, var], dim=-1)
        stat = torch.cat([stat] * (K2 // P), dim=1)  # tile over main+jitter

        side_scores = []
        for i in range(6):
            f = side_feats[:, :, i * g * g:(i + 1) * g * g]
            feat = torch.cat([self.mlps_before[i](f), stat[:, :, i]], dim=-1)
            side_scores.append(self.mlps_head[i](feat))
        iou = self.mlps_head[6](self.mlps_before[6](bbox_feats))
        return torch.stack(side_scores, dim=2), iou
