"""SAQE's quality estimation module (reference
mmdet3d/models/dense_heads/quelity_estimation_module.py). Counterpart of
``nesie_tpu/nn/quality_estimation.py``.

Differences from Nesie's SidePooling:

* grid size 3, and each face grid is tripled along its own normal (the
  grid -10%, as is, +10% of the normal coordinate,
  quelity_estimation_module.py:142-164): 27 points a face, 162 a box;
* MiniPointNets of hidden width 128, one Linear-BN-ReLU before each side
  head's output;
* no whole-box grid: one fused head over the six side features predicts
  the IoU, rotation and R_obj scores (:64-74, 330-345).

Submodule names are the reference's: ``mlps_before.{0-5}`` the face
MiniPointNets, ``mlps_head.{0-5}`` the side heads, ``mlps_head.6`` the
fused head.
"""
from __future__ import annotations

import torch
from torch import nn

from nesie_tpu_torch.core.boxes import rotate_points_z
from .layers import BatchNorm, MiniPointNet
from .side_pooling import _face_indices, interpolate_grid_features

# the coordinate axis each face's +-10% copies move along, face order
# [x-, x+, z+, z-, y-, y+]
_KEEP_AXIS = (0, 0, 2, 2, 1, 1)


def make_saqe_side_grids(center, size, heading, grid_size: int = 3):
    """center, size (B, K, 3), heading (B, K) -> (B, K, 6 * 3 * g^2, 3)
    world-space points: per face, its grid moved -10% along the face's
    normal axis, the grid, the grid moved +10%."""
    g = grid_size
    step = torch.linspace(-1.0, 1.0, g, dtype=center.dtype,
                          device=center.device)
    gx, gy, gz = torch.meshgrid(step, step, step, indexing="ij")
    local = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    local = local[None, None] * (size[..., None, :] / 2.0)  # (B, K, g^3, 3)
    idx = torch.from_numpy(_face_indices(g)).to(center.device)
    faces = local[:, :, idx].unflatten(2, (6, g * g))  # (B, K, 6, g^2, 3)
    mask = torch.zeros((6, 1, 3), dtype=center.dtype, device=center.device)
    mask[torch.arange(6), 0, torch.tensor(_KEEP_AXIS)] = 1.0
    zero = faces * 0.1 * mask
    side = torch.cat([faces - zero, faces, faces + zero], dim=3)
    side = side.flatten(2, 3)  # (B, K, 6 * 3 * g^2, 3)
    return rotate_points_z(side, heading) + center[:, :, None, :]


def _side_head(cin: int, out: int) -> nn.Sequential:
    """Linear-BN-ReLU + Linear (``mlps_head.{i}.0/.1/.3``)."""
    return nn.Sequential(nn.Linear(cin, 128), BatchNorm(128), nn.ReLU(),
                         nn.Linear(128, out))


def _fused_head(cin: int, out: int) -> nn.Sequential:
    """Linear-BN-ReLU to 512 and to 256, then Linear
    (``mlps_head.6.{0,1,3,4,6}``)."""
    return nn.Sequential(
        nn.Linear(cin, 512), BatchNorm(512), nn.ReLU(),
        nn.Linear(512, 256), BatchNorm(256), nn.ReLU(),
        nn.Linear(256, out))


class QualityEstimation(nn.Module):
    """SAQE's quality module: six side heads and the fused IoU, rotation
    and R_obj head over the same six side features."""

    def __init__(self, num_classes: int = 18, seed_feat_dim: int = 256,
                 grid_size: int = 3, reg_topk: int = 4, reg_max: int = 32,
                 iou_class_depend: bool = True):
        super().__init__()
        if not iou_class_depend:
            raise NotImplementedError(
                "iou_class_depend=False is not ported (ROADMAP §1.3)")
        self.grid_size = grid_size
        self.reg_topk = reg_topk
        self.iou_size = num_classes
        stat = (reg_max + 1) + reg_topk + 1
        self.mlps_before = nn.ModuleList(
            [MiniPointNet(3 + seed_feat_dim, 128, hide_dim=128)
             for _ in range(6)])
        self.mlps_head = nn.ModuleList(
            [_side_head(128 + stat, self.iou_size) for _ in range(6)]
            + [_fused_head(6 * (128 + stat), 2 * self.iou_size + 2)])

    def forward(self, center, size, heading, seed_xyz, seed_feats,
                bbox_probs):
        """center/size (B, K2, 3), heading (B, K2), seed_xyz (B, N, 3),
        seed_feats (B, N, C), bbox_probs (B, P, 6, reg_max+1) with K2 a
        multiple of P. Returns raw logits: side_scores (B, K2, 6, C),
        iou_scores (B, K2, C), rotate_scores (B, K2, C) and r_obj_scores
        (B, K2, 2)."""
        K2, P = size.shape[1], bbox_probs.shape[1]
        n_face = 3 * self.grid_size * self.grid_size
        side_grid = make_saqe_side_grids(center, size, heading,
                                         self.grid_size)
        side_feats = interpolate_grid_features(seed_xyz, seed_feats,
                                               side_grid, center)

        topk = torch.topk(bbox_probs, self.reg_topk, dim=-1, sorted=True).values
        var = torch.var(bbox_probs, dim=-1, keepdim=True, correction=0)
        stat = torch.cat([bbox_probs, topk, var], dim=-1)
        stat = torch.cat([stat] * (K2 // P), dim=1)  # tile over main+jitter

        side_scores, fused = [], []
        for i in range(6):
            f = side_feats[:, :, i * n_face:(i + 1) * n_face]
            feat = torch.cat([self.mlps_before[i](f), stat[:, :, i]], dim=-1)
            fused.append(feat)
            side_scores.append(self.mlps_head[i](feat))
        glob = self.mlps_head[6](torch.cat(fused, dim=-1))
        c = self.iou_size
        return (torch.stack(side_scores, dim=2), glob[..., :c],
                glob[..., c:2 * c], glob[..., 2 * c:])
