"""RoIAware 3D pooling (reference
mmdet3d/ops/roiaware_pool3d/roiaware_pool3d.py:9-44 +
src/roiaware_pool3d_kernel.cu). Counterpart of
``nesie_tpu/ops/roiaware_pool.py``.

Pools per-point features into a fixed (out_x, out_y, out_z) voxel grid in
each rotated roi's local frame. The CUDA version scatters point indices
into per-voxel slot lists with atomics; here voxel assignment is a dense
computation and the pooling a batched scatter reduction, differentiable
by autograd: the gradient of a tied maximum is shared equally among the
tied points, as ``jax.ops.segment_max``'s is.

Reference semantics kept:
  * local frame rotation by (rz + pi/2) (kernel.cu:17-25), x voxels span
    the *length* l (dim 4), y voxels the width w (dim 3);
  * strict x/y inequalities, inclusive z band (kernel.cu:27-42);
  * rois give the BOTTOM center, z voxel index from z - cz;
  * at most ``max_pts_per_voxel - 1`` points per voxel, taken in point
    order (slot 0 of the CUDA list is the counter, kernel.cu:96-122);
  * empty voxels pool to 0 in both modes.

Memory: the masked source is (N, npoints, C), 134 MB for 128 rois over
16384 points of 16 channels in float32.
"""
from __future__ import annotations

import torch


def _voxel_ids(rois, pts, out_size):
    """Per (roi, point): flat voxel id in [0, V) or -1 if outside the roi."""
    nx, ny, nz = out_size
    cx, cy, cz = rois[:, 0], rois[:, 1], rois[:, 2]
    w, l, h = rois[:, 3], rois[:, 4], rois[:, 5]
    rz = rois[:, 6]

    sx = pts[None, :, 0] - cx[:, None]
    sy = pts[None, :, 1] - cy[:, None]
    sz = pts[None, :, 2] - cz[:, None]

    rot = rz + torch.pi / 2
    cosa, sina = torch.cos(rot)[:, None], torch.sin(rot)[:, None]
    local_x = sx * cosa - sy * sina
    local_y = sx * sina + sy * cosa

    half_w, half_l, half_h = w[:, None] / 2, l[:, None] / 2, h[:, None] / 2
    inside = ((torch.abs(sz - half_h) <= half_h)
              & (local_x > -half_l) & (local_x < half_l)
              & (local_y > -half_w) & (local_y < half_w))

    x_idx = torch.clamp((local_x + half_l) / (l[:, None] / nx), 0, nx - 1)
    y_idx = torch.clamp((local_y + half_w) / (w[:, None] / ny), 0, ny - 1)
    z_idx = torch.clamp(sz / (h[:, None] / nz), 0, nz - 1)
    vox = (x_idx.to(torch.int64) * (ny * nz) + y_idx.to(torch.int64) * nz
           + z_idx.to(torch.int64))
    return torch.where(inside, vox, -1)


def _rank_in_voxel(vox):
    """(N, npts) occurrence rank of each point within its voxel, row by
    row, in point order (the CUDA sequential collection,
    kernel.cu:108-122)."""
    n = vox.shape[1]
    sv, order = torch.sort(vox, dim=1, stable=True)
    pos = torch.arange(n, device=vox.device).expand_as(vox)
    is_start = torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool),
                          sv[:, 1:] != sv[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    return torch.zeros_like(vox).scatter_(1, order, pos - seg_start)


def roiaware_pool3d(
    rois,
    pts,
    pts_feature,
    out_size=(4, 4, 4),
    max_pts_per_voxel: int = 128,
    mode: str = "max",
):
    """Args:
        rois: (N, 7) [cx, cy, cz(bottom), w, l, h, rz].
        pts: (npoints, 3).
        pts_feature: (npoints, C).
    Returns:
        (N, out_x, out_y, out_z, C) pooled features.
    """
    if mode not in ("max", "avg"):
        raise ValueError(f"mode must be 'max' or 'avg', got {mode!r}")
    if isinstance(out_size, int):
        out_size = (out_size, out_size, out_size)
    nx, ny, nz = out_size
    V = nx * ny * nz
    npts, C = pts_feature.shape
    N = rois.shape[0]

    vox = _voxel_ids(rois, pts, out_size)          # (N, npts)
    rank = _rank_in_voxel(vox)
    keep = (vox >= 0) & (rank < max_pts_per_voxel - 1)
    seg = torch.where(keep, vox, V)                # dropped -> overflow bucket
    index = seg[..., None].expand(N, npts, C)

    if mode == "max":
        src = torch.where(keep[..., None], pts_feature[None], -torch.inf)
        pooled = pts_feature.new_full((N, V + 1, C), -torch.inf)
        pooled = pooled.scatter_reduce(1, index, src, "amax",
                                       include_self=True)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        w = keep.to(pts_feature.dtype)
        total = pts_feature.new_zeros((N, V + 1, C)).scatter_add(
            1, index, pts_feature[None] * w[..., None])
        cnt = pts_feature.new_zeros((N, V + 1)).scatter_add(1, seg, w)
        pooled = total / torch.clamp(cnt, min=1.0)[..., None]
    return pooled[:, :V].reshape(N, nx, ny, nz, C)
