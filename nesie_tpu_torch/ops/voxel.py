"""Voxelization + dynamic scatter (reference mmdet3d/ops/voxel/: hard &
dynamic voxelization CUDA kernels, scatter_points.py). Counterpart of
``nesie_tpu/ops/voxel.py``.

Static output shapes: the points are sorted by voxel id and reduced by
segment, instead of the reference's atomic scatter. Voxel ids are int64
here (int32 in the JAX package, which holds them for any grid below 2^31
cells: KITTI's 1408 x 1600 x 40 at 0.05 m is 90.1M).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelizationResult(NamedTuple):
    voxels: torch.Tensor      # (max_voxels, max_points, C)
    coords: torch.Tensor      # (max_voxels, 3) int32 grid coords (z, y, x)
    num_points: torch.Tensor  # (max_voxels,) int32
    num_voxels: torch.Tensor  # () actual voxel count
    valid: torch.Tensor       # (max_voxels,) bool


def _grid_coords(points, voxel_size, point_range):
    f32 = dict(dtype=torch.float32, device=points.device)
    vs = torch.tensor(voxel_size, **f32)
    lo = torch.tensor(point_range[:3], **f32)
    hi = torch.tensor(point_range[3:], **f32)
    grid = torch.floor((points[:, :3] - lo) / vs).to(torch.int64)
    dims = torch.ceil((hi - lo) / vs).to(torch.int64)
    in_range = torch.all((grid >= 0) & (grid < dims), dim=1)
    return grid, dims, in_range


def voxelize(
    points,
    voxel_size,
    point_range,
    max_points: int = 35,
    max_voxels: int = 20000,
) -> VoxelizationResult:
    """Hard voxelization of one cloud (N, C) with static output shapes.

    The reference kernel's semantics: at most ``max_points`` points per
    voxel (extras dropped), at most ``max_voxels`` voxels. The CUDA kernel
    keeps voxels in first-point-arrival order, which is nondeterministic;
    here they are in voxel-id order and each voxel's points in point order,
    which is deterministic.
    """
    N, C = points.shape
    dev = points.device
    grid, dims, in_range = _grid_coords(points, voxel_size, point_range)
    linear = (grid[:, 2] * dims[1] + grid[:, 1]) * dims[0] + grid[:, 0]
    big = dims[0] * dims[1] * dims[2]
    linear = torch.where(in_range, linear, big)  # invalid sorts last

    order = torch.argsort(linear, stable=True)
    sorted_ids = linear[order]
    sorted_pts = points[order]
    sorted_grid = grid[order]

    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_ids[1:] != sorted_ids[:-1]]) & (sorted_ids < big)
    seg = torch.cumsum(is_start, 0) - 1  # voxel slot per point
    # rank within segment: the position since the segment's first point
    idx = torch.arange(N, device=dev)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = idx - seg_start

    keep = (sorted_ids < big) & (seg < max_voxels) & (rank < max_points)
    # rejected points all go to the overflow row max_voxels, at rank 0, and
    # write 0 there: the only duplicate indices of the index_put_ below
    # (whose order is unspecified on CUDA) land in a row sliced off
    seg_c = torch.where(keep, seg, max_voxels)
    voxels = points.new_zeros((max_voxels + 1, max_points, C))
    voxels.index_put_((seg_c, torch.where(keep, rank, 0)),
                      torch.where(keep[:, None], sorted_pts, 0.0))
    voxels = voxels[:max_voxels]

    # one writer a voxel: its first point
    first = keep & (rank == 0)
    coords = torch.zeros((max_voxels + 1, 3), dtype=torch.int32, device=dev)
    coords[torch.where(first, seg_c, max_voxels)] = torch.where(
        first[:, None], sorted_grid.flip(1).to(torch.int32), 0)
    coords = coords[:max_voxels]

    num_points = torch.zeros(max_voxels + 1, dtype=torch.int32, device=dev)
    num_points.scatter_add_(0, seg_c, keep.to(torch.int32))
    num_points = num_points[:max_voxels]
    valid = num_points > 0
    return VoxelizationResult(
        voxels=voxels,
        coords=coords,
        num_points=num_points,
        num_voxels=valid.sum(),
        valid=valid,
    )


def dynamic_scatter(points, coords_or_ids, num_segments: int,
                    mode: str = "mean"):
    """Dynamic scatter (reference scatter_points.py): reduce point features
    into voxels by mean or max.

    Args:
        points: (N, C); coords_or_ids: (N,) int voxel ids in [0, num_segments)
            (out-of-range ids are dropped).
    Returns:
        (num_segments, C) reduced features; empty segments give 0.
    """
    ids = coords_or_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, num_segments)
    n, c = points.shape
    if mode == "mean":
        tot = points.new_zeros((num_segments + 1, c)).index_add_(
            0, safe, torch.where(ok[:, None], points, 0.0))[:num_segments]
        cnt = points.new_zeros(num_segments + 1).index_add_(
            0, safe, ok.to(points.dtype))[:num_segments]
        return tot / torch.clamp(cnt[:, None], min=1.0)
    if mode == "max":
        out = points.new_full((num_segments + 1, c), -torch.inf).scatter_reduce(
            0, safe[:, None].expand(n, c),
            torch.where(ok[:, None], points, -torch.inf), "amax",
            include_self=True)[:num_segments]
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)
