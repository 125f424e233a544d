"""Host-side numpy voxel generator (reference mmdet3d/core/voxel/
voxel_generator.py:5-279 + builder.py).

The reference implements this as numba-jitted per-point loops; here the
same semantics are fully vectorized numpy (no numba in this image, and a
single pass of sorts/bincounts beats an interpreted loop anyway):

* voxels appear in FIRST-POINT-ARRIVAL order (the loop assigns
  ``voxelidx = voxel_num++`` when a cell is first seen),
* cells first seen after ``max_voxels`` are dropped entirely, but cells
  already open keep accepting points,
* each voxel stores at most ``max_num_points`` points in point order and
  the per-voxel count saturates there,
* with ``reverse_index`` (the default) coordinates are returned (z, y, x).

A copy of ``nesie_tpu/data/voxel_generator.py``, so that the port does
not import the JAX package. The device-side counterpart is
``nesie_tpu_torch.ops.voxel.voxelize``; this class is the *data-pipeline*
component the reference builds from ``voxel_layer`` configs.
"""
from __future__ import annotations

import numpy as np


class VoxelGenerator:
    """Drop-in equivalent of the reference ``VoxelGenerator``.

    Args:
        voxel_size: (3,) xyz size of a voxel.
        point_cloud_range: (6,) [x0, y0, z0, x1, y1, z1].
        max_num_points: per-voxel point cap.
        max_voxels: voxel count cap.
    """

    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels: int = 20000):
        point_cloud_range = np.asarray(point_cloud_range, np.float32)
        voxel_size = np.asarray(voxel_size, np.float32)
        grid_size = np.round(
            (point_cloud_range[3:] - point_cloud_range[:3]) / voxel_size
        ).astype(np.int64)
        self._voxel_size = voxel_size
        self._point_cloud_range = point_cloud_range
        self._max_num_points = max_num_points
        self._max_voxels = max_voxels
        self._grid_size = grid_size

    def generate(self, points, reverse_index: bool = True):
        """Voxelize one cloud (N, C); see module docstring for semantics.

        Returns:
            voxels (M, max_num_points, C), coors (M, 3) int32,
            num_points_per_voxel (M,) int32.
        """
        points = np.asarray(points)
        vs = self._voxel_size.astype(points.dtype)
        lo = self._point_cloud_range[:3].astype(points.dtype)
        grid = self._grid_size
        c = np.floor((points[:, :3] - lo) / vs).astype(np.int64)
        valid = np.all((c >= 0) & (c < grid[None, :]), axis=1)
        vp = points[valid]
        cv = c[valid]
        if len(vp) == 0:
            return (
                np.zeros((0, self._max_num_points, points.shape[1]),
                         points.dtype),
                np.zeros((0, 3), np.int32),
                np.zeros((0,), np.int32),
            )

        lin = (cv[:, 2] * grid[1] + cv[:, 1]) * grid[0] + cv[:, 0]
        uniq, first_idx, inv = np.unique(lin, return_index=True,
                                         return_inverse=True)
        # arrival rank of each unique cell = position of its first point
        arrival = np.argsort(np.argsort(first_idx, kind="stable"),
                             kind="stable")
        rank = arrival[inv]  # (N,) per-point voxel slot
        M = min(len(uniq), self._max_voxels)

        # within-voxel position = index among same-voxel points, point order
        order = np.argsort(rank, kind="stable")
        sorted_rank = rank[order]
        run_start = np.concatenate(
            [[0], np.flatnonzero(np.diff(sorted_rank)) + 1]
        )
        pos_sorted = np.arange(len(order)) - np.repeat(
            run_start, np.diff(np.concatenate([run_start, [len(order)]]))
        )
        pos = np.empty_like(pos_sorted)
        pos[order] = pos_sorted

        keep = (rank < M) & (pos < self._max_num_points)
        voxels = np.zeros((M, self._max_num_points, points.shape[1]),
                          points.dtype)
        voxels[rank[keep], pos[keep]] = vp[keep]
        num_points = np.bincount(
            rank[keep], minlength=M
        ).astype(np.int32)

        coors = cv[np.sort(first_idx)][:M].astype(np.int32)
        if reverse_index:
            coors = coors[:, ::-1]  # (z, y, x) like the reference kernel
        return voxels, coors, num_points

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def max_num_points_per_voxel(self):
        return self._max_num_points

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def grid_size(self):
        return self._grid_size

    def __repr__(self):
        indent = " " * (len(self.__class__.__name__) + 1)
        return (
            f"{self.__class__.__name__}(voxel_size={self._voxel_size},\n"
            f"{indent}point_cloud_range="
            f"{self._point_cloud_range.tolist()},\n"
            f"{indent}max_num_points={self._max_num_points},\n"
            f"{indent}max_voxels={self._max_voxels},\n"
            f"{indent}grid_size={self._grid_size.tolist()})"
        )


def build_voxel_generator(cfg: dict) -> VoxelGenerator:
    """Reference mmdet3d/core/voxel/builder.py: construct from a
    ``voxel_layer``-style dict config."""
    return VoxelGenerator(
        voxel_size=cfg["voxel_size"],
        point_cloud_range=cfg["point_cloud_range"],
        max_num_points=cfg["max_num_points"],
        max_voxels=cfg.get("max_voxels", 20000),
    )
