"""Host-side loading of one point cloud (numpy only).

A copy of the three functions of ``nesie_tpu/data/io.py`` that the
inference path needs, so that the port does not import the JAX package:

  * ``load_points_bin``: float32 .bin files, ``load_dim`` columns, keep xyz;
  * ``add_height``: the shift_height feature, z minus the 1st-percentile
    floor;
  * ``sample_points``: random choice of N points, with replacement iff the
    cloud has fewer than N.
"""
from __future__ import annotations

import numpy as np


def load_points_bin(path, load_dim: int = 6, use_dim=(0, 1, 2)):
    pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, load_dim)
    return pts[:, list(use_dim)]


def add_height(points):
    """Append the shift_height channel (z minus the 1%-percentile floor)."""
    floor = np.percentile(points[:, 2], 0.99)
    height = points[:, 2] - floor
    return np.concatenate([points, height[:, None]], axis=1)


def sample_points(points, num_points: int, rng: np.random.Generator):
    n = points.shape[0]
    choice = rng.choice(n, num_points, replace=n < num_points)
    return points[choice]
