from .pointops import (
    ball_query,
    furthest_point_sample,
    furthest_point_sample_with_features,
    gather_points,
    group_points,
    knn,
    points_sampler,
    square_distance,
    three_interpolate,
    three_nn,
)
from .roiaware_pool import roiaware_pool3d

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "furthest_point_sample_with_features",
    "gather_points",
    "group_points",
    "knn",
    "points_sampler",
    "roiaware_pool3d",
    "square_distance",
    "three_interpolate",
    "three_nn",
]
