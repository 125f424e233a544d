from .pointops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    three_interpolate,
    three_nn,
)

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "three_interpolate",
    "three_nn",
]
