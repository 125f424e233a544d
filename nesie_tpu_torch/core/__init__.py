from .boxes import (
    box_corners,
    box_to_surface,
    corners_minmax,
    gravity_center_of,
    limit_period,
    points_in_boxes,
    rotate_points_z,
    rotation_z,
)
from .iou import axis_aligned_iou_3d, axis_aligned_overlap_3d, giou3d, iou3d, iou_bev
from .nms import aligned_3d_nms_mask

__all__ = [
    "aligned_3d_nms_mask",
    "axis_aligned_iou_3d",
    "axis_aligned_overlap_3d",
    "box_corners",
    "box_to_surface",
    "corners_minmax",
    "giou3d",
    "gravity_center_of",
    "iou3d",
    "iou_bev",
    "limit_period",
    "points_in_boxes",
    "rotate_points_z",
    "rotation_z",
]
