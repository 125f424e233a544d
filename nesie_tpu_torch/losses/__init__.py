from .basic import (
    binary_cross_entropy,
    corner_loss_lidar,
    l1_loss,
    mse_loss,
    smooth_l1_loss,
    softmax_cross_entropy,
    weight_reduce,
    weighted_smooth_l1,
)
from .chamfer import chamfer_distance
from .gfocal import distribution_focal_loss, quality_focal_loss
from .iou_loss import axis_aligned_iou_loss, iou_3d_loss
from .side_pred import side_pred_loss
from .surface import (
    bbox_to_surface,
    surface_loss_ce,
    surface_loss_mse,
    surface_loss_smooth_l1,
    surface_to_prob,
    transform_surface,
)

__all__ = [
    "axis_aligned_iou_loss",
    "bbox_to_surface",
    "binary_cross_entropy",
    "chamfer_distance",
    "corner_loss_lidar",
    "distribution_focal_loss",
    "iou_3d_loss",
    "l1_loss",
    "mse_loss",
    "quality_focal_loss",
    "side_pred_loss",
    "smooth_l1_loss",
    "softmax_cross_entropy",
    "surface_loss_ce",
    "surface_loss_mse",
    "surface_loss_smooth_l1",
    "surface_to_prob",
    "transform_surface",
    "weight_reduce",
    "weighted_smooth_l1",
]
