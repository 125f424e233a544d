"""PCDet-convention rotated IoU + NMS (reference
mmdet3d/ops/pcdet_nms/pcdet_nms_utils.py + src/iou3d_nms_kernel.cu).
Counterpart of ``nesie_tpu/core/pcdet_nms.py``.

Boxes are ``(x, y, z, dx, dy, dz, heading)`` with z the GRAVITY center and
heading a counterclockwise BEV rotation (iou3d_nms_kernel.cu:94-98) — the
same corner convention as ``core.iou.bev_corners``, so these are thin
adapters over the shared polygon-clipping core.

Differences from the mmdet3d-convention ops in ``core.multiclass_nms``:
  * center-format boxes (not BEV corner-format [x1,y1,x2,y2,ry]);
  * ``boxes_iou3d``'s height overlap uses center z +/- dz/2
    (pcdet_nms_utils.py:56-76);
  * ``nms`` returns kept ORIGINAL indices in descending-score order plus
    None, matching ``nms_gpu``'s (indices, None) tuple
    (pcdet_nms_utils.py:84-101);
  * ``nms_normal`` ignores heading entirely — axis-aligned BEV IoU
    (kernel's iou_normal).

The IoU is computed on the boxes' device; the score order (a stable
descending sort) and the greedy pass run on the host, as in the JAX
package, so the keep lists are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .iou import bev_corners, rotated_intersection_area_2d


def _bev5(boxes7):
    return torch.cat([boxes7[:, 0:2], boxes7[:, 3:5], boxes7[:, 6:7]], dim=1)


def _overlaps_bev(boxes_a, boxes_b):
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    ca = bev_corners(_bev5(boxes_a))
    cb = bev_corners(_bev5(boxes_b))
    return rotated_intersection_area_2d(
        ca[:, None].expand(n, m, 4, 2).reshape(n * m, 4, 2),
        cb[None, :].expand(n, m, 4, 2).reshape(n * m, 4, 2),
    ).reshape(n, m)


def boxes_iou_bev(boxes_a, boxes_b, eps: float = 1e-8):
    """(N, 7), (M, 7) -> (N, M) rotated BEV IoU (pcdet boxes_iou_bev)."""
    inter = _overlaps_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter,
                               min=eps)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7), (M, 7) -> (N, M) 3D IoU with center-z height overlap
    (pcdet_nms_utils.py boxes_iou3d_gpu:45-78)."""
    overlaps_bev = _overlaps_bev(boxes_a, boxes_b)
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    overlaps_h = torch.clamp(
        torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    overlaps_3d = overlaps_bev * overlaps_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-6)


def _score_order(scores):
    return np.argsort(-torch.as_tensor(scores).cpu().numpy(), kind="stable")


def _greedy(order, iou: np.ndarray, thresh: float, device):
    keep = []
    suppressed = np.zeros(len(order), bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > thresh
    return torch.as_tensor(order[keep], device=device)


def nms(boxes, scores, thresh: float, pre_maxsize: int | None = None):
    """Rotated-BEV greedy NMS (pcdet nms_gpu, pcdet_nms_utils.py:84-101).

    Returns (kept original indices in descending-score order, int64 on
    the boxes' device, None).
    """
    order = _score_order(scores)
    if pre_maxsize is not None:
        order = order[:pre_maxsize]
    b = boxes[torch.as_tensor(order, device=boxes.device)]
    iou = boxes_iou_bev(b, b).cpu().numpy()
    return _greedy(order, iou, thresh, boxes.device), None


def nms_normal(boxes, scores, thresh: float):
    """Axis-aligned BEV NMS, heading ignored (pcdet nms_normal_gpu +
    kernel iou_normal)."""
    order = _score_order(scores)
    b = boxes[torch.as_tensor(order, device=boxes.device)]
    x1, x2 = b[:, 0] - b[:, 3] / 2, b[:, 0] + b[:, 3] / 2
    y1, y2 = b[:, 1] - b[:, 4] / 2, b[:, 1] + b[:, 4] / 2
    ix = torch.clamp(torch.minimum(x2[:, None], x2[None, :])
                     - torch.maximum(x1[:, None], x1[None, :]), min=0)
    iy = torch.clamp(torch.minimum(y2[:, None], y2[None, :])
                     - torch.maximum(y1[:, None], y1[None, :]), min=0)
    inter = ix * iy
    area = b[:, 3] * b[:, 4]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-8)
    return _greedy(order, iou.cpu().numpy(), thresh, boxes.device), None
