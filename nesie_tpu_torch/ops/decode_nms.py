"""The eval decode's keep mask: the CUDA kernels' wrapper and the plain
PyTorch version.

``eval.postprocess.decode_and_nms`` keeps a proposal when more than
``NONEMPTY`` points of its cloud lie inside it, no higher-scored kept
proposal of its class overlaps it by IoU > ``nms_thr``, and its score is
above ``score_thr``. The JAX package does this in XLA
(``nesie_tpu/eval/postprocess.py``, a ``vmap``), with no Pallas kernel.

``keep_mask_ref`` is the plain version, one scene at a time through
``core.boxes.points_in_boxes`` (an (N, P) mask) and
``core.nms.aligned_3d_nms_mask``, whose fixpoint asks the host after each
round whether it has converged. It is the CPU path and the kernels'
oracle. ``keep_mask_cuda`` launches ``csrc/decode_nms.cu`` on the whole
batch, with no host sync: point counts, then class-aware greedy NMS.

Exact rounding: on the card the kernels make ``keep_mask_ref``'s float32
decisions bit for bit. The kernels write every product, sum, difference
and quotient that PyTorch rounds as an op of its own with ``__fmul_rn``,
``__fadd_rn``, ``__fsub_rn`` or ``__fdiv_rn``, in PyTorch's order of
operations, so that no FMA contraction rounds otherwise. The cos and sin
of the yaw and the boxes' minmax corners (``box_minmax``) come from
PyTorch's own ops, batched.
"""
from __future__ import annotations

import torch

from nesie_tpu_torch.core.boxes import (
    box_corners,
    corners_minmax,
    points_in_boxes,
    rotate_points_z,
)
from nesie_tpu_torch.core.nms import aligned_3d_nms_mask

from . import _build

NONEMPTY = 5  # a proposal is kept only with more points inside than this
MAX_BOXES = 1024  # proposals a scene the keep kernel takes


def keep_mask_ref(points: torch.Tensor, bbox: torch.Tensor, obj: torch.Tensor,
                  classes: torch.Tensor, nms_thr: float, score_thr: float):
    """Plain keep mask, one scene at a time. points (B, N, >=3), bbox
    (B, P, 7) gravity-centred boxes, obj (B, P) scores, classes (B, P) ->
    selected (B, P) bool, counts (B, P) int32 (points inside each box)."""
    selected, counts = [], []
    for pts_b, bbox_b, obj_b, cls_b in zip(points, bbox, obj, classes):
        inside = points_in_boxes(pts_b[:, :3], bbox_b, bottom_center=False)
        count = inside.sum(dim=0)
        mm = corners_minmax(box_corners(bbox_b))
        keep = aligned_3d_nms_mask(mm, obj_b, cls_b, nms_thr,
                                   valid_mask=count > NONEMPTY)
        selected.append(keep & (obj_b > score_thr))
        counts.append(count.to(torch.int32))
    return torch.stack(selected), torch.stack(counts)


def box_minmax(bbox: torch.Tensor) -> torch.Tensor:
    """``corners_minmax(box_corners(bbox))`` bit for bit, (..., 7) ->
    (..., 6), with the corner signs made on the boxes' device:
    ``box_corners`` copies them from the host, and that copy makes the
    host wait for the card."""
    i = torch.arange(8, device=bbox.device)
    half = i // 2
    signs = torch.stack([i // 4, half % 2, (i + half) % 2], dim=-1)
    local = (signs.to(bbox.dtype) - 0.5) * bbox[..., None, 3:6]
    return corners_minmax(rotate_points_z(local, bbox[..., 6])
                          + bbox[..., None, :3])


def _check(points, bbox, obj, classes) -> None:
    if points.dim() != 3 or points.shape[-1] < 3:
        raise ValueError(f"points has shape {tuple(points.shape)}; the "
                         "kernel takes (B, N, >=3)")
    b = points.shape[0]
    if bbox.dim() != 3 or bbox.shape[0] != b or bbox.shape[-1] != 7:
        raise ValueError(f"bbox has shape {tuple(bbox.shape)}; the kernel "
                         f"takes ({b}, P, 7)")
    p = bbox.shape[1]
    if tuple(obj.shape) != (b, p) or tuple(classes.shape) != (b, p):
        raise ValueError(f"obj {tuple(obj.shape)} and classes "
                         f"{tuple(classes.shape)} must be ({b}, {p})")
    if p > MAX_BOXES:
        raise ValueError(f"{p} proposals a scene; the kernel takes at most "
                         f"{MAX_BOXES}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid height 65535")
    named = {"points": points, "bbox": bbox, "obj": obj, "classes": classes}
    for name, t in named.items():
        dtype = torch.int64 if name == "classes" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != points.device:
            raise ValueError(f"{name} must be a CUDA tensor on the points' "
                             f"card, got {t.device}")


def keep_mask_cuda(points: torch.Tensor, bbox: torch.Tensor,
                   obj: torch.Tensor, classes: torch.Tensor, nms_thr: float,
                   score_thr: float):
    """``keep_mask_ref`` on the card in two launches of
    ``csrc/decode_nms.cu``, with no host sync and no (N, P) tensor: the
    points inside each box, then one block a scene sorts, builds the
    suppression bitmask and runs the greedy scan. Takes contiguous
    float32 points, bbox and obj and int64 classes on one card, P <=
    ``MAX_BOXES``; raises on anything else."""
    _check(points, bbox, obj, classes)
    b, n, channels = points.shape
    p = bbox.shape[1]
    dev = points.device
    selected = torch.empty((b, p), dtype=torch.bool, device=dev)
    counts = torch.empty((b, p), dtype=torch.int32, device=dev)
    if b * p == 0:
        return selected, counts
    yaw = bbox[..., 6]
    cos, sin = torch.cos(yaw).contiguous(), torch.sin(yaw).contiguous()
    minmax = box_minmax(bbox)
    _build.launch("decode_nms", "nesie_decode_nms_counts", points.data_ptr(),
                  b, n, channels, bbox.data_ptr(), cos.data_ptr(),
                  sin.data_ptr(), p, counts.data_ptr(), device=dev)
    _build.launch("decode_nms", "nesie_decode_nms_keep", minmax.data_ptr(),
                  obj.data_ptr(), classes.data_ptr(), counts.data_ptr(), b, p,
                  NONEMPTY, nms_thr, score_thr, selected.data_ptr(),
                  device=dev)
    return selected, counts
