"""Teacher pseudo-labels (reference VoteNetNesie.get_pseudo_labels,
votenet_nesie.py:129-299), on the device with static shapes.

Counterpart of ``nesie_tpu/train/pseudo_label.py``. The reference's LHS
NMS on the top-64 candidates runs here as a fixed loop of K masked steps
over all scenes at once, with no host synchronisation: a scene with
nothing left alive makes no change.

``literal_reference_cbl=True`` (the default) keeps the reference's literal
class-balanced arithmetic: ``classwise_acc`` gives the c-th *largest*
pseudo count to class c (votenet_nesie.py:141-147), and the per-proposal
threshold indexes the flattened class array with class values
(votenet_nesie.py:161). ``False`` gives the FlexMatch-intended form.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from perfbench.reference import parallel
from perfbench.reference.core.boxes import box_corners, corners_minmax


@dataclass(frozen=True)
class PseudoLabelConfig:
    num_classes: int = 18
    max_num_obj: int = 64
    use_cbl: bool = True
    thresh_warmup: bool = True
    cls_thr_base: float = 0.7
    cls_thr_scale: float = 0.3
    cls_thr_cap: float = 0.95
    obj_thr: float = 0.9
    iou_thr_base: float = 0.25
    iou_thr_scale: float = 0.5
    iou_thr_cap: float = 0.35
    lhs_nms_iou: float = 0.25
    dataset_name: str = "ScanNet"
    literal_reference_cbl: bool = True


class PseudoLabels(NamedTuple):
    boxes: torch.Tensor    # (B, MAX_OBJ, 7) bottom-centered teacher boxes
    labels: torch.Tensor   # (B, MAX_OBJ) int32 argmax classes
    valid: torch.Tensor    # (B, MAX_OBJ) bool
    quality: torch.Tensor  # (B, MAX_OBJ, 6) per-side quality weights


def classwise_acc(ulb_list, ulb_flag, num_labeled: int, thresh_warmup: bool,
                  literal: bool = False):
    """FlexMatch-style learning status: ulb_list (U, C) per-scan pseudo
    class histograms, ulb_flag (U,) 1.0 until a scan is first visited ->
    (C,) in [0, 1] after the x / (2 - x) warp. ``literal`` gives the c-th
    largest count to class c, as the reference does."""
    counts = ulb_list.sum(0)
    if literal:
        counts = torch.sort(counts, descending=True).values
    if thresh_warmup:
        ulb_count = 10.0 * ulb_flag.sum() * num_labeled / ulb_list.shape[0]
        denom = torch.maximum(counts.max(), ulb_count)
    else:
        denom = counts.max()
    acc = counts / torch.clamp(denom, min=1e-6)
    return acc / (2.0 - acc)


def lhs_nms_keep_mask(boxes6, scores, classes, thresh: float):
    """Lenient greedy NMS that also keeps the better half of every
    suppressed cluster (reference lhs_3d_faster_samecls,
    votenet_nesie.py:733-779): boxes6 (..., K, 6) minmax, scores (..., K),
    classes (..., K) -> (..., K) bool keep mask."""
    lead, k = scores.shape[:-1], scores.shape[-1]
    boxes6 = boxes6.reshape(-1, k, 6)
    scores = scores.reshape(-1, k)
    classes = classes.reshape(-1, k)
    lt = torch.maximum(boxes6[:, :, None, :3], boxes6[:, None, :, :3])
    rb = torch.minimum(boxes6[:, :, None, 3:], boxes6[:, None, :, 3:])
    whd = torch.clamp(rb - lt, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
    d = boxes6[..., 3:] - boxes6[..., :3]
    vol = d[..., 0] * d[..., 1] * d[..., 2] + 1e-8
    iou = inter / (vol[:, :, None] + vol[:, None, :] - inter)
    iou = iou * (classes[:, :, None] == classes[:, None, :])

    alive = torch.ones_like(scores, dtype=torch.bool)
    keep = torch.zeros_like(alive)
    slots = torch.arange(k, device=scores.device)
    for _ in range(k):  # every step retires at least one alive box
        active = alive.any(-1, keepdim=True)
        i = torch.where(alive, scores, -torch.inf).argmax(-1, keepdim=True)
        picked = (slots == i) & active
        keep |= picked
        others = alive & ~picked
        suppressed = others & (iou.gather(
            1, i[..., None].expand(-1, 1, k))[:, 0] > thresh)
        n_sup = suppressed.sum(-1, keepdim=True)
        sup_scores = torch.where(suppressed, scores, -torch.inf)
        rank = (sup_scores[:, None, :] > sup_scores[:, :, None]).sum(-1)
        keep |= suppressed & (rank < n_sup // 2)
        alive = others & ~suppressed
    return keep.reshape(*lead, k)


def quality_poly(side_scores):
    """q(s) = 5/3 s^2 - 8/3 s + 1 (votenet_nesie.py:201)."""
    return 5.0 / 3.0 * side_scores * side_scores - 8.0 / 3.0 * side_scores \
        + 1.0


def get_pseudo_labels(teacher_results, acc,
                      cfg: PseudoLabelConfig = PseudoLabelConfig(),
                      rows: parallel.RowLayout | None = None
                      ) -> PseudoLabels:
    """Filter the teacher's predictions into at most ``max_num_obj``
    pseudo boxes per scene. acc: (C,) from ``classwise_acc`` (unused
    without CBL). Boxes come back bottom-centered. ``rows``: this rank's
    rows of the global batch, whose flattened classes the literal CBL
    threshold indexes (as the JAX step indexes the whole batch's)."""
    sem = teacher_results["sem_scores"]  # (B, P, C) logits
    B, P = sem.shape[:2]
    bbox = teacher_results["bbox_preds"]
    bbox = torch.cat([bbox[..., :2], bbox[..., 2:3] - 0.5 * bbox[..., 5:6],
                      bbox[..., 3:]], dim=-1)  # -> bottom-centered
    max_cls, argmax_cls = sem.max(-1)

    if cfg.use_cbl:
        if cfg.literal_reference_cbl:
            # thr[j] = acc[cls_flat[cls_flat[j]]], as the reference indexes
            flat = argmax_cls.reshape(-1)
            lookup = parallel.global_rows(rows, argmax_cls).reshape(-1)
            thr = acc[lookup[torch.clamp(flat, max=lookup.numel() - 1)]]
            thr = thr.reshape(argmax_cls.shape)
        else:
            thr = acc[argmax_cls]
        cls_thr = torch.clamp(cfg.cls_thr_base + cfg.cls_thr_scale * thr,
                              max=cfg.cls_thr_cap)
        iou_thr = torch.clamp(cfg.iou_thr_base + cfg.iou_thr_scale * thr,
                              max=cfg.iou_thr_cap)
    else:
        cls_thr = torch.full_like(max_cls, 0.9)
        iou_thr = torch.full_like(max_cls, cfg.iou_thr_base)

    pos_obj = torch.softmax(teacher_results["obj_scores"], dim=-1)[..., 1]
    iou_pred = teacher_results["iou_scores"].gather(
        -1, argmax_cls[..., None])[..., 0]
    final_mask = (max_cls > cls_thr) & (pos_obj > cfg.obj_thr) \
        & (iou_pred > iou_thr)
    side_at_cls = teacher_results["side_scores"].gather(
        -1, argmax_cls[..., None, None].expand(-1, -1, 6, 1))[..., 0]
    quality = quality_poly(side_at_cls)

    # the top max_num_obj candidates by pos_obj * iou * mask; equal scores
    # in index order, as lax.top_k
    k = min(cfg.max_num_obj, P)
    rank_score = pos_obj * iou_pred * final_mask
    inds = torch.sort(rank_score, dim=1, descending=True,
                      stable=True).indices[:, :k]
    if k < cfg.max_num_obj:  # padded slots are never valid
        inds = torch.cat([inds, inds.new_zeros((B, cfg.max_num_obj - k))], 1)

    def gather(x):
        idx = inds.reshape(inds.shape + (1,) * (x.dim() - 2))
        return x.gather(1, idx.expand(-1, -1, *x.shape[2:]))

    sel_mask = gather(final_mask)
    if k < cfg.max_num_obj:
        sel_mask = sel_mask & (torch.arange(cfg.max_num_obj,
                                            device=sem.device) < k)
    sel_boxes = gather(bbox)
    sel_labels = gather(argmax_cls)
    sel_quality = gather(quality)
    sel_scores = gather(pos_obj) * gather(iou_pred)  # unmasked LHS score

    # LHS NMS on the corner min/max of the boxes, built around the bottom
    # z as if it were the center, heading zeroed for ScanNet (reference
    # votenet_nesie.py:149,229)
    nms_boxes = sel_boxes
    if cfg.dataset_name == "ScanNet":
        nms_boxes = torch.cat([nms_boxes[..., :6],
                               torch.zeros_like(nms_boxes[..., 6:])], -1)
    keep = lhs_nms_keep_mask(corners_minmax(box_corners(nms_boxes)),
                             sel_scores, sel_labels, cfg.lhs_nms_iou)
    valid = sel_mask & keep
    return PseudoLabels(
        boxes=sel_boxes * valid[..., None],
        labels=(sel_labels * valid).to(torch.int32),
        valid=valid,
        quality=sel_quality * valid[..., None],
    )
