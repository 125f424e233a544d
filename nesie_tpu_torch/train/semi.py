"""Semi-supervised teacher-student training (reference
VoteNetNesie.forward_train, votenet_nesie.py:69-127, and
NesieHead.unsup_loss, nesie_head.py:414-509). Counterpart of
``nesie_tpu/train/semi.py``.

The batch puts the ``n_labeled`` labeled scenes first and the unlabeled
ones after (the reference's ``combine_data``). The teacher runs on the
weak view in train mode, with batch statistics and no update of its
running statistics; its pseudo boxes are moved from the weak to the
strong view by replaying the recorded ``AugParams``. The per-scan pseudo
class histograms (the reference runner's ``ulb_list`` / ``ulb_flag``) live
in a ``UlbState`` of device tensors.

Under a launched process group (``parallel``) each rank holds its rows of
each part, labeled then unlabeled (``parallel.mesh``'s row layout), and
the step computes what one process computes on the global batch: BN
statistics, loss normalisers and gradients over every rank, the draws made
for the global batch, and ``UlbState`` updated from every rank's
unlabeled rows in their global order, so that it stays the same on every
rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from nesie_tpu_torch import parallel
from nesie_tpu_torch.data.augment import (
    augment_boxes,
    augment_points,
    reproject_boxes,
)
from nesie_tpu_torch.losses import iou_3d_loss, softmax_cross_entropy, surface_loss_mse
from nesie_tpu_torch.nn.layers import frozen_bn_stats
from nesie_tpu_torch.utils import span
from .pseudo_label import PseudoLabelConfig, classwise_acc, get_pseudo_labels
from .saqe_loss import saqe_supervised_loss, saqe_unsup_loss
from .state import TrainState, apply_gradients, ema_update
from .step import saqe_loss_config
from .sup_loss import NesieLossConfig, nesie_supervised_loss, sigma_poly
from .targets import HeadTargets, get_targets


class UlbState(NamedTuple):
    ulb_list: torch.Tensor  # (num_unlabeled_scans, C) pseudo class histograms
    ulb_flag: torch.Tensor  # (num_unlabeled_scans,) 1.0 until first visited

    @staticmethod
    def create(num_unlabeled: int, num_classes: int, device="cuda"):
        return UlbState(
            ulb_list=torch.zeros((num_unlabeled, num_classes), device=device),
            ulb_flag=torch.ones((num_unlabeled,), device=device))


def update_ulb_state(ulb_state: UlbState, scan_idx, hist) -> UlbState:
    """Write each drawn scan's histogram and clear its flag. A scan drawn
    twice in one step keeps its last row, as the reference's Python loop
    does (votenet_nesie.py:301): every write to one scan carries that
    last row's value, so the order of the writes does not matter."""
    pos = torch.arange(scan_idx.shape[0], device=scan_idx.device)
    last_pos = torch.full((ulb_state.ulb_list.shape[0],), -1,
                          dtype=pos.dtype, device=pos.device)
    last_pos = last_pos.scatter_reduce(0, scan_idx, pos, "amax")
    ulb_list = ulb_state.ulb_list.clone()
    ulb_list[scan_idx] = hist[last_pos[scan_idx]].to(ulb_list.dtype)
    ulb_flag = ulb_state.ulb_flag.clone()
    ulb_flag[scan_idx] = 0.0
    return UlbState(ulb_list, ulb_flag)


def nesie_unsup_loss(results, targets: HeadTargets, pseudo_quality,
                     cfg: NesieLossConfig = NesieLossConfig(),
                     un_label_weight: float = 2.0):
    """Quality-weighted unsupervised losses (nesie_head.py:414-509);
    pseudo_quality (B, MAX_OBJ, 6), zero on invalid slots."""
    C = cfg.num_classes
    B, P = results["obj_scores"].shape[:2]
    flat = B * P
    quality_side = pseudo_quality.gather(
        1, targets.assignment.long()[..., None].expand(-1, -1, 6))
    quality_mean = quality_side.mean(-1)
    losses = {}

    src = results["bbox_preds"][..., :3]
    d = ((src[:, :, None] - targets.center_targets[:, None]) ** 2).sum(-1)
    s2d = d.amin(2) * targets.box_loss_weights * cfg.center_src_weight
    d2s = d.amin(1) * targets.valid_gt_weights * cfg.center_dst_weight
    losses["unsup_center_loss"] = s2d.sum() + d2s.sum()

    sem_ce = softmax_cross_entropy(results["sem_scores"], targets.mask_targets)
    losses["unsup_semantic_loss"] = cfg.semantic_weight * (
        sem_ce * targets.box_loss_weights).sum()

    sem_argmax = results["sem_scores"].argmax(-1).reshape(flat)
    side_at = results["side_scores"].reshape(flat, 6, C).gather(
        2, sem_argmax[:, None, None].expand(-1, 6, 1))[..., 0]
    sigma = sigma_poly(side_at)
    sigma_mean = sigma.mean(-1)
    bbox_targets = targets.bbox_targets.reshape(flat, -1)

    iou_weight = (targets.box_loss_weights * quality_mean).reshape(flat)
    raw_iou = cfg.iou_weight * iou_3d_loss(
        results["bbox_preds"].reshape(flat, 7), bbox_targets) * iou_weight
    losses["unsup_iou_loss"] = (torch.exp(-sigma_mean) * raw_iou
                                + cfg.alpha * sigma_mean * iou_weight).sum()

    surface_weight = (targets.box_loss_weights.reshape(flat)[:, None]
                      * quality_side.reshape(flat, 6))
    raw_surface = cfg.surface_weight * surface_loss_mse(
        results["surface_pred"].reshape(flat, 6), bbox_targets) \
        * surface_weight
    losses["unsup_surface_loss"] = (torch.exp(-sigma) * raw_surface
                                    + cfg.alpha * sigma * surface_weight).sum()

    losses = {k: un_label_weight * v for k, v in losses.items()}
    return sum(losses.values()), losses


def _slice(results: dict, start: int, end: int) -> dict:
    """Rows [start, end) of every tensor (``spec``'s aggregated_indices
    is None and stays None)."""
    return {k: None if v is None else v[start:end]
            for k, v in results.items()}


def make_semi_train_step(
    n_labeled: int,
    num_labeled_scans: int,
    loss_cfg: NesieLossConfig = NesieLossConfig(),
    pl_cfg: PseudoLabelConfig = PseudoLabelConfig(),
    sample_mod: str = "vote",
    ema_momentum: float = 1e-3,
    ema_warm_up: float = 10.0,
    un_label_weight: float = 2.0,
    pos_distance_thr: float = 0.3,
    neg_distance_thr: float = 0.6,
    ema_bn_stats: bool = False,
    head: str = "nesie",
    teacher_jitter: bool = False,
):
    """Build ``step(state, ulb_state, batch, noise=None, generator=None,
    teacher_noise=None, teacher_generator=None) -> (ulb_state, metrics)``;
    ``state`` is updated in place. The teacher runs without jittered
    proposals by default (the JAX package's ``teacher_jitter=False``);
    with ``teacher_jitter`` it scores its P proposals and their jittered
    copies together, so its train-mode BN statistics cover 2P rows, as
    the student's do. ``head="saqe"`` takes the SAQE semi-phase
    losses; the pseudo-labels are built as for Nesie, from the teacher's
    ``obj_scores``, as the JAX package builds them (ROADMAP §3).

    batch (B = n_labeled + n_unlabeled, labeled first; under a process
    group this rank's rows of each part):
        points_raw_s, points_raw_t (B, N, C): the un-augmented strong and
            weak views;
        gt_boxes (B, MAX_GT, 7) / gt_labels / gt_valid: un-augmented GT of
            the labeled prefix (the rest is ignored);
        aug_s, aug_t: AugParams with leading dim B;
        ulb_scan_idx (B,) int64: UlbState rows of the unlabeled slots.
    noise / generator: the student's draws (jitter noise; the seed
        indices of ``sample_mod="random"``), see NesieHead.forward;
    teacher_noise / teacher_generator: the teacher's, from its own
        generator (the JAX step draws them from its teacher key).

    Spans (``utils.span``): ``semi.step`` (``step``: the count before the
    update) over ``semi.augment``, ``semi.teacher``, ``semi.pseudo_label``,
    ``semi.ulb_state``, ``semi.student``, ``semi.targets``, ``semi.loss``,
    ``apply_gradients``' ``train.backward`` and ``train.update``, and
    ``semi.ema``.
    """
    if head == "saqe":
        saqe_cfg = saqe_loss_config(loss_cfg)

        def sup_loss_fn(out, targets):
            return saqe_supervised_loss(out, targets, saqe_cfg, phase="semi")

        def unsup_loss_fn(out, targets, quality):
            return saqe_unsup_loss(out, targets, quality, saqe_cfg,
                                   un_label_weight)
    else:
        def sup_loss_fn(out, targets):
            return nesie_supervised_loss(out, targets, loss_cfg)

        def unsup_loss_fn(out, targets, quality):
            return nesie_unsup_loss(out, targets, quality, loss_cfg,
                                    un_label_weight)

    def step(state: TrainState, ulb_state: UlbState, batch: dict, noise=None,
             generator: torch.Generator | None = None, teacher_noise=None,
             teacher_generator: torch.Generator | None = None):
        with span("semi.step", step=state.step):
            return _step(state, ulb_state, batch, noise, generator,
                         teacher_noise, teacher_generator)

    def _step(state, ulb_state, batch, noise, generator, teacher_noise,
              teacher_generator):
        B = batch["points_raw_s"].shape[0]
        rows = parallel.part_rows(n_labeled, B - n_labeled)
        with span("semi.augment"):
            points_s = augment_points(batch["points_raw_s"], batch["aug_s"],
                                      shift_height=True)
            points_t = augment_points(batch["points_raw_t"], batch["aug_t"],
                                      shift_height=True)
            gt_boxes = augment_boxes(batch["gt_boxes"], batch["aug_s"])

        # teacher on the weak view: batch statistics, no stat update
        with span("semi.teacher", device=True):
            teacher = state.teacher.train()
            with torch.no_grad(), frozen_bn_stats(teacher):
                teacher_out = teacher(points_t, sample_mod,
                                      with_jitter=teacher_jitter,
                                      noise=teacher_noise,
                                      generator=teacher_generator, rows=rows)
            teacher.eval()

        with span("semi.pseudo_label"):
            acc = classwise_acc(ulb_state.ulb_list, ulb_state.ulb_flag,
                                num_labeled_scans, pl_cfg.thresh_warmup,
                                literal=pl_cfg.literal_reference_cbl)
            pl = get_pseudo_labels(teacher_out, acc, pl_cfg, rows)

        with span("semi.ulb_state"):
            pl_boxes = reproject_boxes(pl.boxes, batch["aug_t"],
                                       batch["aug_s"])
            pl_boxes = pl_boxes * pl.valid[..., None]
            hist = (F.one_hot(pl.labels.long(), pl_cfg.num_classes).float()
                    * pl.valid[..., None]).sum(1)
            # every rank's unlabeled rows in global order: the last-row
            # rule is by global position
            new_ulb_state = update_ulb_state(
                ulb_state,
                parallel.all_gather_rows(
                    batch["ulb_scan_idx"][n_labeled:].long()),
                parallel.all_gather_rows(hist[n_labeled:]))

        with span("semi.student"):
            state.model.train()
            out = state.model(points_s, sample_mod, with_jitter=True,
                              noise=noise, generator=generator, rows=rows)
        out_sup, out_unsup = _slice(out, 0, n_labeled), _slice(out, n_labeled, B)
        with span("semi.targets"):
            sup_targets = get_targets(
                points_s[:n_labeled, :, :3], gt_boxes[:n_labeled],
                batch["gt_labels"][:n_labeled], batch["gt_valid"][:n_labeled],
                out_sup["aggregated_points"],
                pos_distance_thr=pos_distance_thr,
                neg_distance_thr=neg_distance_thr,
                gt_per_seed=loss_cfg.gt_per_seed)
            unsup_targets = get_targets(
                points_s[n_labeled:, :, :3], pl_boxes[n_labeled:],
                pl.labels[n_labeled:], pl.valid[n_labeled:],
                out_unsup["aggregated_points"],
                pos_distance_thr=pos_distance_thr,
                neg_distance_thr=neg_distance_thr,
                gt_per_seed=loss_cfg.gt_per_seed)
        with span("semi.loss"):
            sup_total, sup_terms = sup_loss_fn(out_sup, sup_targets)
            unsup_total, unsup_terms = unsup_loss_fn(
                out_unsup, unsup_targets, pl.quality[n_labeled:])
            total = sup_total + unsup_total

        grad_norm = apply_gradients(state, total)
        with span("semi.ema", device=True):
            ema_update(state, ema_momentum, ema_warm_up, ema_bn_stats)
        metrics = {k: v.detach() for k, v in {**sup_terms,
                                              **unsup_terms}.items()}
        metrics["loss"] = total.detach()
        metrics["num_pseudo"] = pl.valid[n_labeled:].sum()
        metrics = parallel.reduce_metrics(metrics)  # the global values
        metrics["grad_norm"] = grad_norm
        return new_ulb_state, metrics

    return step
