"""The supervised train step and the eval forward. Counterpart of
``nesie_tpu/train/step.py`` (semi-supervised step in ``semi.py``).

A step updates ``TrainState`` in place (the student, its optimizer, the
step count and the teacher) and returns its metrics as 0-dim tensors on
the model's device, so that it does not wait for the card.
"""
from __future__ import annotations

import torch

from nesie_tpu_torch.data.augment import augment_boxes, augment_points
from .state import TrainState, apply_gradients, ema_update
from .saqe_loss import SAQELossConfig, saqe_supervised_loss
from .sup_loss import NesieLossConfig, nesie_supervised_loss
from .targets import get_targets


def saqe_loss_config(loss_cfg: NesieLossConfig) -> SAQELossConfig:
    """The SAQE steps' loss settings, as the JAX package's steps make them
    (``nesie_tpu/train/step.py:38-41``, ``semi.py:161-165``): a plain
    ``NesieLossConfig`` (what every named ``saqe-*`` config carries) is
    replaced by ``SAQELossConfig(num_classes=...)``, so its other
    settings, ``iou_pred_weight=3.0`` of the pretrain configs and any
    ``loss.*`` override among them, do not reach the SAQE losses. Kept as
    the JAX package has it (ROADMAP §3)."""
    if isinstance(loss_cfg, SAQELossConfig):
        return loss_cfg
    return SAQELossConfig(num_classes=loss_cfg.num_classes)


def make_supervised_train_step(
    loss_cfg: NesieLossConfig = NesieLossConfig(),
    sample_mod: str = "vote",
    ema_momentum: float = 1e-3,
    ema_warm_up: float = 10.0,
    pos_distance_thr: float = 0.3,
    neg_distance_thr: float = 0.6,
    ema_bn_stats: bool = False,
    head: str = "nesie",
):
    """Build the supervised step ``train_step(state, batch, noise=None,
    generator=None) -> metrics``. ``head="saqe"`` takes the SAQE
    pretrain losses.

    batch: points (B, N, C_in), gt_boxes (B, MAX_GT, 7) bottom-centered,
    gt_labels (B, MAX_GT), gt_valid (B, MAX_GT) bool, and optionally
    ``aug`` (AugParams, applied on the device to points and boxes).
    noise / generator: the head's jitter noise (see NesieHead.forward).
    """
    if head == "saqe":
        saqe_cfg = saqe_loss_config(loss_cfg)

        def sup_loss_fn(out, targets):
            return saqe_supervised_loss(out, targets, saqe_cfg,
                                        phase="pretrain")
    else:
        def sup_loss_fn(out, targets):
            return nesie_supervised_loss(out, targets, loss_cfg)

    def train_step(state: TrainState, batch: dict, noise=None,
                   generator: torch.Generator | None = None) -> dict:
        points, gt_boxes = batch["points"], batch["gt_boxes"]
        if "aug" in batch:
            points = augment_points(points, batch["aug"], shift_height=True)
            gt_boxes = augment_boxes(gt_boxes, batch["aug"])
        state.model.train()
        out = state.model(points, sample_mod, with_jitter=True, noise=noise,
                          generator=generator)
        targets = get_targets(
            points[..., :3], gt_boxes, batch["gt_labels"], batch["gt_valid"],
            out["aggregated_points"], pos_distance_thr=pos_distance_thr,
            neg_distance_thr=neg_distance_thr,
            gt_per_seed=loss_cfg.gt_per_seed)
        total, terms = sup_loss_fn(out, targets)
        grad_norm = apply_gradients(state, total)
        ema_update(state, ema_momentum, ema_warm_up, ema_bn_stats)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_forward(sample_mod: str = "seed", use_teacher: bool = False):
    """``forward(state, points) -> results``: the student's (or the
    teacher's) eval forward, running-statistics BN, no jitter."""

    @torch.no_grad()
    def forward(state: TrainState, points: torch.Tensor) -> dict:
        model = state.teacher if use_teacher else state.model
        model.eval()
        return model(points, sample_mod, with_jitter=False)

    return forward
