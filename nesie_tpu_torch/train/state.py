"""Training state, optimizer, LR schedule and the EMA teacher.

Counterpart of ``nesie_tpu/train/state.py`` (reference recipe: AdamW lr
8e-3, weight decay 0.01, gradient clip at global L2 norm 10, LR x0.1 at
epochs 24 and 32 of 36).

The optimizer is optax's ``clip_by_global_norm(10)`` then
``adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)``:

  * the clip follows optax's rule, ``g * max_norm / norm`` once the norm
    reaches ``max_norm``, with no epsilon (``torch.nn.utils.
    clip_grad_norm_`` adds 1e-6 to the norm);
  * ``torch.optim.AdamW`` is optax's adamw, decay decoupled and applied to
    every parameter;
  * the LR is read from the schedule at the step count before the update,
    as optax's ``piecewise_constant_schedule`` does, and written into the
    param group by hand: no torch scheduler.

The teacher is a second module of the same architecture. ``ema_update``
moves its parameters by ``m = min(base, (1 + t) / (warm_up + t))`` at the
step count ``t`` after the update (reference simi_teacher_hook.py:54-64);
its BN running statistics are the student's (``ema_bn_stats=False``) or
an EMA of them.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn

from nesie_tpu_torch import parallel
from nesie_tpu_torch.utils import span


@dataclass
class TrainState:
    model: nn.Module      # the student
    teacher: nn.Module    # the EMA teacher
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0
    grad_clip_norm: float = 10.0


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     milestones: Sequence[int] = (24, 32),
                     gamma: float = 0.1) -> Callable[[int], float]:
    """Epoch-milestone step decay: ``base_lr`` times ``gamma`` for every
    boundary the step count has reached."""
    boundaries = [int(m * steps_per_epoch) for m in milestones]

    def schedule(step: int) -> float:
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr *= gamma
        return lr

    return schedule


def make_cosine_lr_after_step(base_lr: float, steps_per_epoch: int,
                              step_epoch: int, total_epochs: int,
                              clip: float = 1e-6) -> Callable[[int], float]:
    """Constant-then-cosine decay (reference ``cosine_lr_after_step``,
    mmdet3d/models/utils/utils.py:26-34): ``base_lr`` until epoch
    ``step_epoch``, then a half cosine down to ``clip`` at
    ``total_epochs``."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < step_epoch:
            return base_lr
        frac = (epoch - step_epoch) / max(total_epochs - step_epoch, 1)
        return clip + 0.5 * (base_lr - clip) * (1.0 + math.cos(math.pi * frac))

    return schedule


def make_optimizer(params, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """optax's adamw (b1 0.9, b2 0.999, eps 1e-8); the LR is set per step
    by ``apply_gradients``."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, lr_schedule: Callable[[int], float],
                       device="cuda", weight_decay: float = 0.01,
                       grad_clip_norm: float = 10.0) -> TrainState:
    """Move ``model`` to ``device`` and pair it with a teacher copy and
    the optimizer."""
    model = model.to(device)
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return TrainState(model=model, teacher=teacher,
                      optimizer=make_optimizer(model.parameters(),
                                               weight_decay),
                      lr_schedule=lr_schedule, grad_clip_norm=grad_clip_norm)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element squared."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place; returns the norm before
    clipping."""
    norm = global_norm(grads)
    below = norm < max_norm
    for g in grads:  # optax: (g / norm) * max_norm, g itself below the bound
        g.copy_(torch.where(below, g, (g / norm) * max_norm))
    return norm


def apply_gradients(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Backward, clip, one AdamW step at the schedule's LR, step + 1.
    Under a launched process group ``loss`` is this rank's share of the
    global loss and the gradients are summed over the ranks before the
    clip. Returns the gradients' global norm before clipping."""
    with span("train.backward"):
        state.optimizer.zero_grad(set_to_none=False)
        loss.backward()
    with span("train.update", device=True):
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        for p in params:  # optax updates a parameter without gradient too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # the global loss is the sum of the ranks' losses: sum the
        # gradients (not DDP's mean), so clip and AdamW see the
        # one-process gradient
        parallel.all_reduce_sum_([p.grad for p in params])
        norm = clip_by_global_norm_([p.grad for p in params],
                                    state.grad_clip_norm)
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
    state.step += 1
    return norm


@torch.no_grad()
def ema_update(state: TrainState, base_momentum: float = 1e-3,
               warm_up: float = 10.0, ema_bn_stats: bool = False) -> float:
    """Teacher <- (1 - m) teacher + m student, with
    ``m = min(base_momentum, (1 + t) / (warm_up + t))`` at ``t =
    state.step``. BN running statistics: the student's by default (the
    reference shares them), an EMA with the same ``m`` when
    ``ema_bn_stats``. Returns m."""
    t = float(state.step)
    m = min(base_momentum, (1.0 + t) / (warm_up + t))
    for e, p in zip(state.teacher.parameters(), state.model.parameters()):
        e.mul_(1.0 - m).add_(m * p)
    for (name, e), p in zip(state.teacher.named_buffers(),
                            state.model.buffers()):
        if ema_bn_stats and not name.endswith("num_batches_tracked"):
            e.mul_(1.0 - m).add_(m * p)
        else:
            e.copy_(p)
    return m
