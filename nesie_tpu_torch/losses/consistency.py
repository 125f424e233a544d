"""SESS-style teacher-student consistency losses and the Lovasz losses.
Counterpart of ``nesie_tpu/losses/consistency.py`` (reference
mmdet3d/models/losses/consistency.py and lovasz_loss.py); the shipped
configs use neither.

Teacher proposals are moved into the student's augmented frame, matched
by chamfer, and compared by centre, class and size. Ties go as in the
JAX package: ``argmin`` / ``argmax`` take the first index, and the Lovasz
sorts are stable (descending errors, then ascending index).
"""
from __future__ import annotations

import torch


def _align_teacher_centers(ema_center, flip_x, flip_y, rot_mat, scale):
    """The student's augmentation applied to the teacher's centres:
    ema_center (B, P, 3); flip_x, flip_y (B,) bool; rot_mat (B, 3, 3);
    scale (B, 1, 3) or (B,)."""
    x = torch.where(flip_x[:, None], -ema_center[..., 0], ema_center[..., 0])
    y = torch.where(flip_y[:, None], -ema_center[..., 1], ema_center[..., 1])
    c = torch.stack([x, y, ema_center[..., 2]], dim=-1)
    c = torch.einsum("bpj,bij->bpi", c, rot_mat)
    return c * scale.reshape(scale.shape[0], 1, -1)


def decode_votenet_size(size_scores, size_residuals, mean_size_arr):
    """VoteNet's size decode: size_scores (B, P, S), size_residuals
    (B, P, S, 3), mean_size_arr (S, 3) -> (B, P, 3), the argmax cluster's
    mean size plus its residual."""
    cls = size_scores.argmax(-1)
    res = size_residuals.gather(
        2, cls[..., None, None].expand(*cls.shape, 1, 3))[:, :, 0]
    mean = torch.as_tensor(mean_size_arr, dtype=size_residuals.dtype,
                           device=size_residuals.device)
    return mean[cls] + res


def consistency_losses(center, sem_scores, size, ema_center, ema_sem_scores,
                       ema_size, flip_x, flip_y, rot_mat, scale):
    """Returns (total, dict of the centre, class and size consistency).

    Matched per teacher proposal (the nearest student proposal); the
    class term is 2 x the elementwise mean of KL(teacher || student); the
    size term the elementwise-mean squared error between the matched
    student sizes and the scaled teacher sizes. center / ema_center
    (B, P, 3), sem_scores (B, P, C) logits, size / ema_size (B, P, 3)
    decoded sizes; the augmentation as in ``_align_teacher_centers``."""
    ema_center = _align_teacher_centers(ema_center, flip_x, flip_y, rot_mat,
                                        scale)
    d = ((center[:, :, None] - ema_center[:, None]) ** 2).sum(-1)
    dist1 = d.amin(2)  # student -> nearest teacher
    dist2 = d.amin(1)  # teacher -> nearest student
    map_ind = d.argmin(1)  # each teacher proposal's nearest student
    center_loss = (dist1 + dist2).mean()

    log_p = torch.log_softmax(sem_scores, dim=-1)
    log_p_aligned = log_p.gather(
        1, map_ind[..., None].expand(-1, -1, log_p.shape[-1]))
    q = torch.softmax(ema_sem_scores, dim=-1)
    class_loss = 2.0 * (q * (torch.log(torch.clamp(q, min=1e-12))
                             - log_p_aligned)).mean()

    size_aligned = size.gather(1, map_ind[..., None].expand(-1, -1, 3))
    ema_size_s = ema_size * scale.reshape(scale.shape[0], 1, -1)
    size_loss = ((size_aligned - ema_size_s) ** 2).mean()

    total = center_loss + class_loss + size_loss
    return total, dict(center_consistency_loss=center_loss,
                       class_consistency_loss=class_loss,
                       size_consistency_loss=size_loss)


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def _descending(errors: torch.Tensor) -> torch.Tensor:
    return torch.argsort(-errors, stable=True)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary Lovasz hinge over flattened logits (N,) and labels (N,) in
    {0, 1}."""
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    order = _descending(errors)
    return (torch.relu(errors[order]) * lovasz_grad(labels[order])).sum()


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   num_classes: int, classes: str = "present"):
    """Multi-class Lovasz-softmax over flattened probabilities (N, C) and
    labels (N,). ``"present"`` averages over the classes that occur in
    ``labels``; ``"all"`` over every class."""
    losses, present = [], []
    for c in range(num_classes):
        fg = (labels == c).to(probs.dtype)
        errors = torch.abs(fg - probs[:, c])
        order = _descending(errors)
        losses.append((errors[order] * lovasz_grad(fg[order])).sum())
        present.append(fg.sum() > 0)
    losses = torch.stack(losses)
    if classes == "all":
        return losses.mean()
    mask = torch.stack(present).to(losses.dtype)
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
