"""Target assignment for the Nesie head, batched with static shapes.

Counterpart of ``nesie_tpu/train/targets.py`` (reference
NesieHead.get_targets, nesie_head.py:511-679): ground truth comes as
padded ``(B, MAX_GT, 7)`` bottom-centered boxes with validity masks.

Reference quirks kept, as in the JAX package:
  * vote slots: slots 0/1 take the 1st/2nd containing box in index order;
    slot 2 the *last* containing box once 3 or more contain the point; a
    point in one box repeats its vote in all three slots;
  * padded zero boxes take part in the proposal->GT chamfer loss but not
    in the argmin assignment;
  * an empty scene falls back to the zero box in slot 0 with label 0.

The weights are normalised by sums over the global batch: over every
rank's rows under a launched process group (``parallel``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import parallel
from perfbench.reference.core.boxes import points_in_boxes
from perfbench.reference.losses.chamfer import chamfer_distance


class HeadTargets(NamedTuple):
    vote_targets: torch.Tensor        # (B, N, 9)
    vote_target_masks: torch.Tensor   # (B, N) int32
    center_targets: torch.Tensor      # (B, MAX_GT, 3) gravity centers, 0-padded
    bbox_targets: torch.Tensor        # (B, P, 7) assigned gravity-centered boxes
    mask_targets: torch.Tensor        # (B, P) int32 class of the assigned GT
    valid_gt_masks: torch.Tensor      # (B, MAX_GT) float
    objectness_targets: torch.Tensor  # (B, P) int32
    objectness_weights: torch.Tensor  # (B, P) float, globally normalised
    box_loss_weights: torch.Tensor    # (B, P) float, globally normalised
    valid_gt_weights: torch.Tensor    # (B, MAX_GT) float, globally normalised
    assignment: torch.Tensor          # (B, P) int32


def _gravity_centers(boxes):
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + 0.5 * boxes[..., 5:6]],
                     dim=-1)


def vote_targets(points, gt_boxes, gt_valid, gt_per_seed: int = 3):
    """Per-point vote targets: points (B, N, 3), gt_boxes (B, K, 7)
    bottom-centered, gt_valid (B, K) bool -> votes (B, N, 3*gt_per_seed),
    mask (B, N) int32."""
    K = gt_boxes.shape[1]
    inside = points_in_boxes(points, gt_boxes) & gt_valid[:, None, :]
    votes_all = (_gravity_centers(gt_boxes)[:, None, :, :]
                 - points[:, :, None, :3])  # (B, N, K, 3)

    iota = torch.arange(K, device=points.device)
    key = torch.where(inside, iota, K)
    count = inside.sum(-1)
    first_key = key.amin(-1)
    second_key = torch.where(key == first_key[..., None], K, key).amin(-1)
    first = torch.clamp(first_key, 0, K - 1)
    second = torch.clamp(second_key, 0, K - 1) if K > 1 else first
    last = torch.clamp(torch.where(inside, iota, -1).amax(-1), 0, K - 1)
    third = torch.where(count >= 3, last, first)  # the clamp-at-2 overwrite

    def take(idx):
        return votes_all.gather(2, idx[..., None, None].expand(
            *idx.shape, 1, 3))[..., 0, :]

    v0 = take(first)
    v1 = torch.where((count >= 2)[..., None], take(second), v0)
    v2 = torch.where((count >= 3)[..., None], take(third), v0)
    votes = torch.cat([v0, v1, v2][:gt_per_seed], dim=-1)
    mask = (count > 0).to(torch.int32)
    return votes * mask[..., None], mask


def vote_targets_single(points, gt_boxes, gt_valid, gt_per_seed: int = 3):
    """One scene: points (N, 3), gt_boxes (K, 7), gt_valid (K,) ->
    votes (N, 3*gt_per_seed), mask (N,) int32."""
    votes, mask = vote_targets(points[None], gt_boxes[None], gt_valid[None],
                               gt_per_seed)
    return votes[0], mask[0]


def get_targets(points, gt_boxes, gt_labels, gt_valid, aggregated_points,
                pos_distance_thr: float = 0.3, neg_distance_thr: float = 0.6,
                gt_per_seed: int = 3) -> HeadTargets:
    """Batched target assignment: points (B, N, >=3), gt_boxes
    (B, MAX_GT, 7) bottom-centered and zero-padded, gt_labels (B, MAX_GT),
    gt_valid (B, MAX_GT) bool, aggregated_points (B, P, 3)."""
    votes, vote_masks = vote_targets(points[..., :3], gt_boxes, gt_valid,
                                     gt_per_seed)
    centers = _gravity_centers(gt_boxes) * gt_valid[..., None]
    dist_sq, _, assignment, _ = chamfer_distance(
        aggregated_points, centers, mode="l2", dst_valid=gt_valid)
    euclid = torch.sqrt(dist_sq + 1e-6)

    pos = euclid < pos_distance_thr
    objectness_targets = pos.to(torch.int32)
    objectness_masks = (pos | (euclid > neg_distance_thr)).float()
    pos_f = pos.float()
    valid_f = gt_valid.float()
    # the normalisers: sums over the global batch (every rank's rows)
    n_obj, n_pos, n_valid = parallel.all_reduce_sum(torch.stack(
        [objectness_masks.sum(), pos_f.sum(), valid_f.sum()]))
    objectness_weights = objectness_masks / (n_obj + 1e-6)
    box_loss_weights = pos_f / (n_pos + 1e-6)
    valid_gt_weights = valid_f / (n_valid + 1e-6)

    mask_targets = gt_labels.gather(1, assignment)
    idx = assignment[..., None]
    assigned_boxes = gt_boxes.gather(1, idx.expand(-1, -1, 7))
    assigned_centers = centers.gather(1, idx.expand(-1, -1, 3))
    bbox_targets = torch.cat([assigned_centers, assigned_boxes[..., 3:]],
                             dim=-1)
    return HeadTargets(
        vote_targets=votes,
        vote_target_masks=vote_masks,
        center_targets=centers,
        bbox_targets=bbox_targets,
        mask_targets=mask_targets.to(torch.int32),
        valid_gt_masks=valid_f,
        objectness_targets=objectness_targets,
        objectness_weights=objectness_weights,
        box_loss_weights=box_loss_weights,
        valid_gt_weights=valid_gt_weights,
        assignment=assignment.to(torch.int32),
    )
