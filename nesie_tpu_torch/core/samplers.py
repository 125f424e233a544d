"""Proposal samplers from the reference's sampler registry.

``IoUNegPiecewiseSampler`` (reference mmdet3d/core/bbox/samplers/
iou_neg_piecewise_sampler.py:8-157) is the PartA2 two-stage sampler:
positives are drawn at random up to ``num * pos_fraction``; negatives are
stratified into IoU pieces ``[thr_i+1, thr_i)`` with per-piece quotas
``num_expected * neg_piece_fractions[i]``, a shortfall in one piece
extending the next piece's quota, and the final piece (IoU >= 0) absorbing
whatever remains.

This is host-side target assignment (the reference runs it per scene
inside the RoI head between stages); a numpy implementation keeps the
ragged sizes off the device — the sampled indices then gather fixed-size
RoI batches for the card. The RNG is injectable so tests can pin both this
and the reference to the same draws.

Not used by the shipped indoor Nesie/SAQE configs (single-stage VoteNet
heads); completes the reference's component inventory (SURVEY.md §2.2).

A copy of ``nesie_tpu/core/samplers.py``, so that the port does not
import the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np


class AssignResult(NamedTuple):
    """Assigner output (mmdet AssignResult essentials): ``gt_inds`` is 0
    for negatives and 1-based GT index for positives."""

    gt_inds: np.ndarray       # (N,) int
    max_overlaps: np.ndarray  # (N,) float
    labels: Optional[np.ndarray] = None

    def add_gt(self, gt_labels):
        """Prepend GT self-assignments (mmdet AssignResult.add_gt_)."""
        num_gts = len(gt_labels)
        gt_inds = np.concatenate(
            [np.arange(1, num_gts + 1, dtype=self.gt_inds.dtype), self.gt_inds]
        )
        max_overlaps = np.concatenate(
            [np.ones(num_gts, self.max_overlaps.dtype), self.max_overlaps]
        )
        labels = (
            None
            if self.labels is None
            else np.concatenate([np.asarray(gt_labels), self.labels])
        )
        return AssignResult(gt_inds, max_overlaps, labels)


class SamplingResult(NamedTuple):
    pos_inds: np.ndarray
    neg_inds: np.ndarray
    pos_assigned_gt_inds: np.ndarray  # 0-based GT index per positive
    pos_is_gt: np.ndarray             # positives that are appended GTs
    iou: Optional[np.ndarray] = None  # max_overlaps at [pos; neg] if asked


def _default_random_choice(gallery: np.ndarray, num: int,
                           rng: np.random.Generator) -> np.ndarray:
    """mmdet RandomSampler.random_choice: a random permutation prefix."""
    perm = rng.permutation(len(gallery))[:num]
    return gallery[perm]


@dataclass
class IoUNegPiecewiseSampler:
    num: int
    pos_fraction: float = 0.5
    neg_piece_fractions: Sequence[float] = (0.8, 0.2)
    neg_iou_piece_thrs: Sequence[float] = (0.55, 0.1)
    neg_pos_ub: float = -1
    add_gt_as_proposals: bool = False
    return_iou: bool = False
    # injectable for deterministic tests; signature (gallery, num, rng)
    random_choice: Callable = field(default=_default_random_choice)

    def __post_init__(self):
        assert len(self.neg_piece_fractions) == len(self.neg_iou_piece_thrs)
        self.neg_piece_num = len(self.neg_piece_fractions)

    def _sample_pos(self, assign: AssignResult, num_expected: int, rng):
        pos_inds = np.flatnonzero(assign.gt_inds > 0)
        if len(pos_inds) <= num_expected:
            return pos_inds
        return self.random_choice(pos_inds, num_expected, rng)

    def _sample_neg(self, assign: AssignResult, num_expected: int, rng):
        """Piecewise stratified negatives (reference _sample_neg,
        iou_neg_piecewise_sampler.py:56-96): per-piece quota with the
        shortfall of an underfull piece extending the next one."""
        neg_inds = np.flatnonzero(assign.gt_inds == 0)
        if len(neg_inds) <= num_expected:
            return neg_inds
        choice = np.zeros((0,), np.int64)
        extend_num = 0
        max_overlaps = assign.max_overlaps[neg_inds]
        for piece in range(self.neg_piece_num):
            if piece == self.neg_piece_num - 1:
                piece_expected = num_expected - len(choice)
                min_iou_thr = 0.0
            else:
                piece_expected = (
                    int(num_expected * self.neg_piece_fractions[piece])
                    + extend_num
                )
                min_iou_thr = self.neg_iou_piece_thrs[piece + 1]
            max_iou_thr = self.neg_iou_piece_thrs[piece]
            piece_neg = np.flatnonzero(
                (max_overlaps >= min_iou_thr) & (max_overlaps < max_iou_thr)
            )
            if len(piece_neg) < piece_expected:
                choice = np.concatenate([choice, neg_inds[piece_neg]])
                extend_num += piece_expected - len(piece_neg)
            else:
                picked = self.random_choice(piece_neg, piece_expected, rng)
                choice = np.concatenate([choice, neg_inds[picked]])
                extend_num = 0
        return choice

    def sample(
        self,
        assign: AssignResult,
        bboxes: np.ndarray,
        gt_bboxes: np.ndarray,
        gt_labels: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> SamplingResult:
        """Reference sample() (iou_neg_piecewise_sampler.py:98-157):
        optional GT-as-proposal prepend, unique()'d pos/neg draws, the
        ``neg_pos_ub`` cap, and ``iou`` attached when ``return_iou``."""
        rng = rng or np.random.default_rng()
        bboxes = np.atleast_2d(bboxes)
        gt_flags = np.zeros(len(bboxes), bool)
        if self.add_gt_as_proposals and len(gt_bboxes) > 0:
            if gt_labels is None:
                raise ValueError(
                    "gt_labels must be given when add_gt_as_proposals is True"
                )
            bboxes = np.concatenate([gt_bboxes, bboxes], axis=0)
            assign = assign.add_gt(gt_labels)
            gt_flags = np.concatenate([np.ones(len(gt_bboxes), bool), gt_flags])

        num_expected_pos = int(self.num * self.pos_fraction)
        pos_inds = np.unique(self._sample_pos(assign, num_expected_pos, rng))
        num_expected_neg = self.num - len(pos_inds)
        if self.neg_pos_ub >= 0:
            neg_upper = int(self.neg_pos_ub * max(1, len(pos_inds)))
            num_expected_neg = min(num_expected_neg, neg_upper)
        neg_inds = np.unique(self._sample_neg(assign, num_expected_neg, rng))

        res = SamplingResult(
            pos_inds=pos_inds,
            neg_inds=neg_inds,
            pos_assigned_gt_inds=assign.gt_inds[pos_inds] - 1,
            pos_is_gt=gt_flags[pos_inds],
        )
        if self.return_iou:
            res = res._replace(
                iou=assign.max_overlaps[np.concatenate([pos_inds, neg_inds])]
            )
        return res
