"""3D semantic segmentation with a PointNet++ encoder-decoder. Counterpart
of ``nesie_tpu/nn/segmentor.py`` (reference mmdet3d
encoder_decoder.py EncoderDecoder3D): the SSG backbone, a last FP back to
every input point and a per-point classifier, an optional auxiliary head
on the last intermediate FP level (deep supervision in training), the
losses, and sliding-window inference with overlap averaging.

The defaults are mmdet3d's ``pointnet2_ssg`` ScanNet segmentation widths.
Dropout draws its mask from an explicit ``torch.Generator`` (flax's
inverted dropout: kept values scaled by 1 / (1 - p)).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from nesie_tpu_torch.losses import softmax_cross_entropy
from nesie_tpu_torch.losses.consistency import lovasz_softmax
from .layers import PointMLP
from .pointnet2 import PointFPModule, PointNet2SASSG


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with a mask from ``generator`` (on x's device)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class PointNet2Segmentor(nn.Module):
    """points (B, N, in_channels) -> per-point logits (B, N, num_classes),
    or with ``with_aux`` a dict of ``seg_logits``, ``aux_logits`` (B, M,
    num_classes) at the last intermediate level and ``aux_indices``
    (B, M), that level's indices into the input points."""

    def __init__(
        self,
        num_classes: int = 20,
        in_channels: int = 4,
        num_points: Sequence[int] = (1024, 256, 64, 16),
        radii: Sequence[float] = (0.1, 0.2, 0.4, 0.8),
        num_samples: Sequence[int] = (32, 32, 32, 32),
        sa_channels: Sequence[Sequence[int]] = (
            (32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512),
        ),
        fp_channels: Sequence[Sequence[int]] = (
            (256, 256), (256, 256), (256, 128), (128, 128, 128),
        ),
        head_channels: int = 128,
        dropout: float = 0.5,
        with_aux: bool = False,
    ):
        super().__init__()
        self.dropout = dropout
        self.with_aux = with_aux
        self.backbone = PointNet2SASSG(in_channels, num_points, radii,
                                       num_samples, sa_channels,
                                       fp_channels[:-1])
        mid = fp_channels[-2][-1] if len(fp_channels) > 1 \
            else sa_channels[-1][-1]
        self.fp_final = PointFPModule(mid + in_channels - 3, fp_channels[-1])
        self.head = PointMLP(fp_channels[-1][-1], (head_channels,), bias=True)
        self.cls = nn.Linear(head_channels, num_classes)
        if with_aux:
            self.aux_head = PointMLP(mid, (head_channels,), bias=True)
            self.aux_cls = nn.Linear(head_channels, num_classes)

    def _drop(self, x, generator):
        if self.training and self.dropout > 0:
            return dropout(x, self.dropout, generator)
        return x

    def forward(self, points: torch.Tensor,
                generator: torch.Generator | None = None):
        """``generator``: the dropout masks' draws, needed in train mode
        with ``dropout > 0``."""
        feat = self.backbone(points)
        full = self.fp_final(feat["sa_xyz"][0], feat["fp_xyz"][-1],
                             feat["sa_features"][0], feat["fp_features"][-1])
        seg_logits = self.cls(self._drop(self.head(full), generator))
        if not self.with_aux:
            return seg_logits
        aux = self._drop(self.aux_head(feat["fp_features"][-1]), generator)
        return dict(seg_logits=seg_logits, aux_logits=self.aux_cls(aux),
                    aux_indices=feat["fp_indices"][-1])


def segmentation_loss(logits, labels, ignore_index: int = 255,
                      use_lovasz: bool = False):
    """Per-point cross-entropy averaged over the points whose label is not
    ``ignore_index`` (+ Lovasz-softmax over every point, the ignored ones
    as class 0, as in the JAX package)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = softmax_cross_entropy(logits, safe) * valid
    loss = ce.sum() / torch.clamp(valid.sum(), min=1).to(ce.dtype)
    if use_lovasz:
        probs = torch.softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
        loss = loss + lovasz_softmax(probs, safe.reshape(-1),
                                     logits.shape[-1])
    return loss


def encoder_decoder_loss(out, labels, aux_weight: float = 0.4,
                         ignore_index: int = 255, use_lovasz: bool = False):
    """The decode loss + ``aux_weight`` x the auxiliary loss, whose labels
    are the input labels at the auxiliary level's point indices."""
    if not isinstance(out, dict):
        return segmentation_loss(out, labels, ignore_index, use_lovasz)
    loss = segmentation_loss(out["seg_logits"], labels, ignore_index,
                             use_lovasz)
    aux_labels = labels.gather(1, out["aux_indices"].long())
    return loss + aux_weight * segmentation_loss(
        out["aux_logits"], aux_labels, ignore_index, use_lovasz)


def segmentor_apply_fn(model: nn.Module, device):
    """A ``slide_inference`` ``apply_fn``: a (B, num_points, D) numpy batch
    through ``model`` on ``device``, in inference mode; only the logits
    come back to the host."""
    device = torch.device(device)

    @torch.inference_mode()
    def apply_fn(chunk):
        pts = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        out = model(pts.to(device))
        logits = out["seg_logits"] if isinstance(out, dict) else out
        return logits.float().cpu().numpy()

    return apply_fn


def slide_inference(points, apply_fn, num_points: int, block_size: float,
                    sample_rate: float = 0.5, batch_size: int = 4,
                    use_normalized_coord: bool = False, seed: int = 0,
                    eps: float = 1e-3):
    """Sliding-window patch inference with overlap averaging (the JAX
    package's numpy code): ``block_size`` square BEV patches at stride
    ``block_size * sample_rate``; each patch's points padded by random
    duplication (``np.random.default_rng(seed)``) to a multiple of
    ``num_points``; ``apply_fn`` over batches of ``batch_size`` patches
    (the last padded by repeating its last patch); the per-point logits
    averaged over every occurrence.

    points (N, 3+C) numpy; apply_fn (B, num_points, D) -> (B, num_points,
    num_classes). Returns (N, num_classes) numpy logits."""
    rng = np.random.default_rng(seed)
    points = np.asarray(points)
    coords, feats = points[:, :3], points[:, 3:]
    coord_max, coord_min = coords.max(0), coords.min(0)
    stride = block_size * sample_rate
    n_x = int(np.ceil(max(coord_max[0] - coord_min[0] - block_size, 0)
                      / stride)) + 1
    n_y = int(np.ceil(max(coord_max[1] - coord_min[1] - block_size, 0)
                      / stride)) + 1

    patch_points, patch_idxs = [], []
    for iy in range(n_y):
        e_y = min(coord_min[1] + iy * stride + block_size, coord_max[1])
        s_y = e_y - block_size
        for ix in range(n_x):
            e_x = min(coord_min[0] + ix * stride + block_size, coord_max[0])
            s_x = e_x - block_size
            cur_min = np.array([s_x, s_y, coord_min[2]])
            cur_max = np.array([e_x, e_y, coord_max[2]])
            choice = np.all(
                (coords >= cur_min - eps) & (coords <= cur_max + eps), axis=1)
            if not choice.any():
                continue
            idxs = np.nonzero(choice)[0]
            n_batch = int(np.ceil(len(idxs) / num_points))
            size = n_batch * num_points
            pad = rng.choice(idxs, size - len(idxs),
                             replace=size > 2 * len(idxs))
            idxs = rng.permutation(np.concatenate([idxs, pad]))
            center = cur_min + block_size / 2.0
            c = coords[idxs].copy()
            c[:, 0] -= center[0]
            c[:, 1] -= center[1]
            f = feats[idxs]
            if use_normalized_coord:
                f = np.concatenate([f, coords[idxs] / coord_max], axis=1)
            patch_points.append(
                np.concatenate([c, f], axis=1).reshape(n_batch, num_points, -1))
            patch_idxs.append(idxs.reshape(n_batch, num_points))

    patch_points = np.concatenate(patch_points, 0)
    patch_idxs = np.concatenate(patch_idxs, 0)
    if len(np.unique(patch_idxs)) != len(points):
        raise AssertionError("some points are not sampled in sliding "
                             "inference")

    logits_sum = None
    counts = np.zeros((len(points), 1), np.float32)
    for start in range(0, len(patch_points), batch_size):
        chunk = patch_points[start:start + batch_size]
        n_real = len(chunk)
        if n_real < batch_size:  # pad the tail batch to the static shape
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - n_real, 0)], 0)
        out = np.asarray(apply_fn(chunk))[:n_real]
        if logits_sum is None:
            logits_sum = np.zeros((len(points), out.shape[-1]), np.float32)
        for b in range(n_real):
            np.add.at(logits_sum, patch_idxs[start + b], out[b])
            np.add.at(counts, patch_idxs[start + b], 1.0)
    return logits_sum / np.maximum(counts, 1.0)
