"""3D anchor generation (reference
mmdet3d/core/anchor/anchor_3d_generator.py: Anchor3DRangeGenerator:8,
AlignedAnchor3DRangeGenerator:213, AlignedAnchor3DRangeGeneratorPerCls:329).
Counterpart of ``nesie_tpu/core/anchors.py``.

Parity components for anchor-based heads — the VoteNet family is
anchor-free, so nothing in the Nesie path consumes these. Semantics
(meshgrid order, permute to (D, H, W, S, R, 7), per-size ranges, aligned
half-cell shift, zero-filled custom values) follow the reference.

The centres are computed as ``jnp.linspace`` computes them,
``lo * (1 - t) + hi * t`` with ``t = i / (n - 1)`` in float32 and ``hi``
itself last; ``torch.linspace`` steps from both ends and rounds
differently. ``device`` places the anchors (default: the CPU).
"""
from __future__ import annotations

from typing import Sequence

import torch


def _linspace(lo, hi, n: int):
    """``jnp.linspace(lo, hi, n)`` for float32 scalar tensors."""
    if n == 1:
        return lo.reshape(1)
    t = torch.arange(n - 1, dtype=torch.float32, device=lo.device) / (n - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _single_range(feature_size, anchor_range, scale, sizes, rotations,
                  aligned: bool, align_corner: bool, device=None):
    """Anchors for one (range, sizes) pair.

    Returns (D, H, W, S, R, 7) like the reference's ``anchors_single_range``
    (anchor_3d_generator.py:147-211 plain / :243-328 aligned).
    """
    if len(feature_size) == 2:
        feature_size = (1, *feature_size)
    D, H, W = (int(v) for v in feature_size)
    r = torch.tensor(anchor_range, dtype=torch.float32, device=device)

    def centers(lo, hi, n):
        if not aligned:
            return _linspace(lo, hi, n)
        edges = _linspace(lo, hi, n + 1)
        if align_corner:
            return edges[:n]
        return edges[:n] + (edges[1] - edges[0]) / 2

    zs = centers(r[2], r[5], D)
    ys = centers(r[1], r[4], H)
    xs = centers(r[0], r[3], W)
    sizes = torch.tensor(sizes, dtype=torch.float32,
                         device=device).reshape(-1, 3) * scale
    rots = torch.tensor(rotations, dtype=torch.float32, device=device)
    S, R = sizes.shape[0], rots.shape[0]

    zz, yy, xx = torch.meshgrid(zs, ys, xs, indexing="ij")  # (D, H, W)
    grid = torch.stack([xx, yy, zz], dim=-1)                # (D, H, W, 3)
    return torch.cat([
        grid[:, :, :, None, None].expand(D, H, W, S, R, 3),
        sizes[None, None, None, :, None].expand(D, H, W, S, R, 3),
        rots[None, None, None, None, :, None].expand(D, H, W, S, R, 1),
    ], dim=-1)


class Anchor3DRangeGenerator:
    """Range-based dense anchors (anchor_3d_generator.py:8-211)."""

    aligned = False

    def __init__(
        self,
        ranges: Sequence[Sequence[float]],
        sizes: Sequence[Sequence[float]] = ((1.6, 3.9, 1.56),),
        scales: Sequence[float] = (1,),
        rotations: Sequence[float] = (0, 1.5707963),
        custom_values: Sequence[float] = (),
        reshape_out: bool = True,
        size_per_range: bool = True,
        align_corner: bool = False,
        device=None,
    ):
        ranges = [list(r) for r in ranges]
        if size_per_range:
            if len(sizes) != len(ranges):
                assert len(ranges) == 1
                ranges = ranges * len(sizes)
            assert len(ranges) == len(sizes)
        else:
            assert len(ranges) == 1
        self.ranges = ranges
        self.sizes = [list(s) for s in sizes]
        self.scales = list(scales)
        self.rotations = list(rotations)
        self.custom_values = tuple(custom_values)
        self.reshape_out = reshape_out
        self.size_per_range = size_per_range
        self.align_corner = align_corner
        self.device = device

    @property
    def num_base_anchors(self):
        return len(self.sizes) * len(self.rotations)

    @property
    def num_levels(self):
        return len(self.scales)

    def _with_custom(self, anchors):
        if not self.custom_values:
            return anchors
        # the reference leaves the custom columns zeroed (:204-209)
        pad = anchors.new_zeros(
            anchors.shape[:-1] + (len(self.custom_values),))
        return torch.cat([anchors, pad], dim=-1)

    def _range(self, featmap_size, rng, scale, sizes):
        return _single_range(featmap_size, rng, scale, sizes, self.rotations,
                             self.aligned, self.align_corner, self.device)

    def single_level_grid_anchors(self, featmap_size, scale):
        """(D, H, W, S_total, R, 7+custom) for one feature level."""
        if not self.size_per_range:
            return self._with_custom(
                self._range(featmap_size, self.ranges[0], scale, self.sizes))
        per = [self._range(featmap_size, rng, scale, [size])
               for rng, size in zip(self.ranges, self.sizes)]
        return self._with_custom(torch.cat(per, dim=-3))

    def grid_anchors(self, featmap_sizes):
        """Anchors per level; flattened to (N, 7+custom) if reshape_out."""
        assert self.num_levels == len(featmap_sizes)
        out = []
        for i in range(self.num_levels):
            a = self.single_level_grid_anchors(featmap_sizes[i],
                                               self.scales[i])
            out.append(a.reshape(-1, a.shape[-1]) if self.reshape_out else a)
        return out


class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    """Voxel-aligned variant (anchor_3d_generator.py:213-328): centers sit
    at cell centers of an (N+1)-edge grid (or corners if align_corner)."""

    aligned = True


class AlignedAnchor3DRangeGeneratorPerCls(AlignedAnchor3DRangeGenerator):
    """Per-class featmap sizes in one level (anchor_3d_generator.py:329-403)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        assert len(self.scales) == 1, (
            "multi-scale levels unsupported for per-class anchors"
        )

    def grid_anchors(self, featmap_sizes):
        return [self.multi_cls_grid_anchors(featmap_sizes, self.scales[0])]

    def multi_cls_grid_anchors(self, featmap_sizes, scale):
        """Per class c: (S_c*R*prod(featmap_sizes[c]), 7+custom), anchors
        ordered base-anchor-major (reference permute, :366-403)."""
        assert len(featmap_sizes) == len(self.sizes) == len(self.ranges)
        out = []
        for fs, rng, size in zip(featmap_sizes, self.ranges, self.sizes):
            a = self._with_custom(self._range(fs, rng, scale, size))
            code = a.shape[-1]
            ndim = len(fs)
            a = a.reshape(*fs, -1, code)           # (*fs, S*R, code)
            a = torch.movedim(a, ndim, 0)          # (S*R, *fs, code)
            out.append(a.reshape(-1, code))
        return out


def anchor_3d_range_grid(
    feature_size: Sequence[int],
    anchor_range: Sequence[float],
    sizes: Sequence[Sequence[float]] = ((1.6, 3.9, 1.56),),
    rotations: Sequence[float] = (0.0, 1.5707963),
    device=None,
):
    """Flat convenience wrapper: dense (D*H*W*S*R, 7) anchors over a range
    (plain, non-aligned convention)."""
    a = _single_range(feature_size, anchor_range, 1.0, sizes, rotations,
                      aligned=False, align_corner=False, device=device)
    return a.reshape(-1, 7)
