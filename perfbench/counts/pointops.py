"""Least device time of the point searches (copied from the port's
``chip_smoke.py`` bounds, with the operation rate taken from the data
sheet): the larger of the float32 operations at the non-FMA rate and each
input byte read and each output byte written once at HBM's rate."""
from __future__ import annotations

from .peaks import FP32_OPS, HBM_BYTES_PER_S


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_OPS, nbytes / HBM_BYTES_PER_S)


def fps_bound_s(b: int, n: int, m: int) -> float:
    """D-FPS: per step and point 3 subtractions, 3 products, 2 sums, one
    min and one compare of the argmax; reads the coordinates, writes the
    indices."""
    return bound_s(10.0 * b * n * (m - 1), 12.0 * b * n + 4.0 * b * m)


def ball_query_bound_s(scanned: float, b: int, n: int, m: int,
                       k: int) -> float:
    """Ball query: 8 operations per (center, point) pair up to the K-th
    hit (``scanned``: the pairs these inputs need, a center with fewer than
    K hits scanning all n); reads both point sets, writes the indices."""
    return bound_s(8.0 * scanned, 12.0 * b * (n + m) + 4.0 * b * m * k)


def ball_query_scanned(idx, n: int):
    """The pairs a ball query's output says it needed: up to the K-th
    hit's index + 1 where the K-th slot holds a hit past the first, all n
    otherwise (a 0-dim float64 tensor on the output's device)."""
    import torch

    last, first = idx[..., -1].long(), idx[..., 0].long()
    return torch.where(last > first, last + 1, n).double().sum()


def three_nn_bound_s(b: int, m: int, n: int) -> float:
    """Three-NN: 8 operations per (query, source) pair for the distance
    and one compare; reads both point sets, writes 3 indices a query."""
    return bound_s(9.0 * b * m * n, 12.0 * b * (m + n) + 12.0 * b * m)
