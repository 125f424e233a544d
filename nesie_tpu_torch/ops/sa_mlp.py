"""A set abstraction's grouping, shared MLP and pool: the CUDA kernel's
wrapper and the plain PyTorch version.

``nn.pointnet2.PointSAModule`` runs, after its ball query, the
neighbourhoods through a three-layer ``PointMLP`` and pools them. The
JAX package leaves that to XLA, with no Pallas kernel.

``sa_mlp_ref`` is the plain version: ``group_by_index`` gathers the
relative xyz and the features into (B, M, K, C) tensors, the MLP runs on
them, ``pool_neighbours`` takes the max (or mean) over K. It is the CPU
path, every path the kernel does not take, and the kernel's oracle.

``sa_mlp_cuda`` launches ``csrc/sa_mlp.cu``: the gather, three Linear +
eval BatchNorm + ReLU layers and the max over K in one kernel, from the
raw parameters, with no intermediate in device memory (a small launch
before it pads the first layer's weight into the kernel's input order,
each call anew). Its rounding follows PyTorch's CUDA ops (the kernel's
note), so it differs from the plain version on the card only where
cuBLAS sums a Linear in another order. ``kernel_shape_ok`` says which
widths and K it takes; ``mlp_layers`` reads a ``PointMLP``'s parameters
in the form ``sa_mlp_cuda`` takes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .pointops import group_points

WIDTHS = (64, 128)  # the hidden widths c1 = c2 the kernel takes
PASS = 128  # the last layer's width is a multiple of this


def group_by_index(xyz, new_xyz, features, idx, radius, use_xyz=True,
                   normalize_xyz=True):
    """Grouping by the ball query's ``idx`` (B, M, K): (grouped
    (B, M, K, C'), relative xyz (B, M, K, 3)). The relative offsets,
    divided by the radius with ``normalize_xyz``, lead the grouped
    features with ``use_xyz`` and stand alone without features."""
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        return grouped_xyz, grouped_xyz
    grouped = group_points(features, idx)
    if use_xyz:
        grouped = torch.cat([grouped_xyz, grouped], dim=-1)
    return grouped, grouped_xyz


def pool_neighbours(x: torch.Tensor, pool: str) -> torch.Tensor:
    """Over the neighbourhood axis: ``"max"`` or ``"avg"``."""
    if pool == "max":
        return x.amax(dim=2)
    if pool == "avg":
        return x.mean(dim=2)
    raise ValueError(f"pool={pool!r}: 'max' or 'avg'")


def sa_mlp_ref(xyz, new_xyz, features, idx, radius, mlp, use_xyz=True,
               normalize_xyz=True, pool="max") -> torch.Tensor:
    """Plain version: group, ``mlp`` (a callable on (B, M, K, C')), pool.
    Returns (B, M, C_out)."""
    grouped, _ = group_by_index(xyz, new_xyz, features, idx, radius, use_xyz,
                                normalize_xyz)
    return pool_neighbours(mlp(grouped), pool)


def kernel_shape_ok(widths, num_sample: int) -> bool:
    """Whether the kernel takes layers of output ``widths`` (three) and
    ``num_sample`` neighbours: c1 = c2 in ``WIDTHS``, c3 a multiple of
    ``PASS``, K a multiple of 8 that divides 128."""
    return (len(widths) == 3 and widths[0] == widths[1]
            and widths[0] in WIDTHS and widths[2] % PASS == 0
            and num_sample % 8 == 0 and 128 % num_sample == 0)


def mlp_layers(mlp) -> list[tuple]:
    """A ``PointMLP``'s layers as ``sa_mlp_cuda`` takes them: (Linear
    weight, BN weight, BN bias, running mean, running var, BN eps)."""
    return [(m.conv.weight, m.bn.weight, m.bn.bias, m.bn.running_mean,
             m.bn.running_var, m.bn.eps) for m in mlp]


def _rows(name: str, t: torch.Tensor, dev) -> tuple[int, int]:
    """(batch, point) strides of a (B, n, C) float32 tensor on ``dev``
    whose channels are contiguous."""
    if t.device != dev or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on the input's card, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"{name} has shape {tuple(t.shape)} and strides "
                         f"{t.stride()}; the kernel takes (B, n, C) with "
                         "contiguous channels")
    return t.stride(0), t.stride(1)


def sa_mlp_cuda(xyz, new_xyz, features, idx, radius: float, layers,
                normalize_xyz: bool = True) -> torch.Tensor:
    """Launch ``csrc/sa_mlp.cu`` for one SA call: xyz (B, N, 3), new_xyz
    (B, M, 3) contiguous, features (B, N, C) or None, idx (B, M, K) int32
    contiguous, all on one card; ``layers``: three (Linear weight, BN
    weight, BN bias, running mean, running var, BN eps), the tensors
    float32 contiguous. xyz and features may be views with strided points
    (their channels contiguous). Returns (B, M, c3); raises on anything
    the kernel does not take."""
    dev = xyz.device
    xsb, xsn = _rows("xyz", xyz, dev)
    if xyz.shape[2] != 3:
        raise ValueError(f"xyz has shape {tuple(xyz.shape)}; (B, N, 3)")
    b, n = xyz.shape[:2]
    _build.check_cuda_input("new_xyz", new_xyz)
    if new_xyz.device != dev or new_xyz.shape[0] != b:
        raise ValueError("xyz and new_xyz must share batch size and device")
    m = new_xyz.shape[1]
    if (idx.dtype != torch.int32 or idx.device != dev or idx.dim() != 3
            or tuple(idx.shape[:2]) != (b, m) or not idx.is_contiguous()):
        raise ValueError(f"idx must be contiguous ({b}, {m}, K) int32 on "
                         f"{dev}, got {tuple(idx.shape)} {idx.dtype}")
    k = idx.shape[2]
    c, fsb, fsn, vec, feats = 0, 0, 0, False, xyz
    if features is not None:
        fsb, fsn = _rows("features", features, dev)
        if tuple(features.shape[:2]) != (b, n):
            raise ValueError(f"features has shape {tuple(features.shape)}; "
                             f"({b}, {n}, C)")
        c, feats = features.shape[2], features
        vec = (c % 4 == 0 and fsb % 4 == 0 and fsn % 4 == 0
               and features.data_ptr() % 16 == 0)
    widths = [layer[0].shape[0] for layer in layers]
    if not kernel_shape_ok(widths, k):
        raise ValueError(f"widths {widths} and K={k}: the kernel takes "
                         f"c1 = c2 in {WIDTHS}, c3 a multiple of {PASS} and "
                         "K a multiple of 8 dividing 128")
    cin = c + 3
    ptrs = []
    for (weight, *bn, _), width in zip(layers, widths):
        if tuple(weight.shape) != (width, cin):
            raise ValueError(f"a weight of shape {tuple(weight.shape)} after "
                             f"{cin} inputs")
        for t in (weight, *bn):
            if (t.device != dev or t.dtype != torch.float32
                    or not t.is_contiguous()):
                raise ValueError("the layers' parameters must be contiguous "
                                 f"float32 on {dev}")
        if any(t.shape != (width,) for t in bn):
            raise ValueError(f"BN parameters of a {width}-wide layer")
        ptrs += [t.data_ptr() for t in (weight, *bn)]
        cin = width
    out = torch.empty((b, m, widths[2]), dtype=torch.float32, device=dev)
    if b * m == 0:
        return out
    # W1 in the kernel's layer-1 input order, written by the call
    w1_padded = torch.empty((widths[0], 4 * (1 + (c + 3) // 4)),
                            dtype=torch.float32, device=dev)
    inv_radius = float(np.float32(1.0) / np.float32(radius))
    _build.launch("sa_mlp", "nesie_sa_mlp", xyz.data_ptr(), xsb, xsn,
                  new_xyz.data_ptr(), feats.data_ptr(), fsb, fsn,
                  idx.data_ptr(), b, m, k, c, int(vec), inv_radius,
                  int(normalize_xyz), *widths,
                  (ctypes.c_void_p * 15)(*ptrs),
                  (ctypes.c_float * 3)(*(layer[-1] for layer in layers)),
                  out.data_ptr(), w1_padded.data_ptr(), device=dev)
    return out
