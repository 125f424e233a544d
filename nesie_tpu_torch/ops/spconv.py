"""Sparse 3D convolution in plain PyTorch (reference mmdet3d/ops/spconv/:
the vendored spconv library — indice kernels, gather/scatter conv, sparse
maxpool). Counterpart of ``nesie_tpu/ops/spconv.py``; present but unused
by the shipped Nesie configs (SURVEY.md section 2.1).

Design: instead of the CUDA rulebook hash, voxel coordinates are
linearized and sorted once; each kernel offset finds its (input, output)
pairs with a binary search (``torch.searchsorted``, clipped, then a hit
test). Every output site gathers its k^3 neighbours' features, and one
matmul with the ``(k^3 * C_in, C_out)`` weights sums them (the JAX package
sums one dot an offset: the same terms in another order).

A SparseTensor is (features (V, C), coords (V, 3) int32 [z, y, x] or any
consistent order, valid (V,) bool) with a static voxel capacity V. Output
sites of a strided, transposed or pooling layer are the smallest ``V_out``
distinct linear ids in increasing order, padded with the grid's size
(``jnp.unique(size=, fill_value=)``). Linear ids are int64 here (int32 in
the JAX package, which holds every grid below 2^31 sites: KITTI's
41 x 1600 x 1408 is 92.4M).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SparseTensor(NamedTuple):
    features: torch.Tensor  # (V, C)
    coords: torch.Tensor    # (V, 3) int32
    valid: torch.Tensor     # (V,) bool
    grid_shape: tuple       # static (D, H, W)


def _linear(coords, grid_shape):
    D, H, W = grid_shape
    c = coords.to(torch.int64)
    return (c[..., 0] * H + c[..., 1]) * W + c[..., 2]


def _kernel_offsets(kernel_size: int, device=None):
    """(k^3, 3) offsets in ``meshgrid(..., indexing="ij")`` order: the
    order of the weights' first axis."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    off = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(off, dtype=torch.int64, device=device)


def _in_grid(c, grid_shape):
    D, H, W = grid_shape
    return (torch.all(c >= 0, dim=-1) & (c[..., 0] < D) & (c[..., 1] < H)
            & (c[..., 2] < W))


def _sorted_table(x: SparseTensor):
    """Linear ids of the valid sites, sorted (invalid ones last, as the
    grid's size), and the permutation that sorts them."""
    D, H, W = x.grid_shape
    lin = torch.where(x.valid, _linear(x.coords, x.grid_shape), D * H * W)
    order = torch.argsort(lin, stable=True)
    return lin[order], order


def _unique_sites(lin, size: int, fill: int):
    """``jnp.unique(lin, size=size, fill_value=fill)``: the smallest
    ``size`` distinct values in increasing order, padded with ``fill``."""
    u = torch.unique(lin)[:size]
    pad = lin.new_full((size - u.shape[0],), fill)
    return torch.cat([u, pad])


def _coords_of(uniq, grid_shape):
    _, H, W = grid_shape
    return torch.stack([uniq // (H * W), (uniq // W) % H, uniq % W],
                       dim=1).to(torch.int32)


def _gather_conv(x: SparseTensor, weights, nb, ok, bias, out_valid):
    """Sum over offsets k of ``x.features[site nb[:, k]] @ weights[k]``
    where ``ok[:, k]`` and the site is active; zero rows off
    ``out_valid``. nb (V_out, k^3, 3) int64 coords on ``x``'s grid."""
    V = x.features.shape[0]
    D, H, W = x.grid_shape
    sorted_lin, order = _sorted_table(x)
    nb_lin = torch.where(ok, _linear(nb, x.grid_shape), D * H * W + 1)
    pos = torch.clamp(torch.searchsorted(sorted_lin, nb_lin), 0, V - 1)
    hit = ok & (sorted_lin[pos] == nb_lin)
    # a miss reads its own output row (mod V) and is zeroed: the gather's
    # backward, an index_put_ that accumulates duplicates one after
    # another on CUDA, then meets no row read by every miss
    rows = torch.arange(nb.shape[0], device=nb.device)[:, None] % V
    src = torch.where(hit, order[pos], rows)
    gathered = x.features[src] * hit[..., None]  # (V_out, k^3, C_in)
    k3, c_in, c_out = weights.shape
    out = gathered.reshape(-1, k3 * c_in) @ weights.reshape(k3 * c_in, c_out)
    if bias is not None:
        out = out + bias
    return out * out_valid[:, None]


def submanifold_conv3d(x: SparseTensor, weights, bias=None,
                       kernel_size: int = 3) -> SparseTensor:
    """SubMConv3d: output voxels == input voxels (reference conv.py
    SubMConv3d semantics).

    Args:
        weights: (k^3, C_in, C_out).
    """
    offsets = _kernel_offsets(kernel_size, x.coords.device)
    # the neighbour coordinate each output voxel reads from
    nb = x.coords.to(torch.int64)[:, None, :] - offsets[None]
    ok = x.valid[:, None] & _in_grid(nb, x.grid_shape)
    out = _gather_conv(x, weights, nb, ok, bias, x.valid)
    return SparseTensor(out, x.coords, x.valid, x.grid_shape)


def sparse_conv3d(x: SparseTensor, weights, bias=None, kernel_size: int = 3,
                  stride: int = 2, max_out_voxels: int | None = None
                  ) -> SparseTensor:
    """Strided sparse conv (reference SparseConv3d): output sites are the
    distinct downsampled coords of the active inputs; each gathers its
    covered inputs.

    Args:
        weights: (k^3, C_in, C_out); max_out_voxels: static output capacity
            (defaults to the input capacity).
    """
    Vout = max_out_voxels or x.features.shape[0]
    D, H, W = x.grid_shape
    out_grid = ((D + stride - 1) // stride, (H + stride - 1) // stride,
                (W + stride - 1) // stride)
    big_out = out_grid[0] * out_grid[1] * out_grid[2]

    # candidate output voxels: unique downsampled input coords
    down = x.coords.to(torch.int64) // stride
    lin_out = torch.where(x.valid, _linear(down, out_grid), big_out)
    uniq = _unique_sites(lin_out, Vout, big_out)
    out_valid = uniq < big_out
    out_coords = _coords_of(uniq, out_grid)

    offsets = _kernel_offsets(kernel_size, x.coords.device)
    nb = (out_coords.to(torch.int64)[:, None, :] * stride + offsets[None]
          + (stride - 1) // 2)
    ok = out_valid[:, None] & _in_grid(nb, x.grid_shape)
    out = _gather_conv(x, weights, nb, ok, bias, out_valid)
    return SparseTensor(out, out_coords, out_valid, out_grid)


def _upsample_conv_core(x: SparseTensor, weights, out_coords, out_valid,
                        kernel_size: int, stride: int, bias):
    """Shared gather core for inverse/transposed conv: fine-grid output site
    ``o`` reads coarse input ``q`` for kernel offset ``k`` iff the forward
    conv geometry (sparse_conv3d: in = q*stride + off_k + (stride-1)//2)
    linked them — i.e. q = (o - off_k - c) / stride exactly."""
    offsets = _kernel_offsets(kernel_size, x.coords.device)
    t = (out_coords.to(torch.int64)[:, None, :] - offsets[None]
         - (stride - 1) // 2)
    q = torch.div(t, stride, rounding_mode="floor")
    ok = (out_valid[:, None] & torch.all(t % stride == 0, dim=-1)
          & _in_grid(q, x.grid_shape))
    return _gather_conv(x, weights, q, ok, bias, out_valid)


def sparse_inverse_conv3d(x: SparseTensor, weights, ref: SparseTensor,
                          bias=None, kernel_size: int = 3, stride: int = 2
                          ) -> SparseTensor:
    """SparseInverseConv3d (reference conv.py:359-388): upsamples back to the
    active sites of the tensor that fed the matching strided conv, reusing
    that conv's (input, output) index pairs with the roles swapped.

    The reference keys the stored pairs by ``indice_key``; here the
    pre-downsample tensor ``ref`` is passed explicitly and the pairs are
    recomputed from the same geometry, which yields the same rulebook.

    Args:
        weights: (k^3, C_in, C_out), kernel index in forward-conv order.
        ref: the SparseTensor that was the *input* of the strided conv
            whose downsampling this inverts (defines output sites + grid).
    """
    out = _upsample_conv_core(x, weights, ref.coords, ref.valid,
                              kernel_size, stride, bias)
    return SparseTensor(out, ref.coords, ref.valid, ref.grid_shape)


def sparse_conv_transpose3d(x: SparseTensor, weights, bias=None,
                            kernel_size: int = 3, stride: int = 2,
                            max_out_voxels: int | None = None
                            ) -> SparseTensor:
    """SparseConvTranspose3d (reference conv.py:313-336): standalone
    transposed conv — output sites are every fine-grid site reachable from
    an active input through the kernel (no stored index pairs), on the
    stride-upsampled grid.
    """
    Vout = max_out_voxels or x.features.shape[0]
    D, H, W = x.grid_shape
    out_grid = (D * stride, H * stride, W * stride)
    big_out = out_grid[0] * out_grid[1] * out_grid[2]

    # candidate output sites: q*stride + off + c over all offsets
    offsets = _kernel_offsets(kernel_size, x.coords.device)
    cand = (x.coords.to(torch.int64)[:, None, :] * stride + offsets[None]
            + (stride - 1) // 2)
    ok = x.valid[:, None] & _in_grid(cand, out_grid)
    lin = torch.where(ok, _linear(cand, out_grid), big_out).reshape(-1)
    uniq = _unique_sites(lin, Vout, big_out)
    out_valid = uniq < big_out
    out_coords = _coords_of(uniq, out_grid)

    out = _upsample_conv_core(x, weights, out_coords, out_valid,
                              kernel_size, stride, bias)
    return SparseTensor(out, out_coords, out_valid, out_grid)


def sparse_maxpool3d(x: SparseTensor, stride: int = 2,
                     max_out_voxels: int | None = None) -> SparseTensor:
    """Sparse max pooling (reference src/maxpool_cuda.cu semantics). The
    gradient of tied maxima is shared equally among them, as JAX's."""
    V, C = x.features.shape
    Vout = max_out_voxels or V
    D, H, W = x.grid_shape
    out_grid = ((D + stride - 1) // stride, (H + stride - 1) // stride,
                (W + stride - 1) // stride)
    big_out = out_grid[0] * out_grid[1] * out_grid[2]

    down = x.coords.to(torch.int64) // stride
    lin_out = torch.where(x.valid, _linear(down, out_grid), big_out)
    uniq = _unique_sites(lin_out, Vout, big_out)
    out_valid = uniq < big_out
    # every input voxel's output slot
    slot = torch.clamp(torch.searchsorted(uniq, lin_out), 0, Vout - 1)
    hit = x.valid & (uniq[slot] == lin_out)
    pooled = x.features.new_full((Vout, C), -torch.inf).scatter_reduce(
        0, torch.where(hit, slot, Vout - 1)[:, None].expand(V, C),
        torch.where(hit[:, None], x.features, -torch.inf), "amax",
        include_self=True)
    pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    return SparseTensor(pooled * out_valid[:, None],
                        _coords_of(uniq, out_grid), out_valid, out_grid)
