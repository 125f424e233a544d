"""Sparse ResNet blocks (reference mmdet3d/ops/sparse_block.py) on the
plain-PyTorch sparse convolutions. Counterpart of
``nesie_tpu/nn/sparse_block.py``; the modules own the kernel weights,
``(k^3, C_in, C_out)`` in ``ops.spconv``'s offset order. Flax infers the
input width; here it is the first argument, as in the reference.

``_SparseBN`` is flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5, fast
variance) over all V rows of the features, the padding rows included, as
the JAX package normalises them; only then are the padding rows zeroed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from nesie_tpu_torch.nn.layers import BatchNorm
from nesie_tpu_torch.ops.spconv import (
    SparseTensor,
    sparse_conv3d,
    submanifold_conv3d,
)


class _SparseConvBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, use_bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(kernel_size**3, in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)
        # flax's lecun_normal with the offset axis as a batch axis: a
        # truncated normal of variance 1 / C_in
        std = math.sqrt(1.0 / in_channels) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std)


class SubMConv3d(_SparseConvBase):
    def forward(self, x: SparseTensor) -> SparseTensor:
        return submanifold_conv3d(x, self.weight, self.bias, self.kernel_size)


class SparseConv3d(_SparseConvBase):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2,
                 use_bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, use_bias)
        self.stride = stride

    def forward(self, x: SparseTensor) -> SparseTensor:
        return sparse_conv3d(x, self.weight, self.bias, self.kernel_size,
                             self.stride)


class _SparseBN(BatchNorm):
    def forward(self, x: SparseTensor) -> SparseTensor:
        f = super().forward(x.features)
        return x._replace(features=f * x.valid[:, None])


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with BN/ReLU and a residual connection
    (reference SparseBasicBlock, sparse_block.py). ``down``, a bias-free
    Linear, exists only when the widths differ. Train or eval mode is the
    module's (``block.train()`` / ``block.eval()``)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv1 = SubMConv3d(in_channels, channels)
        self.bn1 = _SparseBN(channels)
        self.conv2 = SubMConv3d(channels, channels)
        self.bn2 = _SparseBN(channels)
        self.down = (nn.Linear(in_channels, channels, bias=False)
                     if in_channels != channels else None)

    def forward(self, x: SparseTensor) -> SparseTensor:
        identity = x.features
        out = self.bn1(self.conv1(x))
        out = out._replace(features=torch.relu(out.features))
        out = self.bn2(self.conv2(out))
        if self.down is not None:
            identity = self.down(identity)
        f = torch.relu(out.features + identity) * x.valid[:, None]
        return out._replace(features=f)
