"""Shared layers, channels-last ``(..., C)``.

Counterpart of ``nesie_tpu/nn/layers.py``. A 1x1 convolution of the
reference is an ``nn.Linear`` over the last axis here. Submodule names
follow the reference's state_dict (mmcv ConvModule: ``<name>.conv`` and
``<name>.bn``), so a reference checkpoint loads by name.

BatchNorm runs on its running statistics only (eps 1e-5; flax momentum 0.9
is torch momentum 0.1). Train-mode BN, with flax's biased-variance
updates, is not ported yet, and a module in training mode raises.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channels-last tensor, eval only."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported; call .eval()")
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class ConvModule(nn.Module):
    """Linear (the reference's 1x1 conv) -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.conv = nn.Linear(cin, cout, bias=bias)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class PointMLP(nn.Sequential):
    """A stack of ConvModules (``PointMLP`` with ``final_activation=True``
    and BN in the JAX package). ``name`` formats each layer's name:
    ``"layer{}"`` for the backbone and head stacks, ``"{}"`` for the vote
    module's ``vote_conv``."""

    def __init__(self, cin: int, channels: Sequence[int], bias: bool = False,
                 name: str = "layer{}"):
        layers = OrderedDict()
        for j, c in enumerate(channels):
            layers[name.format(j)] = ConvModule(cin, c, bias=bias)
            cin = c
        super().__init__(layers)


class MiniPointNet(nn.Module):
    """PointNet over grouped grid points with a global-max skip (reference
    side_pooling_module.py:343): (B, K, N, C) -> (B, K, feature_dim)."""

    def __init__(self, cin: int, feature_dim: int = 128, hide_dim: int = 256):
        super().__init__()
        self.first_conv = nn.Sequential(
            nn.Linear(cin, hide_dim, bias=False), BatchNorm(hide_dim),
            nn.ReLU(), nn.Linear(hide_dim, hide_dim // 2))
        self.second_conv = nn.Sequential(
            nn.Linear(hide_dim, hide_dim, bias=False), BatchNorm(hide_dim),
            nn.ReLU(), nn.Linear(hide_dim, feature_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.first_conv(x)
        g = h.amax(dim=-2, keepdim=True).expand_as(h)
        h = self.second_conv(torch.cat([g, h], dim=-1))
        return h.amax(dim=-2)
