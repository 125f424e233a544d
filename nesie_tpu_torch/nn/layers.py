"""Shared layers, channels-last ``(..., C)``.

Counterpart of ``nesie_tpu/nn/layers.py``. A 1x1 convolution of the
reference is an ``nn.Linear`` over the last axis here. Submodule names
follow the reference's state_dict (mmcv ConvModule: ``<name>.conv`` and
``<name>.bn``), so a reference checkpoint loads by name.

BatchNorm has flax's semantics (``nn.BatchNorm``, momentum 0.9, eps
1e-5). In eval mode it normalises with the running statistics. In train
mode it normalises with the batch statistics of every leading position,
taking flax's fast variance ``max(E[x^2] - E[x]^2, 0)`` (biased), and
updates the running statistics with that same biased variance as
``0.9 * old + 0.1 * batch``; ``torch.nn.BatchNorm1d`` would update with the
unbiased variance. ``frozen_bn_stats`` gives the teacher's mode: batch
statistics, running statistics left as they are. Under a launched process
group (``parallel``) the batch statistics cover every rank's rows, as the
JAX package's single-program mesh takes them over the global batch; the
running update is then the same on every rank. ``nn.SyncBatchNorm`` is no
substitute: it takes Welford's variance and updates with the unbiased one.

``dtype=torch.bfloat16`` (the JAX package's ``PointMLP(dtype=)``, the
backbone's ``compute_dtype``): parameters stay float32 and each Linear is
computed in bf16 on bf16 copies of its input and weights; BN takes its
statistics and normalises in float32, as flax does, and hands bf16 on to
the ReLU; the stack returns float32. Explicit casts, not
``torch.autocast``, whose rules differ from flax's.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nesie_tpu_torch import parallel

BN_MOMENTUM = 0.9  # flax: new = momentum * old + (1 - momentum) * batch
BN_EPS = 1e-5
GN_EPS = 1e-5  # torch's; flax's default 1e-6 would differ by ~2e-3

_CONSTANTS: dict = {}  # (key, device) -> tensor, see device_constant


def device_constant(key, device: torch.device, make) -> torch.Tensor:
    """``make()``, a CPU tensor, on ``device``: copied once per (``key``,
    device) and reused, since a copy from the host makes the host wait for
    the card and a CUDA graph cannot capture one. Kept out of every
    ``state_dict``, and made outside inference mode, so that a training
    step may save it for backward after a request made it. Read it only."""
    device = torch.device(device)
    const = _CONSTANTS.get((key, device))
    if const is None:
        with torch.inference_mode(False):
            const = _CONSTANTS[(key, device)] = make().to(device)
    return const


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1-eps] (reference
    mmdet3d/models/utils/clip_sigmoid.py:1-16): keeps the focal-loss
    ``log`` terms of heatmap heads finite at saturation."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channels-last tensor."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalises in at least float32 (statistics too) and returns
        ``x``'s dtype."""
        flat = x.reshape(-1, x.shape[-1])
        if not self.training:
            # torch's batch norm takes a bf16 input beside float32
            # statistics and affine, normalises in float32 and returns
            # bf16: flax's semantics, without a float32 copy of the input
            return super().forward(flat).reshape(x.shape)
        flat = flat.to(torch.promote_types(flat.dtype, torch.float32))
        if parallel.active():
            mean, sq_mean = _global_moments(flat)
        else:
            mean, sq_mean = flat.mean(dim=0), (flat * flat).mean(dim=0)
        var = torch.clamp(sq_mean - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var)
                self.num_batches_tracked.add_(1)
        y = (flat - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).reshape(x.shape).to(x.dtype)


def _global_moments(flat: torch.Tensor):
    """E[x] and E[x^2] over every rank's rows: (sum x, sum x^2, rows) summed
    over the ranks in one collective, whose backward sums the gradients."""
    count = flat.new_full((1,), flat.shape[0])
    sums = parallel.global_sum(torch.cat(
        [flat.sum(dim=0), (flat * flat).sum(dim=0), count]))
    c = flat.shape[1]
    return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]


@contextlib.contextmanager
def frozen_bn_stats(model: nn.Module):
    """Within the block, every BatchNorm of ``model`` in train mode
    normalises with batch statistics and leaves its running statistics
    alone (the teacher forward of the semi step)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield model
    finally:
        for m, flag in zip(bns, before):
            m.update_stats = flag


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the last axis of a channels-last tensor, each row of
    the leading axis on its own (flax ``nn.GroupNorm``: the statistics of a
    group span its channels and every position of the row), eps 1e-5 as
    torch's. Normalises in at least float32 and returns ``x``'s dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(torch.promote_types(x.dtype, torch.float32))
        return super().forward(h.movedim(-1, 1)).movedim(1, -1).to(x.dtype)


NORMS = ("bn", "gn", "none")


class ConvModule(nn.Module):
    """Linear (the reference's 1x1 conv) -> norm -> ReLU; the Linear in
    ``dtype`` when it is set (returning ``dtype``). ``norm``: ``"bn"``
    (``.bn``), ``"gn"`` (``.gn``, ``gn_groups`` groups, as mmcv names it)
    or ``"none"``; ``act=False`` leaves out the ReLU."""

    def __init__(self, cin: int, cout: int, bias: bool = False,
                 dtype: torch.dtype | None = None, norm: str = "bn",
                 gn_groups: int = 32, act: bool = True):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm={norm!r} is not one of {NORMS}")
        self.conv = nn.Linear(cin, cout, bias=bias)
        if norm == "bn":
            self.bn = BatchNorm(cout)
        elif norm == "gn":
            self.gn = GroupNorm(gn_groups, cout)
        self.norm = norm
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            h = self.conv(x)
        else:
            bias = self.conv.bias
            h = F.linear(x.to(self.dtype), self.conv.weight.to(self.dtype),
                         None if bias is None else bias.to(self.dtype))
        if self.norm == "bn":
            h = self.bn(h)
        elif self.norm == "gn":
            h = self.gn(h)
        return torch.relu(h) if self.act else h


class PointMLP(nn.Sequential):
    """A stack of ConvModules (the JAX package's ``PointMLP``). ``name``
    formats each layer's name: ``"layer{}"`` for the backbone and head
    stacks, ``"{}"`` for the vote module's ``vote_conv``. ``norm`` and
    ``gn_groups`` as in ConvModule; ``final_activation=False`` makes the
    last layer a bare Linear. ``bias="auto"`` gives a layer a bias only
    where no norm follows it (mmcv's rule); True or False sets it for
    every layer. ``dtype``: the Linears' compute dtype; the stack returns
    float32."""

    def __init__(self, cin: int, channels: Sequence[int],
                 bias: bool | str = "auto", name: str = "layer{}",
                 dtype: torch.dtype | None = None, norm: str = "bn",
                 gn_groups: int = 32, final_activation: bool = True):
        layers = OrderedDict()
        for j, c in enumerate(channels):
            normed = final_activation or j < len(channels) - 1
            layer_norm = norm if normed else "none"
            use_bias = (layer_norm == "none") if bias == "auto" else bool(bias)
            layers[name.format(j)] = ConvModule(
                cin, c, bias=use_bias, dtype=dtype, norm=layer_norm,
                gn_groups=gn_groups, act=normed)
            cin = c
        super().__init__(layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x)
        return out if self.dtype is None else out.float()


class MLP(nn.Module):
    """Per-point feature MLP (reference mmdet3d/models/utils/mlp.py:1-50;
    the JAX package's ``MLP``): Linear (the reference's 1x1 Conv1d) + BN +
    ReLU a layer, with a bias on every Linear (the reference sets
    ``bias=True`` explicitly, unlike ConvModule's ``'auto'``), over
    channels-last (B, N, C) input. Its layers are the reference's
    ``mlp.layer{j}.conv`` / ``.bn``."""

    def __init__(self, in_channel: int = 18,
                 conv_channels: Sequence[int] = (256, 256)):
        super().__init__()
        self.mlp = PointMLP(in_channel, conv_channels, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


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
