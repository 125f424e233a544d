"""Prediction head layers: the integral side decode (and its ``Integral``
module), SAQE's angle decode (and its ``AngleIntegral`` module), the base
and the reliable conv heads.
Counterpart of ``nesie_tpu/nn/heads.py``."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import PointMLP


def integral_expectation(logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Softmax expectation over {0, 1/n, ..., 1}: (..., n+1) -> (...)."""
    project = torch.linspace(0.0, 1.0, reg_max + 1, dtype=logits.dtype,
                             device=logits.device)
    return (torch.softmax(logits, dim=-1) * project).sum(dim=-1)


class Integral(nn.Module):
    """``integral_expectation`` as a module without parameters (the
    reference's Integral, nesie_head.py:19)."""

    def __init__(self, reg_max: int = 32):
        super().__init__()
        self.reg_max = reg_max

    def forward(self, logits: torch.Tensor) -> torch.Tensor:
        return integral_expectation(logits, self.reg_max)


def angle_integral_expectation(logits: torch.Tensor) -> torch.Tensor:
    """SAQE's angle decode (reference AngleIntegral, saqe_head.py:54-87,
    and side2box:206-207): the softmax expectation over {0, 1/n, ..., 1}
    (n = channels - 1) times 2 pi, wrapped to (-pi, pi]: (..., n+1) ->
    (...)."""
    ang = integral_expectation(logits, logits.shape[-1] - 1) * 2 * torch.pi
    return torch.where(ang > torch.pi, ang - 2 * torch.pi, ang)


class AngleIntegral(nn.Module):
    """``angle_integral_expectation`` as a module without parameters (the
    reference's AngleIntegral, saqe_head.py:54-87)."""

    def forward(self, logits: torch.Tensor) -> torch.Tensor:
        return angle_integral_expectation(logits)


def _branch(cin: int, channels: Sequence[int], bias: bool, **norm):
    """A branch's conv stack (``PointMLP`` with ``bias``), or None for an
    empty one: the branch is then its output Linear alone."""
    return PointMLP(cin, channels, bias=bias, **norm) if channels else None


def _through(stack, x):
    return x if stack is None else stack(x)


class BaseConvBboxHead(nn.Module):
    """Shared convs, then optional class and regression conv stacks, then
    one Linear each (reference base_conv_bbox_head.py; JAX
    ``BaseConvBboxHead``): feats (B, P, C) -> cls (B, P, num_cls_out),
    reg (B, P, num_reg_out). An empty stack is left out."""

    def __init__(self, in_channels: int,
                 shared_conv_channels: Sequence[int] = (128, 128),
                 cls_conv_channels: Sequence[int] = (),
                 reg_conv_channels: Sequence[int] = (),
                 num_cls_out: int = 20, num_reg_out: int = 59,
                 bias: bool = True):
        super().__init__()
        self.shared_convs = _branch(in_channels, shared_conv_channels, bias)
        c = shared_conv_channels[-1] if shared_conv_channels else in_channels
        self.cls_convs = _branch(c, cls_conv_channels, bias)
        self.conv_cls = nn.Linear(
            cls_conv_channels[-1] if cls_conv_channels else c, num_cls_out)
        self.reg_convs = _branch(c, reg_conv_channels, bias)
        self.conv_reg = nn.Linear(
            reg_conv_channels[-1] if reg_conv_channels else c, num_reg_out)

    def forward(self, feats: torch.Tensor):
        x = _through(self.shared_convs, feats)
        return (self.conv_cls(_through(self.cls_convs, x)),
                self.conv_reg(_through(self.reg_convs, x)))


class ReliableConvBboxHead(nn.Module):
    """Shared conv trunk, then per branch an optional conv stack and one
    Linear, for the class, side-distribution and heading outputs. The
    heading stack normalises with GroupNorm in ``reg_max`` groups
    (reference reliable_conv_bbox_module.py:124). Every shipped config
    leaves the three stacks empty: each branch is then its Linear alone,
    and the state_dict has no stack."""

    def __init__(self, in_channels: int = 128,
                 shared_conv_channels: Sequence[int] = (128, 128),
                 num_cls_out: int = 20, num_bbox_out: int = 198,
                 num_heading_out: int = 2,
                 cls_conv_channels: Sequence[int] = (),
                 bbox_conv_channels: Sequence[int] = (),
                 heading_conv_channels: Sequence[int] = (),
                 reg_max: int = 32, bias: bool = True):
        super().__init__()
        self.shared_convs = PointMLP(in_channels, shared_conv_channels,
                                     bias=bias)
        c = shared_conv_channels[-1]
        self.cls_convs = _branch(c, cls_conv_channels, bias)
        self.bbox_convs = _branch(c, bbox_conv_channels, bias)
        self.heading_convs = _branch(c, heading_conv_channels, bias,
                                     norm="gn", gn_groups=reg_max)

        def width(chans):
            return chans[-1] if chans else c

        self.conv_cls = nn.Linear(width(cls_conv_channels), num_cls_out)
        self.conv_bbox = nn.Linear(width(bbox_conv_channels), num_bbox_out)
        self.conv_heading = nn.Linear(width(heading_conv_channels),
                                      num_heading_out)

    def forward(self, feats: torch.Tensor):
        """feats (B, P, C) -> cls (B, P, num_cls_out),
        reg (B, P, num_bbox_out + num_heading_out)."""
        x = self.shared_convs(feats)
        return self.conv_cls(_through(self.cls_convs, x)), torch.cat(
            [self.conv_bbox(_through(self.bbox_convs, x)),
             self.conv_heading(_through(self.heading_convs, x))], dim=-1)
