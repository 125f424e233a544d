"""Prediction head layers: the integral side decode, SAQE's angle decode and
the reliable conv head. Counterpart of ``nesie_tpu/nn/heads.py``."""
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


def angle_integral_expectation(logits: torch.Tensor) -> torch.Tensor:
    """SAQE's angle decode (reference AngleIntegral, saqe_head.py:54-87,
    and side2box:206-207): the softmax expectation over {0, 1/n, ..., 1}
    (n = channels - 1) times 2 pi, wrapped to (-pi, pi]: (..., n+1) ->
    (...)."""
    ang = integral_expectation(logits, logits.shape[-1] - 1) * 2 * torch.pi
    return torch.where(ang > torch.pi, ang - 2 * torch.pi, ang)


class ReliableConvBboxHead(nn.Module):
    """Shared conv trunk, then one linear layer each for the class,
    side-distribution and heading outputs. The optional per-branch conv
    stacks of the JAX module are empty in every shipped config and are not
    ported."""

    def __init__(self, in_channels: int = 128,
                 shared_conv_channels: Sequence[int] = (128, 128),
                 num_cls_out: int = 20, num_bbox_out: int = 198,
                 num_heading_out: int = 2):
        super().__init__()
        self.shared_convs = PointMLP(in_channels, shared_conv_channels,
                                     bias=True)
        c = shared_conv_channels[-1]
        self.conv_cls = nn.Linear(c, num_cls_out)
        self.conv_bbox = nn.Linear(c, num_bbox_out)
        self.conv_heading = nn.Linear(c, num_heading_out)

    def forward(self, feats: torch.Tensor):
        """feats (B, P, C) -> cls (B, P, num_cls_out),
        reg (B, P, num_bbox_out + num_heading_out)."""
        x = self.shared_convs(feats)
        return self.conv_cls(x), torch.cat(
            [self.conv_bbox(x), self.conv_heading(x)], dim=-1)
