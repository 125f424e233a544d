"""Deep Hough voting module. Counterpart of ``nesie_tpu/nn/vote.py``."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import PointMLP


class VoteModule(nn.Module):
    """One vote per seed: vote = seed_xyz + offset; vote feature = seed
    feature + residual, L2-normalised over channels (eps 1e-12)."""

    def __init__(self, in_channels: int = 256,
                 conv_channels: Sequence[int] = (256, 256)):
        super().__init__()
        self.vote_conv = PointMLP(in_channels, conv_channels, bias=True,
                                  name="{}")
        self.conv_out = nn.Linear(conv_channels[-1], 3 + in_channels)

    def forward(self, seed_xyz: torch.Tensor, seed_feats: torch.Tensor):
        """seed_xyz (B, N, 3), seed_feats (B, N, C) -> vote_xyz (B, N, 3),
        vote_feats (B, N, C), offset (B, N, 3)."""
        votes = self.conv_out(self.vote_conv(seed_feats))
        offset = votes[..., :3]
        vote_xyz = seed_xyz + offset
        vote_feats = seed_feats + votes[..., 3:]
        norm = torch.linalg.vector_norm(vote_feats, dim=-1, keepdim=True)
        vote_feats = vote_feats / torch.clamp(norm, min=1e-12)
        return vote_xyz, vote_feats, offset
