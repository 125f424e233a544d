"""Detector assembly: PointNet++ backbone + Nesie head. Counterpart of
``nesie_tpu/nn/detector.py`` (Nesie head only)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .nesie_head import NesieHead
from .pointnet2 import PointNet2SASSG


class VoteNetNesie(nn.Module):
    """Backbone + head forward, returning the head's results dict. The
    defaults are the flagship ScanNet model."""

    def __init__(
        self,
        num_classes: int = 18,
        reg_max: int = 32,
        num_proposal: int = 256,
        in_channels: int = 4,
        dataset_name: str = "ScanNet",
        sizes: Sequence[float] = (3.0, 3.0, 2.5),
        num_points: Sequence[int] = (2048, 1024, 512, 256),
        radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
        num_samples: Sequence[int] = (64, 32, 16, 16),
        sa_channels: Sequence[Sequence[int]] = (
            (64, 64, 128), (128, 128, 256), (128, 128, 256), (128, 128, 256),
        ),
        fp_channels: Sequence[Sequence[int]] = ((256, 256), (256, 256)),
        jitter_scale: float = 0.3,
        jitter_size_bias: float = 0.0,
    ):
        super().__init__()
        seed_feat_dim = fp_channels[-1][-1]
        self.backbone = PointNet2SASSG(in_channels, num_points, radii,
                                       num_samples, sa_channels, fp_channels)
        self.bbox_head = NesieHead(
            num_classes=num_classes, reg_max=reg_max,
            num_proposal=num_proposal, seed_feat_dim=seed_feat_dim,
            sizes=sizes, vote_conv_channels=(seed_feat_dim, seed_feat_dim),
            dataset_name=dataset_name, jitter_scale=jitter_scale,
            jitter_size_bias=jitter_size_bias)

    def forward(self, points: torch.Tensor, sample_mod: str = "seed",
                with_jitter: bool = False, noise=None,
                generator: torch.Generator | None = None) -> dict:
        """points: (B, N, in_channels). ``noise`` / ``generator``: the
        jitter noise, see ``NesieHead.forward``."""
        return self.bbox_head(self.backbone(points), sample_mod, with_jitter,
                              noise=noise, generator=generator)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: every Linear as torch's default (uniform in
    +-1/sqrt(fan_in)), BN at weight 1, bias 0, mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.copy_(_uniform(m.weight.shape, bound, generator))
            if m.bias is not None:
                m.bias.copy_(_uniform(m.bias.shape, bound, generator))
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


@torch.no_grad()
def init_weights_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights from flax's default initializers, the distributions
    the JAX package's ``init_state`` draws from: every Linear weight
    ``lecun_normal`` (a standard normal truncated at +-2, scaled to
    variance 1/fan_in), biases 0; BN at weight 1, bias 0, mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            # 0.8796...: the standard deviation of a standard normal
            # truncated at +-2 (jax.nn.initializers.variance_scaling)
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


@torch.no_grad()
def randomize_bn_(model: nn.Module, generator: torch.Generator) -> None:
    """BN affine and running stats drawn away from 1/0, so that a
    comparison exercises every BN tensor."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            n = m.num_features
            m.weight.copy_(_uniform((n,), 0.5, generator) + 1.0)
            m.bias.copy_(_uniform((n,), 0.5, generator))
            m.running_mean.copy_(_uniform((n,), 0.5, generator))
            m.running_var.copy_(_uniform((n,), 0.5, generator) + 1.0)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound
