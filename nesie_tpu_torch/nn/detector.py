"""Detector assembly: PointNet++ backbone + the Nesie or the SAQE head.
Counterpart of ``nesie_tpu/nn/detector.py``."""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from nesie_tpu_torch.ops.paconv import PAConv
from nesie_tpu_torch.utils import span
from .nesie_head import NesieHead
from .pointnet2 import PointNet2SASSG
from .saqe_head import SAQEHead


class VoteNetNesie(nn.Module):
    """Backbone + head forward, returning the head's results dict. The
    defaults are the flagship ScanNet model. ``head="nesie"`` is the
    ICCV'23 NesieHead, ``head="saqe"`` the journal SAQEHead (the
    reference's VoteNetSAQE; ``sizes`` unused). ``compute_dtype=
    "bfloat16"`` runs the backbone's MLPs in bf16 (float32 parameters)."""

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
        head: str = "nesie",
        compute_dtype: str | None = None,
    ):
        super().__init__()
        if compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype={compute_dtype!r}: None or "
                             "'bfloat16'")
        seed_feat_dim = fp_channels[-1][-1]
        self.backbone = PointNet2SASSG(
            in_channels, num_points, radii, num_samples, sa_channels,
            fp_channels, compute_dtype=(torch.bfloat16 if compute_dtype
                                        else None))
        common = dict(
            num_classes=num_classes, reg_max=reg_max,
            num_proposal=num_proposal, seed_feat_dim=seed_feat_dim,
            vote_conv_channels=(seed_feat_dim, seed_feat_dim),
            dataset_name=dataset_name, jitter_scale=jitter_scale,
            jitter_size_bias=jitter_size_bias)
        if head == "saqe":
            self.bbox_head = SAQEHead(**common)
        else:
            self.bbox_head = NesieHead(sizes=sizes, **common)

    def forward(self, points: torch.Tensor, sample_mod: str = "seed",
                with_jitter: bool = False, noise=None,
                generator: torch.Generator | None = None,
                sample_indices: torch.Tensor | None = None,
                rows=None) -> dict:
        """points: (B, N, in_channels). ``noise`` / ``generator`` /
        ``sample_indices`` / ``rows``: the head's draws, see
        ``NesieHead.forward``."""
        with span("nn.forward", device=True, b=points.shape[0],
                  n=points.shape[1]):
            return self.bbox_head(self.backbone(points), sample_mod,
                                  with_jitter, noise=noise,
                                  generator=generator,
                                  sample_indices=sample_indices, rows=rows)

    def quality_scores(self, results: dict, center, size, heading):
        """Re-run only the quality module on explicit boxes (reference
        forward_onlyiou_faster, nesie_head.py:790): center, size (B, P, 3),
        heading (B, P) -> the sigmoid IoU score at each proposal's
        semantic argmax (B, P). The quality module must be in eval mode
        (running-statistics BN), as the caller's model is at test time."""
        out = self.bbox_head.grid_conv(
            center, size, heading, results["seed_points"],
            results["seed_features"], results["bbox_probs"])
        iou = torch.sigmoid(out[1])  # (side, iou, ...) for both heads
        sem_argmax = results["sem_scores"].argmax(-1, keepdim=True)
        return iou.gather(-1, sem_argmax)[..., 0]


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: every Linear and PAConv weight bank as torch's
    default Linear (uniform in +-1/sqrt(fan_in)), BN at weight 1, bias 0,
    mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.copy_(_uniform(m.weight.shape, bound, generator))
            if m.bias is not None:
                m.bias.copy_(_uniform(m.bias.shape, bound, generator))
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, PAConv):
            bound = 1.0 / math.sqrt(m.weight_bank.shape[0])
            m.weight_bank.copy_(_uniform(m.weight_bank.shape, bound,
                                         generator))


@torch.no_grad()
def init_weights_flax_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights from flax's default initializers, the distributions
    the JAX package's ``init_state`` draws from: every Linear weight and
    PAConv weight bank ``lecun_normal`` (a standard normal truncated at
    +-2, scaled to variance 1/fan_in), biases 0; BN at weight 1, bias 0,
    mean 0, var 1."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, PAConv):  # (in, out) layout: fan-in is rows
            _lecun_normal_(m.weight_bank, m.weight_bank.shape[0], generator)


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


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    # 0.8796...: the standard deviation of a standard normal truncated at
    # +-2 (jax.nn.initializers.variance_scaling)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound
