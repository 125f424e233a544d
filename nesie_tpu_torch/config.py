"""Test-time settings of the port.

A copy of the defaults that the eval path reads from the JAX package's
``nesie_tpu/config.py`` (``TestConfig`` and ``DataConfig.num_points``).
That module imports the training code, which imports jax, so the port does
not import it.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InferenceConfig:
    num_points: int = 40000      # points sampled per cloud
    sample_mod: str = "seed"
    nms_thr: float = 0.25
    score_thr: float = 0.05
    use_iou_for_nms: bool = True
    seed: int = 0                # the point-sampling RNG seed
