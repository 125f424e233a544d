"""Point-cloud neighbourhood ops, channels-last ``(B, N, C)``.

Counterpart of ``nesie_tpu/ops/pointops.py``. The three searches dispatch
on the device of their input: a CPU tensor takes the plain PyTorch version,
a CUDA tensor the hand-written kernel (which raises if it cannot build or
launch). There is no switch and no fallback between the two.

FPS on a CUDA tensor runs ``fps_onchip.cu``, each row held on chip on
one CTA or across a thread-block cluster, with a plan made for the whole
batch: B <= 16 rows (a ``Detector`` request, the training steps) take the
mailbox exchange (or one CTA for a short row), and so do more rows (the
B=32 eval forward). The batch names its launch count
(``ops.fps.fps_launch_name``).
"""
from __future__ import annotations

import torch

from .ball_query import ball_query_cuda, ball_query_ref
from .fps import fps_onchip_cuda, fps_ref
from .three_nn import three_nn_cuda, three_nn_ref


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no point-op implementation for device {t.device}")


def _coords(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """D-FPS from index 0: (B, N, 3) -> (B, M) int32."""
    xyz = _coords(xyz)
    if _on_cpu(xyz):
        return fps_ref(xyz, num_samples)
    return fps_onchip_cuda(xyz, num_samples)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               num_samples: int, min_radius: float = 0.0) -> torch.Tensor:
    """First K in-radius sources per center, duplicate-filled:
    (B, N, 3), (B, M, 3) -> (B, M, K) int32."""
    xyz, centers = _coords(xyz), _coords(centers)
    if _on_cpu(xyz):
        return ball_query_ref(xyz, centers, radius, num_samples, min_radius)
    return ball_query_cuda(xyz, centers, radius, num_samples, min_radius)


def gather_points(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (B, N, C), idx (B, M) -> (B, M, C)."""
    batch = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[batch, idx.long()]


def group_points(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    batch = torch.arange(data.shape[0], device=data.device)[:, None, None]
    return data[batch, idx.long()]


def three_nn(query: torch.Tensor, source: torch.Tensor):
    """3 nearest sources per query, ascending, lower index on ties.

    The indices come from the kernel (or its plain version); the euclidean
    distances are recomputed here from the gathered sources with the same
    ``(a-b)^2`` arithmetic, so they stay differentiable.

    Returns dist (B, M, 3) float32, idx (B, M, 3) int32.
    """
    q, s = _coords(query), _coords(source)
    idx = three_nn_ref(q, s) if _on_cpu(q) else three_nn_cuda(q, s)
    d = query[:, :, None, :] - group_points(source, idx)  # (B, M, 3, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 gathered rows: feats (B, N, C), idx (B, M, 3),
    weight (B, M, 3) -> (B, M, C)."""
    return (group_points(feats, idx) * weight[..., None]).sum(dim=2)
