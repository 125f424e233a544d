"""Furthest point sampling: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``nesie_tpu/ops/pallas_fps.py``. The kernel is
``csrc/fps.cu``. ``ops.pointops.furthest_point_sample`` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import torch

from . import _build


def fps_ref(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain D-FPS: (B, N, 3) float32 -> (B, M) int32.

    Start at index 0 with every distance at 1e10; each step takes
    ``min(dist, (dx*dx + dy*dy) + dz*dz)`` and the first index of the
    maximum (``torch.argmax`` returns the first maximal index).
    """
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, num_samples), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xyz.device)
    for i in range(1, num_samples):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        last = dist.argmax(dim=1, keepdim=True)
        out[:, i] = last[:, 0].to(torch.int32)
    return out


def fps_cuda(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Launch ``csrc/fps.cu``: one block of 1024 threads per batch row."""
    _build.check_cuda_input("xyz", xyz)
    B, N, _ = xyz.shape
    if not 1 <= num_samples <= N:
        raise ValueError(f"num_samples={num_samples} must be in [1, N={N}]")
    out = torch.empty((B, num_samples), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    dist = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    _build.launch("fps", "nesie_fps", xyz.data_ptr(), B, N, num_samples,
                  dist.data_ptr(), out.data_ptr())
    return out
