"""Radius ball query: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``nesie_tpu/ops/pallas_ball_query.py``. The kernel is
``csrc/ball_query.cu``. ``ops.pointops.ball_query`` picks between the two
by the tensor's device.
"""
from __future__ import annotations

import torch

from . import _build

# elements of one chunk's (B, chunk, N) distance tensor in the plain version
_CHUNK_ELEMENTS = 1 << 24


def ball_query_ref(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                   num_samples: int, min_radius: float = 0.0) -> torch.Tensor:
    """Plain ball query: (B, N, 3), (B, M, 3) -> (B, M, K) int32.

    For each center, the first K source indices in index order with
    ``d2 <= 0 or min_r2 <= d2 < max_r2`` (exact ``(a-b)^2`` form); slots
    past the hit count repeat the first hit; no hit gives all zeros. The
    centers are taken in chunks so that SA1 at B=32 never holds a
    (B, 2048, 40000) tensor.
    """
    xyz = xyz.float()
    centers = centers.float()
    B, N, _ = xyz.shape
    M = centers.shape[1]
    K = num_samples
    # the squared radii in float32, the values the kernel receives
    max_r2 = torch.tensor(radius * radius, dtype=torch.float32)
    min_r2 = torch.tensor(min_radius * min_radius, dtype=torch.float32)
    chunk = max(1, min(M, _CHUNK_ELEMENTS // max(1, B * N)))
    src = torch.arange(N, dtype=torch.int32, device=xyz.device)
    slot = torch.arange(K, dtype=torch.int64, device=xyz.device)
    sx, sy, sz = (t[:, None, :] for t in xyz.unbind(-1))
    out = []
    for c in centers.split(chunk, dim=1):
        dx = sx - c[..., 0:1]
        dy = sy - c[..., 1:2]
        dz = sz - c[..., 2:3]
        d2 = dx * dx + dy * dy + dz * dz  # (B, chunk, N)
        ok = (d2 <= 0.0) | ((d2 >= min_r2) & (d2 < max_r2))
        rank = ok.to(torch.int32).cumsum(-1, dtype=torch.int32)  # 1-based
        total = rank[..., -1:].to(torch.int64)
        # hit with rank r goes to slot r-1; everything else to a dump slot K
        target = torch.where(ok & (rank <= K), rank - 1, K).to(torch.int64)
        idx = torch.zeros((B, c.shape[1], K + 1), dtype=torch.int32,
                          device=xyz.device)
        idx.scatter_(-1, target, src.expand_as(target))
        idx = idx[..., :K]
        idx = torch.where(slot < total, idx, idx[..., :1])  # duplicate-fill
        idx = torch.where(total > 0, idx, 0)                 # no neighbour
        out.append(idx)
    return torch.cat(out, dim=1)


def ball_query_cuda(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                    num_samples: int, min_radius: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/ball_query.cu``: a CTA of up to 256 centers (one
    thread each) of one row scans the row's points in shared-memory tiles;
    a query of too few centers to fill the card takes one warp per center.
    The C entry point picks the path and sizes the CTA itself."""
    _build.check_cuda_input("xyz", xyz)
    _build.check_cuda_input("centers", centers)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if centers.shape[0] != B or centers.device != xyz.device:
        raise ValueError("xyz and centers must share batch size and device")
    if num_samples < 1:
        raise ValueError(f"num_samples={num_samples} must be >= 1")
    out = torch.empty((B, M, num_samples), dtype=torch.int32,
                      device=xyz.device)
    if B * M == 0:
        return out
    _build.launch("ball_query", "nesie_ball_query", xyz.data_ptr(),
                  centers.data_ptr(), B, N, M, num_samples,
                  min_radius * min_radius, radius * radius, out.data_ptr(),
                  device=xyz.device)
    return out
