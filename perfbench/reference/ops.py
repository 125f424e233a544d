"""The point searches of the benchmark's reference: plain PyTorch on
any device, copied from the port's plain versions (``fps_ref``,
``ball_query_ref``, ``three_nn_ref``) and its ``pointops`` helpers, with no
kernel and no dispatch. Channels-last ``(B, N, C)``."""
from __future__ import annotations

import torch

_CHUNK_ELEMENTS = 1 << 24


def fps_ref(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain D-FPS: (B, N, 3) float32 -> (B, M) int32.

    Start at index 0 with every distance at 1e10; each step takes
    ``min(dist, (dx*dx + dy*dy) + dz*dz)`` and the first index of the
    maximum (``torch.argmax`` returns the first maximal index).
    """
    return fps_steps(xyz, num_samples,
                     lambda dist: dist.argmax(dim=1, keepdim=True))


def fps_steps(xyz: torch.Tensor, num_samples: int, select) -> torch.Tensor:
    """``fps_ref``'s loop with the next index found by ``select``: the
    (B, N) distances -> (B, 1) int64 indices."""
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
        last = select(dist)
        out[:, i] = last[:, 0].to(torch.int32)
    return out


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


def three_nn_ref(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Plain three-NN indices: (B, M, 3), (B, N, 3) -> (B, M, 3) int32.

    Exact ``(a-b)^2`` distances, three argmin passes (``torch.argmin``
    returns the first minimal index), so ties go to the lower index.
    """
    query = query.float()
    source = source.float()
    B, N, _ = source.shape
    M = query.shape[1]
    chunk = max(1, min(M, _CHUNK_ELEMENTS // max(1, B * N)))
    sx, sy, sz = (t[:, None, :] for t in source.unbind(-1))
    out = []
    for q in query.split(chunk, dim=1):
        dx = q[..., 0:1] - sx
        dy = q[..., 1:2] - sy
        dz = q[..., 2:3] - sz
        d2 = dx * dx + dy * dy + dz * dz  # (B, chunk, N)
        picks = []
        for _ in range(3):
            i = d2.argmin(dim=-1, keepdim=True)
            picks.append(i)
            d2 = d2.scatter(-1, i, float("inf"))
        out.append(torch.cat(picks, dim=-1).to(torch.int32))
    return torch.cat(out, dim=1)


def _coords(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def furthest_point_sample(xyz: torch.Tensor, num_samples: int
                          ) -> torch.Tensor:
    """D-FPS from index 0: (B, N, 3) -> (B, M) int32."""
    return fps_ref(_coords(xyz), num_samples)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               num_samples: int, min_radius: float = 0.0) -> torch.Tensor:
    """First K in-radius sources per center, duplicate-filled:
    (B, N, 3), (B, M, 3) -> (B, M, K) int32."""
    return ball_query_ref(_coords(xyz), _coords(centers), radius,
                          num_samples, min_radius)


def gather_points(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (B, N, C), idx (B, M) -> (B, M, C)."""
    batch = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[batch, idx.long()]


def group_points(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    batch = torch.arange(data.shape[0], device=data.device)[:, None, None]
    return data[batch, idx.long()]


def three_nn(query: torch.Tensor, source: torch.Tensor):
    """3 nearest sources per query, ascending, lower index on ties; the
    distances recomputed from the gathered sources (differentiable).
    Returns dist (B, M, 3) float32, idx (B, M, 3) int32."""
    idx = three_nn_ref(_coords(query), _coords(source))
    d = query[:, :, None, :] - group_points(source, idx)  # (B, M, 3, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 gathered rows: feats (B, N, C), idx (B, M, 3),
    weight (B, M, 3) -> (B, M, C)."""
    return (group_points(feats, idx) * weight[..., None]).sum(dim=2)
