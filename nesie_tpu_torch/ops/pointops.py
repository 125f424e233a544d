"""Point-cloud neighbourhood ops, channels-last ``(B, N, C)``.

Counterpart of ``nesie_tpu/ops/pointops.py``. The three searches dispatch
on the device of their input: a CPU tensor takes the plain PyTorch version,
a CUDA tensor the hand-written kernel (which raises if it cannot build or
launch). There is no switch and no fallback between the two.

``points_sampler``'s D-FPS mode is that FPS; its F-FPS mode, FPS with a
``valid_mask`` and ``knn`` are plain PyTorch on either device, as their
counterparts in the JAX package are XLA and reach no Pallas kernel.

FPS on a CUDA tensor runs ``fps_onchip.cu``, each row held on chip on
one CTA or across a thread-block cluster, with a plan made for the whole
batch: B <= 16 rows (a ``Detector`` request, the training steps) take the
mailbox exchange (or one CTA for a short row), and so do more rows (the
B=32 eval forward). The batch names its launch count
(``ops.fps.fps_launch_name``).

While a ``graphs.FpsSplitGraph`` captures, FPS on a CUDA tensor ends
the graph being captured, runs eagerly, and opens the next one.

Each call of a kernel is a host span (``utils.span``): ``pointops.fps``,
``pointops.ball_query`` and ``pointops.three_nn``, with the shapes
``b``, ``n``, ``m`` (and ``k``) as attributes.
"""
from __future__ import annotations

import torch

from nesie_tpu_torch.utils import span

from .ball_query import ball_query_cuda, ball_query_ref
from .fps import fps_onchip_cuda, fps_ref
from .three_nn import three_nn_cuda, three_nn_ref


# the graphs.FpsSplitGraph capturing, if any: FPS on a CUDA tensor then
# ends its segment and runs between two graphs
_CAPTURE = None


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no point-op implementation for device {t.device}")


def _coords(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distance in the JAX package's matmul
    form ``|a|^2 + |b|^2 - 2ab`` (float32): (..., M, 3), (..., N, 3) ->
    (..., M, N). It may be slightly negative for coincident points. The
    port's searches rank by the exact ``(a-b)^2`` form instead."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(dim=-1)[..., :, None]
    b2 = (b * b).sum(dim=-1)[..., None, :]
    return a2 + b2 - 2.0 * torch.einsum("...mc,...nc->...mn", a, b)


def _sum_channels(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, ``((x0 + x1) + x2) + ...``,
    the order of the JAX package's ``jnp.sum(..., -1)`` on its XLA paths;
    one elementwise op a channel, the same rounding on every device."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc


def _fps_loop(pts: torch.Tensor, num_samples: int, dists: torch.Tensor):
    """FPS from index 0 as the JAX package's XLA loop runs it, in plain
    PyTorch on the tensor's device: each step adds the squared distance
    to the last pick (summed over the channels of ``pts``), keeps the
    running minimum in ``dists`` and takes its first maximum."""
    b = pts.shape[0]
    rows = torch.arange(b, device=pts.device)
    idxs = torch.zeros((b, num_samples), dtype=torch.int32, device=pts.device)
    last = torch.zeros(b, dtype=torch.long, device=pts.device)
    for i in range(1, num_samples):
        d = pts - pts[rows, last][:, None, :]
        dists = torch.minimum(dists, _sum_channels(d * d))
        last = torch.argmax(dists, dim=-1)
        idxs[:, i] = last.to(torch.int32)
    return idxs


def furthest_point_sample(xyz: torch.Tensor, num_samples: int,
                          valid_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """D-FPS from index 0: (B, N, 3) -> (B, M) int32.

    ``valid_mask`` (B, N) bool: masked points are never picked (padded
    clouds). That case runs the plain loop on either device, as the JAX
    package runs it on XLA and never in its Pallas kernel."""
    xyz = _coords(xyz)
    if valid_mask is not None:
        init = torch.where(valid_mask.to(xyz.device), 1e10, -torch.inf)
        return _fps_loop(xyz, num_samples, init.float())
    if _on_cpu(xyz):
        return fps_ref(xyz, num_samples)
    if _CAPTURE is not None:
        return _CAPTURE.fps(xyz, num_samples)
    return onchip_fps(xyz, num_samples)


def onchip_fps(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """FPS of contiguous float32 CUDA coordinates: the on-chip kernel
    (``fps_onchip_cuda``, looked up at each call) in its ``pointops.fps``
    span."""
    with span("pointops.fps", b=xyz.shape[0], n=xyz.shape[1],
              m=num_samples):
        return fps_onchip_cuda(xyz, num_samples)


def furthest_point_sample_with_features(points: torch.Tensor,
                                        num_samples: int) -> torch.Tensor:
    """F-FPS: FPS from index 0 in an arbitrary feature space (the
    reference Points_Sampler's 'F-FPS' mode): (B, N, D) -> (B, M) int32.
    Plain PyTorch on either device, as the JAX package's is XLA."""
    pts = points.detach().float().contiguous()
    dists = torch.full(pts.shape[:2], 1e10, dtype=torch.float32,
                       device=pts.device)
    return _fps_loop(pts, num_samples, dists)


def points_sampler(xyz: torch.Tensor, features: torch.Tensor | None,
                   num_point: int, mode: str = "D-FPS") -> torch.Tensor:
    """The reference Points_Sampler's dispatch (points_sampler.py:34):
    'D-FPS' (euclidean: the FPS kernel on the card), 'F-FPS' (over
    xyz and ``features`` concatenated) or 'FS' (both, F-FPS first:
    (B, 2 * num_point))."""
    if mode == "D-FPS":
        return furthest_point_sample(xyz, num_point)
    combined = xyz if features is None else torch.cat([xyz, features], -1)
    if mode == "F-FPS":
        return furthest_point_sample_with_features(combined, num_point)
    if mode == "FS":
        d = furthest_point_sample(xyz, num_point)
        f = furthest_point_sample_with_features(combined, num_point)
        return torch.cat([f, d], dim=1)
    raise ValueError(mode)


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               num_samples: int, min_radius: float = 0.0) -> torch.Tensor:
    """First K in-radius sources per center, duplicate-filled:
    (B, N, 3), (B, M, 3) -> (B, M, K) int32."""
    xyz, centers = _coords(xyz), _coords(centers)
    if _on_cpu(xyz):
        return ball_query_ref(xyz, centers, radius, num_samples, min_radius)
    with span("pointops.ball_query", b=xyz.shape[0],
              n=xyz.shape[1], m=centers.shape[1], k=num_samples):
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
    if _on_cpu(q):
        idx = three_nn_ref(q, s)
    else:
        with span("pointops.three_nn", b=q.shape[0],
                  n=s.shape[1], m=q.shape[1]):
            idx = three_nn_cuda(q, s)
    d = query[:, :, None, :] - group_points(source, idx)  # (B, M, 3, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 gathered rows: feats (B, N, C), idx (B, M, 3),
    weight (B, M, 3) -> (B, M, C)."""
    return (group_points(feats, idx) * weight[..., None]).sum(dim=2)


def knn(k: int, source: torch.Tensor, query: torch.Tensor,
        valid_mask: torch.Tensor | None = None,
        chunk_target: int = 256) -> torch.Tensor:
    """The k nearest sources of each query, nearest first, the lower
    index first on ties (the reference knn op): (B, N, 3), (B, M, 3) ->
    (B, M, k) int32. Ranked by the exact ``(a-b)^2`` distance, summed as
    the kernels sum it (the JAX package ranks by ``square_distance``'s
    matmul form, so near-ties may order otherwise); ``valid_mask`` (B, N)
    bool excludes sources. Plain PyTorch on either device,
    ``chunk_target`` queries at a time."""
    s, q = _coords(source), _coords(query)
    out = []
    for lo in range(0, q.shape[1], chunk_target):
        d = q[:, lo:lo + chunk_target, None, :] - s[:, None, :, :]
        d2 = _sum_channels(d * d)
        if valid_mask is not None:
            d2 = torch.where(valid_mask.to(d2.device)[:, None, :], d2,
                             torch.inf)
        out.append(torch.sort(d2, dim=-1, stable=True).indices[..., :k])
    return torch.cat(out, dim=1).to(torch.int32)
