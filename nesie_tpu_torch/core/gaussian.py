"""Gaussian heatmap utilities (reference mmdet3d/core/utils/gaussian.py —
CenterPoint-legacy helpers, unused by the shipped configs). Counterpart
of ``nesie_tpu/core/gaussian.py``."""
from __future__ import annotations

import torch


def gaussian_2d(shape, sigma: float = 1.0, device=None):
    """(m, n) float32 gaussian kernel."""
    m, n = ((s - 1.0) / 2.0 for s in shape)
    y = torch.arange(-m, m + 1, device=device)[:, None]
    x = torch.arange(-n, n + 1, device=device)[None, :]
    h = torch.exp(-(x * x + y * y) / (2 * sigma * sigma))
    return torch.where(h < torch.finfo(h.dtype).eps * h.max(), 0.0, h)


def draw_heatmap_gaussian(heatmap, center, radius: int, k: float = 1.0):
    """Splat one gaussian of given integer radius at integer center
    (max-composited, as the reference does). Returns a new heatmap."""
    d = 2 * radius + 1
    g = gaussian_2d((d, d), sigma=d / 6.0, device=heatmap.device) * k
    H, W = heatmap.shape
    cx, cy = center
    y = torch.arange(H, device=heatmap.device)[:, None]
    x = torch.arange(W, device=heatmap.device)[None, :]
    # the kernel's index of every map cell, clipped; cells outside the
    # splat read a clipped index and are masked below
    gy = torch.clamp(y - (cy - radius), 0, d - 1)
    gx = torch.clamp(x - (cx - radius), 0, d - 1)
    vals = g[gy, gx].to(heatmap.dtype)
    inside = ((y >= cy - radius) & (y <= cy + radius)
              & (x >= cx - radius) & (x <= cx + radius))
    return torch.maximum(heatmap, torch.where(inside, vals, 0.0))


def _sqrt(v):
    """sqrt in float32 for Python numbers (JAX's default dtype), in the
    tensor's dtype for tensors."""
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, dtype=torch.float32)
    return torch.sqrt(v)


def gaussian_radius(det_size, min_overlap: float = 0.5):
    """Radius so that shifted boxes keep >= min_overlap IoU (CornerNet)."""
    height, width = det_size

    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = _sqrt(b1**2 - 4 * a1 * c1)
    r1 = (b1 + sq1) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = _sqrt(b2**2 - 4 * a2 * c2)
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = _sqrt(b3**2 - 4 * a3 * c3)
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)
