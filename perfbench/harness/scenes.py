"""Indoor rooms made on the device from a seeded generator.

A batched copy of the port's ``data.synthetic.make_scene`` (floor, four
walls and box-shaped objects, points on their surfaces, 5 mm noise),
drawn with ``torch`` on the generator's device so that set-up makes a
whole batch in a few calls; and the shift-height feature of
``data.io.add_height`` (z minus the 0.99th percentile of z) on the
device.
"""
from __future__ import annotations

import torch


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def make_rooms(gen: torch.Generator, b: int, n: int, k_range=(8, 8)):
    """``b`` rooms of ``n`` points: (b, n, 3) float32 metres, and the
    objects' (b, k_max, 7) bottom-centered axis-aligned boxes with a
    (b, k_max) bool mask of the objects a room has (``k_range``: the
    least and most objects a room holds, drawn per room)."""
    k_lo, k_hi = k_range
    lo = torch.tensor([4.0, 4.0, 2.5], device=gen.device)
    hi = torch.tensor([8.0, 8.0, 3.0], device=gen.device)
    room = lo + (hi - lo) * _uniform(gen, (b, 3))
    n_floor, n_wall = int(0.3 * n), int(0.3 * n)
    n_obj = n - n_floor - n_wall
    floor = _uniform(gen, (b, n_floor, 3)) * torch.cat(
        [room[:, :2], torch.full((b, 1), 0.02, device=gen.device)],
        1)[:, None]
    wall = _uniform(gen, (b, n_wall, 3)) * room[:, None]
    side = _randint(gen, 0, 4, (b, n_wall))
    wall[..., 0] = torch.where(side == 0, 0.0, wall[..., 0])
    wall[..., 0] = torch.where(side == 1, room[:, None, 0], wall[..., 0])
    wall[..., 1] = torch.where(side == 2, 0.0, wall[..., 1])
    wall[..., 1] = torch.where(side == 3, room[:, None, 1], wall[..., 1])
    k = _randint(gen, k_lo, k_hi + 1, (b,))
    valid = torch.arange(k_hi, device=gen.device)[None] < k[:, None]
    size = _uniform(gen, (b, k_hi, 3), 0.3, 1.5)
    corner = _uniform(gen, (b, k_hi, 3)) * (room[:, None] - size)
    corner[..., 2] = 0.0
    which = (_uniform(gen, (b, n_obj)) * k[:, None]).long().clamp_max(
        k_hi - 1)
    p = _uniform(gen, (b, n_obj, 3))
    axis = _randint(gen, 0, 3, (b, n_obj, 1))
    face = _randint(gen, 0, 2, (b, n_obj, 1)).float()
    p = p.scatter(2, axis, face)  # snap one coordinate onto a face
    pick = which[..., None].expand(-1, -1, 3)
    obj = corner.gather(1, pick) + p * size.gather(1, pick)
    pts = torch.cat([floor, wall, obj], 1)
    pts = pts + 0.005 * torch.randn(pts.shape, generator=gen,
                                    device=gen.device)
    perm = torch.argsort(_uniform(gen, (b, n)), dim=1)
    pts = pts.gather(1, perm[..., None].expand(-1, -1, 3)).contiguous()
    boxes = torch.cat([corner[..., :2] + size[..., :2] / 2, corner[..., 2:3],
                       size, torch.zeros((b, k_hi, 1), device=gen.device)],
                      -1)
    return pts.float(), boxes.float(), valid


def add_height(pts: torch.Tensor) -> torch.Tensor:
    """(..., n, 3) -> (..., n, 4): z minus the 0.99th percentile of z (the
    shift-height feature), as ``numpy.percentile(z, 0.99)`` computes it."""
    floor = torch.quantile(pts[..., 2], 0.0099, dim=-1, keepdim=True)
    return torch.cat([pts, (pts[..., 2] - floor)[..., None]], -1)
