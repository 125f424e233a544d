"""IoU of 3D boxes: axis-aligned, and the differentiable rotated IoU.

Counterpart of ``nesie_tpu/core/iou.py`` (``axis_aligned_overlap_3d``,
``axis_aligned_iou_3d``, ``iou3d``, ``giou3d``). The rotated IoU has the semantics of
the reference's Rotated_IoU package (oriented_iou_loss.py +
box_intersection_2d.py): the two BEV rectangles are clipped with up to 24
candidate vertices, sorted by angle (a stable argsort in place of the CUDA
``sort_vertices``), and the shoelace area taken. The sort indices are
integers and carry no gradient, as in the reference.

Boxes are ``(cx, cy, cz_gravity, sx, sy, sz, yaw)``.
"""
from __future__ import annotations

import torch

_EPS = 1e-8
_BEV = [0, 1, 3, 4, 6]


def axis_aligned_overlap_3d(boxes1, boxes2, *, aligned: bool = False,
                            mode: str = "iou", eps: float = 1e-10):
    """IoU / GIoU of axis-aligned ``(x1,y1,z1,x2,y2,z2)`` boxes:
    (..., N, 6), (..., M, 6) -> (..., N, M), or (..., N) when ``aligned``."""
    if mode not in ("iou", "giou"):
        raise ValueError(mode)
    if not aligned:
        boxes1 = boxes1[..., :, None, :]
        boxes2 = boxes2[..., None, :, :]
    lt = torch.maximum(boxes1[..., :3], boxes2[..., :3])
    rb = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
    whd = torch.clamp(rb - lt, min=0.0)
    inter = whd[..., 0] * whd[..., 1] * whd[..., 2]

    def vol(b):
        d = b[..., 3:] - b[..., :3]
        return d[..., 0] * d[..., 1] * d[..., 2]

    union = torch.clamp(vol(boxes1) + vol(boxes2) - inter, min=eps)
    ious = inter / union
    if mode == "iou":
        return ious
    enc = torch.clamp(torch.maximum(boxes1[..., 3:], boxes2[..., 3:])
                      - torch.minimum(boxes1[..., :3], boxes2[..., :3]),
                      min=0.0)
    enclose = torch.clamp(enc[..., 0] * enc[..., 1] * enc[..., 2], min=eps)
    return ious - (enclose - union) / enclose


def axis_aligned_iou_3d(boxes1, boxes2, **kw):
    """IoU of center-size boxes treated as axis-aligned (yaw ignored)."""

    def to_minmax(b):
        return torch.cat([b[..., :3] - 0.5 * b[..., 3:6],
                          b[..., :3] + 0.5 * b[..., 3:6]], dim=-1)

    return axis_aligned_overlap_3d(to_minmax(boxes1), to_minmax(boxes2), **kw)


def bev_corners(boxes5):
    """(..., 5) ``(x, y, w, h, alpha)`` -> (..., 4, 2) BEV corners,
    counterclockwise for positive alpha (reference ``box2corners_th``)."""
    x, y, w, h, a = (boxes5[..., i:i + 1] for i in range(5))
    sx = torch.tensor([0.5, -0.5, -0.5, 0.5], dtype=boxes5.dtype,
                      device=boxes5.device) * w
    sy = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=boxes5.dtype,
                      device=boxes5.device) * h
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack([sx * c - sy * s + x, sx * s + sy * c + y], dim=-1)


def _edge_intersections(c1, c2):
    """Pairwise segment intersections of two quads (..., 4, 2) ->
    points (..., 4, 4, 2) and mask (..., 4, 4)."""
    roll = [1, 2, 3, 0]
    l1 = torch.cat([c1, c1[..., roll, :]], dim=-1)[..., :, None, :]
    l2 = torch.cat([c2, c2[..., roll, :]], dim=-1)[..., None, :, :]
    x1, y1, x2, y2 = l1.unbind(-1)
    x3, y3, x4, y4 = l2.unbind(-1)
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    t_raw = den_t / (num + _EPS)
    t = torch.where(num == 0.0, -1.0, t_raw)
    den_u = (x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)
    u = torch.where(num == 0.0, -1.0, -den_u / (num + _EPS))
    mask = (t > 0) & (t < 1) & (u > 0) & (u < 1)
    ix = x1 + t_raw * (x2 - x1)
    iy = y1 + t_raw * (y2 - y1)
    return torch.stack([ix, iy], dim=-1) * mask[..., None], mask


def _corners_in_box(c1, c2):
    """(..., 4) bool: corner i of quad c1 inside quad c2 (edges included)."""
    a, b, d = c2[..., 0:1, :], c2[..., 1:2, :], c2[..., 3:4, :]
    ab, ad, am = b - a, d - a, c1 - a
    r_ab = (ab * am).sum(-1) / torch.clamp((ab * ab).sum(-1), min=_EPS)
    r_ad = (ad * am).sum(-1) / torch.clamp((ad * ad).sum(-1), min=_EPS)
    return ((r_ab > -1e-6) & (r_ab < 1 + 1e-6) & (r_ad > -1e-6)
            & (r_ad < 1 + 1e-6))


def _polygon_area(vertices, mask):
    """Shoelace area of the masked candidate vertices (..., 24, 2) taken
    in angle order around their mean; 0 where none is valid."""
    num_valid = mask.sum(-1)
    denom = torch.clamp(num_valid, min=1).to(vertices.dtype)
    mean = (vertices * mask[..., None]).sum(-2) / denom[..., None]
    centered = vertices - mean[..., None, :]
    ang = torch.atan2(centered[..., 1], centered[..., 0])
    key = torch.where(mask, ang, torch.inf)  # invalid last
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_v = centered.gather(-2, order[..., None].expand_as(centered))
    sorted_m = mask.gather(-1, order)
    sorted_v = sorted_v * sorted_m[..., None]  # invalid -> (0, 0)
    x, y = sorted_v[..., 0], sorted_v[..., 1]
    partial = (x[..., :-1] * y[..., 1:] - y[..., :-1] * x[..., 1:]).sum(-1)
    last = torch.clamp(num_valid - 1, min=0)[..., None]
    closing = (x.gather(-1, last)[..., 0] * y[..., 0]
               - y.gather(-1, last)[..., 0] * x[..., 0])
    area = torch.abs(partial + closing) / 2
    return torch.where(num_valid > 0, area, 0.0)


def rotated_intersection_area_2d(c1, c2):
    """Intersection area of two BEV quads given their corners (..., 4, 2)."""
    inter, mask_i = _edge_intersections(c1, c2)
    batch = c1.shape[:-2]
    verts = torch.cat([c1, c2, inter.reshape(batch + (16, 2))], dim=-2)
    mask = torch.cat([_corners_in_box(c1, c2), _corners_in_box(c2, c1),
                      mask_i.reshape(batch + (16,))], dim=-1)
    return _polygon_area(verts, mask)


def iou_bev(boxes5a, boxes5b, eps: float = _EPS):
    """Rotated BEV IoU of aligned (..., 5) box pairs -> (iou, union)."""
    inter = rotated_intersection_area_2d(bev_corners(boxes5a),
                                         bev_corners(boxes5b))
    union = boxes5a[..., 2] * boxes5a[..., 3] + boxes5b[..., 2] \
        * boxes5b[..., 3] - inter
    return inter / torch.clamp(union, min=eps), union


def iou3d(boxes1, boxes2, eps: float = _EPS):
    """Differentiable rotated 3D IoU of aligned (..., 7) gravity-centered
    box pairs (reference ``cal_iou_3d``): the BEV polygon intersection
    times the z overlap. Returns (...,) in [0, 1]."""
    zmax1 = boxes1[..., 2] + 0.5 * boxes1[..., 5]
    zmin1 = boxes1[..., 2] - 0.5 * boxes1[..., 5]
    zmax2 = boxes2[..., 2] + 0.5 * boxes2[..., 5]
    zmin2 = boxes2[..., 2] - 0.5 * boxes2[..., 5]
    z_overlap = torch.clamp(torch.minimum(zmax1, zmax2)
                            - torch.maximum(zmin1, zmin2), min=0.0)
    iou2d, union2d = iou_bev(boxes1[..., _BEV], boxes2[..., _BEV])
    inter3d = iou2d * union2d * z_overlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter3d / torch.clamp(v1 + v2 - inter3d, min=eps)


def _smallest_enclosing_wh(corners):
    """Width and height of the minimum-area rectangle enclosing 8 BEV
    points (..., 8, 2) -> (w, h), each (...). The optimal rectangle has an
    edge parallel to a hull edge, so scanning every point-pair direction
    is exact (the reference's ``smallest_bounding_box``,
    min_enclosing_box.py). As in the JAX package, a point paired with
    itself takes ``sqrt`` at 0, so the gradient through the chosen
    rectangle is NaN in x, y, the sizes and yaw."""
    diff = corners[..., :, None, :] - corners[..., None, :, :]
    batch = corners.shape[:-2]
    diff = diff.reshape(batch + (64, 2))
    norm = torch.sqrt((diff * diff).sum(dim=-1))
    degenerate = norm < 1e-8
    u = diff / torch.clamp(norm, min=1e-8)[..., None]  # candidate x-axes
    px = torch.einsum("...dc,...pc->...dp", u, corners)
    perp = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
    py = torch.einsum("...dc,...pc->...dp", perp, corners)
    w = px.amax(dim=-1) - px.amin(dim=-1)
    h = py.amax(dim=-1) - py.amin(dim=-1)
    area = torch.where(degenerate, torch.inf, w * h)
    best = area.argmin(dim=-1, keepdim=True)
    return w.gather(-1, best)[..., 0], h.gather(-1, best)[..., 0]


def giou3d(boxes1, boxes2, eps: float = _EPS, enclosing: str = "smallest"):
    """Rotated 3D GIoU loss of aligned (..., 7) gravity-centered box pairs
    (reference ``cal_giou_3d``, oriented_iou_loss.py:112). Returns
    (giou_loss, iou).

    ``enclosing``: "smallest" (the reference's default, the min-area
    rotated rectangle) or "aligned" (axis-aligned, a cheaper upper
    bound)."""
    bev1, bev2 = boxes1[..., _BEV], boxes2[..., _BEV]
    c1, c2 = bev_corners(bev1), bev_corners(bev2)
    inter2d = rotated_intersection_area_2d(c1, c2)
    zmax1 = boxes1[..., 2] + 0.5 * boxes1[..., 5]
    zmin1 = boxes1[..., 2] - 0.5 * boxes1[..., 5]
    zmax2 = boxes2[..., 2] + 0.5 * boxes2[..., 5]
    zmin2 = boxes2[..., 2] - 0.5 * boxes2[..., 5]
    z_overlap = torch.clamp(torch.minimum(zmax1, zmax2)
                            - torch.maximum(zmin1, zmin2), min=0.0)
    z_range = torch.clamp(torch.maximum(zmax1, zmax2)
                          - torch.minimum(zmin1, zmin2), min=0.0)

    inter3d = inter2d * z_overlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    union3d = v1 + v2 - inter3d
    iou = inter3d / torch.clamp(union3d, min=eps)

    all_c = torch.cat([c1, c2], dim=-2)
    if enclosing == "smallest":
        w, h = _smallest_enclosing_wh(all_c)
    else:
        w = all_c[..., 0].amax(dim=-1) - all_c[..., 0].amin(dim=-1)
        h = all_c[..., 1].amax(dim=-1) - all_c[..., 1].amin(dim=-1)
    vc = torch.clamp(z_range * w * h, min=eps)
    return 1.0 - iou + (vc - union3d) / vc, iou
