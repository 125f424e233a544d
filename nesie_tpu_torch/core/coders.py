"""Anchor-based box coders from the reference's coder registry.
Counterpart of ``nesie_tpu/core/coders.py``.

* ``delta_xyzwhlr_encode`` / ``delta_xyzwhlr_decode`` — reference
  ``DeltaXYZWLHRBBoxCoder`` (mmdet3d/core/bbox/coders/
  delta_xyzwhlr_bbox_coder.py:19-90), the SECOND/PartA2 residual coder:
  center deltas normalized by the BEV diagonal, log-size ratios, additive
  yaw, z handled at the box *center* (the +h/2 shift on both ends).
* ``centerpoint_decode`` — reference ``CenterPointBBoxCoder.decode``
  (centerpoint_bbox_coders.py:115-227), with static ``(B, K)`` outputs and
  a validity mask; ``centerpoint_filter`` applies the reference's mask
  semantics on the host.

``topk`` breaks ties toward the lower index, as ``jax.lax.top_k`` does:
it is a stable descending sort, where ``torch.topk`` promises no order on
ties.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch


def topk(x: torch.Tensor, k: int):
    """Top ``k`` along the last axis, equal values in index order (the
    ``jax.lax.top_k`` rule) -> (values, int64 indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


# --------------------------------------------------------- DeltaXYZWLHR
def delta_xyzwhlr_encode(src_boxes, dst_boxes):
    """Regression targets transforming ``src_boxes`` (anchors) into
    ``dst_boxes`` (GT). Boxes are (..., 7+) = [x, y, z, w, l, h, yaw, v*]
    with z at the box BOTTOM (the coder recenters, reference
    delta_xyzwhlr_bbox_coder.py:44-45); extra dims are plain residuals.
    """
    xa, ya, za, wa, la, ha, ra = torch.split(src_boxes[..., :7], 1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = torch.split(dst_boxes[..., :7], 1, dim=-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diagonal = torch.sqrt(la**2 + wa**2)
    out = [
        (xg - xa) / diagonal,
        (yg - ya) / diagonal,
        (zg - za) / ha,
        torch.log(wg / wa),
        torch.log(lg / la),
        torch.log(hg / ha),
        rg - ra,
    ]
    if src_boxes.shape[-1] > 7:
        out.append(dst_boxes[..., 7:] - src_boxes[..., 7:])
    return torch.cat(out, dim=-1)


def delta_xyzwhlr_decode(anchors, deltas):
    """Inverse of :func:`delta_xyzwhlr_encode` (reference decode,
    delta_xyzwhlr_bbox_coder.py:56-90); returns bottom-z boxes."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors[..., :7], 1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = torch.split(deltas[..., :7], 1, dim=-1)
    za = za + ha / 2
    diagonal = torch.sqrt(la**2 + wa**2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    out = [xg, yg, zg, wg, lg, hg, rg]
    if anchors.shape[-1] > 7:
        out.append(deltas[..., 7:] + anchors[..., 7:])
    return torch.cat(out, dim=-1)


# ----------------------------------------------------------- CenterPoint
class CenterPointDecoded(NamedTuple):
    bboxes: torch.Tensor  # (B, K, 7 or 9)
    scores: torch.Tensor  # (B, K)
    labels: torch.Tensor  # (B, K) int32
    valid: torch.Tensor   # (B, K) bool — score/center-range mask


def _topk_heatmap(heat, k):
    """Reference two-stage top-k (centerpoint_bbox_coders.py:61-94):
    per-class top-k over space, then top-k over the (class, k) pool."""
    B, C, H, W = heat.shape
    per_cls_scores, per_cls_inds = topk(heat.reshape(B, C, H * W), k)
    ys = (per_cls_inds // W).float()
    xs = (per_cls_inds % W).float()
    pool_scores, pool_inds = topk(per_cls_scores.reshape(B, C * k), k)
    clses = (pool_inds // k).to(torch.int32)
    flat_inds = torch.gather(per_cls_inds.reshape(B, C * k), 1, pool_inds)
    ys = torch.gather(ys.reshape(B, C * k), 1, pool_inds)
    xs = torch.gather(xs.reshape(B, C * k), 1, pool_inds)
    return pool_scores, flat_inds, clses, ys, xs


def _gather_map(feat, inds):
    """(B, C, H, W) regression map gathered at flat spatial ``inds`` (B, K)
    -> (B, K, C) (reference _transpose_and_gather_feat)."""
    B, C, H, W = feat.shape
    flat = feat.reshape(B, C, H * W)
    g = torch.gather(flat, 2, inds[:, None, :].expand(B, C, inds.shape[1]))
    return g.transpose(1, 2)


def centerpoint_decode(
    heat,
    rot_sine,
    rot_cosine,
    hei,
    dim,
    vel=None,
    reg=None,
    *,
    pc_range: Sequence[float],
    out_size_factor: int,
    voxel_size: Sequence[float],
    post_center_range: Optional[Sequence[float]] = None,
    max_num: int = 100,
    score_threshold: Optional[float] = None,
) -> CenterPointDecoded:
    """Decode CenterPoint head maps into top-``max_num`` boxes per scene.

    Maps are (B, C, H, W) like the reference; ``heat`` must already be
    sigmoided. Returns static-shape tensors + ``valid`` instead of the
    reference's ragged per-scene host lists (centerpoint_bbox_coders.py:
    195-221); apply :func:`centerpoint_filter` for those semantics.
    """
    B = heat.shape[0]
    scores, inds, clses, ys, xs = _topk_heatmap(heat, max_num)

    if reg is not None:
        r = _gather_map(reg, inds)  # (B, K, 2)
        xs = xs + r[..., 0]
        ys = ys + r[..., 1]
    else:
        xs = xs + 0.5
        ys = ys + 0.5

    rs = _gather_map(rot_sine, inds)[..., 0]
    rc = _gather_map(rot_cosine, inds)[..., 0]
    rot = torch.atan2(rs, rc)
    hei = _gather_map(hei, inds)[..., 0]
    dim = _gather_map(dim, inds)  # (B, K, 3)

    xs = xs * out_size_factor * voxel_size[0] + pc_range[0]
    ys = ys * out_size_factor * voxel_size[1] + pc_range[1]

    parts = [xs[..., None], ys[..., None], hei[..., None], dim, rot[..., None]]
    if vel is not None:
        parts.append(_gather_map(vel, inds))  # nuScenes 9-dim
    bboxes = torch.cat(parts, dim=-1)

    valid = torch.ones((B, max_num), dtype=torch.bool, device=heat.device)
    if score_threshold is not None:
        valid &= scores > score_threshold
    if post_center_range is not None:
        pcr = torch.tensor(post_center_range, dtype=torch.float32,
                           device=heat.device)
        valid &= torch.all(bboxes[..., :3] >= pcr[:3], dim=-1)
        valid &= torch.all(bboxes[..., :3] <= pcr[3:], dim=-1)
    return CenterPointDecoded(bboxes, scores, clses, valid)


def centerpoint_filter(decoded: CenterPointDecoded):
    """Host-side ragged filtering matching the reference's return value:
    list over batch of dicts(bboxes, scores, labels) of numpy arrays."""
    out = []
    for b in range(decoded.bboxes.shape[0]):
        m = decoded.valid[b].cpu().numpy()
        out.append(dict(
            bboxes=decoded.bboxes[b].cpu().numpy()[m],
            scores=decoded.scores[b].cpu().numpy()[m],
            labels=decoded.labels[b].cpu().numpy()[m],
        ))
    return out
