"""The outdoor stack of the port held to the JAX package on the same
numpy-seeded inputs (CPU): ``core.box_modes``, ``core.np_box_ops``,
``core.gaussian``, ``core.anchors``, ``core.coders``,
``core.multiclass_nms``, ``core.pcdet_nms``, ``core.samplers``,
``data.voxel_generator``, ``data.outdoor_transforms``, ``data.dbsampler``
and ``tools/create_data --gt-db``. The inputs follow the JAX package's own
tests (``tests/test_extras.py``, ``tests/test_parity_ops.py``,
``tests/test_dbsampler.py``, ``tests/test_boxes.py``,
``tests/test_data.py``), their cases among them.

Tolerances:
* integer outputs (keep lists, labels, top-k indices, masks): identical;
* box modes: identical (they only permute and negate), round trips exact;
* the numpy copies (``np_box_ops``, ``samplers``, ``voxel_generator``,
  ``outdoor_transforms``, ``dbsampler``): identical to their originals,
  the same ``np.random.Generator`` seed giving the same draws;
* float32 forwards (gaussians, coders, IoUs, decoded boxes): 1e-5
  absolute;
* anchor centres: within 1e-6 of the larger endpoint of the anchor range
  (a relative tolerance of 1e-6). ``jnp.linspace`` is ``lo * (1 - t) +
  hi * t``, ``t = i / (n - 1)``, which the port computes; XLA rewrites
  the division into a product with the rounded reciprocal, reassociates
  ``hi * t`` and contracts into FMAs, so its centres sit a few ulps of
  the endpoints away. ``torch.linspace`` itself differs from both. Sizes
  and rotations are identical;
* ``create_data --gt-db``: every ``.bin`` file and the
  ``*_dbinfos_train.pkl`` byte-equal to the JAX tool's on the same tree.

The top-k tie rule (``jax.lax.top_k`` takes the lower index) has tests
of its own: ``test_topk_breaks_ties_toward_the_lower_index``,
``test_centerpoint_decode_ties`` and the tied case of
``test_box3d_multiclass_nms_matches_jax``.
"""
import importlib.util
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import nesie_tpu.core.anchors as janc
import nesie_tpu.core.box_modes as jbm
import nesie_tpu.core.coders as jcod
import nesie_tpu.core.gaussian as jgau
import nesie_tpu.core.multiclass_nms as jmn
import nesie_tpu.core.np_box_ops as jnpb
import nesie_tpu.core.pcdet_nms as jpc
import nesie_tpu.core.samplers as jsam
import nesie_tpu.data.dbsampler as jdb
import nesie_tpu.data.outdoor_transforms as jot
import nesie_tpu.data.voxel_generator as jvg
import nesie_tpu_torch.core.anchors as tanc
import nesie_tpu_torch.core.box_modes as tbm
import nesie_tpu_torch.core.coders as tcod
import nesie_tpu_torch.core.gaussian as tgau
import nesie_tpu_torch.core.multiclass_nms as tmn
import nesie_tpu_torch.core.np_box_ops as tnpb
import nesie_tpu_torch.core.pcdet_nms as tpc
import nesie_tpu_torch.core.samplers as tsam
import nesie_tpu_torch.data.dbsampler as tdb
import nesie_tpu_torch.data.outdoor_transforms as tot
import nesie_tpu_torch.data.voxel_generator as tvg
from nesie_tpu_torch.data.synthetic import make_synthetic_scenes
from nesie_tpu_torch.tools import create_data as tcreate

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
F32 = dict(atol=1e-5, rtol=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """Nested tuples / lists / dicts of arrays: identical, same dtypes."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _boxes7(rng, n, dtype=np.float32):
    """tests/test_parity_ops.py's ``_rand_boxes7``."""
    return np.stack([
        rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(-0.5, 0.5, n),
        rng.uniform(0.6, 2.0, n), rng.uniform(0.6, 2.0, n),
        rng.uniform(0.6, 2.0, n), rng.uniform(-np.pi, np.pi, n)],
        axis=1).astype(dtype)


# ------------------------------------------------------------ box modes
BOX_FNS = ["depth_to_lidar", "lidar_to_depth", "depth_to_cam",
           "cam_to_depth", "lidar_to_cam", "cam_to_lidar"]
FRAMES = ["DEPTH", "LIDAR", "CAM"]


@pytest.mark.parametrize("fn", BOX_FNS)
def test_box_modes_match_jax(fn):
    b = np.random.default_rng(0).normal(size=(2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(getattr(tbm, fn)(_t(b)).numpy(),
                                  np.asarray(getattr(jbm, fn)(jnp.asarray(b))))


@pytest.mark.parametrize("src", FRAMES)
@pytest.mark.parametrize("dst", FRAMES)
def test_convert_points_matches_jax(src, dst):
    p = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tbm.convert_points(_t(p), src, dst).numpy(),
        np.asarray(jbm.convert_points(jnp.asarray(p), src, dst)))
    # tests/test_extras.py's case
    if (src, dst) == ("DEPTH", "LIDAR"):
        out = tbm.convert_points(torch.tensor([[1.0, 2.0, 3.0, 9.0]]), src,
                                 dst)
        np.testing.assert_array_equal(out[0].numpy(), [2, -1, 3, 9])


def test_box_mode_round_trips_are_exact():
    b = _t(np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32))
    for a, inv in (("depth_to_lidar", "lidar_to_depth"),
                   ("depth_to_cam", "cam_to_depth"),
                   ("lidar_to_cam", "cam_to_lidar")):
        assert torch.equal(getattr(tbm, inv)(getattr(tbm, a)(b)), b)
        assert torch.equal(getattr(tbm, a)(getattr(tbm, inv)(b)), b)
    with pytest.raises(ValueError):
        tbm.convert_points(b[:, :3], "DEPTH", "IMAGE")


# ---------------------------------------------------------- np_box_ops
def test_np_box_ops_copy_matches_original():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.5, 2.0, (6, 7)).astype(np.float32)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 6)
    pts = rng.uniform(-1, 3, (500, 4)).astype(np.float32)
    for fn, args in (
            ("center_to_corner_box3d", (boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6])),
            ("center_to_corner_box3d", (boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6], (0.5, 0.5, 0))),
            ("center_to_corner_box2d", (boxes[:, :2], boxes[:, 3:5],
                                        boxes[:, 6])),
            ("points_in_rbbox", (pts, boxes)),
            ("points_in_rbbox", (pts, boxes, (0.5, 0.5, 0.5))),
            ("limit_period", (boxes[:, 6] * 3,)),
            ("limit_period", (boxes[:, 6] * 3, 0.0, 2 * np.pi))):
        _same(getattr(tnpb, fn)(*args), getattr(jnpb, fn)(*args))
    for axis in (0, 1, 2):
        _same(tnpb.rotation_points_single_angle(pts[:, :3], 0.7, axis),
              jnpb.rotation_points_single_angle(pts[:, :3], 0.7, axis))
    corners = jnpb.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6],
                                          boxes[:, 6])
    _same(tnpb.corner_to_standup_nd(corners), jnpb.corner_to_standup_nd(corners))


@pytest.mark.parametrize("literal", [False, True])
def test_box_collision_test_copy_matches_original(literal):
    rng = np.random.default_rng(1)
    n = 40
    c = tnpb.center_to_corner_box2d(rng.uniform(-3, 3, (n, 2)),
                                    rng.uniform(0.3, 2.0, (n, 2)),
                                    rng.uniform(-np.pi, np.pi, n))
    # tests/test_dbsampler.py's boxes: far, overlapping, a crossing sliver,
    # and one box inside another (containment)
    extra = np.concatenate([tnpb.center_to_corner_box2d(
        np.array(ctr), np.array(dims), np.array(yaw))
        for ctr, dims, yaw in (([[2.0, 0.0]], [[1.0, 1.0]], [0.0]),
                               ([[0.7, 0.0]], [[1.0, 1.0]], [np.pi / 4]),
                               ([[0.0, 0.0]], [[4.0, 0.05]], [np.pi / 6]),
                               ([[0.0, 0.0]], [[0.2, 0.2]], [0.3]),
                               ([[0.0, 0.0]], [[1.0, 1.0]], [0.0]))])
    c = np.concatenate([c, extra])
    got = tnpb.box_collision_test(c, c, literal_reference=literal)
    _same(got, jnpb.box_collision_test(c, c, literal_reference=literal))
    assert got[-1, -2] != literal  # containment counts unless literal
    _same(tnpb.box_collision_test(c[:0], c), jnpb.box_collision_test(c[:0], c))


def test_np_box_ops_agree_with_the_ports_tensor_boxes():
    """tests/test_boxes.py:86 against the port's own tensor box ops."""
    from nesie_tpu_torch.core import box_corners, points_in_boxes

    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.5, 2.0, (4, 7)).astype(np.float32)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 4)
    c_np = tnpb.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6], boxes[:, 6])
    np.testing.assert_allclose(c_np, box_corners(_t(boxes)).numpy(), **F32)
    pts = rng.uniform(-1, 3, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tnpb.points_in_rbbox(pts, boxes),
        points_in_boxes(_t(pts), _t(boxes)).numpy())


# ------------------------------------------------------------- gaussian
@pytest.mark.parametrize("shape,sigma", [((5, 5), 5 / 6), ((7, 3), 1.0),
                                         ((1, 1), 0.5), ((9, 9), 0.4)])
def test_gaussian_2d_matches_jax(shape, sigma):
    np.testing.assert_allclose(tgau.gaussian_2d(shape, sigma).numpy(),
                               np.asarray(jgau.gaussian_2d(shape, sigma)),
                               **F32)


@pytest.mark.parametrize("center,radius,k", [
    ((8, 8), 2, 1.0),     # tests/test_extras.py's case
    ((0, 0), 3, 1.0),     # clipped at the top-left corner
    ((15, 2), 4, 0.5),    # clipped at the right edge
    ((3, 14), 6, 1.0),    # clipped on three sides
    ((20, 20), 2, 1.0)])  # outside the map: nothing drawn
def test_draw_heatmap_gaussian_matches_jax(center, radius, k):
    hm = np.random.default_rng(2).uniform(0, 0.5, (16, 16)).astype(np.float32)
    got = tgau.draw_heatmap_gaussian(_t(hm), center, radius, k).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jgau.draw_heatmap_gaussian(jnp.asarray(hm), center,
                                                   radius, k)), **F32)
    assert (got >= hm).all()


@pytest.mark.parametrize("det,overlap", [((10.0, 10.0), 0.5),
                                         ((3.2, 17.5), 0.1),
                                         ((0.5, 0.7), 0.7)])
def test_gaussian_radius_matches_jax(det, overlap):
    want = float(jgau.gaussian_radius(det, overlap))
    np.testing.assert_allclose(float(tgau.gaussian_radius(det, overlap)),
                               want, **F32)
    sizes = np.array(det, np.float32)[:, None] * np.array([[1.0, 2.0, 0.5]],
                                                          np.float32)
    np.testing.assert_allclose(
        tgau.gaussian_radius(tuple(_t(sizes)), overlap).numpy(),
        np.asarray(jgau.gaussian_radius(tuple(jnp.asarray(sizes)), overlap)),
        **F32)


# -------------------------------------------------------------- anchors
KITTI_RANGES = [[0, -40, -3, 70, 40, 1], [0, -40, -1.8, 70, 40, 2.2]]
KITTI_SIZES = [[1.6, 3.9, 1.56], [0.6, 0.8, 1.73]]


def _assert_anchors(got, want, ranges):
    scale = 1e-6 * max(abs(v) for r in ranges for v in r)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0, atol=scale)
    np.testing.assert_array_equal(got[..., 3:], want[..., 3:])


@pytest.mark.parametrize("fs", [(2, 4, 5), (1, 200, 176), (3, 1, 7), (6, 9)])
@pytest.mark.parametrize("cls,align_corner", [
    ("Anchor3DRangeGenerator", False),
    ("AlignedAnchor3DRangeGenerator", False),
    ("AlignedAnchor3DRangeGenerator", True)])
def test_anchor_generators_match_jax(cls, align_corner, fs):
    kw = dict(ranges=KITTI_RANGES, sizes=KITTI_SIZES,
              rotations=[0, 1.5707963], align_corner=align_corner)
    for reshape_out in (True, False):
        got = getattr(tanc, cls)(reshape_out=reshape_out, **kw).grid_anchors(
            [fs])[0].numpy()
        want = np.asarray(getattr(janc, cls)(reshape_out=reshape_out,
                                             **kw).grid_anchors([fs])[0])
        _assert_anchors(got, want, KITTI_RANGES)


@pytest.mark.parametrize("options", [
    dict(custom_values=(0.0, 0.0)),
    dict(size_per_range=False, ranges=[KITTI_RANGES[0]]),
    dict(scales=(1, 2), ranges=[KITTI_RANGES[0]], sizes=[KITTI_SIZES[0]])])
def test_anchor_generator_options_match_jax(options):
    kw = {"ranges": KITTI_RANGES, "sizes": KITTI_SIZES, **options}
    fss = [(1, 8, 6)] * len(kw.get("scales", (1,)))
    gens = (tanc.Anchor3DRangeGenerator(**kw),
            janc.Anchor3DRangeGenerator(**kw))
    assert gens[0].num_base_anchors == gens[1].num_base_anchors
    for got, want in zip(gens[0].grid_anchors(fss), gens[1].grid_anchors(fss)):
        _assert_anchors(got.numpy(), np.asarray(want), kw["ranges"])


def test_anchor_generator_per_cls_matches_jax():
    kw = dict(ranges=[[0, 0, -1, 8, 8, 1], [0, 0, -1, 4, 4, 1]],
              sizes=[[1, 1, 1], [2, 2, 2]], rotations=[0.0, 1.5707963])
    fss = [(1, 4, 4), (1, 2, 2)]
    got = tanc.AlignedAnchor3DRangeGeneratorPerCls(**kw).grid_anchors(fss)
    want = janc.AlignedAnchor3DRangeGeneratorPerCls(**kw).grid_anchors(fss)
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        _assert_anchors(g.numpy(), np.asarray(w), kw["ranges"])


def test_anchor_3d_range_grid_matches_jax():
    """tests/test_extras.py's case and a KITTI-sized one."""
    for args in (((1, 4, 4), (0, 0, -1, 4, 4, -1), ((1, 2, 1),), (0.0, 1.57)),
                 ((1, 200, 176), (0, -39.68, -1.78, 69.12, 39.68, -1.78),
                  ((1.6, 3.9, 1.56),), (0.0, 1.5707963))):
        got = tanc.anchor_3d_range_grid(*args).numpy()
        _assert_anchors(got, np.asarray(janc.anchor_3d_range_grid(*args)),
                        [args[1]])
        assert got[:, 2].max() == args[1][2]


def test_linspace_rounding_is_held_to_1e_6_of_the_range():
    """The trap: ``torch.linspace`` does not round as ``jnp.linspace``;
    the port computes jnp's formula and stays within 1e-6 of the range's
    magnitude on every KITTI-sized axis."""
    lo, hi, n = np.float32(-39.68), np.float32(39.68), 497
    want = np.asarray(jnp.linspace(lo, hi, n))
    got = tanc._linspace(torch.tensor(lo), torch.tensor(hi), n).numpy()
    naive = torch.linspace(float(lo), float(hi), n).numpy()
    assert (naive != want).any()
    assert got[0] == lo and got[-1] == hi
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * abs(hi))
    for n in (1, 2, 3, 176, 201, 1409):
        np.testing.assert_allclose(
            tanc._linspace(torch.tensor(-3.0), torch.tensor(70.4), n).numpy(),
            np.asarray(jnp.linspace(np.float32(-3.0), np.float32(70.4), n)),
            rtol=0, atol=1e-6 * 70.4)


# --------------------------------------------------------------- coders
@pytest.mark.parametrize("extra", [0, 2])
def test_delta_xyzwhlr_coder_matches_jax(extra):
    rng = np.random.default_rng(3)
    anchors = tanc.AlignedAnchor3DRangeGenerator(
        ranges=KITTI_RANGES, sizes=KITTI_SIZES).grid_anchors([(1, 20, 16)])[0]
    anchors = anchors.numpy()
    gt = anchors.copy()
    gt[:, :3] += rng.normal(scale=0.5, size=(len(gt), 3))
    gt[:, 3:6] *= rng.uniform(0.7, 1.4, (len(gt), 3))
    gt[:, 6] += rng.normal(scale=0.3, size=len(gt))
    if extra:
        anchors = np.concatenate([anchors, rng.normal(size=(len(gt), 2))], 1)
        gt = np.concatenate([gt, rng.normal(size=(len(gt), 2))], 1)
    anchors, gt = anchors.astype(np.float32), gt.astype(np.float32)
    deltas = tcod.delta_xyzwhlr_encode(_t(anchors), _t(gt))
    np.testing.assert_allclose(
        deltas.numpy(), np.asarray(jcod.delta_xyzwhlr_encode(
            jnp.asarray(anchors), jnp.asarray(gt))), **F32)
    back = tcod.delta_xyzwhlr_decode(_t(anchors), deltas)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jcod.delta_xyzwhlr_decode(
            jnp.asarray(anchors), jnp.asarray(deltas.numpy()))), **F32)
    np.testing.assert_allclose(back.numpy(), gt, atol=1e-4, rtol=0)


def test_topk_breaks_ties_toward_the_lower_index():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9, 0.5]] * 2, np.float32)
    x[1] = x[1][::-1]
    vals, idx = tcod.topk(_t(x), 6)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx[0].tolist() == [1, 3, 6, 0, 2, 5]


CP = dict(pc_range=[-51.2, -51.2], out_size_factor=8, voxel_size=[0.1, 0.1],
          post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
          max_num=50, score_threshold=0.1)


def _cp_maps(rng, b=2, c=3, h=16, w=16, quantize=None):
    heat = 1 / (1 + np.exp(-rng.normal(size=(b, c, h, w))))
    if quantize:
        heat = np.round(heat * quantize) / quantize  # many equal scores
    maps = dict(heat=heat, rot_sine=rng.normal(size=(b, 1, h, w)),
                rot_cosine=rng.normal(size=(b, 1, h, w)),
                hei=rng.normal(size=(b, 1, h, w)),
                dim=rng.uniform(0.5, 3, (b, 3, h, w)),
                vel=rng.normal(size=(b, 2, h, w)),
                reg=rng.uniform(0, 1, (b, 2, h, w)))
    return {k: v.astype(np.float32) for k, v in maps.items()}


def _cp_both(maps, **kw):
    want = jcod.centerpoint_decode(**{k: jnp.asarray(v) for k, v in
                                      maps.items()}, **kw)
    got = tcod.centerpoint_decode(**{k: _t(v) for k, v in maps.items()}, **kw)
    return got, want


def _assert_decoded(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               **F32)
    assert got.labels.dtype == torch.int32


@pytest.mark.parametrize("drop", [(), ("vel",), ("reg",), ("vel", "reg")])
def test_centerpoint_decode_matches_jax(drop):
    maps = _cp_maps(np.random.default_rng(4))
    for k in drop:
        maps.pop(k)
    got, want = _cp_both(maps, **CP)
    _assert_decoded(got, want)
    loose = {**CP, "post_center_range": None, "score_threshold": None}
    _assert_decoded(*_cp_both(maps, **loose))
    for g, w in zip(tcod.centerpoint_filter(got),
                    jcod.centerpoint_filter(want)):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], **F32)


def test_centerpoint_decode_ties():
    """Scores rounded to tenths: hundreds of ties in both top-k stages;
    the gathered positions and classes follow ``jax.lax.top_k``."""
    maps = _cp_maps(np.random.default_rng(5), quantize=10)
    got, want = _cp_both(maps, **{**CP, "max_num": 100})
    _assert_decoded(got, want)
    _, inds, clses, ys, xs = tcod._topk_heatmap(_t(maps["heat"]), 100)
    jw = jcod._topk_heatmap(jnp.asarray(maps["heat"]), 100)
    for g, w in zip((inds, clses, ys, xs), jw[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ NMS
def _nms_boxes(rng, n, ties=False):
    boxes = _boxes7(rng, n)
    scores = rng.uniform(size=(n, 4)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    return boxes, scores


@pytest.mark.parametrize("literal", [True, False])
def test_nms_bev_rotated_matches_jax(literal):
    boxes, scores = _nms_boxes(np.random.default_rng(6), 40)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    valid = scores[:, 1] > 0.2
    for mask in (None, valid):
        got = tmn.nms_bev_rotated(_t(bev), _t(scores[:, 0]), 0.3,
                                  None if mask is None else _t(mask), literal)
        want = jmn.nms_bev_rotated(jnp.asarray(bev), jnp.asarray(scores[:, 0]),
                                   0.3, None if mask is None else
                                   jnp.asarray(mask), literal)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        tmn._rotated_iou_matrix(_t(bev)).numpy(),
        np.asarray(jmn._rotated_iou_matrix(jnp.asarray(bev))), **F32)


def test_circle_nms_matches_jax():
    # tests/test_parity_ops.py's case
    dets = np.array([[0, 0, 0.9], [0.1, 0, 0.8], [5, 5, 0.7]], np.float32)
    assert tmn.circle_nms(_t(dets), 1.0).tolist() == [True, False, True]
    rng = np.random.default_rng(7)
    dets = np.concatenate([rng.uniform(-5, 5, (60, 2)),
                           np.round(rng.uniform(size=(60, 1)), 1)], 1)
    dets = dets.astype(np.float32)
    dets[1, :2] = dets[0, :2] + np.float32([1.0, 0.0])  # at exactly thresh 1
    dets[1, 2] = dets[0, 2] - np.float32(0.05)
    valid = dets[:, 2] > 0.2
    for thresh in (1.0, 2.5):
        for mask in (None, valid):
            got = tmn.circle_nms(_t(dets), thresh,
                                 None if mask is None else _t(mask))
            want = jmn.circle_nms(jnp.asarray(dets), thresh,
                                  None if mask is None else jnp.asarray(mask))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not tmn.circle_nms(_t(dets[:2]), 1.0)[1]  # d2 <= thresh suppresses


@pytest.mark.parametrize("case", ["parity", "seeded", "tied"])
def test_box3d_multiclass_nms_matches_jax(case):
    if case == "parity":  # tests/test_parity_ops.py's case
        boxes = np.array([[0, 0, 0, 1, 1, 1, 0.0], [0.05, 0, 0, 1, 1, 1, 0.0],
                          [5, 5, 5, 1, 1, 1, 0.3]], np.float32)
        scores = np.array([[0.9, 0.0, 0.1], [0.8, 0.0, 0.2],
                           [0.0, 0.7, 0.3]], np.float32)
        args = (0.1, 0.25, 5)
    else:
        boxes, scores = _nms_boxes(np.random.default_rng(8), 60,
                                   ties=case == "tied")
        args = (0.3, 0.2, 40)
    got = tmn.box3d_multiclass_nms(_t(boxes), _t(scores), *args)
    want = jmn.box3d_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    *args)
    for g, w, name in zip(got, want, ("boxes", "scores", "labels", "valid")):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if case == "parity":
        assert int(got[3].sum()) == 2
        assert set(got[2][got[3]].tolist()) == {0, 1}


def test_pcdet_ious_match_jax():
    rng = np.random.default_rng(9)
    a, b = _boxes7(rng, 12), _boxes7(rng, 9)
    for fn in ("boxes_iou_bev", "boxes_iou3d"):
        np.testing.assert_allclose(
            getattr(tpc, fn)(_t(a), _t(b)).numpy(),
            np.asarray(getattr(jpc, fn)(a, b)), **F32)
    # tests/test_parity_ops.py's height convention
    a1 = np.array([[0, 0, 0.0, 1, 1, 1, 0.3]], np.float32)
    b1 = np.array([[0, 0, 0.4, 1, 1, 1, 0.3]], np.float32)
    np.testing.assert_allclose(float(tpc.boxes_iou3d(_t(a1), _t(b1))[0, 0]),
                               0.6 / (2 - 0.6), rtol=1e-5)


@pytest.mark.parametrize("fn,kw", [("nms", {}), ("nms", dict(pre_maxsize=5)),
                                   ("nms", dict(pre_maxsize=17)),
                                   ("nms_normal", {})])
def test_pcdet_nms_keep_lists_match_jax(fn, kw):
    rng = np.random.default_rng(10)
    boxes = _boxes7(rng, 24)
    scores = rng.uniform(size=24).astype(np.float32)
    scores[::3] = scores[1::3][:8]  # equal scores keep index order
    for thresh in (0.0, 0.3, 0.7):
        got, none = getattr(tpc, fn)(_t(boxes), _t(scores), thresh, **kw)
        want, _ = getattr(jpc, fn)(boxes, scores, thresh, **kw)
        assert none is None and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- sampler
def _assign(rng, n=300, n_gt=6):
    """gt_inds, max_overlaps and labels of an assigner's result."""
    gt_inds = np.where(rng.uniform(size=n) < 0.15,
                       rng.integers(1, n_gt + 1, n), 0)
    return gt_inds, rng.uniform(0, 0.8, n).astype(np.float32), \
        rng.integers(0, 3, n)


@pytest.mark.parametrize("options", [
    dict(num=64),
    dict(num=128, add_gt_as_proposals=True, return_iou=True),
    dict(num=32, neg_pos_ub=1.5, pos_fraction=0.25),
    dict(num=512, neg_piece_fractions=(0.5, 0.3, 0.2),
         neg_iou_piece_thrs=(0.55, 0.3, 0.1))])
def test_iou_neg_piecewise_sampler_copy_matches_original(options):
    rng = np.random.default_rng(11)
    fields = _assign(rng)
    j_assign, t_assign = jsam.AssignResult(*fields), tsam.AssignResult(*fields)
    boxes = rng.normal(size=(300, 7)).astype(np.float32)
    gt = rng.normal(size=(6, 7)).astype(np.float32)
    gt_labels = np.arange(6) % 3
    got = tsam.IoUNegPiecewiseSampler(**options).sample(
        t_assign, boxes, gt, gt_labels, rng=np.random.default_rng(12))
    want = jsam.IoUNegPiecewiseSampler(**options).sample(
        j_assign, boxes, gt, gt_labels, rng=np.random.default_rng(12))
    assert got._fields == want._fields
    _same(tuple(got), tuple(want))
    # an injected random_choice reaches both the same way
    pick = lambda g, k, r: g[:k]  # noqa: E731
    got = tsam.IoUNegPiecewiseSampler(random_choice=pick, **options).sample(
        t_assign, boxes, gt, gt_labels)
    want = jsam.IoUNegPiecewiseSampler(random_choice=pick, **options).sample(
        j_assign, boxes, gt, gt_labels)
    _same(tuple(got), tuple(want))


# ------------------------------------------------------- voxel generator
@pytest.mark.parametrize("cfg", [
    dict(voxel_size=[0.1, 0.1, 0.1], point_cloud_range=[0, 0, 0, 1, 1, 1],
         max_num_points=3, max_voxels=64),
    dict(voxel_size=[0.05, 0.05, 0.1], point_cloud_range=[0, -40, -3, 70.4,
                                                          40, 1],
         max_num_points=5, max_voxels=16000),
    dict(voxel_size=[0.25, 0.25, 0.5], point_cloud_range=[0, 0, 0, 1, 1, 1],
         max_num_points=35)])
def test_voxel_generator_copy_matches_original(cfg):
    rng = np.random.default_rng(13)
    lo, hi = np.array(cfg["point_cloud_range"][:3]), np.array(
        cfg["point_cloud_range"][3:])
    pts = np.concatenate([rng.uniform(lo - 0.1, hi + 0.1, (4000, 3)),
                          rng.uniform(size=(4000, 1))], 1).astype(np.float32)
    gen, jgen = tvg.build_voxel_generator(cfg), jvg.build_voxel_generator(cfg)
    assert repr(gen) == repr(jgen)
    for reverse in (True, False):
        _same(gen.generate(pts, reverse), jgen.generate(pts, reverse))
    _same(gen.generate(pts[:0]), jgen.generate(pts[:0]))
    _same((gen.voxel_size, gen.point_cloud_range, gen.grid_size,
           gen.max_num_points_per_voxel),
          (jgen.voxel_size, jgen.point_cloud_range, jgen.grid_size,
           jgen.max_num_points_per_voxel))


# ------------------------------------------------- outdoor transforms
def test_outdoor_transforms_copy_matches_original():
    """tests/test_data.py:147's inputs through both copies."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (500, 4)).astype(np.float32)
    _same(tot.points_range_filter(pts, (-1, -1, -5, 1, 1, 5)),
          jot.points_range_filter(pts, (-1, -1, -5, 1, 1, 5)))
    boxes = np.array([[0, 0, 0, 1, 1, 1, 0], [9, 9, 0, 1, 1, 1, 0],
                      [0.5, -0.5, 0, 2, 1, 1, 0.4]], np.float32)
    labels = np.array([1, 2, 0])
    _same(tot.object_range_filter(boxes, labels, (-2, -2, 2, 2)),
          jot.object_range_filter(boxes, labels, (-2, -2, 2, 2)))
    pts2 = np.concatenate([np.zeros((10, 3), np.float32) + [0, 0, 0.5],
                           pts[:, :3]]).astype(np.float32)
    for std, rot in (((0.25, 0.25, 0.25), (-0.157, 0.157)),
                     ((1.0, 0.5, 0.1), (-0.7, 0.7))):
        _same(tot.object_noise(pts2, boxes, np.random.default_rng(1), std, rot),
              jot.object_noise(pts2, boxes, np.random.default_rng(1), std, rot))


# --------------------------------------------------------------- dbsampler
def _gt_db_infos(root):
    """tests/test_dbsampler.py's 2-scene dataset, infos only."""
    rng = np.random.default_rng(1)
    infos = []
    for s in range(2):
        pts = rng.uniform(-4, 4, size=(2000, 6)).astype(np.float32)
        boxes = np.array([[-2, -2, 0, 1, 1, 1], [2, 2, 0, 1.5, 1.5, 1]],
                         np.float32)
        for b in boxes:
            blob = b[:3] + rng.uniform(-0.3, 0.3, size=(50, 3))
            pts = np.concatenate([pts, np.concatenate(
                [blob, np.zeros((50, 3))], 1).astype(np.float32)])
        name = f"scene{s:04d}"
        pts.tofile(str(root / f"{name}.bin"))
        infos.append(dict(point_cloud=dict(num_features=6, lidar_idx=name),
                          pts_path=f"{name}.bin",
                          annos=dict(gt_num=2, gt_boxes_upright_depth=boxes,
                                     **{"class": np.array([0, 1])})))
    infos.append(dict(point_cloud=dict(num_features=6, lidar_idx="empty"),
                      pts_path="scene0000.bin", annos=dict(gt_num=0)))
    with open(root / "scannet_infos_train.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root / "scannet_infos_train.pkl"


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def gt_db(tmp_path):
    """Both packages' create_gt_database on one tree, each into its own
    copy; returns the port's copy and the classes."""
    classes = ("chair", "table")
    for name, mod in (("port", tdb), ("jax", jdb)):
        root = tmp_path / name
        root.mkdir()
        info = _gt_db_infos(root)
        mod.create_gt_database(info, root, root, classes, db_prefix="scannet")
    return tmp_path, classes


def test_create_gt_database_copy_writes_the_same_bytes(gt_db):
    tmp_path, _ = gt_db
    port, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert port.keys() == want.keys()
    assert "scannet_dbinfos_train.pkl" in port
    assert sum(k.endswith(".bin") for k in port) == 4 + 2
    for k in want:
        assert port[k] == want[k], k


def test_batch_sampler_copy_matches_original():
    for n, nums in ((5, (3, 3, 2, 4, 5, 1)), (0, (2,)), (7, (7, 1, 8))):
        a = tdb.BatchSampler(list(range(n)), np.random.default_rng(0))
        b = jdb.BatchSampler(list(range(n)), np.random.default_rng(0))
        for k in nums:
            assert a.sample(k) == b.sample(k)


@pytest.mark.parametrize("options", [
    dict(rate=1.0, prepare={"filter_by_min_points": {"chair": 1}},
         sample_groups={"chair": 4, "table": 4}),
    dict(rate=0.5, prepare={"filter_by_difficulty": [-1],
                            "filter_by_min_points": {"table": 60}},
         sample_groups={"table": 6, "chair": 3}),
    dict(rate=1.0, prepare={}, sample_groups={"chair": 1})])
def test_database_sampler_copy_matches_original(gt_db, options):
    tmp_path, classes = gt_db
    gts = (np.array([[-2, -2, -0.5, 1, 1, 1, 0]], np.float32),
           np.array([[0, 0, 0, 1, 1, 1, 0]], np.float32),
           np.zeros((0, 7), np.float32))
    labels = (np.array([0]), np.array([0]), np.zeros((0,), np.int64))

    def make(mod, root):
        return mod.DataBaseSampler(root / "scannet_dbinfos_train.pkl", root,
                                   classes=classes, point_dims=3,
                                   rng=np.random.default_rng(0), **options)

    a, b = make(tdb, tmp_path / "port"), make(jdb, tmp_path / "jax")
    _same(a.db_infos, b.db_infos)
    for gt, lab in zip(gts, labels):
        got, want = a.sample_all(gt, lab), b.sample_all(gt, lab)
        assert (got is None) == (want is None)
        if want is not None:
            _same(got, want)
    rng = np.random.default_rng(2)
    points = rng.uniform(-4, 4, size=(500, 4)).astype(np.float32)
    for gt, lab in zip(gts, labels):
        _same(tot.object_sample(points, gt, lab, a),
              jot.object_sample(points, gt, lab, b))


# ------------------------------------------------------ create_data --gt-db
def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd"])
def test_create_data_gt_db_matches_the_jax_tool(dataset, tmp_path,
                                                monkeypatch, capsys):
    """A raw tree (``chip_smoke.write_raw_scannet`` / ``write_raw_sunrgbd``)
    through the port's ``create_data``; then ``--gt-db`` (no ``--raw-dir``)
    on two copies of the prepared tree, one by the port's CLI and one by
    the JAX tool: the same files, byte for byte, and the same output."""
    if dataset == "scannet":
        scenes = make_synthetic_scenes(3, seed=3, floor_points=2000,
                                       points_per_object=120)
        ids = [s.scene_id for s in scenes]
        raw = chip_smoke.write_raw_scannet(tmp_path / "raw", scenes,
                                           {"train": ids[:2], "val": ids[2:]})
        prep = ["--raw-dir", str(raw), "--splits-dir", str(raw.parent / "meta")]
    else:
        scenes = make_synthetic_scenes(3, seed=4, num_classes=10,
                                       floor_points=2000, yaw_range=1.0)
        raw = chip_smoke.write_raw_sunrgbd(tmp_path / "raw", scenes,
                                           {"train": [0, 2], "val": [1]})
        prep = ["--raw-dir", str(raw)]
    tcreate.main([dataset, *prep, "--out-dir", str(tmp_path / "port")])
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    capsys.readouterr()

    db = tcreate.main([dataset, "--gt-db", "--out-dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out.replace(str(tmp_path / "port"), "<out>")
    monkeypatch.setattr(sys, "argv", ["create_data.py", dataset, "--gt-db",
                                      "--out-dir", str(tmp_path / "jax")])
    _load_jax_tool("create_data").main()
    assert port_out == capsys.readouterr().out.replace(
        str(tmp_path / "jax"), "<out>")
    assert db == tmp_path / "port" / f"{dataset}_dbinfos_train.pkl"
    port, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert port.keys() == want.keys()
    bins = [k for k in port if k.startswith(f"{dataset}_gt_database/")]
    assert bins and all(k.endswith(".bin") for k in bins)
    for k in want:
        assert port[k] == want[k], k
    with open(db, "rb") as f:
        infos = pickle.load(f)
    assert sum(len(v) for v in infos.values()) == len(bins)


def test_create_data_requires_raw_dir_without_gt_db(tmp_path):
    with pytest.raises(SystemExit):
        tcreate.parse_args(["scannet", "--out-dir", str(tmp_path)])
    assert tcreate.parse_args(["scannet", "--gt-db", "--out-dir",
                               str(tmp_path)]).gt_db
