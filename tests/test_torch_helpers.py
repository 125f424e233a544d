"""The public helpers the JAX package exports, held to their JAX
originals on the same numpy-seeded inputs (CPU).

* Box helpers, ``clip_sigmoid``, ``Integral``, ``square_distance``,
  ``weight_reduce``, ``weighted_smooth_l1`` and ``corner_loss_lidar``:
  float32 values within 1e-6.
* ``giou3d``, both ``enclosing`` modes: float32 values within 1e-6;
  float64 gradients (``jax.grad`` under ``jax.enable_x64`` against torch
  autograd) within 1e-10. In the "smallest" mode both packages take
  ``sqrt`` at 0 for a corner paired with itself, so the gradients in x,
  y, the sizes and yaw are NaN on both sides: the NaN pattern must be the
  same, the finite entries within 1e-10.
* ``make_cosine_lr_after_step``: every step of a short schedule within
  1e-7 relative. The port returns Python floats (float64), as torch's
  param groups take them; JAX evaluates the same formula in float32 by
  default, which alone moves it by up to 4.4e-7, so its schedule runs
  under ``jax.enable_x64``.
* ``points_sampler`` D-FPS: identical to the Pallas kernel in interpret
  mode. F-FPS, ``FS`` and FPS with ``valid_mask``: identical to JAX's XLA
  paths (the channel sums are taken in JAX's order).
* ``knn``: JAX ranks by the matmul-form distance, the port by the exact
  form. Indices are equal wherever JAX's distances of the two candidates
  differ by more than 1e-5 relative, and the sorted k distances agree to
  1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.core.boxes as jboxes
import nesie_tpu.core.iou as jiou
import nesie_tpu.losses.basic as jbasic
import nesie_tpu.nn.heads as jheads
import nesie_tpu.nn.layers as jlayers
import nesie_tpu.ops.pointops as jpo
import nesie_tpu.train.state as jstate
import nesie_tpu_torch.core.boxes as tboxes
import nesie_tpu_torch.core.iou as tiou
import nesie_tpu_torch.losses.basic as tbasic
import nesie_tpu_torch.nn.heads as theads
import nesie_tpu_torch.nn.layers as tlayers
import nesie_tpu_torch.ops.pointops as tpo
import nesie_tpu_torch.train.state as tstate

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rng, n, dtype=np.float32):
    return np.concatenate([rng.normal(size=(n, 3)),
                           rng.uniform(0.3, 2.0, (n, 3)),
                           rng.uniform(-3.0, 3.0, (n, 1))], 1).astype(dtype)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpo, "_FPS_IMPL", "pallas")


def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    b = _boxes(rng, 9)
    val = rng.uniform(-10, 10, (4, 5)).astype(np.float32)
    for offset, period in ((0.5, np.pi), (0.0, 2 * np.pi), (1.0, np.pi / 2)):
        np.testing.assert_allclose(
            tboxes.limit_period(_t(val), offset, period).numpy(),
            np.asarray(jboxes.limit_period(jnp.asarray(val), offset, period)),
            **TOL)
    for name in ("gravity_center_of", "box_to_surface"):
        got = getattr(tboxes, name)(_t(b)).numpy()
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(b)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.parametrize("enclosing", ["smallest", "aligned"])
def test_giou3d_matches_jax(enclosing):
    rng = np.random.default_rng(1)
    b1 = _boxes(rng, 12)
    b2 = (b1 + rng.normal(scale=0.3, size=b1.shape)).astype(np.float32)
    b2[:3] = b1[:3]  # identical pairs: loss 0, IoU 1
    b2[3:5, :3] += 5.0  # disjoint pairs: IoU 0
    got = tiou.giou3d(_t(b1), _t(b2), enclosing=enclosing)
    want = jiou.giou3d(jnp.asarray(b1), jnp.asarray(b2), enclosing=enclosing)
    for g, w, what in zip(got, want, ("loss", "iou")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=what)
    np.testing.assert_allclose(got[1][:3].numpy(), 1.0, atol=1e-5)
    assert (got[1][3:5].numpy() == 0).all()

    b1d, b2d = b1.astype(np.float64), b2.astype(np.float64)
    with jax.enable_x64(True):
        jg = jax.grad(lambda a, b: jiou.giou3d(a, b, enclosing=enclosing)
                      [0].sum(), argnums=(0, 1))(jnp.asarray(b1d),
                                                 jnp.asarray(b2d))
    t1, t2 = _t(b1d).requires_grad_(), _t(b2d).requires_grad_()
    tiou.giou3d(t1, t2, enclosing=enclosing)[0].sum().backward()
    for g, w in zip((t1.grad, t2.grad), jg):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, atol=1e-10, rtol=0)
        # the z and height columns are finite in both modes
        assert np.isfinite(g[:, [2, 5]]).all()
        if enclosing == "aligned":
            assert np.isfinite(g).all()


def test_basic_losses_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(2, 6, 7)).astype(np.float32)
    target = rng.normal(size=(2, 6, 7)).astype(np.float32)
    target[0, 1, 2] = target[1, 4, :] = np.nan  # ignored
    code = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    anchor_w = rng.uniform(size=(2, 6)).astype(np.float32)
    cases = [dict(), dict(beta=0.5, code_weights=code),
             dict(beta=1e-6, weights=anchor_w),  # pure L1
             dict(beta=0.2, code_weights=code, weights=anchor_w)]
    for kw in cases:
        got = tbasic.weighted_smooth_l1(
            _t(pred), _t(target),
            **{k: _t(v) if isinstance(v, np.ndarray) and k == "weights" else v
               for k, v in kw.items()}).numpy()
        want = np.asarray(jbasic.weighted_smooth_l1(
            jnp.asarray(pred), jnp.asarray(target),
            **{k: jnp.asarray(v) if k == "weights" else v
               for k, v in kw.items()}))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(kw.keys()))

    loss = rng.uniform(size=(5, 3)).astype(np.float32)
    w = rng.uniform(size=(5, 3)).astype(np.float32)
    for kw in (dict(), dict(reduction="sum"), dict(reduction="none"),
               dict(weight=w), dict(weight=w, avg_factor=3.5),
               dict(weight=w, reduction="sum"), dict(avg_factor=7.0)):
        got = tbasic.weight_reduce(
            _t(loss), **{k: _t(v) if k == "weight" else v
                         for k, v in kw.items()}).numpy()
        want = np.asarray(jbasic.weight_reduce(
            jnp.asarray(loss), **{k: jnp.asarray(v) if k == "weight" else v
                                  for k, v in kw.items()}))
        np.testing.assert_allclose(got, want, **TOL, err_msg=str(kw))

    pb, gb = _boxes(rng, 10), _boxes(rng, 10)
    gb[:4] = pb[:4] + 0.05  # inside smooth-L1's quadratic part
    np.testing.assert_allclose(
        tbasic.corner_loss_lidar(_t(pb), _t(gb)).numpy(),
        np.asarray(jbasic.corner_loss_lidar(jnp.asarray(pb), jnp.asarray(gb))),
        **TOL)


def test_clip_sigmoid_and_integral_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 50)) * 12).astype(np.float32)  # saturates
    np.testing.assert_allclose(
        tlayers.clip_sigmoid(_t(x)).numpy(),
        np.asarray(jlayers.clip_sigmoid(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        tlayers.clip_sigmoid(_t(x), eps=0.1).numpy(),
        np.asarray(jlayers.clip_sigmoid(jnp.asarray(x), eps=0.1)), **TOL)

    logits = rng.normal(size=(3, 7, 9)).astype(np.float32)
    module = theads.Integral(reg_max=8)
    assert not list(module.parameters())
    want = jheads.Integral(reg_max=8).apply({}, jnp.asarray(logits))
    np.testing.assert_allclose(module(_t(logits)).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("args", [(0.008, 3, 4, 12), (0.1, 5, 0, 3),
                                  (2e-3, 1, 6, 6)])
def test_cosine_lr_after_step_matches_jax(args):
    steps = range(args[1] * (args[3] + 2))
    port = tstate.make_cosine_lr_after_step(*args)
    got = np.array([port(s) for s in steps])
    with jax.enable_x64(True):
        jsched = jstate.make_cosine_lr_after_step(*args)
        want = np.array([float(jsched(s)) for s in steps])
    assert all(isinstance(port(s), float) for s in steps)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_square_distance_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(2, 40, 3)).astype(np.float32)
    b = rng.normal(size=(2, 70, 3)).astype(np.float32)
    b[:, :5] = a[:, :5]  # coincident points: near 0, maybe negative
    np.testing.assert_allclose(
        tpo.square_distance(_t(a), _t(b)).numpy(),
        np.asarray(jpo.square_distance(jnp.asarray(a), jnp.asarray(b))),
        **TOL)


def _sampler_clouds():
    rng = np.random.default_rng(5)
    grid = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1)
    grid = grid.reshape(1, -1, 3)
    return {
        "normal": (rng.normal(size=(3, 300, 3)), rng.normal(size=(3, 300, 2)),
                   64),
        "lattice_ties": (grid, np.ones((1, 216, 1)), 100),
        "batch_17": (rng.normal(size=(17, 130, 3)),
                     rng.uniform(size=(17, 130, 1)), 40),
    }


@pytest.mark.parametrize("case", ["normal", "lattice_ties", "batch_17"])
def test_points_sampler_dfps_matches_pallas(pallas_interpret, case):
    xyz, feats, m = _sampler_clouds()[case]
    xyz, feats = xyz.astype(np.float32), feats.astype(np.float32)
    want = jax.jit(lambda x, f: jpo.points_sampler(x, f, m, "D-FPS"))(
        jnp.asarray(xyz), jnp.asarray(feats))
    got = tpo.points_sampler(_t(xyz), _t(feats), m, "D-FPS")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["F-FPS", "FS"])
@pytest.mark.parametrize("case", ["normal", "lattice_ties", "batch_17"])
def test_points_sampler_ffps_matches_jax(mode, case):
    xyz, feats, m = _sampler_clouds()[case]
    xyz, feats = xyz.astype(np.float32), feats.astype(np.float32)
    for f in (feats, None):
        want = jpo.points_sampler(jnp.asarray(xyz),
                                  None if f is None else jnp.asarray(f), m,
                                  mode)
        got = tpo.points_sampler(_t(xyz), None if f is None else _t(f), m,
                                 mode)
        assert got.dtype == torch.int32
        assert got.shape == ((xyz.shape[0], 2 * m) if mode == "FS"
                             else (xyz.shape[0], m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_fps_matches_jax():
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(4, 400, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 400)) > 0.4
    mask[3, 200:] = False  # a padded row
    want = jpo.furthest_point_sample(jnp.asarray(xyz), 96,
                                     valid_mask=jnp.asarray(mask))
    got = tpo.furthest_point_sample(_t(xyz), 96, valid_mask=_t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mask[np.arange(4)[:, None], got[:, 1:].numpy()].all()
    # without a mask it is the plain D-FPS
    np.testing.assert_array_equal(
        tpo.furthest_point_sample(_t(xyz), 96).numpy(),
        np.asarray(jpo.furthest_point_sample(jnp.asarray(xyz), 96)))


def assert_knn_tie_rule(got, want, d_jax, rel=1e-5):
    """``got`` and ``want`` (B, M, k) agree except where JAX's distances
    (B, M, N) of the two candidates are within ``rel``; the sorted k
    distances (JAX's) agree to ``rel``."""
    dg = np.take_along_axis(d_jax, got.astype(np.int64), -1)
    dw = np.take_along_axis(d_jax, want.astype(np.int64), -1)
    scale = np.maximum(np.abs(dw), 1e-12)
    differ = got != want
    assert (np.abs(dg - dw)[differ] <= rel * scale[differ]).all()
    np.testing.assert_allclose(np.sort(dg, -1), np.sort(dw, -1), rtol=rel,
                               atol=0)


@pytest.mark.parametrize("case", ["normal", "lattice", "masked"])
def test_knn_matches_jax_under_tie_rule(case):
    rng = np.random.default_rng(7)
    mask = None
    if case == "lattice":  # exact ties everywhere: lower index first
        grid = np.stack(np.meshgrid(*[np.arange(7.0)] * 3, indexing="ij"), -1)
        src = grid.reshape(1, -1, 3).astype(np.float32)
        qry = src[:, rng.permutation(src.shape[1])[:128]] + 0.5
    else:
        src = rng.normal(size=(2, 500, 3)).astype(np.float32)
        qry = rng.normal(size=(2, 128, 3)).astype(np.float32)
        qry[:, :10] = src[:, :10]  # a query on a source
    if case == "masked":
        mask = rng.uniform(size=src.shape[:2]) > 0.3
    want = np.asarray(jpo.knn(16, jnp.asarray(src), jnp.asarray(qry),
                              None if mask is None else jnp.asarray(mask)))
    got = tpo.knn(16, _t(src), _t(qry),
                  None if mask is None else _t(mask), chunk_target=48)
    assert got.dtype == torch.int32 and got.shape == want.shape
    d_jax = np.maximum(np.asarray(jpo.square_distance(jnp.asarray(qry),
                                                      jnp.asarray(src))), 0)
    if mask is not None:
        d_jax = np.where(mask[:, None, :], d_jax, np.inf)
        assert mask[np.arange(2)[:, None, None], got.numpy()].all()
    assert_knn_tie_rule(got.numpy(), want, d_jax)
    if case == "lattice":
        np.testing.assert_array_equal(got.numpy(), want)


def test_exports_match_jax_inits():
    """Every name the JAX ``ops``, ``core`` and ``losses`` packages export
    is exported by the port's, except the XLA / Pallas switches and the
    voxel stack that the port does not have."""
    not_ported = {"set_fps_impl", "set_ball_query_impl", "set_three_nn_impl",
                  "roiaware_pool3d"}
    for pkg in ("ops", "core", "losses"):
        jmod = importlib.import_module(f"nesie_tpu.{pkg}")
        tmod = importlib.import_module(f"nesie_tpu_torch.{pkg}")
        missing = set(jmod.__all__) - set(tmod.__all__) - not_ported
        assert not missing, (pkg, sorted(missing))
        for name in tmod.__all__:
            assert callable(getattr(tmod, name)), (pkg, name)
