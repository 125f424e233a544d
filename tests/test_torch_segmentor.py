"""The port's segmentation tail against the JAX package: ScoreNet, PAConv
and PAConvSAModule (with train-mode BN statistics), PointNet2Segmentor
with and without its auxiliary head, ``inference_segmentor``, the
segmentation losses, and the numpy copies (``slide_inference``,
``seg_metrics``, ``tta``). Weights and inputs as in
``test_torch_tail_support``.

Tolerances: float32 forwards atol 1e-4, rtol 1e-4 with identical
neighbour indices; float64 losses and gradients (against
``jax.value_and_grad`` of the same function) atol 1e-12, rtol 1e-9; the
numpy copies exactly. The slice test (a narrow segmentor block through
forward, ``encoder_decoder_loss`` with aux and Lovasz, and gradient in
train mode, float64) holds the loss to the same and the gradients and BN
statistics to atol 1e-10, rtol 1e-8 (the train-mode BNs' summation
orders, as in ``test_torch_votehead``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tail_support as T
from nesie_tpu import apis as japis
from nesie_tpu.eval import seg_metrics as jseg
from nesie_tpu.eval import tta as jtta
from nesie_tpu.nn import segmentor as jsegm
from nesie_tpu.nn.pointnet2 import PAConvSAModule as JPAConvSA
from nesie_tpu.ops.paconv import PAConv as JPAConv
from nesie_tpu.ops.paconv import ScoreNet as JScoreNet
from nesie_tpu.ops.paconv import assign_score_withk as j_assign
from nesie_tpu_torch import apis as tapis
from nesie_tpu_torch.convert import module_state_dict_from_flax, state_dict_from_flax
from nesie_tpu_torch.eval import seg_metrics as tseg
from nesie_tpu_torch.eval import tta as ttta
from nesie_tpu_torch.nn import segmentor as tsegm
from nesie_tpu_torch.nn.pointnet2 import PAConvSAModule
from nesie_tpu_torch.ops.paconv import PAConv, ScoreNet, assign_score_withk
from test_torch_tail_support import pallas_interpret  # noqa: F401

torch.set_num_threads(1)

NC = 5
# tests/test_extras.py's narrow segmentor
TINY = dict(num_classes=NC, num_points=(32, 16, 8, 8),
            num_samples=(8, 8, 4, 4), sa_channels=((8, 8),) * 4,
            fp_channels=((8, 8),) * 4, head_channels=8)
SLICE_TOL64 = dict(atol=1e-10, rtol=1e-8)


def _grouped(seed, b=2, n=8, k=6, c=5):
    """Grouped features (b, n, k, c) and relative xyz (b, n, k, 3), slot 0
    the centre (offset 0)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, k, c)).astype(np.float32)
    xyz = rng.uniform(-0.2, 0.2, (b, n, k, 3)).astype(np.float32)
    xyz[:, :, 0] = 0.0
    return feats, xyz


def _load(mod, params, stats):
    mod.load_state_dict(module_state_dict_from_flax(params, stats)
                        if "weight_bank" not in params else
                        _paconv_sd(params, stats), strict=True)
    return mod


def _paconv_sd(params, stats):
    """A bare PAConv's variables, through PAConvSAModule's mapping."""
    sd = module_state_dict_from_flax({"layer0": params}, {"layer0": stats})
    return {k[len("mlps.0.layer0."):]: v for k, v in sd.items()}


# ---- PAConv ----------------------------------------------------------------------

def test_assign_score_withk():
    rng = np.random.default_rng(0)
    scores = rng.uniform(size=(2, 6, 4, 3)).astype(np.float32)
    point_feats = rng.normal(size=(2, 10, 3, 5)).astype(np.float32)
    center_feats = rng.normal(size=(2, 10, 3, 5)).astype(np.float32)
    knn = rng.integers(0, 10, (2, 6, 4)).astype(np.int32)
    want = j_assign(*(jnp.asarray(a) for a in (scores, point_feats,
                                               center_feats, knn)))
    got = assign_score_withk(T.t32(scores), T.t32(point_feats),
                             T.t32(center_feats), torch.from_numpy(knn))
    T.close(got, want)


@pytest.mark.parametrize("score_norm,last_bn", [("softmax", False),
                                                ("sigmoid", True)])
def test_scorenet(score_norm, last_bn):
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 7)).astype(np.float32)
    jmod = JScoreNet((7, 16, 16, 8), last_bn=last_bn, score_norm=score_norm,
                     temp_factor=0.5)
    params, stats = T.flax_variables(jmod, x)
    want = jmod.apply(T.jvars(params, stats), x)
    mod = ScoreNet((7, 16, 16, 8), last_bn=last_bn, score_norm=score_norm,
                   temp_factor=0.5)
    sd = module_state_dict_from_flax(
        {"layer0": {"weight_bank": np.zeros((2, 2)), "scorenet": params}},
        {"layer0": {"scorenet": stats}})
    mod.load_state_dict({k[len("mlps.0.layer0.scorenet."):]: v
                         for k, v in sd.items() if ".scorenet." in k},
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(T.t32(x))
    T.close(got, want)


@pytest.mark.parametrize("scorenet_input,kernel_input", [
    ("w_neighbor_dist", "w_neighbor"), ("w_neighbor", "identity"),
    ("identity", "w_neighbor")])
@pytest.mark.parametrize("train", [False, True])
def test_paconv(scorenet_input, kernel_input, train):
    feats, xyz = _grouped(2)
    kw = dict(num_kernels=4, scorenet_input=scorenet_input,
              kernel_input=kernel_input, scorenet_mlp=(8, 16))
    jmod = JPAConv(5, 12, **kw)
    params, stats = T.flax_variables(jmod, feats, xyz)
    want, new = jmod.apply(T.jvars(params, stats), feats, xyz, train=train,
                           mutable=["batch_stats"])
    mod = _load(PAConv(5, 12, **kw), params, stats).train(train)
    with torch.no_grad():
        got = mod(T.t32(feats), T.t32(xyz))
    T.close(got, want)
    if train:  # the updated running statistics
        sd = _paconv_sd(params, T._numpy(new["batch_stats"]))
        for k, v in mod.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                T.close(v, sd[k], msg=k)


def _sa_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(2, 256, 3)).astype(np.float32),
            rng.normal(size=(2, 256, 5)).astype(np.float32))


@pytest.mark.parametrize("train,interpret", [(False, True), (True, False)])
def test_paconv_sa_module(request, train, interpret):
    if interpret:
        request.getfixturevalue("pallas_interpret")
    xyz, feats = _sa_inputs(3)
    kw = dict(num_point=32, radius=0.2, num_sample=8,
              mlp_channels=(5, 16, 24), paconv_num_kernels=(4, 4))
    jmod = JPAConvSA(**kw)
    params, stats = T.flax_variables(jmod, xyz, feats)
    (w_xyz, w_feat, w_idx), new = jax.jit(
        lambda v, a, b: jmod.apply(v, a, b, train=train,
                                   mutable=["batch_stats"]))(
        T.jvars(params, stats), xyz, feats)
    mod = PAConvSAModule(32, 0.2, 8, (5, 16, 24), (4, 4))
    _load(mod, params, stats).train(train)
    with torch.no_grad():
        g_xyz, g_feat, g_idx = mod(T.t32(xyz), T.t32(feats))
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_xyz.numpy(), np.asarray(w_xyz))
    T.close(g_feat, w_feat)
    if train:
        sd = module_state_dict_from_flax(params, T._numpy(new["batch_stats"]))
        for k, v in mod.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                T.close(v, sd[k], msg=k)


# ---- the segmentor ---------------------------------------------------------------

def _block(seed, b=2, n=128):
    return np.random.default_rng(seed).uniform(size=(b, n, 4)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_segmentor(with_aux, dropout):
    jmod = jsegm.PointNet2Segmentor(with_aux=with_aux, dropout=dropout,
                                    **TINY)
    return jmod, *T.flax_variables(jmod, _block(99))


def _segmentors(with_aux, dropout=0.5):
    """(JAX module, params, stats, port module loaded from them)."""
    jmod, params, stats = _jax_segmentor(with_aux, dropout)
    mod = tsegm.PointNet2Segmentor(with_aux=with_aux, dropout=dropout,
                                   **TINY)
    mod.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jmod, params, stats, mod


@pytest.mark.parametrize("with_aux,interpret", [(False, True), (True, False)])
def test_segmentor_forward_eval(request, with_aux, interpret):
    if interpret:
        request.getfixturevalue("pallas_interpret")
    jmod, params, stats, mod = _segmentors(with_aux)
    pts = _block(4)
    want = jax.jit(lambda v, p: jmod.apply(v, p))(T.jvars(params, stats), pts)
    with torch.no_grad():
        got = mod.eval()(T.t32(pts))
    if with_aux:
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["aux_indices"].numpy(),
                                      np.asarray(want["aux_indices"]))
        T.close(got["aux_logits"], want["aux_logits"])
        got, want = got["seg_logits"], want["seg_logits"]
    assert got.shape == (2, 128, NC)
    T.close(got, want)


def test_segmentor_dropout_needs_generator():
    *_, mod = _segmentors(False)
    with pytest.raises(ValueError, match="torch.Generator"):
        mod.train()(T.t32(_block(5)))
    out = mod(T.t32(_block(5)), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def test_inference_segmentor():
    jmod, params, stats, mod = _segmentors(True)
    cloud = np.random.default_rng(6).uniform(0, 2, (500, 3)).astype(
        np.float32)
    want = japis.inference_segmentor(jmod, T.jvars(params, stats), cloud,
                                     num_points=128, seed=3)
    got = tapis.inference_segmentor(mod.eval(), cloud, num_points=128, seed=3)
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["semantic_mask"], want["semantic_mask"])
    T.close(got["seg_logits"], want["seg_logits"])


# ---- losses (float64) ------------------------------------------------------------

def _labels(rng, shape, ignore_share=0.3):
    labels = rng.integers(0, NC, shape)
    labels[rng.uniform(size=shape) < ignore_share] = 255
    return labels


@pytest.mark.parametrize("use_lovasz", [False, True])
def test_segmentation_loss_float64(use_lovasz):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 40, NC))
    labels = _labels(rng, (2, 40))
    with jax.enable_x64(True):
        jval, jgrad = jax.value_and_grad(
            lambda x: jsegm.segmentation_loss(x, jnp.asarray(labels),
                                              use_lovasz=use_lovasz))(
            T.jnp64(logits))
    x = torch.from_numpy(logits).requires_grad_()
    val = tsegm.segmentation_loss(x, torch.from_numpy(labels),
                                  use_lovasz=use_lovasz)
    val.backward()
    T.close(val, jval, T.TOL64)
    T.close(x.grad, jgrad, T.TOL64)


@pytest.mark.parametrize("use_lovasz", [False, True])
def test_encoder_decoder_loss_float64(use_lovasz):
    rng = np.random.default_rng(8)
    out = dict(seg_logits=rng.normal(size=(2, 40, NC)),
               aux_logits=rng.normal(size=(2, 12, NC)))
    aux_idx = np.stack([rng.permutation(40)[:12] for _ in range(2)]
                       ).astype(np.int32)
    labels = _labels(rng, (2, 40))
    with jax.enable_x64(True):
        jval, jgrad = jax.value_and_grad(
            lambda d: jsegm.encoder_decoder_loss(
                {**d, "aux_indices": jnp.asarray(aux_idx)},
                jnp.asarray(labels), use_lovasz=use_lovasz))(
            {k: T.jnp64(v) for k, v in out.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    val = tsegm.encoder_decoder_loss(
        {**tp, "aux_indices": torch.from_numpy(aux_idx)},
        torch.from_numpy(labels), use_lovasz=use_lovasz)
    val.backward()
    T.close(val, jval, T.TOL64)
    for k, v in tp.items():
        T.close(v.grad, jgrad[k], T.TOL64, msg=k)


def test_lovasz_softmax_all_classes_float64():
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(NC), 50)
    labels = rng.integers(0, NC - 1, 50)  # the last class absent
    for classes in ("present", "all"):
        from nesie_tpu.losses.consistency import lovasz_softmax as jl
        from nesie_tpu_torch.losses.consistency import lovasz_softmax as tl
        with jax.enable_x64(True):
            jval, jgrad = jax.value_and_grad(
                lambda p: jl(p, jnp.asarray(labels), NC, classes))(
                T.jnp64(probs))
        x = torch.from_numpy(probs).requires_grad_()
        val = tl(x, torch.from_numpy(labels), NC, classes)
        val.backward()
        T.close(val, jval, T.TOL64, msg=classes)
        T.close(x.grad, jgrad, T.TOL64, msg=classes)


# ---- the numpy copies ------------------------------------------------------------

def _linear_apply_fn(seed, width):
    """A deterministic stand-in model: a fixed random linear map of every
    point's features."""
    w = np.random.default_rng(seed).normal(size=(width, NC)).astype(
        np.float32)
    return lambda chunk: np.asarray(chunk, np.float32) @ w


@pytest.mark.parametrize("use_normalized_coord", [False, True])
def test_slide_inference_equals_jax(use_normalized_coord):
    pts = np.random.default_rng(10).uniform(0, 4, (3000, 4)).astype(
        np.float32)
    width = 7 if use_normalized_coord else 4
    kw = dict(num_points=256, block_size=1.5, sample_rate=0.5, batch_size=3,
              use_normalized_coord=use_normalized_coord, seed=4)
    want = jsegm.slide_inference(pts, _linear_apply_fn(0, width), **kw)
    got = tsegm.slide_inference(pts, _linear_apply_fn(0, width), **kw)
    np.testing.assert_array_equal(got, want)


def test_slide_inference_through_the_segmentor():
    """``segmentor_apply_fn`` on the port model against the JAX model's
    apply, through both ``slide_inference``s."""
    jmod, params, stats, mod = _segmentors(False)
    pts = np.random.default_rng(11).uniform(0, 2.5, (600, 4)).astype(
        np.float32)
    jfn = jax.jit(lambda p: jmod.apply(T.jvars(params, stats), p))
    kw = dict(num_points=128, block_size=1.5, batch_size=2, seed=1)
    want = jsegm.slide_inference(pts, jfn, **kw)
    got = tsegm.slide_inference(
        pts, tsegm.segmentor_apply_fn(mod.eval(), "cpu"), **kw)
    T.close(got, want)


def test_seg_metrics_equal_jax():
    rng = np.random.default_rng(12)
    preds = [rng.integers(0, NC, 300) for _ in range(3)]
    gts = [_labels(rng, (300,), 0.1) for _ in range(3)]
    for got, want in zip(tseg.intersection_and_union(preds[0], gts[0], NC),
                         jseg.intersection_and_union(preds[0], gts[0], NC)):
        np.testing.assert_array_equal(got, want)
    got, want = tseg.seg_eval(preds, gts, NC), jseg.seg_eval(preds, gts, NC)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_tta_equals_jax():
    rng = np.random.default_rng(13)
    views = ttta.make_tta_views(flip=True, scales=(1.0, 0.9))
    assert views == jtta.make_tta_views(flip=True, scales=(1.0, 0.9))
    pts = rng.normal(size=(50, 4))
    results = []
    base = np.concatenate([rng.uniform(-2, 2, (6, 3)),
                           rng.uniform(0.3, 1.0, (6, 3)),
                           rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    for hf, vf, sc in views:
        np.testing.assert_array_equal(ttta.apply_view_np(pts, hf, vf, sc),
                                      jtta.apply_view_np(pts, hf, vf, sc))
        boxes = base + rng.normal(scale=0.05, size=base.shape)
        np.testing.assert_array_equal(
            ttta.mapping_back_np(boxes, hf, vf, sc),
            jtta.mapping_back_np(boxes, hf, vf, sc))
        results.append(dict(boxes=boxes, scores=rng.uniform(size=6),
                            labels=rng.integers(0, 3, 6)))
    results[3] = dict(boxes=np.zeros((0, 7)), scores=np.zeros(0),
                      labels=np.zeros(0, np.int64))
    got = ttta.merge_aug_bboxes_3d(results, views, nms_thr=0.25)
    want = jtta.merge_aug_bboxes_3d(results, views, nms_thr=0.25)
    assert 0 < len(got["boxes"]) < 7 * len(views)
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


# ---- the slice: a narrow segmentor block, forward + loss + gradient -------------

def test_segmentor_slice_float64_train_step():
    jmod, params, stats, _ = _segmentors(True, dropout=0.0)
    params, stats = T.to64(params), T.to64(stats)
    pts = _block(14).astype(np.float64)
    labels = _labels(np.random.default_rng(15), (2, 128))

    with T.jax_float64():
        def jloss(prm):
            out, new = jmod.apply({"params": prm, "batch_stats": stats},
                                  T.jnp64(pts), train=True,
                                  mutable=["batch_stats"])
            return jsegm.encoder_decoder_loss(out, jnp.asarray(labels),
                                              use_lovasz=True), (out, new)

        (jval, (jout, jnew)), jgrad = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jax.tree.map(T.jnp64, params))

    mod = tsegm.PointNet2Segmentor(with_aux=True, dropout=0.0, **TINY)
    mod.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    mod = mod.double().train()
    out = mod(torch.from_numpy(pts))
    val = tsegm.encoder_decoder_loss(out, torch.from_numpy(labels),
                                     use_lovasz=True)
    val.backward()
    np.testing.assert_array_equal(out["aux_indices"].numpy(),
                                  np.asarray(jout["aux_indices"]))
    T.close(val, jval, T.TOL64)
    assert mod.aux_cls.weight.grad.abs().sum() > 0
    T.assert_grads_match(mod, jgrad, state_dict_from_flax, SLICE_TOL64)
    want_stats = T.to_port64(state_dict_from_flax, params,
                             T.to64(jnew["batch_stats"]))
    for k, v in mod.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            T.close(v, want_stats[k], SLICE_TOL64, msg=k)
