"""The port's modules against their flax counterparts, on the same weights
and the same numpy inputs.

Weights: a seeded port model with randomised BN affine and running stats
is converted to flax variables with ``nesie_tpu.convert_torch``; the port
module under test is then loaded from those variables through
``state_dict_from_flax``. The JAX side runs its Pallas kernels in
interpret mode, so neighbour indices agree exactly.

Tolerance: atol 1e-4, rtol 1e-4 in float32 (the matmuls sum in another
order on the two sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.ops.pointops as jpo
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.nn.heads import ReliableConvBboxHead as JReliableHead
from nesie_tpu.nn.layers import MiniPointNet as JMiniPointNet
from nesie_tpu.nn.layers import PointMLP as JPointMLP
from nesie_tpu.nn.nesie_head import NesieHead as JNesieHead
from nesie_tpu.nn.pointnet2 import PointFPModule as JFPModule
from nesie_tpu.nn.pointnet2 import PointSAModule as JSAModule
from nesie_tpu.nn.side_pooling import SidePooling as JSidePooling
from nesie_tpu.nn.vote import VoteModule as JVoteModule
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.nn.heads import integral_expectation
from nesie_tpu_torch.nn.side_pooling import make_box_grids

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(
    reg_max=8,
    num_proposal=128,
    num_points=(256, 128, 128, 128),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
SEED_DIM = TINY["fp_channels"][-1][-1]


@pytest.fixture(scope="module")
def weights():
    """(port model loaded via state_dict_from_flax, params, batch_stats)."""
    src = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(0)
    init_weights_(src, gen)
    randomize_bn_(src, gen)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    model = VoteNetNesie(**TINY)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model.eval(), params, stats


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")


def _vars(params, stats):
    return {"params": params, "batch_stats": stats}


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_point_mlp(weights):
    model, p, s = weights
    x = np.random.default_rng(0).normal(size=(2, 16, 8, 4))
    want = JPointMLP((16, 16, 32)).apply(
        _vars(p["backbone"]["sa0"]["mlp"], s["backbone"]["sa0"]["mlp"]), x)
    with torch.no_grad():
        got = model.backbone.SA_modules[0].mlps[0](_t(x))
    _close(got, want)


def test_mini_pointnet(weights):
    model, p, s = weights
    x = np.random.default_rng(1).normal(size=(2, 5, 16, 3 + SEED_DIM))
    g = ("bbox_head", "grid_conv", "side_mini2")
    want = JMiniPointNet(128).apply(
        _vars(p[g[0]][g[1]][g[2]], s[g[0]][g[1]][g[2]]), x)
    with torch.no_grad():
        got = model.bbox_head.grid_conv.mlps_before[2](_t(x))
    _close(got, want)


@pytest.mark.parametrize("stage", [0, 1])
def test_sa_module(weights, pallas_interpret, stage):
    """SA1 samples by FPS; SA2 takes the arange (FPS prefix order)."""
    model, p, s = weights
    rng = np.random.default_rng(2 + stage)
    n = 512 if stage == 0 else 256
    cin = 1 if stage == 0 else 32
    xyz = rng.uniform(size=(2, n, 3)).astype(np.float32)
    feats = rng.normal(size=(2, n, cin)).astype(np.float32)
    jmod = JSAModule(TINY["num_points"][stage], (0.2, 0.4)[stage],
                     TINY["num_samples"][stage], TINY["sa_channels"][stage],
                     input_fps_ordered=stage > 0)
    name = f"sa{stage}"
    fn = jax.jit(lambda v, a, b: jmod.apply(v, a, b))
    w_xyz, w_feat, w_idx = fn(
        _vars(p["backbone"][name], s["backbone"][name]), xyz, feats)
    with torch.no_grad():
        g_xyz, g_feat, g_idx = model.backbone.SA_modules[stage](
            _t(xyz), _t(feats))
    np.testing.assert_array_equal(g_idx.numpy(), _np(w_idx))
    np.testing.assert_array_equal(g_xyz.numpy(), _np(w_xyz))
    _close(g_feat, w_feat)


def test_fp_module(weights, pallas_interpret):
    model, p, s = weights
    rng = np.random.default_rng(4)
    tgt = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    src = rng.uniform(size=(2, 128, 3)).astype(np.float32)
    tf = rng.normal(size=(2, 256, 32)).astype(np.float32)
    sf = rng.normal(size=(2, 128, 32)).astype(np.float32)
    jmod = JFPModule(TINY["fp_channels"][1])
    want = jax.jit(lambda v, *a: jmod.apply(v, *a))(
        _vars(p["backbone"]["fp1"], s["backbone"]["fp1"]), tgt, src, tf, sf)
    with torch.no_grad():
        got = model.backbone.FP_modules[1](_t(tgt), _t(src), _t(tf), _t(sf))
    _close(got, want)


def test_vote_module(weights):
    model, p, s = weights
    rng = np.random.default_rng(5)
    xyz = rng.uniform(size=(2, 64, 3))
    feats = rng.normal(size=(2, 64, SEED_DIM))
    hp, hs = p["bbox_head"]["vote_module"], s["bbox_head"]["vote_module"]
    want = JVoteModule(SEED_DIM, conv_channels=(SEED_DIM, SEED_DIM)).apply(
        _vars(hp, hs), xyz, feats)
    with torch.no_grad():
        got = model.bbox_head.vote_module(_t(xyz), _t(feats))
    for g, w in zip(got, want):
        _close(g, w)


def test_reliable_conv_bbox_head(weights):
    model, p, s = weights
    feats = np.random.default_rng(6).normal(size=(2, 32, 128))
    jmod = JReliableHead(shared_conv_channels=(128, 128), num_cls_out=20,
                         num_bbox_out=6 * 9, num_heading_out=2, reg_max=8)
    want = jmod.apply(_vars(p["bbox_head"]["conv_pred"],
                            s["bbox_head"]["conv_pred"]), feats)
    with torch.no_grad():
        got = model.bbox_head.conv_pred(_t(feats))
    for g, w in zip(got, want):
        _close(g, w)


def test_integral_expectation():
    from nesie_tpu.nn.heads import integral_expectation as j_integral

    logits = np.random.default_rng(7).normal(size=(2, 8, 6, 33))
    _close(integral_expectation(_t(logits), 32),
           j_integral(jnp.asarray(logits, jnp.float32), 32))


@pytest.mark.parametrize("heading", ["zero", "random"])
def test_side_pooling(weights, pallas_interpret, heading):
    """heading 'zero' is the ScanNet path; 'random' exercises the
    rotation used by SUN RGB-D."""
    model, p, s = weights
    rng = np.random.default_rng(8)
    B, P = 2, 16
    center = rng.uniform(size=(B, P, 3)).astype(np.float32)
    size = rng.uniform(0.2, 1.0, size=(B, P, 3)).astype(np.float32)
    yaw = (np.zeros((B, P)) if heading == "zero"
           else rng.uniform(-np.pi, np.pi, size=(B, P))).astype(np.float32)
    seed_xyz = rng.uniform(size=(B, 128, 3)).astype(np.float32)
    seed_feats = rng.normal(size=(B, 128, SEED_DIM)).astype(np.float32)
    logits = rng.normal(size=(B, P, 6, 9)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jmod = JSidePooling(num_classes=18, seed_feat_dim=SEED_DIM, reg_max=8)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a))(
        _vars(p["bbox_head"]["grid_conv"], s["bbox_head"]["grid_conv"]),
        center, size, yaw, seed_xyz, seed_feats, probs)
    with torch.no_grad():
        got = model.bbox_head.grid_conv(
            _t(center), _t(size), _t(yaw), _t(seed_xyz), _t(seed_feats),
            _t(probs))
    for g, w in zip(got, want):
        _close(g, w)


def test_make_box_grids():
    from nesie_tpu.nn.side_pooling import make_box_grids as j_grids

    rng = np.random.default_rng(9)
    c, sz = rng.normal(size=(2, 3, 3)), rng.uniform(size=(2, 3, 3))
    yaw = rng.uniform(-3, 3, size=(2, 3))
    want = j_grids(*(jnp.asarray(a, jnp.float32) for a in (c, sz, yaw)), 4)
    got = make_box_grids(_t(c), _t(sz), _t(yaw), 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6, rtol=1e-6)


def test_nesie_head(weights, pallas_interpret):
    model, p, s = weights
    rng = np.random.default_rng(10)
    B, n = 2, 128
    seed_xyz = rng.uniform(size=(B, n, 3)).astype(np.float32)
    seed_feats = rng.normal(size=(B, n, SEED_DIM)).astype(np.float32)
    seed_idx = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    jmod = JNesieHead(num_classes=18, reg_max=8, num_proposal=128,
                      seed_feat_dim=SEED_DIM,
                      vote_conv_channels=(SEED_DIM, SEED_DIM))

    def run(v, xyz, f, i):
        fd = dict(fp_xyz=[xyz], fp_features=[f], fp_indices=[i])
        return jmod.apply(v, fd, "seed", jax.random.PRNGKey(0), train=False,
                          with_jitter=False)

    want = jax.jit(run)(_vars(p["bbox_head"], s["bbox_head"]), seed_xyz,
                        seed_feats, seed_idx)
    fd = dict(fp_xyz=[_t(seed_xyz)], fp_features=[_t(seed_feats)],
              fp_indices=[torch.from_numpy(seed_idx)])
    with torch.no_grad():
        got = model.bbox_head(fd)
    assert set(got) == set(want)
    for k in got:
        if got[k].dtype == torch.int32:
            np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
        else:
            _close(got[k], want[k])


def test_nesie_head_refuses_unported_modes(weights):
    """A sample mode that the JAX head lacks is refused; ``random`` needs
    its indices or a generator, jittered proposals their noise or a
    generator. (The four modes: tests/test_torch_options.py.)"""
    model, _, _ = weights
    with pytest.raises(ValueError, match="not one of"):
        model.bbox_head({}, "fps")
    with pytest.raises(ValueError, match="sample_indices or a generator"):
        model.bbox_head({}, "random")
    with pytest.raises(ValueError, match="noise or a generator"):
        model.bbox_head({}, "seed", with_jitter=True)


def test_train_mode_bn_refuses(weights):
    """Train-mode BN runs on batch statistics and updates the running
    statistics flax's way; under ``frozen_bn_stats`` it refuses the
    update. (Parity with flax: tests/test_torch_train_modules.py.)"""
    from nesie_tpu_torch.nn.layers import frozen_bn_stats

    model, _, _ = weights
    mlp = model.backbone.SA_modules[0].mlps[0]
    bn = mlp.layer0.bn
    saved = {k: v.clone() for k, v in mlp.state_dict().items()}
    before = saved["layer0.bn.running_mean"]
    mlp.train()
    try:
        with torch.no_grad(), frozen_bn_stats(mlp):
            mlp(torch.zeros(1, 2, 3, 4))
        assert torch.equal(bn.running_mean, before)
        with torch.no_grad():
            out = mlp(torch.zeros(1, 2, 3, 4))
        assert torch.isfinite(out).all()
        torch.testing.assert_close(bn.running_mean, 0.9 * before)
    finally:
        mlp.eval()
        mlp.load_state_dict(saved)
