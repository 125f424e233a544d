"""The port's point-based detection tail against the JAX package: the SA
options and MSG, the conv heads' branch stacks (GroupNorm), the legacy
VoteHead with its bin coder and loss, and the consistency and Lovasz
losses. Weights and inputs as in ``test_torch_tail_support``.

Tolerances: float32 forwards atol 1e-4, rtol 1e-4 with identical
neighbour indices; float64 losses and gradients (against
``jax.value_and_grad`` of the same function) atol 1e-12, rtol 1e-9.
The slice test (a narrow VoteHead detector batch through forward, loss
and gradient in train mode, float64) holds the loss terms to the same and
the parameter gradients and BN statistics to atol 1e-10, rtol 1e-8: the
train-mode BNs of 17 layers carry the two sides' summation orders into
gradients of magnitude 1e3, whose last digits then differ by ~1e-9
relative.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tail_support as T
from nesie_tpu.losses import consistency as jcons
from nesie_tpu.nn.heads import BaseConvBboxHead as JBaseHead
from nesie_tpu.nn.heads import ReliableConvBboxHead as JReliableHead
from nesie_tpu.nn.pointnet2 import PointNet2SASSG as JSASSG
from nesie_tpu.nn.pointnet2 import PointSAModule as JSA
from nesie_tpu.nn.pointnet2 import PointSAModuleMSG as JMSG
from nesie_tpu.nn.vote_head import BinBoxCoder as JCoder
from nesie_tpu.nn.vote_head import VoteHead as JVoteHead
from nesie_tpu.train import targets as jtg
from nesie_tpu.train import votehead_loss as jvl
from nesie_tpu_torch.convert import module_state_dict_from_flax, state_dict_from_flax
from nesie_tpu_torch.losses import consistency as tcons
from nesie_tpu_torch.nn.heads import BaseConvBboxHead, ReliableConvBboxHead
from nesie_tpu_torch.nn.pointnet2 import PointSAModule, PointSAModuleMSG
from nesie_tpu_torch.nn.vote_head import VoteNet
from nesie_tpu_torch.train import targets as ttg
from nesie_tpu_torch.train import votehead_loss as tvl
from test_torch_tail_support import pallas_interpret  # noqa: F401

torch.set_num_threads(1)

# tests/test_vote_head.py's narrow detector
C, B, N, P = 4, 2, 256, 16
TINY = dict(num_points=(64, 32, 16, 16), num_samples=(8, 8, 4, 4),
            sa_channels=((16, 16, 32),) + ((32, 32, 32),) * 3,
            fp_channels=((32, 32), (32, 32)))
MAX_GT = 8
SLICE_TOL64 = dict(atol=1e-10, rtol=1e-8)


class JVoteNet(fnn.Module):
    """The JAX package's PointNet2SASSG + VoteHead, named as the port's
    ``VoteNet`` (``backbone``, ``bbox_head``)."""

    num_dir_bins: int = 1
    with_rot: bool = False

    @fnn.compact
    def __call__(self, pts, sample_mod, train=False):
        feat = JSASSG(in_channels=4, name="backbone", **TINY)(pts, train=train)
        return JVoteHead(num_classes=C, num_sizes=C, num_proposal=P,
                         seed_feat_dim=32, num_dir_bins=self.num_dir_bins,
                         with_rot=self.with_rot, name="bbox_head")(
            feat, sample_mod, None, train=train)


def _port_votenet(params, stats, num_dir_bins=1, with_rot=False):
    model = VoteNet(num_classes=C, num_sizes=C, num_proposal=P,
                    num_dir_bins=num_dir_bins, with_rot=with_rot, **TINY)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model


def _points(seed, b=B, n=N):
    return np.random.default_rng(seed).uniform(size=(b, n, 4)).astype(
        np.float32)


def _check_outputs(got: dict, want: dict, tol=T.TOL):
    assert set(got) == set(want)
    for k in got:
        if got[k].dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        else:
            T.close(got[k], want[k], tol, msg=k)


# ---- set abstraction ---------------------------------------------------------

def _sa_case(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 5)).astype(np.float32)
    return xyz, feats


@pytest.mark.parametrize("use_xyz,normalize_xyz,pool,features,interpret", [
    (True, True, "max", True, False), (True, False, "avg", True, True),
    (False, True, "max", True, False), (False, False, "avg", True, False),
    (True, False, "max", False, False), (False, True, "avg", False, False)])
def test_sa_module_options(request, use_xyz, normalize_xyz, pool, features,
                           interpret):
    if interpret:
        request.getfixturevalue("pallas_interpret")
    xyz, feats = _sa_case(1)
    f = feats if features else None
    jmod = JSA(32, 0.3, 8, (16, 16, 24), use_xyz=use_xyz,
               normalize_xyz=normalize_xyz, pool=pool)
    params, stats = T.flax_variables(jmod, xyz, f)
    want = jax.jit(lambda v, a, b: jmod.apply(v, a, b))(
        T.jvars(params, stats), xyz, f)
    mod = PointSAModule(32, 0.3, 8, 5 if features else 0, (16, 16, 24),
                        use_xyz=use_xyz, normalize_xyz=normalize_xyz,
                        pool=pool)
    mod.load_state_dict(module_state_dict_from_flax(params, stats),
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(T.t32(xyz), T.t32(f) if features else None)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    T.close(got[1], want[1])


@pytest.mark.parametrize("interpret", [False, True])
def test_sa_module_msg(request, interpret):
    if interpret:
        request.getfixturevalue("pallas_interpret")
    xyz, feats = _sa_case(2)
    jmod = JMSG(num_point=32, radii=(0.2, 0.4), sample_nums=(8, 16),
                mlp_channels=((16, 16), (16, 32)))
    params, stats = T.flax_variables(jmod, xyz, feats)
    want = jax.jit(lambda v, a, b: jmod.apply(v, a, b))(
        T.jvars(params, stats), xyz, feats)
    mod = PointSAModuleMSG(32, (0.2, 0.4), (8, 16), 5, ((16, 16), (16, 32)))
    mod.load_state_dict(module_state_dict_from_flax(params, stats),
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(T.t32(xyz), T.t32(feats))
    assert got[1].shape == (2, 32, 48)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    T.close(got[1], want[1])


def test_sa_module_defaults_unchanged():
    """The options' defaults are the shipped modules' arithmetic: radius-
    normalised xyz in front, max-pool."""
    xyz, feats = _sa_case(3)
    torch.manual_seed(0)
    mod = PointSAModule(32, 0.3, 8, 5, (16, 24)).eval()
    x, f = T.t32(xyz), T.t32(feats)
    from nesie_tpu_torch.ops import ball_query, gather_points, group_points
    with torch.no_grad():
        new_xyz, out, idx = mod(x, f)
        nb = ball_query(x, gather_points(x, idx), 0.3, 8)
        g = (group_points(x, nb) - new_xyz[:, :, None, :]) / 0.3
        want = mod.mlps[0](torch.cat([g, group_points(f, nb)], -1)).amax(2)
    assert torch.equal(out, want)


# ---- conv heads ----------------------------------------------------------------

def test_reliable_head_branch_stacks_gn():
    feats = np.random.default_rng(4).normal(size=(2, 24, 32)).astype(
        np.float32)
    kw = dict(shared_conv_channels=(32, 32), cls_conv_channels=(16,),
              bbox_conv_channels=(32, 16), heading_conv_channels=(16, 16),
              num_cls_out=7, num_bbox_out=27, num_heading_out=2, reg_max=8)
    jmod = JReliableHead(**kw)
    params, stats = T.flax_variables(jmod, feats)
    assert "norm0" in params["heading_convs"]  # GroupNorm affine
    want = jmod.apply(T.jvars(params, stats), feats)
    mod = ReliableConvBboxHead(in_channels=32, **kw)
    mod.load_state_dict(module_state_dict_from_flax(params, stats),
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(T.t32(feats))
    for g, w in zip(got, want):
        T.close(g, w)


@pytest.mark.parametrize("shared", [(32, 32), ()])
def test_base_conv_bbox_head(shared):
    feats = np.random.default_rng(5).normal(size=(2, 24, 32)).astype(
        np.float32)
    kw = dict(shared_conv_channels=shared, cls_conv_channels=(16,),
              reg_conv_channels=(), num_cls_out=5, num_reg_out=7)
    jmod = JBaseHead(**kw)
    params, stats = T.flax_variables(jmod, feats)
    want = jmod.apply(T.jvars(params, stats), feats)
    mod = BaseConvBboxHead(32, **kw)
    mod.load_state_dict(module_state_dict_from_flax(params, stats),
                        strict=True)
    with torch.no_grad():
        got = mod.eval()(T.t32(feats))
    assert mod.reg_convs is None
    for g, w in zip(got, want):
        T.close(g, w)


def test_reliable_head_empty_stacks_unchanged():
    """The shipped configs' head (every branch stack empty): the same
    parameters as before the stacks were ported, and each branch its
    Linear alone on the shared trunk."""
    torch.manual_seed(0)
    mod = ReliableConvBboxHead(128, (128, 128), 20, 54, 2).eval()
    assert sorted({k.split(".")[0] for k in mod.state_dict()}) == [
        "conv_bbox", "conv_cls", "conv_heading", "shared_convs"]
    x = torch.randn(2, 16, 128)
    with torch.no_grad():
        cls, reg = mod(x)
        h = mod.shared_convs(x)
        assert torch.equal(cls, mod.conv_cls(h))
        assert torch.equal(reg, torch.cat([mod.conv_bbox(h),
                                           mod.conv_heading(h)], -1))


# ---- VoteHead ------------------------------------------------------------------

@pytest.mark.parametrize("sample_mod,with_rot,interpret", [
    ("vote", False, True), ("vote", True, False), ("seed", False, False),
    ("seed", True, False)])
def test_vote_head_forward_and_decode(request, sample_mod, with_rot,
                                      interpret):
    if interpret:
        request.getfixturevalue("pallas_interpret")
    bins = 12 if with_rot else 1
    pts = _points(6)
    jmod = JVoteNet(num_dir_bins=bins, with_rot=with_rot)
    params, stats = T.flax_variables(jmod, pts, sample_mod)
    want = jax.jit(lambda v, p: jmod.apply(v, p, sample_mod))(
        T.jvars(params, stats), pts)
    model = _port_votenet(params, stats, bins, with_rot).eval()
    with torch.no_grad():
        got = model(T.t32(pts), sample_mod)
    _check_outputs(got, want)

    mean_sizes = np.random.default_rng(7).uniform(0.2, 1.5, (C, 3))
    jcoder = JCoder(bins, C, jnp.asarray(mean_sizes, jnp.float32), with_rot)
    boxes = model.bbox_head.coder(mean_sizes).decode(
        got["aggregated_points"], got)
    T.close(boxes, jcoder.decode(want["aggregated_points"], want))
    assert (boxes[..., 3:6] >= 0.1).all()


def test_vote_head_refuses_unknown_mode():
    model = VoteNet(num_classes=C, num_sizes=C, num_proposal=P, **TINY)
    with pytest.raises(ValueError, match="not one of"):
        model(torch.zeros(1, 64, 4), "spec")


def _gt(seed, b=B):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, MAX_GT, 7))
    boxes[:, :3, :3] = rng.uniform(0.2, 0.8, (b, 3, 3))
    boxes[:, :3, 3:6] = rng.uniform(0.2, 0.6, (b, 3, 3))
    boxes[:, :3, 6] = rng.uniform(-np.pi, np.pi, (b, 3))
    labels = np.zeros((b, MAX_GT), np.int32)
    labels[:, :3] = rng.integers(0, C, (b, 3))
    valid = np.zeros((b, MAX_GT), bool)
    valid[:, :3] = True
    return boxes, labels, valid


def _targets(pts, agg, seed):
    """Both packages' targets (float64) for the same points, proposals
    and GT; they must agree."""
    boxes, labels, valid = _gt(seed, pts.shape[0])
    jt = jtg.get_targets(T.jnp64(pts), T.jnp64(boxes), jnp.asarray(labels),
                         jnp.asarray(valid), T.jnp64(agg))
    tt = ttg.get_targets(torch.from_numpy(pts).double(),
                         torch.from_numpy(boxes), torch.from_numpy(labels),
                         torch.from_numpy(valid), torch.from_numpy(agg))
    for name, g, w in zip(tt._fields, tt, jt):
        if g.dtype.is_floating_point:
            T.close(g, w, T.TOL64, msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    return tt, jt


def _random_preds(rng, bins, b=B, n_seed=32):
    shapes = dict(obj_scores=(b, P, 2), center_offset=(b, P, 3),
                  dir_class=(b, P, bins), dir_res=(b, P, bins),
                  size_class=(b, P, C), size_res=(b, P, C, 3),
                  sem_scores=(b, P, C), aggregated_points=(b, P, 3),
                  vote_points=(b, n_seed, 3), seed_points=(b, n_seed, 3))
    preds = {k: rng.normal(scale=0.5, size=s) for k, s in shapes.items()}
    for k in ("aggregated_points", "vote_points", "seed_points"):
        preds[k] = rng.uniform(0.0, 1.0, shapes[k])
    return preds


@pytest.mark.parametrize("bins,with_rot", [(1, False), (12, True)])
def test_votehead_loss_and_grad_float64(bins, with_rot):
    rng = np.random.default_rng(8)
    preds = _random_preds(rng, bins)
    pts = rng.uniform(size=(B, 128, 4))
    seed_idx = np.stack([rng.permutation(128)[:32] for _ in range(B)]
                        ).astype(np.int32)
    preds["seed_points"] = np.take_along_axis(pts[..., :3],
                                              seed_idx[..., None], 1)
    mean_sizes = rng.uniform(0.2, 1.0, (C, 3))
    cfg = dict(num_classes=C, num_dir_bins=bins, with_rot=with_rot)
    with jax.enable_x64(True):
        tt, jt = _targets(pts, preds["aggregated_points"], 9)

        def jloss(p):
            return jvl.votehead_supervised_loss(
                {**p, "seed_indices": jnp.asarray(seed_idx)}, jt,
                jnp.asarray(mean_sizes), jvl.VoteHeadLossConfig(**cfg))

        (jtotal, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(
            {k: T.jnp64(v) for k, v in preds.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, terms = tvl.votehead_supervised_loss(
        {**tp, "seed_indices": torch.from_numpy(seed_idx)}, tt, mean_sizes,
        tvl.VoteHeadLossConfig(**cfg))
    total.backward()
    assert set(terms) == set(jterms)
    for k in terms:
        T.close(terms[k], jterms[k], T.TOL64, msg=k)
    T.close(total, jtotal, T.TOL64)
    if with_rot:
        assert float(jterms["dir_class_loss"]) > 0
    for k, v in tp.items():
        if v.grad is None:  # an input the loss does not read
            assert not np.asarray(jgrad[k]).any(), k
        else:
            T.close(v.grad, jgrad[k], T.TOL64, msg=k)


# ---- consistency and Lovasz ------------------------------------------------------

def _aug(rng, b):
    flip_x = rng.uniform(size=b) < 0.5
    flip_y = rng.uniform(size=b) < 0.5
    ang = rng.uniform(-np.pi / 6, np.pi / 6, b)
    rot = np.zeros((b, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = np.cos(ang), -np.sin(ang)
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(ang), np.cos(ang)
    rot[:, 2, 2] = 1.0
    scale = rng.uniform(0.85, 1.15, (b, 1, 3))
    return flip_x, flip_y, rot, scale


def test_consistency_losses_float64():
    rng = np.random.default_rng(10)
    b, p, s = 2, 12, 5
    size_scores = rng.normal(size=(2, b, p, s))
    size_res = rng.normal(scale=0.1, size=(2, b, p, s, 3))
    mean_size = rng.uniform(0.3, 1.5, (s, 3))
    inputs = dict(center=rng.normal(size=(b, p, 3)),
                  sem_scores=rng.normal(size=(b, p, C)),
                  ema_center=rng.normal(size=(b, p, 3)),
                  ema_sem_scores=rng.normal(size=(b, p, C)),
                  size_res=size_res[0], ema_size_res=size_res[1])
    flip_x, flip_y, rot, scale = _aug(rng, b)

    def run(m, d, x):
        size = m.decode_votenet_size(x(size_scores[0]), d["size_res"],
                                     x(mean_size))
        ema_size = m.decode_votenet_size(x(size_scores[1]),
                                         d["ema_size_res"], x(mean_size))
        return m.consistency_losses(
            d["center"], d["sem_scores"], size, d["ema_center"],
            d["ema_sem_scores"], ema_size, x(flip_x), x(flip_y), x(rot),
            x(scale))

    with jax.enable_x64(True):
        (jtotal, jterms), jgrad = jax.value_and_grad(
            lambda d: run(jcons, d, jnp.asarray), has_aux=True)(
            {k: T.jnp64(v) for k, v in inputs.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()}
    total, terms = run(tcons, tp, torch.from_numpy)
    total.backward()
    for k in terms:
        T.close(terms[k], jterms[k], T.TOL64, msg=k)
    T.close(total, jtotal, T.TOL64)
    for k, v in tp.items():
        T.close(v.grad, jgrad[k], T.TOL64, msg=k)


def test_consistency_identity_is_zero():
    """Student = teacher under the identity augmentation: the centre and
    size terms vanish (tests/test_extras.py's JAX check, on the port)."""
    rng = np.random.default_rng(11)
    center = torch.from_numpy(rng.normal(size=(2, 8, 3)))
    sem = torch.from_numpy(rng.normal(size=(2, 8, 4)))
    size = torch.from_numpy(np.abs(rng.normal(size=(2, 8, 3))))
    _, terms = tcons.consistency_losses(
        center, sem, size, center, sem, size, torch.zeros(2, dtype=bool),
        torch.zeros(2, dtype=bool), torch.eye(3).expand(2, 3, 3).double(),
        torch.ones(2, 1, 3).double())
    assert float(terms["center_consistency_loss"]) < 1e-12
    assert float(terms["size_consistency_loss"]) < 1e-12


def test_lovasz_hinge_float64_with_ties():
    """Logits on a coarse grid, so errors tie: both sorts are stable."""
    rng = np.random.default_rng(12)
    logits = rng.integers(-4, 5, 64) / 4.0
    labels = (rng.uniform(size=64) < 0.4).astype(np.float64)
    with jax.enable_x64(True):
        jval, jgrad = jax.value_and_grad(jcons.lovasz_hinge)(
            T.jnp64(logits), T.jnp64(labels))
    x = torch.from_numpy(logits).requires_grad_()
    val = tcons.lovasz_hinge(x, torch.from_numpy(labels))
    val.backward()
    T.close(val, jval, T.TOL64)
    T.close(x.grad, jgrad, T.TOL64)


# ---- the slice: a narrow VoteHead detector, forward + loss + gradient ----------

def test_votehead_slice_float64_train_step():
    pts = _points(13).astype(np.float64)
    jmod = JVoteNet()
    params, stats = T.flax_variables(jmod, pts.astype(np.float32), "vote")
    params, stats = T.to64(params), T.to64(stats)
    mean_sizes = np.random.default_rng(14).uniform(0.3, 1.0, (C, 3))
    boxes, labels, valid = _gt(15)
    cfg = jvl.VoteHeadLossConfig(num_classes=C)

    with T.jax_float64():
        def jloss(prm):
            out, new = jmod.apply({"params": prm, "batch_stats": stats},
                                  T.jnp64(pts), "vote", train=True,
                                  mutable=["batch_stats"])
            tg = jtg.get_targets(T.jnp64(pts), T.jnp64(boxes),
                                 jnp.asarray(labels), jnp.asarray(valid),
                                 out["aggregated_points"])
            total, terms = jvl.votehead_supervised_loss(
                out, tg, T.jnp64(mean_sizes), cfg)
            return total, (terms, out, new)

        (jtotal, (jterms, jout, jnew)), jgrad = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jax.tree.map(T.jnp64, params))

    model = _port_votenet(params, stats).double().train()
    out = model(torch.from_numpy(pts), "vote")
    tg = ttg.get_targets(torch.from_numpy(pts), torch.from_numpy(boxes),
                         torch.from_numpy(labels), torch.from_numpy(valid),
                         out["aggregated_points"])
    total, terms = tvl.votehead_supervised_loss(
        out, tg, mean_sizes, tvl.VoteHeadLossConfig(num_classes=C))
    total.backward()

    for k in ("seed_indices", "aggregated_indices"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    for k in terms:
        T.close(terms[k], jterms[k], T.TOL64, msg=k)
    T.close(total, jtotal, T.TOL64)
    T.assert_grads_match(model, jgrad, state_dict_from_flax, SLICE_TOL64)
    want_stats = T.to_port64(state_dict_from_flax, params,
                             T.to64(jnew["batch_stats"]))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            T.close(v, want_stats[k], SLICE_TOL64, msg=k)
