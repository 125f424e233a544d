"""The port's SAQE family against the JAX package's, on the CPU: the angle
decode, the tripled face grids, QualityEstimation, SAQEHead and the
detector, the weight conversion, the SAQE losses and the SAQE pretrain
and semi steps.

Model: ``tests/test_saqe.py``'s TINY SAQE shape (4 classes, reg_max 8,
16 proposals, jitter 0.5 with size bias 0.2); weights from a seeded port
model with randomised BN, carried to flax by
``nesie_tpu.convert_torch.convert_state_dict(head="saqe")``. The jitter
noise of both sides is the noise JAX draws from the same key.

Neighbour searches: QualityEstimation alone runs JAX's Pallas three-NN in
interpret mode. The head, the detector and the steps run the JAX model
with ``test_torch_train_support``'s jnp searches, which have the Pallas
kernels' semantics at every shape (at TINY's sample counts, which are not
multiples of 128, the JAX package would take its matmul-form ball query
instead, and could order near-ties otherwise than the port and the
kernels).

Tolerances: the angle decode and the grids atol 1e-6, rtol 1e-6;
QualityEstimation atol 1e-5, rtol 1e-5 (float32); the head and the
detector atol 1e-4, rtol 1e-4 (float32, TF32 off: no GPU here); the
losses (float64) atol 1e-5, rtol 1e-5; the steps (float64, see
``test_torch_train_support`` why) as ``test_torch_train_step`` and
``test_torch_train_semi``: loss terms atol 1e-4, rtol 1e-4, gradients,
parameters, BN statistics and the teacher atol 1e-4, rtol 1e-3, each
step's directional derivative against a central difference rtol 1e-4;
integer outputs exactly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nesie_tpu.ops.pointops as jpo
import test_torch_train_support as S
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.data.augment import AugParams as JAug
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu.nn.heads import angle_integral_expectation as j_angle
from nesie_tpu.nn.quality_estimation import QualityEstimation as JQuality
from nesie_tpu.nn.quality_estimation import make_saqe_side_grids as j_grids
from nesie_tpu.nn.saqe_head import SAQEHead as JSAQEHead
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import saqe_loss as jsaqe
from nesie_tpu.train import semi as jsemi
from nesie_tpu.train import state as jstate
from nesie_tpu.train import step as jstep
from nesie_tpu.train import targets as jtg
from nesie_tpu.train.sup_loss import NesieLossConfig as JNesieLossConfig
from nesie_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from nesie_tpu_torch.data.augment import AugParams, augment_boxes, augment_points
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.nn.heads import angle_integral_expectation
from nesie_tpu_torch.nn.quality_estimation import QualityEstimation, make_saqe_side_grids
from nesie_tpu_torch.train import saqe_loss as tsaqe
from nesie_tpu_torch.train import semi as tsemi
from nesie_tpu_torch.train import state as tstate
from nesie_tpu_torch.train import step as tstep
from nesie_tpu_torch.train import targets as ttg
from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
from nesie_tpu_torch.train.sup_loss import NesieLossConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

C = 4
TINY = dict(
    num_classes=C,
    reg_max=8,
    num_proposal=16,
    head="saqe",
    jitter_scale=0.5,
    jitter_size_bias=0.2,
    num_points=(64, 32, 16, 16),
    radii=(0.2, 0.4, 0.8, 1.2),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
SEED_DIM, P = 32, TINY["num_proposal"]
GRID_TOL = dict(atol=1e-6, rtol=1e-6)
QE_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS64_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-3)
LR = 1e-3
FD_H = 1e-7
JAX_COMPILE = {"xla_disable_hlo_passes": "fusion"}  # test_torch_train_semi


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=msg,
                               **tol)


def _vars(params, stats):
    return {"params": params, "batch_stats": stats}


def _weights(seed=0):
    """(params, batch_stats) of the JAX package and the port model loaded
    from them, from a seeded port model with randomised BN."""
    src = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(seed)
    init_weights_(src, gen)
    randomize_bn_(src, gen)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}, head="saqe")
    model = VoteNetNesie(**TINY)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return params, stats, model.eval()


@pytest.fixture(scope="module")
def weights():
    return _weights(0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpo, "_3NN_IMPL", "pallas")


def _assert_results_close(got: dict, want: dict, tol):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        if got[k].dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=k)
        else:
            _close(got[k], want[k], tol, msg=k)


# ---- the angle decode and the grids -------------------------------------

def test_angle_integral_expectation():
    """Random logits, and rows whose expectation sits at 0, at the wrap
    (exactly pi: not wrapped) and past it (wrapped to below 0)."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(3, 7, 12))).astype(np.float32)
    special = np.zeros((4, 12), np.float32)
    special[0, 0] = 50.0  # mass at bin 0
    # uniform: expectation 0.5 exactly, angle pi; one bin up: past it
    special[2, 11] = 50.0  # mass at the last bin: 2 pi, wrapped to ~0
    special[3, 8] = 4.0
    want_all = []
    for x in (logits, special):
        got = angle_integral_expectation(_t(x))
        want = np.asarray(j_angle(jnp.asarray(x)))
        _close(got, want, GRID_TOL)
        assert (want > -np.pi).all() and (want <= np.float32(np.pi)).all()
        want_all.append(want)
    assert want_all[1][1] == np.float32(np.pi)
    assert want_all[1][3] < 0 and abs(want_all[1][2]) < 1e-3


@pytest.mark.parametrize("heading", ["zero", "random"])
def test_make_saqe_side_grids(heading):
    rng = np.random.default_rng(1)
    center = rng.normal(size=(2, 5, 3)).astype(np.float32)
    size = rng.uniform(0.2, 2.0, size=(2, 5, 3)).astype(np.float32)
    yaw = (np.zeros((2, 5)) if heading == "zero"
           else rng.uniform(-np.pi, np.pi, (2, 5))).astype(np.float32)
    want = np.asarray(j_grids(*(jnp.asarray(a) for a in (center, size, yaw))))
    got = make_saqe_side_grids(_t(center), _t(size), _t(yaw))
    assert got.shape == (2, 5, 162, 3)
    _close(got, want, GRID_TOL)


# ---- QualityEstimation ----------------------------------------------------

def _quality_inputs(seed=2, k2=2 * P):
    rng = np.random.default_rng(seed)
    B = 2
    center = rng.uniform(size=(B, k2, 3)).astype(np.float32)
    size = rng.uniform(0.2, 1.0, size=(B, k2, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, k2)).astype(np.float32)
    seed_xyz = rng.uniform(size=(B, 32, 3)).astype(np.float32)
    seed_feats = rng.normal(size=(B, 32, SEED_DIM)).astype(np.float32)
    logits = rng.normal(size=(B, P, 6, 9)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return center, size, yaw, seed_xyz, seed_feats, probs


def test_quality_estimation_eval(weights, pallas_interpret):
    """Eval mode over 2P boxes (the stat tiled over the jittered half)."""
    params, stats, model = weights
    args = _quality_inputs()
    jmod = JQuality(num_classes=C, seed_feat_dim=SEED_DIM, reg_max=8)
    gp, gs = params["bbox_head"]["grid_conv"], stats["bbox_head"]["grid_conv"]
    want = jax.jit(lambda v, *a: jmod.apply(v, *a))(_vars(gp, gs), *args)
    with torch.no_grad():
        got = model.bbox_head.grid_conv(*(_t(a) for a in args))
    assert [tuple(g.shape) for g in got] == [
        (2, 2 * P, 6, C), (2, 2 * P, C), (2, 2 * P, C), (2, 2 * P, 2)]
    for name, g, w in zip(("side", "iou", "rotate", "R_obj"), got, want):
        _close(g, w, QE_TOL, msg=name)


def test_quality_estimation_train_mode(weights, pallas_interpret):
    """Train mode over 2P proposals: batch statistics over all of them,
    and the running statistics flax's way."""
    params, stats, model = weights
    args = _quality_inputs(seed=3)
    jmod = JQuality(num_classes=C, seed_feat_dim=SEED_DIM, reg_max=8)
    gp, gs = params["bbox_head"]["grid_conv"], stats["bbox_head"]["grid_conv"]
    want, mutated = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"]))(_vars(gp, gs), *args)
    qe = copy.deepcopy(model.bbox_head.grid_conv).train()
    with torch.no_grad():
        got = qe(*(_t(a) for a in args))
    for name, g, w in zip(("side", "iou", "rotate", "R_obj"), got, want):
        _close(g, w, QE_TOL, msg=name)
    new_stats = {**stats, "bbox_head": {**stats["bbox_head"],
                                        "grid_conv": mutated["batch_stats"]}}
    want_sd = state_dict_from_flax(params, new_stats)
    prefix = "bbox_head.grid_conv."
    checked = 0
    for k, v in qe.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, want_sd[prefix + k].numpy(), QE_TOL, msg=k)
            assert not torch.equal(
                v, model.bbox_head.grid_conv.state_dict()[k]), k
            checked += 1
    assert checked == 2 * (6 * 2 + 6 + 2)  # every BN of the module


def test_quality_estimation_refuses_iou_class_independent():
    """``iou_class_depend=False`` is ported: one side, IoU and rotation
    score a box, R_obj's two logits as before (parity with JAX:
    tests/test_torch_options.py)."""
    mod = QualityEstimation(C, SEED_DIM, reg_max=8, iou_class_depend=False)
    with torch.no_grad():
        side, iou, rot, r_obj = mod.eval()(*map(_t, _quality_inputs()))
    assert side.shape == (2, 2 * P, 6, 1)
    assert iou.shape == rot.shape == (2, 2 * P, 1)
    assert r_obj.shape == (2, 2 * P, 2)


# ---- SAQEHead and the detector ---------------------------------------------

def _head_inputs(seed=4):
    rng = np.random.default_rng(seed)
    B, n = 2, 32
    seed_xyz = rng.uniform(size=(B, n, 3)).astype(np.float32)
    seed_feats = rng.normal(size=(B, n, SEED_DIM)).astype(np.float32)
    seed_idx = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    return seed_xyz, seed_feats, seed_idx


@pytest.mark.parametrize("sample_mod,with_jitter", [
    ("seed", False), ("seed", True), ("vote", True)])
def test_saqe_head_forward(weights, sample_mod, with_jitter):
    params, stats, model = weights
    xyz, feats, idx = _head_inputs()
    jmod = JSAQEHead(num_classes=C, reg_max=8, num_proposal=P,
                     seed_feat_dim=SEED_DIM,
                     vote_conv_channels=(SEED_DIM, SEED_DIM))
    key = jax.random.PRNGKey(7)

    def run(v, x, f, i):
        fd = dict(fp_xyz=[x], fp_features=[f], fp_indices=[i])
        return jmod.apply(v, fd, sample_mod, key, train=False,
                          with_jitter=with_jitter)

    with S.jax_float64(x64=False):
        want = jax.jit(run)(_vars(params["bbox_head"], stats["bbox_head"]),
                            xyz, feats, idx)
    noise = S.jitter_noise(key, (2, P, 3)) if with_jitter else None
    fd = dict(fp_xyz=[_t(xyz)], fp_features=[_t(feats)],
              fp_indices=[torch.from_numpy(idx)])
    with torch.no_grad():
        got = model.bbox_head(fd, sample_mod, with_jitter=with_jitter,
                              noise=noise)
    _assert_results_close(got, want, TOL)


@pytest.mark.parametrize("with_jitter", [False, True])
def test_detector_forward(weights, with_jitter):
    params, stats, model = weights
    pts = S.scenes(5, 2)[0][0].astype(np.float32)
    key = jax.random.PRNGKey(9)
    jmodel = JVoteNetNesie(**TINY)
    with S.jax_float64(x64=False):
        want = jax.jit(lambda v, p: jmodel.apply(
            v, p, "seed", key, train=False, with_jitter=with_jitter))(
                _vars(params, stats), pts)
    noise = S.jitter_noise(key, (2, P, 3)) if with_jitter else None
    with torch.no_grad():
        got = model(_t(pts), "seed", with_jitter=with_jitter, noise=noise)
    _assert_results_close(got, want, TOL)
    # the main outputs do not depend on the jittered half (eval-mode BN)
    if with_jitter:
        with torch.no_grad():
            alone = model(_t(pts), "seed")
        for k in ("iou_scores", "side_scores", "R_obj_scores"):
            torch.testing.assert_close(alone[k], got[k], rtol=0, atol=1e-6)


def test_saqe_head_refuses_unported_modes(weights):
    """A sample mode that the JAX head lacks is refused; ``random`` needs
    its indices or a generator. (The four modes:
    tests/test_torch_options.py.)"""
    _, _, model = weights
    with pytest.raises(ValueError, match="not one of"):
        model.bbox_head({}, "fps")
    with pytest.raises(ValueError, match="sample_indices or a generator"):
        model.bbox_head({}, "random")
    with pytest.raises(ValueError, match="noise or a generator"):
        model.bbox_head({}, "seed", with_jitter=True)


# ---- conversion ---------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_conversion_round_trips(weights):
    """flax -> port -> flax and port -> flax -> port exactly; a
    params-only tree lands on the parameter names."""
    params, stats, model = weights
    back_p, back_s = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, head="saqe")
    for want, got in ((params, back_p), (stats, back_s)):
        want, got = _flat(want), _flat(got)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = state_dict_from_flax(back_p, back_s)
    ref = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    only = state_dict_from_flax(params)
    assert only.keys() == dict(model.named_parameters()).keys()


def test_reference_named_saqe_state_dict_loads(weights, tmp_path):
    """A reference-named ``.pth``: 1x1 convolutions as (out, in, 1), the
    teacher's ``ema_*`` buffers beside the student's."""
    _, _, model = weights
    sd = {k: (v[..., None] if v.dim() == 2 else v).clone()
          for k, v in model.state_dict().items()}
    sd.update({"ema_" + k.replace(".", "_"): v + 1.0 for k, v in sd.items()
               if v.is_floating_point()})
    path = tmp_path / "saqe.pth"
    torch.save({"state_dict": sd}, path)
    fresh = VoteNetNesie(**TINY)
    fresh.load_state_dict(load_reference_state_dict(path), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---- losses (float64) --------------------------------------------------

@pytest.fixture(scope="module")
def loss_inputs():
    """Targets of both packages for aggregation points near the GT, and a
    SAQE results dict of plausible values (float64 numpy)."""
    rng = np.random.default_rng(8)
    b, max_gt, seed_n = 2, 8, 40
    boxes = np.zeros((b, max_gt, 7))
    valid = np.zeros((b, max_gt), bool)
    labels = np.zeros((b, max_gt), np.int32)
    for i in range(b):
        k = 5 - 2 * i
        boxes[i, :k] = np.concatenate([
            rng.uniform([0.8, 0.8, 0.0], [1.6, 1.6, 0.0], (k, 3)),
            rng.uniform(0.6, 1.4, (k, 3)), rng.uniform(-0.4, 0.4, (k, 1))],
            -1)
        valid[i, :k] = True
        labels[i, :k] = rng.integers(0, C, k)
    pts = rng.uniform([0, 0, 0], [2.5, 2.5, 1.2], (b, 400, 3))
    agg = rng.uniform([0, 0, 0], [2.5, 2.5, 1.0], (b, P, 3))
    agg[0, :5] = boxes[0, :5, :3] + [0, 0, 0.3]

    def box(shape):
        return np.concatenate([rng.uniform(0.5, 2, shape + (3,)),
                               rng.uniform(0.4, 1.5, shape + (3,)),
                               rng.normal(size=shape + (1,))], -1)

    res = dict(
        seed_indices=rng.integers(0, 400, (b, seed_n)).astype(np.int32),
        seed_points=rng.uniform(0, 2.5, (b, seed_n, 3)),
        vote_points=rng.uniform(0, 2.5, (b, seed_n, 3)),
        obj_scores=rng.normal(size=(b, P, 2)),
        sem_scores=rng.normal(size=(b, P, C)),
        bbox_preds=box((b, P)),
        surface_pred=rng.normal(size=(b, P, 6)),
        jitter_bbox_preds=box((b, P)),
        jitter_surface_preds=rng.normal(size=(b, P, 6)),
    )
    for key, shape in (("iou_scores", (C,)), ("side_scores", (6, C)),
                       ("rotate_scores", (C,))):
        for suffix in ("", "_jitter"):
            res[key + suffix] = rng.uniform(0.05, 0.95, (b, P) + shape)
    for suffix in ("", "_jitter"):
        res["R_obj_scores" + suffix] = rng.normal(size=(b, P, 2))
    quality = rng.uniform(0, 1, (b, max_gt, 6))
    with jax.enable_x64(True):
        jt = jtg.get_targets(*(jnp.asarray(a) for a in (pts, boxes, labels,
                                                        valid, agg)))
        jt = jax.tree.map(np.asarray, jt)
    tt = ttg.get_targets(*(torch.from_numpy(a) for a in (pts, boxes, labels,
                                                         valid, agg)))
    assert float(tt.box_loss_weights.sum()) > 0  # positives exist
    return res, jt, tt, quality


GRAD_KEYS = ("vote_points", "obj_scores", "sem_scores", "bbox_preds",
             "surface_pred", "iou_scores", "iou_scores_jitter", "side_scores",
             "side_scores_jitter", "rotate_scores", "rotate_scores_jitter",
             "R_obj_scores", "R_obj_scores_jitter")


def _loss_pair(loss_inputs, jfn, tfn):
    """Terms and gradients of both packages' loss on the same inputs."""
    res, jt, tt, quality = loss_inputs
    keys = [k for k in GRAD_KEYS if k in res]
    with jax.enable_x64(True):
        def jloss(*xs):
            r = {**{k: jnp.asarray(v) for k, v in res.items()},
                 **dict(zip(keys, xs))}
            return jfn(r, jax.tree.map(jnp.asarray, jt), jnp.asarray(quality))

        (jtotal, jterms), jgrads = jax.value_and_grad(
            jloss, argnums=tuple(range(len(keys))), has_aux=True)(
                *(jnp.asarray(res[k]) for k in keys))
        jterms = {k: float(v) for k, v in jterms.items()}
        jgrads = [np.asarray(g) for g in jgrads]
    tres = {k: torch.from_numpy(v) for k, v in res.items()}
    for k in keys:
        tres[k].requires_grad_()
    total, terms = tfn(tres, tt, torch.from_numpy(quality))
    total.backward()
    return (float(jtotal), jterms, dict(zip(keys, jgrads))), (
        float(total.detach()), {k: float(v.detach()) for k, v in terms.items()},
        {k: tres[k].grad for k in keys})


def _assert_losses_match(j, t):
    (jtotal, jterms, jgrads), (total, terms, grads) = j, t
    assert list(terms) == list(jterms) or set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(terms[k], v, err_msg=k, **LOSS64_TOL)
        assert v != 0.0, k  # every term is exercised
    np.testing.assert_allclose(total, jtotal, **LOSS64_TOL)
    for k, g in jgrads.items():
        got = grads[k]
        if got is None:
            assert not np.any(g), k
        else:
            np.testing.assert_allclose(got.numpy(), g, err_msg=k,
                                       **LOSS64_TOL)


@pytest.mark.parametrize("phase", ["pretrain", "semi"])
def test_saqe_supervised_loss(loss_inputs, phase):
    jcfg, tcfg = (jsaqe.SAQELossConfig(num_classes=C),
                  tsaqe.SAQELossConfig(num_classes=C))
    j, t = _loss_pair(
        loss_inputs,
        lambda r, tg, q: jsaqe.saqe_supervised_loss(r, tg, jcfg, phase),
        lambda r, tg, q: tsaqe.saqe_supervised_loss(r, tg, tcfg, phase))
    assert ("angle_pred_loss" in t[1]) == (phase == "pretrain")
    _assert_losses_match(j, t)


def test_saqe_unsup_loss(loss_inputs):
    jcfg, tcfg = (jsaqe.SAQELossConfig(num_classes=C),
                  tsaqe.SAQELossConfig(num_classes=C))
    j, t = _loss_pair(
        loss_inputs,
        lambda r, tg, q: jsaqe.saqe_unsup_loss(r, tg, q, jcfg),
        lambda r, tg, q: tsaqe.saqe_unsup_loss(r, tg, q, tcfg))
    _assert_losses_match(j, t)


def test_saturated_quality_score_is_nonfinite_as_in_jax():
    """A sigmoid quality score that rounds to 1.0 in float32 makes the
    QFL against background infinite in both packages (their BCE clamps the
    probability at 1 - 1e-12, which is 1.0 in float32; torch's
    ``F.binary_cross_entropy`` clamps the log at -100 instead), and a
    zero box weight then makes the SAQE ``iou_pred_loss`` NaN. The port
    keeps the JAX package's behaviour (ROADMAP §3)."""
    from nesie_tpu.losses import quality_focal_loss as jqfl
    from nesie_tpu_torch.losses import quality_focal_loss as tqfl

    pred = np.array([[1.0, 0.5], [0.3, 0.2]], np.float32)
    label, score = np.array([5, 5]), np.zeros(2, np.float32)
    want = np.asarray(jqfl(jnp.asarray(pred), jnp.asarray(label),
                           jnp.asarray(score), use_sigmoid=False))
    got = tqfl(_t(pred), torch.from_numpy(label), _t(score),
               use_sigmoid=False).numpy()
    assert np.isinf(want[0]) and np.isinf(got[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    with np.errstate(invalid="ignore"):
        assert np.isnan(got[0] * 0.0) and np.isnan(want[0] * 0.0)
    assert torch.nn.functional.binary_cross_entropy(
        torch.ones(1), torch.zeros(1)).item() == 100.0


def test_saqe_loss_config_drops_nesie_settings():
    """As the JAX steps do: a plain NesieLossConfig becomes
    SAQELossConfig(num_classes=...), its other settings dropped."""
    cfg = tstep.saqe_loss_config(NesieLossConfig(num_classes=C,
                                                 iou_pred_weight=3.0))
    assert cfg == tsaqe.SAQELossConfig(num_classes=C)
    keep = tsaqe.SAQELossConfig(num_classes=C, iou_pred_weight=3.0)
    assert tstep.saqe_loss_config(keep) is keep


# ---- the steps (float64) ----------------------------------------------

def _weights64(seed):
    params, stats, model = _weights(seed)
    return S.to64(params), S.to64(stats), model.double()


def _scenes(seed, b, views=1):
    pts, boxes, labels, valid = S.scenes(seed, b, views)
    return pts, boxes, labels % C, valid


def _torch_aug(d):
    return AugParams(*(torch.from_numpy(np.asarray(d[f]))
                       for f in S.AUG_FIELDS))


def _recording_clip(grads, names):
    clip = tstate.clip_by_global_norm_

    def record(gs, max_norm):
        grads.update({n: g.clone() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    return record


def _frozen_quotient(run_loss, params):
    """Central difference of ``run_loss`` (a loss at the current weights)
    along a seeded unit direction in ``params``, every ``Tensor.detach``
    and no-grad IoU label frozen at the unmoved pass's values: the
    function whose gradient a backward pass computes. Returns (direction,
    quotient)."""
    rng = np.random.default_rng(7)
    v = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)))
         for n, p in params.items()}
    norm = torch.sqrt(sum((d * d).sum() for d in v.values()))
    v = {n: d / norm for n, d in v.items()}
    detach, iou3d = torch.Tensor.detach, tsaqe.iou3d
    recorded, record = {detach: [], iou3d: []}, [True]

    def frozen(fn):
        def replay(*args, **kw):
            out = fn(*args, **kw)
            if record[0]:
                recorded[fn].append(out)
                return out
            want = recorded[fn][replay.i]
            replay.i += 1
            assert want.shape == out.shape
            return want
        replay.i = 0
        return replay

    def loss(shift):
        with torch.no_grad():
            for n, p in params.items():
                p.add_(shift * FD_H * v[n])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "detach", frozen(detach))
            mp.setattr(tsaqe, "iou3d", frozen(iou3d))
            total = run_loss()
        with torch.no_grad():
            for n, p in params.items():
                p.sub_(shift * FD_H * v[n])
        return total

    loss(0.0)
    record[0] = False
    return v, (loss(1.0) - loss(-1.0)) / (2 * FD_H)


def _slope(grads, direction):
    return sum(float((torch.as_tensor(np.asarray(grads[n]),
                                      dtype=torch.float64) * d).sum())
               for n, d in direction.items())


SUP_B, SUP_SEED = 2, 1


@pytest.fixture(scope="module")
def pretrain_step():
    """One SAQE pretrain step of each package from the same weights,
    batch and jitter noise; the port's frozen difference quotient along
    a direction in the backbone's first SA module."""
    params, stats, model = _weights64(1)
    pts, boxes, labels, valid = _scenes(SUP_SEED, SUP_B)
    aug = S.sample_aug(np.random.default_rng(SUP_SEED + 100), SUP_B)
    key = jax.random.PRNGKey(5)
    with S.jax_float64():
        jmodel = JVoteNetNesie(**TINY)
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(_vars(params, stats), tx)
        step = jstep.make_supervised_train_step(
            jmodel, tx, loss_cfg=JNesieLossConfig(num_classes=C), head="saqe")
        batch = dict(points=jnp.asarray(pts[0]), gt_boxes=jnp.asarray(boxes),
                     gt_labels=jnp.asarray(labels),
                     gt_valid=jnp.asarray(valid),
                     aug=JAug(*(jnp.asarray(aug[f]) for f in S.AUG_FIELDS)))
        new, metrics = step(state, batch, key)
        jax_side = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))
        noise = S.jitter_noise(key, (SUP_B, P, 3))

    tbatch = dict(points=torch.from_numpy(pts[0]),
                  gt_boxes=torch.from_numpy(boxes),
                  gt_labels=torch.from_numpy(labels),
                  gt_valid=torch.from_numpy(valid), aug=_torch_aug(aug))
    fd_model = copy.deepcopy(model)
    state = create_train_state(model, make_lr_schedule(LR, 10), device="cpu")
    grads = {}
    names = [n for n, _ in state.model.named_parameters()]
    step = tstep.make_supervised_train_step(NesieLossConfig(num_classes=C),
                                            head="saqe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstate, "clip_by_global_norm_",
                   _recording_clip(grads, names))
        metrics = step(state, tbatch, noise=noise)

    fd_model.train()
    points = augment_points(tbatch["points"], tbatch["aug"], shift_height=True)
    gt_boxes = augment_boxes(tbatch["gt_boxes"], tbatch["aug"])

    def run_loss():
        with torch.no_grad():
            out = fd_model(points, "vote", with_jitter=True, noise=noise)
            targets = ttg.get_targets(points[..., :3], gt_boxes,
                                      tbatch["gt_labels"], tbatch["gt_valid"],
                                      out["aggregated_points"])
            return tsaqe.saqe_supervised_loss(
                out, targets, tsaqe.SAQELossConfig(num_classes=C))[0].item()

    fd = _frozen_quotient(run_loss, {
        n: p for n, p in fd_model.named_parameters()
        if n.startswith("backbone.SA_modules.0.")})
    torch_side = dict(metrics={k: float(v) for k, v in metrics.items()},
                      grads=grads, params=state.model.state_dict(),
                      teacher=dict(state.teacher.named_parameters()),
                      state=state, fd=fd)
    return jax_side, torch_side


N_LABELED, N_UNLABELED = 1, 2
SEMI_B = N_LABELED + N_UNLABELED
NUM_SCANS, NUM_LABELED_SCANS = 6, 3
SCAN_IDX = np.array([0, 4, 4])
SEMI_SEED = 2  # one with positive proposals in the labeled scene
PL = dict(num_classes=C, obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0,
          cls_thr_cap=0.0, iou_thr_base=0.3, iou_thr_scale=0.0,
          iou_thr_cap=0.3)


def _initial_ulb():
    ulb_list = np.zeros((NUM_SCANS, C))
    ulb_list[1] = np.arange(float(C))
    ulb_flag = np.ones(NUM_SCANS)
    ulb_flag[1] = 0.0
    return ulb_list, ulb_flag


@pytest.fixture(scope="module")
def semi_step():
    """One SAQE semi step of each package (the JAX step jitted with
    XLA's fusion pass off), the pseudo-labels read inside both, and the
    port's frozen difference quotient."""
    params, stats, model = _weights64(0)
    pts, boxes, labels, valid = _scenes(SEMI_SEED, SEMI_B, views=2)
    rng = np.random.default_rng(SEMI_SEED + 100)
    data = dict(points_raw_s=pts[0], points_raw_t=pts[1], gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid,
                aug_s=S.sample_aug(rng, SEMI_B), aug_t=S.identity_aug(SEMI_B),
                ulb_scan_idx=SCAN_IDX)
    key = jax.random.PRNGKey(3)
    seen = {}

    def get_pseudo_labels(teacher_results, acc, cfg):
        lab = jpl.get_pseudo_labels(teacher_results, acc, cfg)
        jax.debug.callback(
            lambda *xs: seen.setdefault("jax", [np.array(x) for x in xs]),
            teacher_results["aggregated_indices"], lab.valid, lab.labels,
            lab.quality)
        return lab

    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsemi, "get_pseudo_labels", get_pseudo_labels)
        jmodel = JVoteNetNesie(**TINY)
        jbatch = {k: jnp.asarray(v) for k, v in data.items()
                  if not isinstance(v, dict)}
        for k in ("aug_s", "aug_t"):
            jbatch[k] = JAug(*(jnp.asarray(data[k][f]) for f in S.AUG_FIELDS))
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(_vars(params, stats), tx)
        ulb0 = jsemi.UlbState(*(jnp.asarray(x) for x in _initial_ulb()))
        step = jsemi.make_semi_train_step(
            jmodel, tx, n_labeled=N_LABELED,
            num_labeled_scans=NUM_LABELED_SCANS,
            loss_cfg=JNesieLossConfig(num_classes=C),
            pl_cfg=jpl.PseudoLabelConfig(**PL), head="saqe")
        step = step.lower(state, ulb0, jbatch, key).compile(
            compiler_options=JAX_COMPILE)
        new, new_ulb, metrics = step(state, ulb0, jbatch, key)
        jax.block_until_ready(metrics)
        _, rng_s = jax.random.split(key)
        noise = S.jitter_noise(rng_s, (SEMI_B, P, 3))
        jax_side = dict(
            seen=seen["jax"], metrics={k: float(v) for k, v in metrics.items()},
            ulb=[np.asarray(x) for x in new_ulb],
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))

    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if not isinstance(v, dict)}
    for k in ("aug_s", "aug_t"):
        batch[k] = _torch_aug(data[k])
    fd_model = copy.deepcopy(model)
    tstep_fn = make_semi_train_step(
        N_LABELED, NUM_LABELED_SCANS, loss_cfg=NesieLossConfig(num_classes=C),
        pl_cfg=PseudoLabelConfig(**PL), head="saqe")
    state = create_train_state(model, make_lr_schedule(LR, 10), device="cpu")
    grads, tseen = {}, {}
    names = [n for n, _ in state.model.named_parameters()]
    get_pl = tsemi.get_pseudo_labels

    def t_get_pseudo_labels(teacher_results, acc, cfg, rows=None):
        lab = get_pl(teacher_results, acc, cfg, rows)
        tseen["torch"] = [teacher_results["aggregated_indices"].numpy(),
                          lab.valid.numpy(), lab.labels.numpy(),
                          lab.quality.numpy()]
        return lab

    ulb = UlbState(*(torch.from_numpy(x) for x in _initial_ulb()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsemi, "get_pseudo_labels", t_get_pseudo_labels)
        mp.setattr(tstate, "clip_by_global_norm_",
                   _recording_clip(grads, names))
        new_ulb, metrics = tstep_fn(state, ulb, batch, noise=noise)

    fd_state = create_train_state(fd_model, make_lr_schedule(LR, 10),
                                  device="cpu")

    def run_loss():
        totals = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsemi, "apply_gradients",
                       lambda state, total: totals.append(total.item()))
            mp.setattr(tsemi, "ema_update", lambda *a: None)
            tstep_fn(fd_state, UlbState(*(torch.from_numpy(x)
                                          for x in _initial_ulb())),
                     batch, noise=noise)
        return totals[0]

    fd = _frozen_quotient(run_loss, {
        n: p for n, p in fd_state.model.named_parameters()
        if n.startswith("backbone.SA_modules.0.")})
    torch_side = dict(
        seen=tseen["torch"], metrics={k: float(v) for k, v in metrics.items()},
        ulb=[x.numpy() for x in new_ulb], grads=grads,
        params=state.model.state_dict(),
        teacher=dict(state.teacher.named_parameters()), state=state, fd=fd)
    return jax_side, torch_side


STEPS = ("pretrain_step", "semi_step")


@pytest.mark.parametrize("which", STEPS)
def test_step_loss_terms_match(which, request):
    j, t = request.getfixturevalue(which)
    assert set(t["metrics"]) == set(j["metrics"])
    for name in ("objectness_loss", "angle_loss", "side_loss",
                 "iou_pred_loss"):
        assert t["metrics"][name] != 0.0, name
    if which == "pretrain_step":
        assert "angle_pred_loss" in t["metrics"]
    else:
        assert j["metrics"]["num_pseudo"] > 0
        assert "angle_pred_loss" not in t["metrics"]
        assert t["metrics"]["unsup_iou_loss"] != 0.0
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(t["metrics"][k], v, err_msg=k,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("which", STEPS)
def test_step_gradients_match(which, request):
    j, t = request.getfixturevalue(which)
    assert set(t["grads"]) == set(j["grads"])
    S.assert_state_dicts_close(t["grads"], j["grads"], STEP_TOL)
    # the quality module's fused head is trained (R_obj, rotate, IoU)
    g = t["grads"]["bbox_head.grid_conv.mlps_head.6.6.weight"]
    assert g.abs().sum() > 0


@pytest.mark.parametrize("which", STEPS)
def test_step_updated_state_matches(which, request):
    """AdamW-updated parameters, BN running statistics and the EMA
    teacher."""
    j, t = request.getfixturevalue(which)
    S.assert_state_dicts_close(t["params"], j["params"], STEP_TOL)
    S.assert_state_dicts_close(t["teacher"], j["teacher"], STEP_TOL)
    assert t["state"].step == 1


@pytest.mark.parametrize("which", STEPS)
def test_step_gradients_match_finite_difference(which, request):
    j, t = request.getfixturevalue(which)
    v, quotient = t["fd"]
    assert abs(quotient) > 1e-6  # the direction moves the loss
    slopes = {"jax": _slope(j["grads"], v), "port": _slope(t["grads"], v)}
    for side, slope in slopes.items():
        np.testing.assert_allclose(
            slope, quotient, rtol=1e-4,
            err_msg=f"{side}: slopes {slopes}, quotient {quotient}")


def test_semi_step_pseudo_labels_and_ulb_state(semi_step):
    j, t = semi_step
    j_idx, j_valid, j_labels, j_quality = j["seen"]
    t_idx, t_valid, t_labels, t_quality = t["seen"]
    np.testing.assert_array_equal(
        t_idx, j_idx, err_msg="the teacher's vote-mode FPS picked other "
        "aggregation points than JAX; choose another SEMI_SEED")
    assert j_valid[N_LABELED:].sum() > 0
    np.testing.assert_array_equal(t_valid, j_valid)
    np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_allclose(t_quality, j_quality, **STEP_TOL)
    for got, want in zip(t["ulb"], j["ulb"]):
        np.testing.assert_array_equal(got, want)


def test_init_weights_flax_covers_saqe(weights):
    """``init_weights_flax_`` redraws every SAQE parameter: each Linear
    weight within flax's truncation bound and not the old one, biases and
    BN shifts 0, BN scales 1, BN running statistics 0 and 1."""
    from nesie_tpu_torch.nn.detector import init_weights_flax_

    _, _, model = weights
    fresh = copy.deepcopy(model)
    init_weights_flax_(fresh, torch.Generator().manual_seed(0))
    old = model.state_dict()
    n_weights = 0
    for name, m in fresh.named_modules():
        if isinstance(m, torch.nn.Linear):
            bound = 2.0 / np.sqrt(m.in_features) / 0.87962566103423978
            assert m.weight.abs().max() <= bound * (1 + 1e-6), name
            assert not torch.equal(m.weight, old[f"{name}.weight"]), name
            if m.bias is not None:
                assert not m.bias.any(), name
            n_weights += 1
        elif isinstance(m, torch.nn.BatchNorm1d):
            assert (m.weight == 1).all() and not m.bias.any(), name
            assert not m.running_mean.any() and (m.running_var == 1).all()
    # the quality module alone: 6 x 4 MiniPointNet, 6 x 2 side head and 3
    # fused head Linears
    assert sum(1 for n, m in fresh.bbox_head.grid_conv.named_modules()
               if isinstance(m, torch.nn.Linear)) == 39
    assert n_weights > 39
