"""The port's head, training and eval options against the JAX package's,
on the CPU: ``PointSAModule(target_xyz=)``, the backbone's real FPS at
SA2-SA4 (``fps_prefix_opt=False``), the ``random`` and ``spec`` sample
modes and the real seed FPS (``seed_fps_prefix_opt=False``) of both
heads, the class-independent quality modules (``iou_class_depend=
False``), the bf16 backbone (``compute_dtype="bfloat16"``), test-time IoU
optimisation (``iou_opt_boxes``) and the semi step with
``teacher_jitter=True``.

Model: ``tests/test_saqe.py``'s TINY shape (4 classes, reg_max 8, 16
proposals, SA points 64/32/16/16), with either head; weights from a
seeded port model with randomised BN, carried to flax by
``nesie_tpu.convert_torch.convert_state_dict`` and back by
``state_dict_from_flax``.

Neighbour searches, as in ``test_torch_saqe``: the quality modules and
``iou_opt_boxes`` alone run JAX's Pallas three-NN in interpret mode; the
backbone, the heads and the steps run the JAX model with
``test_torch_train_support``'s jnp searches, which have the Pallas
kernels' semantics at every shape (at TINY's sample counts the JAX
package would take its matmul-form ball query, which can order near-ties
otherwise). The ``random`` mode's seed indices are JAX's
``jax.random.randint`` draw, passed to the port; the port's own draw is
checked for range and reproducibility, never against JAX's stream.

Tolerances (TF32 off: no GPU here): float32 forwards atol 1e-4, rtol
1e-4, the quality modules atol 1e-5, rtol 1e-5; the bf16 backbone and
detector against JAX's bf16 atol 5e-2, rtol 5e-2 (XLA's and torch's CPU
bf16 dots round differently) and against the port's float32 within
``BF16_VS_F32``; ``iou_opt_boxes`` atol 1e-5, rtol 1e-5; the float64
semi step as ``test_torch_train_semi``: loss terms atol 1e-4, rtol 1e-4,
gradients and updated parameters atol 1e-4, rtol 1e-3; integer outputs
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nesie_tpu.nn.nesie_head as jnesie_head
import nesie_tpu.nn.saqe_head as jsaqe_head
import nesie_tpu.nn.side_pooling as jside_pooling
import nesie_tpu.ops.pointops as jpo
import test_torch_train_support as S
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.data.augment import AugParams as JAug
from nesie_tpu.eval.iou_opt import iou_opt_boxes as j_iou_opt_boxes
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu.nn.nesie_head import NesieHead as JNesieHead
from nesie_tpu.nn.pointnet2 import PointNet2SASSG as JPointNet2SASSG
from nesie_tpu.nn.pointnet2 import PointSAModule as JPointSAModule
from nesie_tpu.nn.quality_estimation import QualityEstimation as JQuality
from nesie_tpu.nn.saqe_head import SAQEHead as JSAQEHead
from nesie_tpu.nn.side_pooling import SidePooling as JSidePooling
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import semi as jsemi
from nesie_tpu.train import state as jstate
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data.augment import AugParams
from nesie_tpu_torch.eval.iou_opt import iou_opt_boxes
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.nn.nesie_head import random_sample_indices
from nesie_tpu_torch.nn.quality_estimation import QualityEstimation
from nesie_tpu_torch.nn.side_pooling import SidePooling
from nesie_tpu_torch.train import semi as tsemi
from nesie_tpu_torch.train import state as tstate
from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

C, P, SEED_DIM = 4, 16, 32
TINY = dict(
    num_classes=C,
    reg_max=8,
    num_proposal=P,
    num_points=(64, 32, 16, 16),
    radii=(0.2, 0.4, 0.8, 1.2),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
HEAD_KW = {"nesie": {}, "saqe": dict(head="saqe", jitter_scale=0.5,
                                     jitter_size_bias=0.2)}
TOL = dict(atol=1e-4, rtol=1e-4)
QE_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# the bf16 port against its own float32: each backbone output within
# atol + rtol * |x|, and the share of proposals whose boxes, objectness
# and IoU scores all agree so
BF16_VS_F32 = dict(atol=5e-2, rtol=5e-2, min_agree=0.9)
OPT_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-4, rtol=1e-3)
JAX_COMPILE = {"xla_disable_hlo_passes": "fusion"}  # test_torch_train_semi


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _vars(params, stats):
    return {"params": params, "batch_stats": stats}


def _weights(head, seed=0, **extra):
    """(params, batch_stats) of the JAX package and the port model loaded
    from them (eval mode), from a seeded port model with randomised BN."""
    kw = dict(TINY, **HEAD_KW[head], **extra)
    src = VoteNetNesie(**kw)
    gen = torch.Generator().manual_seed(seed)
    init_weights_(src, gen)
    randomize_bn_(src, gen)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}, head=head)
    model = VoteNetNesie(**kw)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return params, stats, model.eval()


@pytest.fixture(scope="module")
def weights():
    return {head: _weights(head) for head in HEAD_KW}


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jpo, "_3NN_IMPL", "pallas")


@pytest.fixture
def jnp_searches(monkeypatch):
    """The JAX model's neighbour searches on ``test_torch_train_support``'s
    jnp versions (float32), the heads' seed FPS too."""
    monkeypatch.setattr(jnesie_head, "furthest_point_sample", S.j_fps)
    monkeypatch.setattr(jsaqe_head, "furthest_point_sample", S.j_fps)
    with S.jax_float64(x64=False):
        yield


def _assert_results_close(got: dict, want: dict, tol, keys=None):
    keys = sorted(want) if keys is None else keys
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in keys:
        if want[k] is None:
            assert got[k] is None, k
        elif got[k].dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       err_msg=k, **tol)


def _cloud(seed, b=2, n=512):
    return S.scenes(seed, b)[0][0][:, :n].astype(np.float32)


# ---- PointNet++: explicit centres, real FPS at SA2-SA4 ---------------------

def test_sa_module_target_xyz(weights, jnp_searches):
    """``target_xyz`` replaces the sample: the ball query is centred on
    the given points and no indices come back (SA2's weights)."""
    params, stats, model = weights["nesie"]
    rng = np.random.default_rng(1)
    xyz = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 32)).astype(np.float32)
    target = rng.uniform(size=(2, 24, 3)).astype(np.float32)
    jmod = JPointSAModule(num_point=32, radius=0.4, num_sample=8,
                          mlp_channels=(32, 32, 32))
    new_xyz, out, idx = jmod.apply(
        _vars(params["backbone"]["sa1"], stats["backbone"]["sa1"]),
        xyz, feats, target_xyz=target)
    assert idx is None
    with torch.no_grad():
        got_xyz, got, got_idx = model.backbone.SA_modules[1](
            _t(xyz), _t(feats), target_xyz=_t(target))
    assert got_idx is None and got.shape == (2, 24, 32)
    np.testing.assert_array_equal(_np(got_xyz), np.asarray(new_xyz))
    np.testing.assert_allclose(_np(got), np.asarray(out), **TOL)


def test_backbone_real_fps(weights, jnp_searches, monkeypatch):
    """``fps_prefix_opt=False``: SA2-SA4 sample by FPS too (four FPS
    calls); the indices equal JAX's. (By prefix consistency they are the
    ``arange`` of the default here, but for exact ties.)"""
    import nesie_tpu_torch.nn.pointnet2 as tpointnet2

    calls = []
    fps = tpointnet2.furthest_point_sample
    monkeypatch.setattr(tpointnet2, "furthest_point_sample",
                        lambda x, m: calls.append(m) or fps(x, m))
    params, stats, _ = weights["nesie"]
    pts = _cloud(3)
    jbb = JPointNet2SASSG(num_points=TINY["num_points"],
                          num_samples=TINY["num_samples"],
                          sa_channels=TINY["sa_channels"],
                          fp_channels=TINY["fp_channels"],
                          fps_prefix_opt=False)
    want = jbb.apply(_vars(params["backbone"], stats["backbone"]), pts)
    model = VoteNetNesie(**TINY)
    model.load_state_dict(state_dict_from_flax(params, stats))
    model.backbone = type(model.backbone)(
        num_points=TINY["num_points"], num_samples=TINY["num_samples"],
        sa_channels=TINY["sa_channels"], fp_channels=TINY["fp_channels"],
        fps_prefix_opt=False)
    model.load_state_dict(state_dict_from_flax(params, stats))
    with torch.no_grad():
        got = model.eval().backbone(_t(pts))
    for key in ("sa_indices", "fp_indices", "sa_xyz"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=key)
    for key in ("sa_features", "fp_features"):
        for g, w in zip(got[key][1:], want[key][1:]):
            np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=key,
                                       **TOL)
    assert calls == list(TINY["num_points"])


# ---- the heads' sample modes ------------------------------------------------

def _head_inputs(seed=4):
    rng = np.random.default_rng(seed)
    B, n = 2, 32
    seed_xyz = rng.uniform(size=(B, n, 3)).astype(np.float32)
    seed_feats = rng.normal(size=(B, n, SEED_DIM)).astype(np.float32)
    seed_idx = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    return seed_xyz, seed_feats, seed_idx


@pytest.mark.parametrize("head", ["nesie", "saqe"])
@pytest.mark.parametrize("sample_mod,prefix_opt", [
    ("random", True), ("spec", True), ("seed", False)])
def test_head_sample_modes(weights, jnp_searches, head, sample_mod,
                           prefix_opt):
    """Eval forward of each head: ``random`` with JAX's draw passed in,
    ``spec`` (P = the 32 seeds, no aggregation indices) and ``seed`` with
    the real seed FPS."""
    params, stats, model = weights[head]
    xyz, feats, idx = _head_inputs()
    cls = JSAQEHead if head == "saqe" else JNesieHead
    jmod = cls(num_classes=C, reg_max=8, num_proposal=P,
               seed_feat_dim=SEED_DIM, vote_conv_channels=(SEED_DIM,) * 2,
               seed_fps_prefix_opt=prefix_opt)
    key = jax.random.PRNGKey(7)

    def run(v, x, f, i):
        fd = dict(fp_xyz=[x], fp_features=[f], fp_indices=[i])
        return jmod.apply(v, fd, sample_mod, key, train=False,
                          with_jitter=False)

    want = jax.jit(run)(_vars(params["bbox_head"], stats["bbox_head"]),
                        xyz, feats, idx)
    draw = None
    if sample_mod == "random":  # the head's first split of its key
        draw = torch.from_numpy(np.array(jax.random.randint(
            jax.random.split(key)[1], (2, P), 0, 32, dtype=jnp.int32)))
        np.testing.assert_array_equal(
            draw.numpy(), np.asarray(want["aggregated_indices"]))
    fd = dict(fp_xyz=[_t(xyz)], fp_features=[_t(feats)],
              fp_indices=[torch.from_numpy(idx)])
    model.bbox_head.seed_fps_prefix_opt = prefix_opt
    try:
        with torch.no_grad():
            got = model.bbox_head(fd, sample_mod, sample_indices=draw)
    finally:
        model.bbox_head.seed_fps_prefix_opt = True
    _assert_results_close(got, want, TOL)
    n_prop = 32 if sample_mod == "spec" else P
    assert got["bbox_preds"].shape == (2, n_prop, 7)
    if sample_mod == "seed":
        assert not (_np(got["aggregated_indices"]) == np.arange(P)).all()


def test_random_draw_in_range_and_reproducible(weights):
    """The port's own ``random`` draw: int32 indices in [0, seeds), the
    same from the same generator seed, drawn before the jitter noise."""
    a = random_sample_indices((3, 50), 40, torch.Generator().manual_seed(5),
                              torch.device("cpu"))
    b = random_sample_indices((3, 50), 40, torch.Generator().manual_seed(5),
                              torch.device("cpu"))
    c = random_sample_indices((3, 50), 40, torch.Generator().manual_seed(6),
                              torch.device("cpu"))
    assert a.dtype == torch.int32 and a.shape == (3, 50)
    assert int(a.min()) >= 0 and int(a.max()) < 40
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, _, model = weights["nesie"]
    xyz, feats, idx = _head_inputs()
    fd = dict(fp_xyz=[_t(xyz)], fp_features=[_t(feats)],
              fp_indices=[torch.from_numpy(idx)])
    with torch.no_grad():
        out = model.bbox_head(fd, "random", with_jitter=True,
                              generator=torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        draw = random_sample_indices((2, P), 32, gen, torch.device("cpu"))
        again = model.bbox_head(fd, "random", with_jitter=True,
                                generator=gen, sample_indices=draw)
    assert torch.equal(out["aggregated_indices"], draw)
    for k in ("bbox_preds", "jitter_bbox_preds", "iou_scores_jitter"):
        assert torch.equal(out[k], again[k]), k
    with pytest.raises(ValueError, match="sample_indices or a generator"):
        model.bbox_head(fd, "random")


# ---- class-independent quality modules ---------------------------------------

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


def _perturbed(stats, seed):
    """Every BN running mean and variance of a flax tree moved off 0/1."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        a = np.asarray(t)
        return a + rng.uniform(0.0, 0.5, a.shape).astype(a.dtype)
    return walk(stats)


@pytest.mark.parametrize("head", ["nesie", "saqe"])
def test_quality_module_class_independent(weights, pallas_interpret, head):
    """``iou_class_depend=False``: JAX's module initialised alone, carried
    into the port's model by ``state_dict_from_flax`` (its width-1 output
    layers), and its eval outputs (one score a box) compared."""
    params, stats, _ = weights[head]
    inputs = _quality_inputs()
    if head == "saqe":
        jmod = JQuality(num_classes=C, seed_feat_dim=SEED_DIM, reg_max=8,
                        iou_class_depend=False)
        tmod = QualityEstimation(C, SEED_DIM, reg_max=8,
                                 iou_class_depend=False)
    else:
        jmod = JSidePooling(num_classes=C, seed_feat_dim=SEED_DIM, reg_max=8,
                            iou_class_depend=False)
        tmod = SidePooling(C, SEED_DIM, reg_max=8, iou_class_depend=False)
    variables = jmod.init(jax.random.PRNGKey(3), *inputs)
    gstats = _perturbed(variables["batch_stats"], 4)
    want = jmod.apply(_vars(variables["params"], gstats), *inputs)
    full_p = {**params, "bbox_head": {**params["bbox_head"],
                                      "grid_conv": variables["params"]}}
    full_s = {**stats, "bbox_head": {**stats["bbox_head"],
                                     "grid_conv": gstats}}
    model = VoteNetNesie(**TINY, **HEAD_KW[head])
    model.bbox_head.grid_conv = tmod
    model.load_state_dict(state_dict_from_flax(full_p, full_s), strict=True)
    with torch.no_grad():
        got = model.eval().bbox_head.grid_conv(*map(_t, inputs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] in (1, 2)
        np.testing.assert_allclose(_np(g), np.asarray(w), **QE_TOL)


# ---- the bf16 backbone -------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_pair():
    """JAX's and the port's detector with ``compute_dtype="bfloat16"``
    and the float32 port, on the same weights; their seed-mode eval
    forwards on one batch."""
    params, stats, f32 = _weights("nesie")
    pts = _cloud(6)
    bf16 = VoteNetNesie(**TINY, compute_dtype="bfloat16")
    bf16.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    jmodel = JVoteNetNesie(**TINY, compute_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnesie_head, "furthest_point_sample", S.j_fps)
        with S.jax_float64(x64=False):
            want = jax.jit(lambda v, p: jmodel.apply(
                v, p, "seed", jax.random.PRNGKey(0), train=False,
                with_jitter=False))(_vars(params, stats), pts)
            jbb = jax.jit(lambda v, p: jmodel.apply(
                v, p, method=lambda m, x: m.backbone(x)))(
                    _vars(params, stats), pts)
    with torch.no_grad():
        got = bf16.eval()(_t(pts))
        got_bb = bf16.backbone(_t(pts))
        ref = f32(_t(pts))
        ref_bb = f32.backbone(_t(pts))
    return dict(bf16=bf16, f32=f32, want=want, jbb=jbb, got=got,
                got_bb=got_bb, ref=ref, ref_bb=ref_bb)


def test_bf16_model_loads_float32_weights(bf16_pair):
    """Parameters and BN statistics stay float32 and equal the float32
    model's; the backbone's MLPs compute in bf16 and hand float32 on."""
    a, b = bf16_pair["bf16"].state_dict(), bf16_pair["f32"].state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for feats in bf16_pair["got_bb"]["fp_features"]:
        assert feats.dtype == torch.float32
    assert bf16_pair["bf16"].backbone.SA_modules[0].mlps[0].layer0.dtype \
        == torch.bfloat16
    assert bf16_pair["bf16"].bbox_head.vote_aggregation.mlps[0].dtype is None


def test_bf16_backbone_matches_jax_bf16(bf16_pair):
    """Indices exactly (FPS and ball queries take float32 coordinates);
    features within BF16_TOL of JAX's bf16 backbone."""
    got, want = bf16_pair["got_bb"], bf16_pair["jbb"]
    for key in ("sa_indices", "fp_indices"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=key)
    for key in ("sa_features", "fp_features"):
        for g, w in zip(got[key][1:], want[key][1:]):
            assert np.asarray(w).dtype == np.float32
            np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=key,
                                       **BF16_TOL)


def _agree(got, want, keys, atol, rtol):
    """Share of proposals whose ``keys`` all agree within atol + rtol|x|."""
    ok = None
    for k in keys:
        g, w = _np(got[k]), np.asarray(want[k])
        close = (np.abs(g - w) <= atol + rtol * np.abs(w)).reshape(
            g.shape[0], g.shape[1], -1).all(-1)
        ok = close if ok is None else ok & close
    return ok.mean()


def test_bf16_detector_matches_jax_bf16_and_port_f32(bf16_pair):
    """The bf16 detector's eval forward: against JAX's bf16 detector and
    against the port's float32 one, the share of proposals whose boxes,
    objectness and IoU scores agree within the stated tolerance; the
    seed indices exactly, and the bf16 forward differs from float32."""
    keys = ("bbox_preds", "obj_scores", "iou_scores")
    got, want, ref = bf16_pair["got"], bf16_pair["want"], bf16_pair["ref"]
    np.testing.assert_array_equal(_np(got["seed_indices"]),
                                  np.asarray(want["seed_indices"]))
    assert _agree(got, want, keys, BF16_TOL["atol"], BF16_TOL["rtol"]) \
        >= BF16_VS_F32["min_agree"]
    assert _agree(got, ref, keys, BF16_VS_F32["atol"], BF16_VS_F32["rtol"]) \
        >= BF16_VS_F32["min_agree"]
    for g, r in zip(bf16_pair["got_bb"]["fp_features"][1:],
                    bf16_pair["ref_bb"]["fp_features"][1:]):
        np.testing.assert_allclose(_np(g), _np(r), atol=BF16_VS_F32["atol"],
                                   rtol=BF16_VS_F32["rtol"])
    assert not torch.equal(got["bbox_preds"], ref["bbox_preds"])


# ---- test-time IoU optimisation ---------------------------------------------

@pytest.fixture(scope="module", params=[1e-2, 20.0])
def iou_opt_pair(weights, request):
    """``tests/test_postprocess.py:100``'s shape (4 classes, 16 proposals,
    one cloud of 256 points, opt_step 3) at its opt_rate 1e-2 and at 20,
    where the steps move the boxes by millimetres: JAX's
    ``iou_opt_boxes`` on its forward's results, and the port's on the same
    results. Returns both, the results and a counter of the port's
    quality-module calls."""
    from jax.experimental import pallas as pl

    rate = request.param

    params, stats, model = weights["nesie"]
    pts = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, 256, 4)))
    jmodel = JVoteNetNesie(**TINY)
    variables = _vars(params, stats)
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        mp.setattr(jpo, "_3NN_IMPL", "pallas")
        with S.jax_float64(x64=False):
            # the quality module's three-NN: the Pallas kernel
            mp.setattr(jside_pooling, "three_nn", jpo.three_nn)
            out = jax.jit(lambda v, p: jmodel.apply(
                v, p, "seed", jax.random.PRNGKey(0), train=False,
                with_jitter=False))(variables, pts)
            refined = jax.jit(lambda v, o: j_iou_opt_boxes(
                jmodel, v, o, opt_rate=rate, opt_step=3))(variables, out)

            def j_iou_sum(bbox):
                s = jmodel.apply(variables, out, bbox[..., :3],
                                 bbox[..., 3:6], jnp.zeros_like(bbox[..., 6]),
                                 method=JVoteNetNesie.quality_scores)
                return float(jnp.sum(s))

            j_sums = [j_iou_sum(out["bbox_preds"]),
                      j_iou_sum(refined["bbox_preds"])]
    results = {k: torch.from_numpy(np.array(v)) for k, v in out.items()
               if v is not None}
    calls = []
    orig_q = model.quality_scores

    def counting(*args):
        calls.append(1)
        return orig_q(*args)

    model.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model, "quality_scores", counting)
        got = iou_opt_boxes(model, results, opt_rate=rate, opt_step=3)
    return dict(model=model, results=results, got=got, want=refined,
                calls=len(calls), j_sums=j_sums, rate=rate)


def test_iou_opt_matches_jax(iou_opt_pair):
    """Refined boxes within OPT_TOL of JAX's; headings and the other
    results untouched; opt_step + 1 = 4 quality passes."""
    got, want = iou_opt_pair["got"], iou_opt_pair["want"]
    before = iou_opt_pair["results"]["bbox_preds"]
    np.testing.assert_allclose(_np(got["bbox_preds"]),
                               np.asarray(want["bbox_preds"]), **OPT_TOL)
    moved = (got["bbox_preds"][..., :6] - before[..., :6]).abs().max()
    assert moved > 2e-4 * iou_opt_pair["rate"]
    assert torch.equal(got["bbox_preds"][..., 6], before[..., 6])
    for k, v in iou_opt_pair["results"].items():
        if k != "bbox_preds":
            assert torch.equal(got[k], v), k
    assert iou_opt_pair["calls"] == 4


def test_iou_opt_ascends_and_leaves_no_gradients(iou_opt_pair):
    """Gradient ascent: the summed quality score of the refined boxes is
    not below that of the forward's (the port's, and JAX's); the model is
    left in eval mode with no parameter gradient."""
    model, results = iou_opt_pair["model"], iou_opt_pair["results"]

    def iou_sum(bbox):
        with torch.no_grad():
            return float(model.quality_scores(
                results, bbox[..., :3], bbox[..., 3:6],
                torch.zeros_like(bbox[..., 6])).sum())

    assert iou_sum(iou_opt_pair["got"]["bbox_preds"]) \
        >= iou_sum(results["bbox_preds"]) - 1e-6
    j0, j1 = iou_opt_pair["j_sums"]
    assert j1 >= j0 - 1e-6
    np.testing.assert_allclose(iou_sum(results["bbox_preds"]), j0, rtol=1e-5)
    assert not model.training
    assert all(p.grad is None for p in model.parameters())


# ---- the semi step with teacher_jitter ---------------------------------------

N_LABELED, N_UNLABELED = 1, 2
SEMI_B = N_LABELED + N_UNLABELED
NUM_SCANS, NUM_LABELED_SCANS = 6, 3
SCAN_IDX = np.array([0, 4, 4])
SEMI_SEED = 0  # test_torch_train_semi's: the vote-mode FPS agrees
SEMI_P = S.TINY["num_proposal"]
PL = dict(num_classes=18, obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0,
          cls_thr_cap=0.0, iou_thr_base=0.3, iou_thr_scale=0.0,
          iou_thr_cap=0.3)
LR = 1e-3


def _semi_batch():
    pts, boxes, labels, valid = S.scenes(SEMI_SEED, SEMI_B, views=2)
    rng = np.random.default_rng(SEMI_SEED + 100)
    return dict(points_raw_s=pts[0], points_raw_t=pts[1], gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid,
                aug_s=S.sample_aug(rng, SEMI_B), aug_t=S.identity_aug(SEMI_B),
                ulb_scan_idx=SCAN_IDX)


def _initial_ulb():
    ulb_list = np.zeros((NUM_SCANS, 18))
    ulb_list[1] = np.arange(18.0)
    ulb_flag = np.ones(NUM_SCANS)
    ulb_flag[1] = 0.0
    return ulb_list, ulb_flag


def _jax_semi(params, stats, data, key):
    """JAX's semi step with ``teacher_jitter=True`` (float64, jitted with
    XLA's fusion pass off); returns the noise of teacher and student and
    what the step saw and produced."""
    seen = {}

    def get_pseudo_labels(teacher_results, acc, cfg):
        lab = jpl.get_pseudo_labels(teacher_results, acc, cfg)
        jax.debug.callback(
            lambda *xs: seen.setdefault("teacher", [np.array(x) for x in xs]),
            teacher_results["iou_scores_jitter"], lab.valid, lab.labels,
            lab.quality)
        return lab

    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsemi, "get_pseudo_labels", get_pseudo_labels)
        jmodel = JVoteNetNesie(**S.TINY)
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
            pl_cfg=jpl.PseudoLabelConfig(**PL), teacher_jitter=True)
        step = step.lower(state, ulb0, jbatch, key).compile(
            compiler_options=JAX_COMPILE)
        new, new_ulb, metrics = step(state, ulb0, jbatch, key)
        jax.block_until_ready(metrics)
        rng_t, rng_s = jax.random.split(key)
        shape = (SEMI_B, SEMI_P, 3)
        noise = (S.jitter_noise(rng_t, shape), S.jitter_noise(rng_s, shape))
        return noise, dict(
            seen=seen, metrics={k: float(v) for k, v in metrics.items()},
            ulb=[np.asarray(x) for x in new_ulb],
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats))


def _torch_semi(model, data, noise, teacher_jitter=True):
    seen, grads = {}, {}
    state = create_train_state(model, make_lr_schedule(LR, 10), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if not isinstance(v, dict)}
    for k in ("aug_s", "aug_t"):
        batch[k] = AugParams(*(torch.from_numpy(np.asarray(data[k][f]))
                               for f in S.AUG_FIELDS))
    ulb = UlbState(*(torch.from_numpy(x) for x in _initial_ulb()))
    names = [n for n, _ in state.model.named_parameters()]
    get_pl, clip = tsemi.get_pseudo_labels, tstate.clip_by_global_norm_

    def get_pseudo_labels(teacher_results, acc, cfg, rows=None):
        lab = get_pl(teacher_results, acc, cfg, rows)
        seen["teacher"] = [
            teacher_results.get("iou_scores_jitter", torch.zeros(0)).numpy(),
            lab.valid.numpy(), lab.labels.numpy(), lab.quality.numpy()]
        return lab

    def recording_clip(gs, max_norm):
        grads.update({n: g.clone() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    step = make_semi_train_step(N_LABELED, NUM_LABELED_SCANS,
                                pl_cfg=PseudoLabelConfig(**PL),
                                teacher_jitter=teacher_jitter)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsemi, "get_pseudo_labels", get_pseudo_labels)
        mp.setattr(tstate, "clip_by_global_norm_", recording_clip)
        new_ulb, metrics = step(state, ulb, batch, noise=noise[1],
                                teacher_noise=noise[0])
    return dict(seen=seen, metrics={k: float(v) for k, v in metrics.items()},
                ulb=[x.numpy() for x in new_ulb], grads=grads,
                params=state.model.state_dict(), state=state)


@pytest.fixture(scope="module")
def semi_run():
    params, stats, _ = S.weights(0)
    data = _semi_batch()
    noise, jax_side = _jax_semi(params, stats, data, jax.random.PRNGKey(3))
    torch_side = _torch_semi(S.weights(0)[2], data, noise)
    plain = _torch_semi(S.weights(0)[2], data, noise, teacher_jitter=False)
    return jax_side, torch_side, plain


def test_teacher_jitter_pseudo_labels_match(semi_run):
    """The teacher's jittered half and its pseudo-labels equal JAX's; its
    train-mode BN statistics over 2P rows move the pseudo-label quality
    away from the teacher without jitter."""
    j, t, plain = semi_run
    j_jit, j_valid, j_labels, j_quality = j["seen"]["teacher"]
    t_jit, t_valid, t_labels, t_quality = t["seen"]["teacher"]
    assert j_valid[N_LABELED:].sum() > 0
    assert t_jit.shape == (SEMI_B, SEMI_P, 18)
    np.testing.assert_allclose(t_jit, j_jit, **STEP_TOL)
    np.testing.assert_array_equal(t_valid, j_valid)
    np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_allclose(t_quality, j_quality, **STEP_TOL)
    for got, want in zip(t["ulb"], j["ulb"]):
        np.testing.assert_array_equal(got, want)
    p_quality = plain["seen"]["teacher"][3]
    assert plain["seen"]["teacher"][0].size == 0
    assert not np.allclose(p_quality, t_quality, atol=1e-6)


def test_teacher_jitter_step_matches_jax(semi_run):
    """Loss terms, gradients and the updated parameters and BN
    statistics of the float64 step."""
    j, t, _ = semi_run
    assert set(t["metrics"]) == set(j["metrics"])
    assert j["metrics"]["num_pseudo"] > 0
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(t["metrics"][k], v, err_msg=k, **LOSS_TOL)
    assert set(t["grads"]) == set(j["grads"])
    S.assert_state_dicts_close(t["grads"], j["grads"], STEP_TOL)
    S.assert_state_dicts_close(t["params"], j["params"], STEP_TOL)
    assert t["state"].step == 1


# ---- the CLIs ------------------------------------------------------------------

def test_cli_round_trip_with_iou_opt(tmp_path):
    """The port's train CLI (pretrain, one epoch) then its test CLI with
    and without ``test.iou_opt=true`` on a tiny written dataset: the
    dumped boxes move, their headings stay, the metrics are in [0, 1]."""
    from nesie_tpu_torch.data.synthetic import write_synthetic_scannet
    from nesie_tpu_torch.tools import test as ttest
    from nesie_tpu_torch.tools import train as ttrain

    data = write_synthetic_scannet(tmp_path / "data", 6, 2, seed=0)
    model = [f"model.{k}={v}" for k, v in TINY.items()
             if k != "num_classes"] + ["data.num_points=1024"]
    name = "nesie-votenet-scannet-pretrain-010"
    ttrain.main([name, "--data-root", str(data), "--work-dir",
                 str(tmp_path / "work"), "--device", "cpu", "--cfg-options",
                 *model, "optim.max_epochs=1", "data.repeat=1",
                 "data.samples_per_step=1"])
    ckpt = tmp_path / "work" / name / "checkpoints"
    dumps = {}
    for opt in ("false", "true"):
        dumps[opt] = tmp_path / f"raw_{opt}"
        res = ttest.main([name, str(ckpt), "--data-root", str(data),
                          "--device", "cpu", "--batch-size", "2",
                          "--dump-raw", str(dumps[opt]), "--cfg-options",
                          *model, f"test.iou_opt={opt}",
                          "test.opt_rate=1.0"])
        assert 0.0 <= res["mAP_0.25"] <= 1.0
    files = sorted(p.name for p in dumps["false"].glob("*.npz"))
    assert len(files) == 2
    for f in files:
        plain = np.load(dumps["false"] / f)["bbox_preds"]
        opt = np.load(dumps["true"] / f)["bbox_preds"]
        np.testing.assert_array_equal(opt[..., 6], plain[..., 6])
        assert not np.array_equal(opt[..., :6], plain[..., :6])
        assert np.isfinite(opt).all()


def test_init_detector_honours_sample_mod_and_dtype(tmp_path):
    """``init_detector(config name)`` with ``test.sample_mod=random`` and
    ``model.compute_dtype=bfloat16``: a bf16 backbone, a generator seeded
    with the config's seed that draws anew for every request, and the
    same answers from a second detector of the same config."""
    from nesie_tpu_torch.apis import init_detector

    over = [f"model.{k}={v}" for k, v in TINY.items()
            if k != "num_classes"] + ["data.num_points=1024",
                                      "test.sample_mod=random",
                                      "model.compute_dtype=bfloat16",
                                      "test.score_thr=0.0"]
    cloud = S.scenes(8, 1)[0][0][0][:, :3].astype(np.float32)
    dets = [init_detector("nesie-votenet-scannet-train-010", device="cpu",
                          cfg_options=over) for _ in range(2)]
    assert dets[0].cfg.sample_mod == "random"
    assert dets[0].model.backbone.SA_modules[0].mlps[0].layer0.dtype \
        == torch.bfloat16
    first = [d(cloud) for d in dets]
    second = dets[0](cloud)
    for k in ("boxes_3d", "scores_3d", "labels_3d"):
        np.testing.assert_array_equal(first[0][k], first[1][k])
        assert np.isfinite(first[0][k]).all()
    assert len(first[0]["boxes_3d"]) > 0
    assert not np.array_equal(first[0]["boxes_3d"], second["boxes_3d"])
