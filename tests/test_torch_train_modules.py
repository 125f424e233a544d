"""The port's training modules against their JAX counterparts on the same
numpy inputs: train-mode BatchNorm, the head's vote mode and jittered
proposals, the augmentations, the IoU functions, and the optimizer, LR
schedule and EMA teacher.

Tolerances: atol 1e-5, rtol 1e-5 in float32 for the pure functions and
one BN layer (sums in another order); the head in train mode is compared
in float64 (see ``test_torch_train_support``) at atol 1e-8, rtol 1e-8;
the optimizer against optax at atol 1e-6, rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train_support as S
from nesie_tpu.core import iou as jiou
from nesie_tpu.data import augment as jaug
from nesie_tpu.nn.layers import PointMLP as JPointMLP
from nesie_tpu.nn.nesie_head import NesieHead as JNesieHead
from nesie_tpu.nn.nesie_head import jitter_boxes as jjitter_boxes
from nesie_tpu.train import state as jstate
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.core import iou as tiou
from nesie_tpu_torch.data import augment as taug
from nesie_tpu_torch.nn.layers import BatchNorm, PointMLP, frozen_bn_stats
from nesie_tpu_torch.nn.nesie_head import jitter_boxes, jitter_noise
from nesie_tpu_torch.train import state as tstate

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
F64 = dict(atol=1e-8, rtol=1e-8)


def _boxes(rng, n, spread=2.0):
    c = rng.uniform(-spread, spread, (n, 3))
    s = rng.uniform(0.2, 1.5, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([c, s, yaw], -1).astype(np.float32)


# ---- train-mode BatchNorm ----------------------------------------------

@pytest.fixture
def mlp_pair():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 50, 7, 6)) * 2 + 1).astype(np.float32)
    jmlp = JPointMLP((16, 8))
    variables = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    # BN affine and running stats away from 1 / 0
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), variables["batch_stats"])
    for k in params:
        if k.startswith("norm"):
            params[k] = {n: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                         for n, v in params[k].items()}
    tmlp = PointMLP(6, (16, 8))
    sd = {}
    for j in range(2):
        sd[f"layer{j}.conv.weight"] = params[f"dense{j}"]["kernel"].T
        sd[f"layer{j}.bn.weight"] = params[f"norm{j}"]["scale"]
        sd[f"layer{j}.bn.bias"] = params[f"norm{j}"]["bias"]
        sd[f"layer{j}.bn.running_mean"] = stats[f"norm{j}"]["mean"]
        sd[f"layer{j}.bn.running_var"] = stats[f"norm{j}"]["var"]
        sd[f"layer{j}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    tmlp.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return x, jmlp, params, stats, tmlp


def test_train_bn_output_and_running_stats(mlp_pair):
    """Batch statistics with flax's fast biased variance; running stats
    updated to 0.9 old + 0.1 batch with that same variance."""
    x, jmlp, params, stats, tmlp = mlp_pair
    want, mutated = jmlp.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    got = tmlp.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for j in range(2):
        bn = getattr(tmlp, f"layer{j}").bn
        new = mutated["batch_stats"][f"norm{j}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"], **TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), new["var"], **TOL)


def test_train_bn_gradients(mlp_pair):
    x, jmlp, params, stats, tmlp = mlp_pair

    def loss(p, inp):
        out, _ = jmlp.apply({"params": p, "batch_stats": stats}, inp,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out))

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(tmlp.train()(xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    for j in range(2):
        layer = getattr(tmlp, f"layer{j}")
        np.testing.assert_allclose(layer.bn.weight.grad.numpy(),
                                   gp[f"norm{j}"]["scale"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(layer.conv.weight.grad.numpy(),
                                   np.asarray(gp[f"dense{j}"]["kernel"]).T,
                                   atol=1e-4, rtol=1e-4)


def test_frozen_bn_stats_keeps_running_stats(mlp_pair):
    """The teacher's mode: batch statistics for the output, running
    statistics untouched; the flag is restored afterwards."""
    x, jmlp, params, stats, tmlp = mlp_pair
    tmlp.train()
    before = {k: v.clone() for k, v in tmlp.state_dict().items()}
    with torch.no_grad(), frozen_bn_stats(tmlp):
        got = tmlp(torch.from_numpy(x))
    for k, v in tmlp.state_dict().items():
        assert torch.equal(v, before[k]), k
    want, _ = jmlp.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(m.update_stats for m in tmlp.modules()
               if isinstance(m, BatchNorm))


def test_eval_bn_uses_running_stats(mlp_pair):
    x, jmlp, params, stats, tmlp = mlp_pair
    want = jmlp.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmlp.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the head: vote mode and jittered proposals -------------------------

def test_jitter_boxes_matches_jax():
    """The port is fed the two normal draws that JAX takes from the key."""
    rng = np.random.default_rng(1)
    bbox = _boxes(rng, 40).reshape(2, 20, 7)
    key = jax.random.PRNGKey(7)
    want = jjitter_boxes(key, jnp.asarray(bbox), 0.3, 0.1)
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (2, 20, 3))))
                  for k in (k1, k2))
    got = jitter_boxes(torch.from_numpy(bbox), noise, 0.3, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_jitter_noise_from_generator():
    gen = torch.Generator().manual_seed(3)
    n1, n2 = jitter_noise((2, 5, 3), gen, torch.device("cpu"))
    assert n1.shape == n2.shape == (2, 5, 3) and not torch.equal(n1, n2)


@pytest.fixture(scope="module")
def head_outputs():
    """JAX and port NesieHead in train mode, sample_mod="vote", with the
    jittered copies, on the same seed tensors (float64)."""
    params, stats, model = S.weights(2)
    rng = np.random.default_rng(2)
    seed_xyz = rng.uniform(0, 3, (2, 128, 3))
    seed_f = rng.normal(size=(2, 128, 32))
    seed_i = np.tile(np.arange(128, dtype=np.int32), (2, 1))
    key = jax.random.PRNGKey(11)
    with S.jax_float64():
        jh = JNesieHead(num_classes=18, reg_max=8, num_proposal=128,
                        seed_feat_dim=32, vote_conv_channels=(32, 32))
        fd = {"fp_xyz": [jnp.asarray(seed_xyz)],
              "fp_features": [jnp.asarray(seed_f)],
              "fp_indices": [jnp.asarray(seed_i)]}
        want, mutated = jh.apply(
            {"params": params["bbox_head"],
             "batch_stats": stats["bbox_head"]}, fd, "vote", key, train=True,
            with_jitter=True, mutable=["batch_stats"])
        want = jax.tree.map(np.asarray, want)
        new_stats = state_dict_from_flax(
            {"backbone": params["backbone"], "bbox_head": params["bbox_head"]},
            {"backbone": stats["backbone"],
             "bbox_head": mutated["batch_stats"]})
        noise = S.jitter_noise(key, (2, 128, 3))
    head = model.bbox_head.train()
    got = head({"fp_xyz": [torch.from_numpy(seed_xyz)],
                "fp_features": [torch.from_numpy(seed_f)],
                "fp_indices": [torch.from_numpy(seed_i)]}, "vote",
               with_jitter=True, noise=noise)
    return want, {k: v.detach() for k, v in got.items()}, new_stats, model


def test_head_vote_mode_with_jitter_matches_jax(head_outputs):
    want, got, _, _ = head_outputs
    assert "jitter_bbox_preds" in got and "iou_scores_jitter" in got
    assert set(want) == set(got)
    np.testing.assert_array_equal(got["aggregated_indices"].numpy(),
                                  want["aggregated_indices"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **F64)


def test_head_train_bn_stats_cover_both_proposal_sets(head_outputs):
    """SidePooling's BN statistics in train mode are taken over the main
    and the jittered proposals together, as in the reference."""
    _, _, new_stats, model = head_outputs
    sd = model.state_dict()
    for k, v in new_stats.items():
        if k.startswith("bbox_head.") and ("running" in k):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k,
                                       atol=1e-6, rtol=1e-6)


def test_head_raises_on_unported_modes():
    from nesie_tpu_torch.nn.nesie_head import NesieHead

    head = NesieHead(num_classes=4, reg_max=4, num_proposal=8,
                     seed_feat_dim=8, vote_conv_channels=(8, 8))
    with pytest.raises(ValueError, match="not one of"):
        head({"fp_xyz": [None], "fp_features": [None],
              "fp_indices": [None]}, "fps")
    with pytest.raises(ValueError, match="sample_indices or a generator"):
        head({"fp_xyz": [None], "fp_features": [None],
              "fp_indices": [None]}, "random")
    with pytest.raises(ValueError, match="noise or a generator"):
        head({"fp_xyz": [None], "fp_features": [None],
              "fp_indices": [None]}, "vote", with_jitter=True)


# ---- augmentation ---------------------------------------------------------

@pytest.fixture(scope="module")
def aug_params():
    rng = np.random.default_rng(3)
    b = 4
    raw = dict(flip_h=np.array([True, False, True, False]),
               flip_v=np.array([False, True, True, False]),
               rot=rng.uniform(-0.3, 0.3, b).astype(np.float32),
               scale=rng.uniform(0.85, 1.15, b).astype(np.float32),
               trans=rng.normal(size=(b, 3)).astype(np.float32) * 0.1)
    j = jaug.AugParams(*(jnp.asarray(raw[f]) for f in S.AUG_FIELDS))
    t = taug.AugParams(*(torch.from_numpy(raw[f]) for f in S.AUG_FIELDS))
    return rng, j, t


@pytest.mark.parametrize("shift_height", [False, True])
def test_augment_points_matches_jax(aug_params, shift_height):
    rng, j, t = aug_params
    pts = rng.uniform(-2, 2, (4, 100, 4)).astype(np.float32)
    want = jaug.augment_points(jnp.asarray(pts), j, shift_height=shift_height)
    got = taug.augment_points(torch.from_numpy(pts), t,
                              shift_height=shift_height)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", ["augment_boxes", "unaugment_boxes"])
def test_box_augmentations_match_jax(aug_params, fn):
    rng, j, t = aug_params
    boxes = _boxes(rng, 4 * 6).reshape(4, 6, 7)
    want = getattr(jaug, fn)(jnp.asarray(boxes), j)
    got = getattr(taug, fn)(torch.from_numpy(boxes), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reproject_boxes_matches_jax_and_round_trips(aug_params):
    rng, j, t = aug_params
    boxes = _boxes(rng, 4 * 6).reshape(4, 6, 7)
    ident_j = jaug.AugParams.identity((4,))
    ident_t = taug.AugParams.identity((4,))
    want = jaug.reproject_boxes(jnp.asarray(boxes), ident_j, j)
    got = taug.reproject_boxes(torch.from_numpy(boxes), ident_t, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    back = taug.unaugment_boxes(taug.augment_boxes(torch.from_numpy(boxes), t),
                                t)
    np.testing.assert_allclose(back[..., :6].numpy(), boxes[..., :6],
                               atol=1e-5)


def test_aug_params_sample_ranges():
    gen = torch.Generator().manual_seed(0)
    a = taug.AugParams.sample(gen, (1000,))
    assert a.flip_h.dtype == torch.bool and 0.3 < a.flip_h.float().mean() < 0.7
    assert a.rot.abs().max() <= np.pi / 36
    assert a.scale.min() >= 0.85 and a.scale.max() <= 1.15
    assert a.trans.shape == (1000, 3) and 0.05 < a.trans.std() < 0.15


# ---- IoU ------------------------------------------------------------------

def test_iou3d_matches_jax_with_gradients():
    rng = np.random.default_rng(4)
    b1 = _boxes(rng, 300, spread=0.6)
    b2 = _boxes(rng, 300, spread=0.6)
    b2[:20] = b1[:20]  # identical pairs
    b2[20:40, 6] = b1[20:40, 6]  # aligned headings
    want_v = jiou.iou3d(jnp.asarray(b1), jnp.asarray(b2))
    g1 = jax.grad(lambda a: jnp.sum(jiou.iou3d(a, jnp.asarray(b2))))(
        jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    got = tiou.iou3d(t1, torch.from_numpy(b2))
    got.sum().backward()
    assert (np.asarray(want_v) > 0).sum() > 100  # overlaps are exercised
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_v),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("mode,aligned", [("iou", False), ("iou", True),
                                          ("giou", True)])
def test_axis_aligned_iou_matches_jax(mode, aligned):
    rng = np.random.default_rng(5)
    b1 = _boxes(rng, 12, spread=1.0).reshape(2, 6, 7)
    b2 = _boxes(rng, 12, spread=1.0).reshape(2, 6, 7)
    want = jiou.axis_aligned_iou_3d(jnp.asarray(b1), jnp.asarray(b2),
                                    aligned=aligned, mode=mode)
    got = tiou.axis_aligned_iou_3d(torch.from_numpy(b1), torch.from_numpy(b2),
                                   aligned=aligned, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- optimizer, LR schedule, EMA -----------------------------------------

def test_lr_schedule_matches_optax():
    want = jstate.make_lr_schedule(8e-3, 10, milestones=(2, 3))
    got = tstate.make_lr_schedule(8e-3, 10, milestones=(2, 3))
    for step in (0, 19, 20, 29, 30, 45):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_and_adamw_match_optax(scale):
    """Two steps of clip_by_global_norm(10) + adamw against optax, below
    and above the clip bound, LR read at the count before each update."""
    rng = np.random.default_rng(6)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in p0.items()} for _ in range(2)]
    sched = jstate.make_lr_schedule(1e-2, 1, milestones=(1,))
    tx = jstate.make_optimizer(sched)
    params = jax.tree.map(jnp.asarray, p0)
    opt = tx.init(params)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    state = tstate.TrainState(model=None, teacher=None,
                              optimizer=tstate.make_optimizer(ps.values()),
                              lr_schedule=tstate.make_lr_schedule(
                                  1e-2, 1, milestones=(1,)))
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, upd)
        loss = sum((ps[k] * torch.from_numpy(g[k])).sum() for k in ps)
        norm = tstate.apply_gradients(state, loss)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            jax.tree.map(jnp.asarray, g))), rtol=1e-5)
        for k in ps:
            np.testing.assert_allclose(ps[k].detach().numpy(), params[k],
                                       atol=1e-6, rtol=1e-5, err_msg=k)
    assert state.step == 2


@pytest.mark.parametrize("ema_bn_stats", [False, True])
def test_ema_update_matches_jax(ema_bn_stats):
    bn_t, bn_s = BatchNorm(3), BatchNorm(3)
    with torch.no_grad():
        bn_t.weight.fill_(1.0)
        bn_s.weight.fill_(3.0)
        bn_t.running_mean.fill_(0.0)
        bn_s.running_mean.fill_(2.0)
    state = tstate.TrainState(model=bn_s, teacher=bn_t, optimizer=None,
                              lr_schedule=None, step=5)
    m = tstate.ema_update(state, 1e-3, 10.0, ema_bn_stats)
    js = jstate.TrainState(
        step=jnp.asarray(5, jnp.int32), params={"w": jnp.full((3,), 3.0)},
        batch_stats={"m": jnp.full((3,), 2.0)},
        ema_params={"w": jnp.ones((3,))},
        ema_batch_stats={"m": jnp.zeros((3,))}, opt_state=())
    want = jstate.ema_update(js, 1e-3, 10.0, ema_bn_stats)
    assert m == pytest.approx(min(1e-3, 6 / 15))
    np.testing.assert_allclose(bn_t.weight.detach().numpy(),
                               want.ema_params["w"], rtol=1e-6)
    np.testing.assert_allclose(bn_t.running_mean.numpy(),
                               want.ema_batch_stats["m"], rtol=1e-6)
