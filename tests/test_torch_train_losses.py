"""The port's losses, targets, pseudo-labels and their helpers against the
JAX package on the same numpy inputs (float32).

Tolerances: atol 1e-5, rtol 1e-5 for values, atol 1e-4, rtol 1e-4 for
gradients and the summed losses (float32 sums in another order); integer
outputs (assignments, labels, keep masks, validity) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nesie_tpu import losses as jl
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import semi as jsemi
from nesie_tpu.train import sup_loss as jsup
from nesie_tpu.train import targets as jtg
from nesie_tpu_torch import losses as tl
from nesie_tpu_torch.train import pseudo_label as tpl
from nesie_tpu_torch.train import semi as tsemi
from nesie_tpu_torch.train import sup_loss as tsup
from nesie_tpu_torch.train import targets as ttg

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=1e-4, rtol=1e-4)
C, P, MAX_GT = 18, 32, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()
                                          if torch.is_tensor(got) else got),
                               np.asarray(want), err_msg=msg, **tol)


# ---- elementary losses ----------------------------------------------------

def test_basic_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    for name in ("mse_loss", "l1_loss", "smooth_l1_loss"):
        _close(getattr(tl, name)(_t(a), _t(b)),
               getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)), msg=name)
    cw = (0.2, 0.3, 0.1, 0.2, 0.2)
    _close(tl.softmax_cross_entropy(_t(a), _t(labels), class_weight=cw),
           jl.softmax_cross_entropy(jnp.asarray(a), jnp.asarray(labels), cw))
    prob = rng.uniform(0, 1, (6, 5)).astype(np.float32)
    prob[0, 0], prob[0, 1] = 0.0, 1.0
    from nesie_tpu.losses.basic import binary_cross_entropy as jbce
    _close(tl.binary_cross_entropy(_t(prob), _t(np.abs(b) > 0.5).float()),
           jbce(jnp.asarray(prob), (jnp.abs(jnp.asarray(b)) > 0.5)
                .astype(jnp.float32)))


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_distance_matches_jax(masked):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(2, 10, 3)).astype(np.float32)
    dst = rng.normal(size=(2, 6, 3)).astype(np.float32)
    valid = np.array([[True] * 3 + [False] * 3, [False] * 6])
    kw = dict(mode="l2")
    want = jl.chamfer_distance(jnp.asarray(src), jnp.asarray(dst),
                               dst_valid=jnp.asarray(valid) if masked else None,
                               **kw)
    got = tl.chamfer_distance(_t(src), _t(dst),
                              dst_valid=_t(valid) if masked else None, **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("use_sigmoid", [True, False])
def test_quality_focal_loss_matches_jax(use_sigmoid):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(20, C)).astype(np.float32)
    if not use_sigmoid:
        pred = 1 / (1 + np.exp(-pred))
    label = rng.integers(-1, C + 1, 20)
    score = rng.uniform(0, 1, 20).astype(np.float32)
    want, gw = jax.value_and_grad(lambda p: jnp.sum(jl.quality_focal_loss(
        p, jnp.asarray(label), jnp.asarray(score),
        use_sigmoid=use_sigmoid)))(jnp.asarray(pred))
    pt = _t(pred).requires_grad_()
    got = tl.quality_focal_loss(pt, _t(label), _t(score),
                                use_sigmoid=use_sigmoid)
    got.sum().backward()
    _close(got.sum(), want, SUM_TOL)
    _close(pt.grad, gw, SUM_TOL)


def test_distribution_focal_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(12, 9)).astype(np.float32)
    label = rng.uniform(0, 8, 12).astype(np.float32)
    label[:2] = (0.0, 8.0)
    _close(tl.distribution_focal_loss(_t(logits), _t(label)),
           jl.distribution_focal_loss(jnp.asarray(logits), jnp.asarray(label)))


def test_surface_losses_match_jax():
    rng = np.random.default_rng(4)
    box = np.concatenate([rng.normal(size=(15, 3)),
                          rng.uniform(0.2, 2, (15, 3)),
                          rng.normal(size=(15, 1))], -1).astype(np.float32)
    surf = rng.normal(size=(15, 6)).astype(np.float32)
    center = box[:, :3] + rng.normal(size=(15, 3)).astype(np.float32) * 0.1
    scale = np.tile(np.array([3.0, 3.0, 2.5] * 2, np.float32), (15, 1))
    for name in ("surface_loss_mse", "surface_loss_smooth_l1"):
        _close(getattr(tl, name)(_t(surf), _t(box)),
               getattr(jl, name)(jnp.asarray(surf), jnp.asarray(box)), msg=name)
    target = rng.uniform(-0.2, 1.2, (15, 6)).astype(np.float32)
    for g, w in zip(tl.surface_to_prob(_t(target), 8),
                    jl.surface_to_prob(jnp.asarray(target), 8)):
        _close(g, w)
    logits = rng.normal(size=(15, 6, 9)).astype(np.float32)
    _close(tl.surface_loss_ce(_t(logits), _t(box), _t(center), _t(scale), 8),
           jl.surface_loss_ce(jnp.asarray(logits), jnp.asarray(box),
                              jnp.asarray(center), jnp.asarray(scale), 8),
           SUM_TOL)


@pytest.mark.parametrize("label_func,loss_func", [("l1", "mse"),
                                                  ("mse", "smooth_l1")])
def test_side_pred_loss_matches_jax(label_func, loss_func):
    rng = np.random.default_rng(5)
    side = rng.uniform(0, 1, (10, 6)).astype(np.float32)
    surf = rng.normal(size=(10, 6)).astype(np.float32) * 0.3
    box = np.concatenate([rng.normal(size=(10, 3)) * 0.1,
                          rng.uniform(0.5, 1, (10, 3))], -1).astype(np.float32)
    w = rng.uniform(0, 1, (10, 6)).astype(np.float32)
    kw = dict(label_func=label_func, loss_func=loss_func)
    _close(tl.side_pred_loss(_t(side), _t(surf), _t(box), _t(w), **kw),
           jl.side_pred_loss(jnp.asarray(side), jnp.asarray(surf),
                             jnp.asarray(box), jnp.asarray(w), **kw))


def test_iou_losses_match_jax():
    rng = np.random.default_rng(6)
    a = np.concatenate([rng.normal(size=(30, 3)) * 0.3,
                        rng.uniform(0.3, 1.5, (30, 3)),
                        rng.uniform(-1, 1, (30, 1))], -1).astype(np.float32)
    b = a + rng.normal(size=a.shape).astype(np.float32) * 0.1
    for name in ("iou_3d_loss", "axis_aligned_iou_loss"):
        _close(getattr(tl, name)(_t(a), _t(b)),
               getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)), msg=name)


# ---- targets --------------------------------------------------------------

def _scene(rng, b=2, n=400):
    """Points in and around GT boxes; some boxes overlap so that points
    fall into 2 and 3 boxes; scene 1 has fewer valid boxes."""
    boxes = np.zeros((b, MAX_GT, 7), np.float32)
    valid = np.zeros((b, MAX_GT), bool)
    labels = np.zeros((b, MAX_GT), np.int32)
    for i in range(b):
        k = 5 - 2 * i
        c = rng.uniform(0.8, 1.6, (k, 3))
        c[:, 2] = 0.0
        s = rng.uniform(0.6, 1.4, (k, 3))
        boxes[i, :k] = np.concatenate([c, s, rng.uniform(-0.4, 0.4, (k, 1))],
                                      -1)
        valid[i, :k] = True
        labels[i, :k] = rng.integers(0, C, k)
    pts = rng.uniform([0, 0, 0], [2.5, 2.5, 1.2], (b, n, 3)).astype(np.float32)
    return pts, boxes, labels, valid


def test_vote_targets_match_jax():
    rng = np.random.default_rng(7)
    pts, boxes, _, valid = _scene(rng)
    for b in range(2):
        want = jtg.vote_targets_single(jnp.asarray(pts[b]),
                                       jnp.asarray(boxes[b]),
                                       jnp.asarray(valid[b]))
        got = ttg.vote_targets_single(_t(pts[b]), _t(boxes[b]), _t(valid[b]))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert (np.asarray(want[1]) > 0).sum() > 20  # points inside boxes
        _close(got[0], want[0])


@pytest.fixture(scope="module")
def targets_pair():
    rng = np.random.default_rng(8)
    pts, boxes, labels, valid = _scene(rng)
    agg = rng.uniform([0, 0, 0], [2.5, 2.5, 1.0], (2, P, 3)).astype(np.float32)
    agg[0, :5] = boxes[0, :5, :3] + [0, 0, 0.3]  # some positives
    want = jtg.get_targets(jnp.asarray(pts), jnp.asarray(boxes),
                           jnp.asarray(labels), jnp.asarray(valid),
                           jnp.asarray(agg))
    got = ttg.get_targets(_t(pts), _t(boxes), _t(labels), _t(valid), _t(agg))
    return want, got


def test_get_targets_matches_jax(targets_pair):
    want, got = targets_pair
    assert float(jnp.sum(want.objectness_targets)) > 0
    for name in jtg.HeadTargets._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            _close(g, w, msg=name)


def _results(rng, b=2, p=P, jitter=True):
    """A head results dict of plausible values."""
    seed_n = 40
    out = dict(
        seed_indices=rng.integers(0, 400, (b, seed_n)).astype(np.int32),
        seed_points=rng.uniform(0, 2.5, (b, seed_n, 3)),
        vote_points=rng.uniform(0, 2.5, (b, seed_n, 3)),
        obj_scores=rng.normal(size=(b, p, 2)),
        sem_scores=rng.normal(size=(b, p, C)),
        bbox_preds=np.concatenate([rng.uniform(0.5, 2, (b, p, 3)),
                                   rng.uniform(0.4, 1.5, (b, p, 3)),
                                   rng.normal(size=(b, p, 1))], -1),
        surface_pred=rng.normal(size=(b, p, 6)),
        iou_scores=rng.uniform(0.05, 0.95, (b, p, C)),
        side_scores=rng.uniform(0.05, 0.95, (b, p, 6, C)),
    )
    if jitter:
        out["jitter_bbox_preds"] = out["bbox_preds"] + rng.normal(
            size=(b, p, 7)) * 0.1
        out["iou_scores_jitter"] = rng.uniform(0.05, 0.95, (b, p, C))
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in out.items()}


GRAD_KEYS = ("vote_points", "obj_scores", "sem_scores", "bbox_preds",
             "surface_pred", "iou_scores", "side_scores", "iou_scores_jitter")


def test_supervised_loss_matches_jax(targets_pair):
    want_t, got_t = targets_pair
    res = _results(np.random.default_rng(9))
    keys = [k for k in GRAD_KEYS if k in res]

    def jloss(*xs):
        r = {**{k: jnp.asarray(v) for k, v in res.items()},
             **dict(zip(keys, xs))}
        return jsup.nesie_supervised_loss(r, want_t)

    (jtotal, jterms), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(keys))), has_aux=True)(
            *(jnp.asarray(res[k]) for k in keys))
    tres = {k: _t(v) for k, v in res.items()}
    for k in keys:
        tres[k].requires_grad_()
    total, terms = tsup.nesie_supervised_loss(tres, got_t)
    total.backward()
    assert set(terms) == set(jterms)  # jax.grad hands back a sorted dict
    for k, v in jterms.items():
        _close(terms[k], v, SUM_TOL, msg=k)
    _close(total, jtotal, SUM_TOL)
    for k, g in zip(keys, jgrads):
        _close(tres[k].grad, g, SUM_TOL, msg=k)


def test_unsupervised_loss_matches_jax(targets_pair):
    want_t, got_t = targets_pair
    rng = np.random.default_rng(10)
    res = _results(rng, jitter=False)
    quality = rng.uniform(0, 1, (2, MAX_GT, 6)).astype(np.float32)
    jtotal, jterms = jsemi.nesie_unsup_loss(
        {k: jnp.asarray(v) for k, v in res.items()}, want_t,
        jnp.asarray(quality))
    total, terms = tsemi.nesie_unsup_loss({k: _t(v) for k, v in res.items()},
                                          got_t, _t(quality))
    assert list(terms) == list(jterms)
    for k, v in jterms.items():
        _close(terms[k], v, SUM_TOL, msg=k)
    _close(total, jtotal, SUM_TOL)


def test_sigma_and_quality_polys():
    s = np.linspace(0, 1, 11).astype(np.float32)
    _close(tsup.sigma_poly(_t(s)), jsup.sigma_poly(jnp.asarray(s)))
    _close(tpl.quality_poly(_t(s)), jpl.quality_poly(jnp.asarray(s)))


# ---- pseudo-labels ----------------------------------------------------------

@pytest.mark.parametrize("literal,warmup", [(True, True), (False, False)])
def test_classwise_acc_matches_jax(literal, warmup):
    rng = np.random.default_rng(11)
    ulb = rng.poisson(2, (10, C)).astype(np.float32)
    flag = (rng.uniform(size=10) < 0.5).astype(np.float32)
    want = jpl.classwise_acc(jnp.asarray(ulb), jnp.asarray(flag), 5, warmup,
                             literal=literal)
    got = tpl.classwise_acc(_t(ulb), _t(flag), 5, warmup, literal=literal)
    _close(got, want)


def test_lhs_nms_keep_mask_matches_jax():
    rng = np.random.default_rng(12)
    for trial in range(6):
        k = 24
        c = rng.uniform(0, 2, (k, 3))
        c[: k // 2] = c[0] + rng.normal(size=(k // 2, 3)) * 0.05  # a cluster
        s = rng.uniform(0.3, 1.0, (k, 3))
        boxes6 = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
        scores = rng.uniform(size=k).astype(np.float32)
        classes = rng.integers(0, 2, k).astype(np.int32)
        want = jpl.lhs_nms_keep_mask(jnp.asarray(boxes6), jnp.asarray(scores),
                                     jnp.asarray(classes), 0.25)
        got = tpl.lhs_nms_keep_mask(_t(boxes6), _t(scores), _t(classes), 0.25)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(trial))


def test_lhs_nms_batched_rows_are_independent():
    boxes = np.tile(np.array([[0, 0, 0, 1, 1, 1]], np.float32), (5, 1))
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.5], np.float32)
    got = tpl.lhs_nms_keep_mask(_t(np.stack([boxes, boxes + 5])),
                                _t(np.stack([scores, scores[::-1].copy()])),
                                torch.zeros(2, 5, dtype=torch.int32), 0.25)
    np.testing.assert_array_equal(got[0].numpy(),
                                  [True, True, True, False, False])
    np.testing.assert_array_equal(got[1].numpy(),
                                  [False, False, True, True, True])


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0, cls_thr_cap=0.0,
         iou_thr_base=0.2, iou_thr_scale=0.0, iou_thr_cap=0.2),
    dict(obj_thr=0.3, cls_thr_base=0.2, use_cbl=False, iou_thr_base=0.2,
         literal_reference_cbl=False, max_num_obj=40),
])
def test_get_pseudo_labels_matches_jax(cfg):
    rng = np.random.default_rng(13)
    res = _results(rng, b=2, p=P, jitter=False)
    res["sem_scores"] = res["sem_scores"] * 3
    res["obj_scores"] = res["obj_scores"] * 3
    acc = rng.uniform(0, 0.6, C).astype(np.float32)
    jc = jpl.PseudoLabelConfig(num_classes=C, **{"max_num_obj": 16, **cfg})
    tc = tpl.PseudoLabelConfig(num_classes=C, **{"max_num_obj": 16, **cfg})
    want = jpl.get_pseudo_labels({k: jnp.asarray(v) for k, v in res.items()},
                                 jnp.asarray(acc), jc)
    got = tpl.get_pseudo_labels({k: _t(v) for k, v in res.items()}, _t(acc),
                                tc)
    if cfg:
        assert np.asarray(want.valid).sum() > 0  # not vacuous
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    _close(got.boxes, want.boxes)
    _close(got.quality, want.quality)


def test_ulb_update_last_write_wins():
    """A scan drawn twice in one step keeps the histogram of its last
    row, as JAX's step (semi.py:220-235) does."""
    ulb = tsemi.UlbState.create(5, 3, device="cpu")
    hist = torch.tensor([[1.0, 0, 0], [0, 2.0, 0], [0, 0, 3.0], [4.0, 4, 4]])
    new = tsemi.update_ulb_state(ulb, torch.tensor([2, 0, 2, 4]), hist)
    np.testing.assert_array_equal(new.ulb_list.numpy(), [
        [0, 2, 0], [0, 0, 0], [0, 0, 3], [0, 0, 0], [4, 4, 4]])
    np.testing.assert_array_equal(new.ulb_flag.numpy(), [0, 1, 0, 1, 0])
    assert ulb.ulb_flag.sum() == 5  # the input state is left as it was
