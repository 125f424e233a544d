"""One teacher-student semi step of the port against the JAX package's,
end to end on the CPU, from the same weights and the same batch.

Tiny VoteNetNesie (18 classes, 128 proposals), 1 labeled + 2 unlabeled
scenes of 1024 points, one unlabeled scan drawn twice. Both sides run in
float64, the JAX side with the jnp neighbour searches of
``test_torch_train_support`` (see there why). The JAX step is jitted with
XLA's CPU ``fusion`` pass turned off: with the default pipeline its
gradients of the backbone's parameters are wrong at this batch. The
vote aggregation's dense + train-mode BN + ReLU stack followed by the
max-pool over duplicate-filled ball-query slots is where they part (the
module alone, jitted, differs from its unjitted self at B=3 and not at
B=2, nor with mean pooling, nor with fusion off). A finite difference
settles which is right: ``test_gradients_match_finite_difference`` holds
the port and this JAX step to the difference quotient of the loss with
its stop-gradient values frozen; ``python tests/test_torch_train_semi.py``
prints that quotient beside the slopes of the port, the JAX step jitted
with and without fusion, and the unjitted JAX step.

The student's jitter noise is the noise JAX draws from the same key
(``semi.py:182`` splits the step key, ``nesie_head.py:207`` the
student's); the augmentation parameters are numpy draws handed to both
sides. The pseudo-label thresholds are
relaxed so that both teachers accept boxes. The pseudo-labels and both
forwards' aggregation indices are read inside each side's step.

Tolerances: loss terms atol 1e-4, rtol 1e-4; gradients, AdamW-updated
parameters, BN running statistics and the EMA teacher atol 1e-4,
rtol 1e-3; FPS indices, pseudo-label classes and validity, and
``UlbState`` exactly; both sides' directional derivatives against the
central difference (h = 1e-7) rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train_support as S
from nesie_tpu.data.augment import AugParams as JAug
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import semi as jsemi
from nesie_tpu.train import state as jstate
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data.augment import AugParams
from nesie_tpu_torch.train import semi as tsemi
from nesie_tpu_torch.train import state as tstate
from nesie_tpu_torch.train import sup_loss as tsup_loss
from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule

torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-3)
N_LABELED, N_UNLABELED = 1, 2
B = N_LABELED + N_UNLABELED
NUM_SCANS, NUM_LABELED_SCANS = 6, 3
SCAN_IDX = np.array([0, 4, 4])  # scan 4 drawn twice: the last row wins
LR = 1e-3
# the batch's seed: one where both sides' vote-mode FPS pick the same
# aggregation points (a near-tie among the votes, which differ by float
# rounding, would flip every later index); seed 0 is one
SEED = 0
PL = dict(num_classes=18, obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0,
          cls_thr_cap=0.0, iou_thr_base=0.3, iou_thr_scale=0.0,
          iou_thr_cap=0.3)
# the finite-difference witness: a seeded direction in the first SA
# module's parameters, the step h
FD_PREFIX, FD_H = "backbone.SA_modules.0.", 1e-7
# XLA's CPU fusion pass off for the JAX step: with it, the jitted step's
# backward through the vote aggregation's max-pool loses gradient at this
# batch (see the module docstring)
JAX_COMPILE = {"xla_disable_hlo_passes": "fusion"}


def _batch():
    pts, boxes, labels, valid = S.scenes(SEED, B, views=2)
    rng = np.random.default_rng(SEED + 100)
    return dict(points_raw_s=pts[0], points_raw_t=pts[1], gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid, aug_s=S.sample_aug(rng, B),
                aug_t=S.identity_aug(B), ulb_scan_idx=SCAN_IDX)


def _initial_ulb():
    """A visited scan with a histogram, so that the class status is not
    uniform."""
    ulb_list = np.zeros((NUM_SCANS, 18))
    ulb_list[1] = np.arange(18.0)
    ulb_flag = np.ones(NUM_SCANS)
    ulb_flag[1] = 0.0
    return ulb_list, ulb_flag


def _jax_step(params, stats, data, key, form="jit, no fusion"):
    """The JAX package's semi step, jitted with ``JAX_COMPILE`` (or, for
    the report below, "jit" with XLA's defaults or "eager")."""
    seen = {}

    def stash(name):
        return lambda *xs: seen.setdefault(name, [np.array(x) for x in xs])

    def get_pseudo_labels(teacher_results, acc, cfg):
        lab = jpl.get_pseudo_labels(teacher_results, acc, cfg)
        jax.debug.callback(stash("teacher"), teacher_results[
            "aggregated_indices"], lab.valid, lab.labels, lab.quality)
        return lab

    def reproject_boxes(boxes, src, dst):
        out = jsemi.reproject_boxes.__wrapped_original__(boxes, src, dst)
        jax.debug.callback(stash("pl_boxes"), out)
        return out

    def unsup_targets(*args, **kw):
        jax.debug.callback(stash(f"student_agg{args[4].shape[0]}"), args[4])
        return jsemi.get_targets.__wrapped_original__(*args, **kw)

    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        reproject_boxes.__wrapped_original__ = jsemi.reproject_boxes
        unsup_targets.__wrapped_original__ = jsemi.get_targets
        mp.setattr(jsemi, "get_pseudo_labels", get_pseudo_labels)
        mp.setattr(jsemi, "reproject_boxes", reproject_boxes)
        mp.setattr(jsemi, "get_targets", unsup_targets)
        jmodel = JVoteNetNesie(**S.TINY)
        jbatch = {k: v if isinstance(v, dict) else jnp.asarray(v)
                  for k, v in data.items()}
        for k in ("aug_s", "aug_t"):
            jbatch[k] = JAug(*(jnp.asarray(data[k][f]) for f in S.AUG_FIELDS))
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(
            {"params": params, "batch_stats": stats}, tx)
        ulb0 = jsemi.UlbState(*(jnp.asarray(x) for x in _initial_ulb()))
        step = jsemi.make_semi_train_step(
            jmodel, tx, n_labeled=N_LABELED,
            num_labeled_scans=NUM_LABELED_SCANS,
            pl_cfg=jpl.PseudoLabelConfig(**PL))
        if form == "eager":
            step = step.__wrapped__
        elif form != "jit":
            step = step.lower(state, ulb0, jbatch, key).compile(
                compiler_options=JAX_COMPILE)
        new, new_ulb, metrics = step(state, ulb0, jbatch, key)
        jax.block_until_ready(metrics)
        _, rng_s = jax.random.split(key)
        noise = S.jitter_noise(rng_s, (B, S.TINY["num_proposal"], 3))
        return noise, dict(
            seen=seen, metrics={k: float(v) for k, v in metrics.items()},
            ulb=[np.asarray(x) for x in new_ulb],
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))


def _torch_step(model, data, noise):
    seen = {}
    state = create_train_state(model, make_lr_schedule(LR, 10), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if not isinstance(v, dict)}
    for k in ("aug_s", "aug_t"):
        batch[k] = AugParams(*(torch.from_numpy(np.asarray(data[k][f]))
                               for f in S.AUG_FIELDS))
    ulb = UlbState(*(torch.from_numpy(x) for x in _initial_ulb()))
    grads = {}
    names = [n for n, _ in state.model.named_parameters()]
    get_pl, reproject = tsemi.get_pseudo_labels, tsemi.reproject_boxes
    get_targets, clip = tsemi.get_targets, tstate.clip_by_global_norm_

    def get_pseudo_labels(teacher_results, acc, cfg, rows=None):
        lab = get_pl(teacher_results, acc, cfg, rows)
        seen["teacher"] = [teacher_results["aggregated_indices"].numpy(),
                           lab.valid.numpy(), lab.labels.numpy(),
                           lab.quality.numpy()]
        return lab

    def reproject_boxes(*args):
        out = reproject(*args)
        seen["pl_boxes"] = [out.numpy()]
        return out

    def targets(*args, **kw):
        seen[f"student_agg{args[4].shape[0]}"] = [args[4].detach().numpy()]
        return get_targets(*args, **kw)

    def recording_clip(gs, max_norm):
        grads.update({n: g.clone() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    step = make_semi_train_step(N_LABELED, NUM_LABELED_SCANS,
                                pl_cfg=PseudoLabelConfig(**PL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsemi, "get_pseudo_labels", get_pseudo_labels)
        mp.setattr(tsemi, "reproject_boxes", reproject_boxes)
        mp.setattr(tsemi, "get_targets", targets)
        mp.setattr(tstate, "clip_by_global_norm_", recording_clip)
        new_ulb, metrics = step(state, ulb, batch, noise=noise)
    return dict(seen=seen, metrics={k: float(v) for k, v in metrics.items()},
                ulb=[x.numpy() for x in new_ulb], grads=grads,
                params=state.model.state_dict(),
                teacher=dict(state.teacher.named_parameters()), state=state)


def _frozen_finite_difference(data, noise):
    """The port's semi loss at the initial weights, the student moved by
    +-h along a seeded unit direction in ``FD_PREFIX``'s parameters, with
    every stop-gradient value (``Tensor.detach`` and the no-grad IoU
    labels of the supervised loss) frozen at the unmoved pass's: the
    function whose gradient a backward pass computes. Returns (direction,
    central difference quotient)."""
    state = create_train_state(S.weights(0)[2], make_lr_schedule(LR, 10),
                               device="cpu")
    params = {n: p for n, p in state.model.named_parameters()
              if n.startswith(FD_PREFIX)}
    rng = np.random.default_rng(7)
    v = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)))
         for n, p in params.items()}
    norm = torch.sqrt(sum((d * d).sum() for d in v.values()))
    v = {n: d / norm for n, d in v.items()}
    batch = {k: torch.from_numpy(x) for k, x in data.items()
             if not isinstance(x, dict)}
    for k in ("aug_s", "aug_t"):
        batch[k] = AugParams(*(torch.from_numpy(np.asarray(data[k][f]))
                               for f in S.AUG_FIELDS))
    step = make_semi_train_step(N_LABELED, NUM_LABELED_SCANS,
                                pl_cfg=PseudoLabelConfig(**PL))
    detach, iou3d = torch.Tensor.detach, tsup_loss.iou3d
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
        totals = []
        with torch.no_grad():
            for n, p in params.items():
                p.add_(shift * FD_H * v[n])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "detach", frozen(detach))
            mp.setattr(tsup_loss, "iou3d", frozen(iou3d))
            mp.setattr(tsemi, "apply_gradients",
                       lambda state, total: totals.append(total.item()))
            mp.setattr(tsemi, "ema_update", lambda *a: None)
            step(state, UlbState(*(torch.from_numpy(x)
                                   for x in _initial_ulb())), batch,
                 noise=noise)
        with torch.no_grad():
            for n, p in params.items():
                p.sub_(shift * FD_H * v[n])
        return totals[0]

    loss(0.0)  # records
    record[0] = False
    return v, (loss(1.0) - loss(-1.0)) / (2 * FD_H)


@pytest.fixture(scope="module")
def run():
    params, stats, model = S.weights(0)
    data = _batch()
    noise, jax_side = _jax_step(params, stats, data, jax.random.PRNGKey(3))
    torch_side = _torch_step(model, data, noise)
    torch_side["fd"] = _frozen_finite_difference(data, noise)
    return jax_side, torch_side


def test_fps_indices_agree(run):
    """Teacher aggregation indices (vote-mode FPS) and the student's
    aggregation points of the labeled scene."""
    j, t = run
    np.testing.assert_array_equal(
        t["seen"]["teacher"][0], j["seen"]["teacher"][0],
        err_msg="the vote-mode FPS picked other aggregation points than "
        "JAX (a near-tie among the votes); every later comparison of this "
        "file would differ: choose another SEED")
    for n in (N_LABELED, N_UNLABELED):
        np.testing.assert_allclose(t["seen"][f"student_agg{n}"][0],
                                   j["seen"][f"student_agg{n}"][0], **TOL)


def test_pseudo_labels_match(run):
    j, t = run
    _, j_valid, j_labels, j_quality = j["seen"]["teacher"]
    _, t_valid, t_labels, t_quality = t["seen"]["teacher"]
    assert j_valid[N_LABELED:].sum() > 0  # the comparison is not vacuous
    np.testing.assert_array_equal(t_valid, j_valid)
    np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_allclose(t_quality, j_quality, **TOL)
    np.testing.assert_allclose(t["seen"]["pl_boxes"][0],
                               j["seen"]["pl_boxes"][0], **TOL)


def test_ulb_state_matches(run):
    j, t = run
    for got, want in zip(t["ulb"], j["ulb"]):
        np.testing.assert_array_equal(got, want)
    ulb_list, ulb_flag = t["ulb"]
    assert ulb_flag[4] == 0 and ulb_list[4].sum() > 0


def test_loss_terms_match(run):
    j, t = run
    assert set(t["metrics"]) == set(j["metrics"])
    assert j["metrics"]["num_pseudo"] > 0
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(t["metrics"][k], v, err_msg=k, **LOSS_TOL)


def test_gradients_match(run):
    j, t = run
    assert set(t["grads"]) == set(j["grads"])
    S.assert_state_dicts_close(t["grads"], j["grads"], TOL)


def test_updated_params_and_bn_stats_match(run):
    j, t = run
    S.assert_state_dicts_close(t["params"], j["params"], TOL)
    assert t["state"].step == 1


def test_ema_teacher_matches(run):
    j, t = run
    assert set(t["teacher"]) == set(j["teacher"])
    S.assert_state_dicts_close(t["teacher"], j["teacher"], TOL)
    # the teacher's BN statistics are the student's
    for (k, e), p in zip(t["state"].teacher.named_buffers(),
                         t["state"].model.buffers()):
        assert torch.equal(e, p), k


def _slope(grads, direction):
    return sum(float((torch.as_tensor(np.asarray(grads[n]),
                                      dtype=torch.float64) * d).sum())
               for n, d in direction.items())


def test_gradients_match_finite_difference(run):
    """The port's and the JAX step's gradients, projected on the seeded
    direction, against the difference quotient of the loss with its
    stop-gradient values frozen."""
    j, t = run
    v, quotient = t["fd"]
    assert abs(quotient) > 1e-3  # the direction moves the loss
    slopes = {"jax": _slope(j["grads"], v), "port": _slope(t["grads"], v)}
    for side, slope in slopes.items():
        np.testing.assert_allclose(
            slope, quotient, rtol=1e-4,
            err_msg=f"{side}: slopes {slopes}, quotient {quotient}")


def _report():
    """Print the difference quotient beside the slopes of the port and of
    the JAX step in three forms, then the vote aggregation module alone,
    jitted against unjitted."""
    import nesie_tpu.nn.pointnet2 as jpointnet2
    from nesie_tpu.data.augment import augment_points as jaugment_points

    params, stats, model = S.weights(0)
    data = _batch()
    key = jax.random.PRNGKey(3)
    noise, _ = _jax_step(params, stats, data, key, form="jit")
    v, quotient = _frozen_finite_difference(data, noise)
    print(f"difference quotient (port, h={FD_H}): {quotient!r}")
    port = _torch_step(S.weights(0)[2], data, noise)
    print(f"slope of the port's gradient: {_slope(port['grads'], v)!r}")
    for form in ("jit", "jit, no fusion", "eager"):
        grads = _jax_step(params, stats, data, key, form)[1]["grads"]
        print(f"slope of the JAX step's gradient ({form}): "
              f"{_slope(grads, v)!r}")

    with S.jax_float64():
        jparams = jax.tree.map(jnp.asarray, params)
        aug = JAug(*(jnp.asarray(data["aug_s"][f]) for f in S.AUG_FIELDS))
        points = jaugment_points(jnp.asarray(data["points_raw_s"]), aug,
                                 shift_height=True)
        out, _ = JVoteNetNesie(**S.TINY).apply(
            {"params": jparams, "batch_stats": stats}, points, "vote", key,
            train=True, mutable=["batch_stats"])
        agg_params = jparams["bbox_head"]["vote_aggregation"]
        agg_stats = stats["bbox_head"]["vote_aggregation"]
        widths = tuple(agg_params["mlp"][f"dense{i}"]["kernel"].shape[-1]
                       for i in range(3))
        for pool in ("max", "avg"):
            module = jpointnet2.PointSAModule(
                num_point=S.TINY["num_proposal"], radius=0.3, num_sample=16,
                mlp_channels=widths, pool=pool)
            for b in (2, 3):
                cot = jnp.asarray(np.random.default_rng(1).normal(
                    size=(b, S.TINY["num_proposal"], widths[-1])))

                def f(p, feats, module=module, b=b, cot=cot):
                    (_, o, _), _ = module.apply(
                        {"params": p, "batch_stats": agg_stats},
                        out["vote_points"][:b], feats, train=True,
                        mutable=["batch_stats"])
                    return jnp.sum(o * cot)

                args = (agg_params, out["vote_features"][:b])
                grad = jax.grad(f, argnums=(0, 1))
                eager = jax.tree.leaves(grad(*args))
                scale = max(float(np.abs(np.asarray(x)).max()) for x in eager)
                for opts in ({}, JAX_COMPILE):
                    jitted = jax.tree.leaves(jax.jit(grad).lower(*args).compile(
                        compiler_options=opts)(*args))
                    diff = max(float(np.abs(np.asarray(x - y)).max())
                               for x, y in zip(eager, jitted))
                    print(f"vote aggregation alone, {pool}-pool, B={b}, "
                          f"compiler options {opts}: max |jit - eager| "
                          f"{diff!r} (largest gradient {scale!r})")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    _report()
