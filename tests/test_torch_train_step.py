"""One supervised train step of the port against the JAX package's, end
to end on the CPU, from the same weights and the same batch; and the
eval forward of the student and of the teacher after it.

Tiny VoteNetNesie (18 classes, 128 proposals), 2 scenes of 1024 points
with 5 GT boxes each, augmentation parameters drawn with numpy and handed
to both sides, jitter noise drawn by JAX from the step's key. Both sides
run in float64, the JAX side with the jnp neighbour searches of
``test_torch_train_support`` (see there why); the JAX step is jitted, as
the JAX package trains. A second witness holds the gradients to a finite
difference of the port's loss along a seeded direction in the
SidePooling MLPs' parameters (no target of the loss depends on them, so
the difference quotient is the gradient the losses define; its error is
the ReLU and max-pool kinks the step crosses, 2e-5 relative at h=1e-7).

Tolerances: loss terms atol 1e-4, rtol 1e-4; gradients, AdamW-updated
parameters, BN running statistics, the EMA teacher and the eval forwards
atol 1e-4, rtol 1e-3; aggregation (vote-mode FPS) indices exactly; the
directional derivatives against the central difference (h = 1e-7)
rtol 1e-4.
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
from nesie_tpu.train import state as jstate
from nesie_tpu.train import step as jstep
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data.augment import AugParams, augment_boxes, augment_points
from nesie_tpu_torch.train import state as tstate
from nesie_tpu_torch.train import step as tstep
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
from nesie_tpu_torch.train.sup_loss import nesie_supervised_loss
from nesie_tpu_torch.train.targets import get_targets

torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-3)
B, LR = 2, 1e-3
# a seed where both sides' vote-mode FPS pick the same aggregation points
SEED = 1
EVAL_KEYS = ("bbox_preds", "obj_scores", "sem_scores", "iou_scores",
             "side_scores")
FD_PREFIX, FD_H = "bbox_head.grid_conv.", 1e-7


@pytest.fixture(scope="module")
def run():
    params, stats, model = S.weights(1)
    pts, boxes, labels, valid = S.scenes(SEED, B)
    aug = S.sample_aug(np.random.default_rng(SEED + 100), B)
    key = jax.random.PRNGKey(5)
    seen = {}

    def get_targets(*args, **kw):
        jax.debug.callback(lambda a: seen.setdefault("agg", np.array(a)),
                           args[4])
        return get_targets.original(*args, **kw)

    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        get_targets.original = jstep.get_targets
        mp.setattr(jstep, "get_targets", get_targets)
        jmodel = JVoteNetNesie(**S.TINY)
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(
            {"params": params, "batch_stats": stats}, tx)
        step = jstep.make_supervised_train_step(jmodel, tx)
        batch = dict(points=jnp.asarray(pts[0]), gt_boxes=jnp.asarray(boxes),
                     gt_labels=jnp.asarray(labels),
                     gt_valid=jnp.asarray(valid),
                     aug=JAug(*(jnp.asarray(aug[f]) for f in S.AUG_FIELDS)))
        new, metrics = step(state, batch, key)
        evals = {}
        for teacher in (False, True):
            fwd = jstep.make_eval_forward(jmodel, "seed", use_teacher=teacher)
            out = fwd(new, jnp.asarray(pts[0]), key)
            evals[teacher] = {k: np.asarray(out[k]) for k in EVAL_KEYS}
        jax_side = dict(
            agg=seen["agg"], evals=evals,
            metrics={k: float(v) for k, v in metrics.items()},
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))
        noise = S.jitter_noise(key, (B, S.TINY["num_proposal"], 3))

    state = create_train_state(model, make_lr_schedule(LR, 10), device="cpu")
    batch = dict(points=torch.from_numpy(pts[0]),
                 gt_boxes=torch.from_numpy(boxes),
                 gt_labels=torch.from_numpy(labels),
                 gt_valid=torch.from_numpy(valid),
                 aug=AugParams(*(torch.from_numpy(np.asarray(aug[f]))
                                 for f in S.AUG_FIELDS)))
    grads, tseen = {}, {}
    names = [n for n, _ in state.model.named_parameters()]
    clip, targets = tstate.clip_by_global_norm_, tstep.get_targets

    def recording_clip(gs, max_norm):
        grads.update({n: g.clone() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    def recording_targets(*args, **kw):
        tseen["agg"] = args[4].detach().numpy()
        return targets(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstate, "clip_by_global_norm_", recording_clip)
        mp.setattr(tstep, "get_targets", recording_targets)
        metrics = tstep.make_supervised_train_step()(state, batch, noise=noise)
    evals = {}
    for teacher in (False, True):
        out = tstep.make_eval_forward("seed", use_teacher=teacher)(
            state, torch.from_numpy(pts[0]))
        evals[teacher] = {k: out[k].numpy() for k in EVAL_KEYS}
    torch_side = dict(
        agg=tseen["agg"], evals=evals,
        metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
        params=state.model.state_dict(),
        teacher=dict(state.teacher.named_parameters()), state=state,
        fd=_finite_difference(batch, noise))
    return jax_side, torch_side


def _finite_difference(batch, noise):
    """The port's loss at the step's initial weights, moved by +-h along a
    seeded unit direction in the SidePooling parameters: (direction,
    central difference quotient)."""
    model = S.weights(1)[2].train()
    points = augment_points(batch["points"], batch["aug"], shift_height=True)
    gt_boxes = augment_boxes(batch["gt_boxes"], batch["aug"])
    params = {n: p for n, p in model.named_parameters()
              if n.startswith(FD_PREFIX)}
    rng = np.random.default_rng(7)
    v = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)))
         for n, p in params.items()}
    norm = torch.sqrt(sum((d * d).sum() for d in v.values()))
    v = {n: d / norm for n, d in v.items()}

    def loss(sign):
        with torch.no_grad():
            for n, p in params.items():
                p.add_(sign * FD_H * v[n])
            out = model(points, "vote", with_jitter=True, noise=noise)
            targets = get_targets(
                points[..., :3], gt_boxes, batch["gt_labels"],
                batch["gt_valid"], out["aggregated_points"])
            total = nesie_supervised_loss(out, targets)[0].item()
            for n, p in params.items():
                p.sub_(sign * FD_H * v[n])
        return total

    return v, (loss(1.0) - loss(-1.0)) / (2 * FD_H)


def test_aggregation_points_agree(run):
    j, t = run
    np.testing.assert_allclose(
        t["agg"], j["agg"], **TOL,
        err_msg="the vote-mode FPS picked other aggregation points than "
        "JAX (a near-tie among the votes); choose another SEED")


def test_loss_terms_match(run):
    j, t = run
    assert set(t["metrics"]) == set(j["metrics"])
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
    S.assert_state_dicts_close(t["teacher"], j["teacher"], TOL)


@pytest.mark.parametrize("teacher", [False, True])
def test_eval_forward_matches(run, teacher):
    """``make_eval_forward`` on the state after the step: the student, and
    the teacher (EMA parameters, the student's BN statistics)."""
    j, t = run
    for k in EVAL_KEYS:
        np.testing.assert_allclose(t["evals"][teacher][k],
                                   j["evals"][teacher][k], err_msg=k, **TOL)


def test_gradients_match_finite_difference(run):
    """The port's and the jitted JAX step's gradients, projected on the
    seeded direction, against the difference quotient of the loss."""
    j, t = run
    v, quotient = t["fd"]
    assert abs(quotient) > 1e-6  # the direction moves the loss
    for side in (t, j):
        slope = sum(float((torch.as_tensor(np.asarray(side["grads"][n]),
                                           dtype=torch.float64) * d).sum())
                    for n, d in v.items())
        np.testing.assert_allclose(slope, quotient, rtol=1e-4)
