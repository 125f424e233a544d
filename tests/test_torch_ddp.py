"""Data parallelism of the port (``nesie_tpu_torch.parallel``) on the CPU:
gloo ranks spawned with ``torch.multiprocessing`` from
``tests/test_torch_ddp_worker.py``, which imports no jax, every rank joined
with a timeout (``test_torch_ddp_worker.JOIN_TIMEOUT_S``).

The invariant under test is the JAX package's single-program mesh: N ranks,
each holding its rows of a global batch (labeled rows, then unlabeled rows,
of each part: ``parallel.mesh``'s layout), end a step with the parameters,
BN statistics, EMA teacher, AdamW moments, ``UlbState`` and summed metrics
that one process gets from the whole batch.

* BN: the global-statistics BatchNorm at 2 and 4 ranks against one process
  and against flax's ``nn.BatchNorm`` on the concatenated rows, float64:
  output, input and parameter gradients, running statistics within
  atol 1e-12.
* Steps against the JAX package, float64, the harnesses and tolerances of
  ``test_torch_train_step.py`` and ``test_torch_train_semi.py`` (loss
  terms atol 1e-4 + rtol 1e-4; gradients, parameters, BN statistics and
  the teacher atol 1e-4 + rtol 1e-3; FPS indices, pseudo-labels and
  ``UlbState`` exactly): the supervised step at 2 ranks x 2 scenes
  against JAX's on the 4; the Nesie semi step at 2 ranks x (1 + 2) against
  JAX's on 2 + 4 (fusion off), one unlabeled scan drawn by both ranks.
* Steps against the port's one-process step on the global batch, float64,
  atol 1e-9 + rtol 1e-9, with the draws from seeded generators (the noise
  drawn for the global batch, each rank keeping its rows): the Nesie semi
  step at 4 ranks x (1 + 2), two steps; the SAQE semi step at 2 ranks.
  After the two steps every rank holds bit-identical parameters, buffers,
  teacher, AdamW moments and ``UlbState``.
* The literal-CBL pseudo-label threshold reads the global batch's classes.
* The CLIs at 2 ranks on a tiny dataset: pretrain then semi with
  ``--autoscale-lr`` and ``--multihost``; rank 0 alone writes
  checkpoints (``mesh_size`` 2); each rank's labeled rows are its slice
  of the shared scene order; a one-process resume rescales the step;
  ``tools/test.py --num-devices 2`` gathers one process's detections and
  prints its metrics at the same per-rank batch, exactly.

About 3 minutes on the CPU, most of it the two jitted JAX steps.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_ddp_worker as W
import test_torch_train_support as S
from nesie_tpu.data.augment import AugParams as JAug
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import semi as jsemi
from nesie_tpu.train import state as jstate
from nesie_tpu.train import step as jstep
import nesie_tpu_torch.config as tconfig
import nesie_tpu_torch.data.dataset as tds
import nesie_tpu_torch.train.runner as trunner
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data.synthetic import write_synthetic_scannet
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_
from nesie_tpu_torch.nn.layers import BatchNorm
from nesie_tpu_torch.parallel import RowLayout
from nesie_tpu_torch.tools import test as ttest

torch.set_num_threads(1)

LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-3)
PORT_TOL = dict(atol=1e-9, rtol=1e-9)
BN_TOL = dict(atol=1e-12, rtol=0)
LR = 1e-3
P = S.TINY["num_proposal"]
# the semi step: 1 labeled + 2 unlabeled scenes a rank; scan 4 drawn by
# rank 0 and by rank 1 (global unlabeled positions 1 and 3: rank 1's wins)
NUM_SCANS, NUM_LABELED_SCANS = 6, 3
SCAN_IDX_U = np.array([0, 4, 2, 4])
PL = dict(num_classes=18, obj_thr=0.3, cls_thr_base=0.0, cls_thr_scale=0.0,
          cls_thr_cap=0.0, iou_thr_base=0.3, iou_thr_scale=0.0,
          iou_thr_cap=0.3)
JAX_COMPILE = {"xla_disable_hlo_passes": "fusion"}  # test_torch_train_semi
# batch seeds where the JAX and port vote-mode FPS pick the same points
SUP_SEED, SEMI_SEED = 1, 0
# the 4-rank semi steps: TINY at 16 proposals
TINY16 = dict(S.TINY, num_proposal=16, num_points=(64, 32, 16, 16))
# the SAQE semi step: tests/test_saqe.py's TINY shape
SAQE_C = 4
SAQE_TINY = dict(num_classes=SAQE_C, reg_max=8, num_proposal=16, head="saqe",
                 jitter_scale=0.5, jitter_size_bias=0.2,
                 num_points=(64, 32, 16, 16), radii=(0.2, 0.4, 0.8, 1.2),
                 num_samples=(8, 8, 4, 4),
                 sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                              (32, 32, 32)),
                 fp_channels=((32, 32), (32, 32)))
# the CLIs: tests/test_torch_runner.py's MODEL16 at 1024 points
MODEL16 = dict(num_proposal=16, reg_max=8, num_points=(64, 32, 16, 16),
               num_samples=(8, 8, 4, 4),
               sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                            (32, 32, 32)),
               fp_channels=((32, 32), (32, 32)))
MODEL_OVER = [f"model.{k}={v}" for k, v in MODEL16.items()] + [
    "data.num_points=1024"]
TRAIN_OVER = MODEL_OVER + ["optim.max_epochs=2", "data.repeat=1",
                           "data.samples_per_step=1", "log_interval=1"]
PRETRAIN, SEMI = ("nesie-votenet-scannet-pretrain-050",
                  "nesie-votenet-scannet-train-050")


def _assemble(per_rank, parts, world=None):
    """Rank-local rows (rank order) -> the global batch's rows."""
    world = world or len(per_rank)
    order = torch.cat([RowLayout(tuple(parts), world, r).index()
                       for r in range(world)])
    got = torch.cat([torch.as_tensor(x) for x in per_rank])
    out = torch.empty_like(got)
    out[order] = got
    return out


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_dicts_close(got: dict, want: dict, tol: dict):
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(_np(got[k]), _np(v), err_msg=k, **tol)


def _batch_tensors(data: dict) -> dict:
    out = {}
    for k, v in data.items():
        if isinstance(v, dict):
            out[k] = {f: torch.from_numpy(np.asarray(v[f])) for f in v}
        else:
            out[k] = torch.from_numpy(np.asarray(v))
    return out


def _jax_batch(data: dict) -> dict:
    out = {k: jnp.asarray(v) for k, v in data.items()
           if not isinstance(v, dict)}
    for k, v in data.items():
        if isinstance(v, dict):
            out[k] = JAug(*(jnp.asarray(v[f]) for f in S.AUG_FIELDS))
    return out


def _initial_ulb(num_classes=18):
    ulb_list = np.zeros((NUM_SCANS, num_classes))
    ulb_list[1] = np.arange(float(num_classes))
    ulb_flag = np.ones(NUM_SCANS)
    ulb_flag[1] = 0.0
    return ulb_list, ulb_flag


# ------------------------------------------------------------- row layout
@pytest.mark.parametrize("parts,world", [((2,), 3), ((1, 2), 2),
                                         ((1, 2), 4)])
def test_row_layout_draws_are_global_rows(parts, world):
    """Each rank's index holds its rows of each part; the ranks' draws,
    reassembled, are one process's draw for the global batch."""
    layouts = [RowLayout(parts, world, r) for r in range(world)]
    idx = torch.cat([lay.index() for lay in layouts])
    assert sorted(idx.tolist()) == list(range(sum(parts) * world))
    for i, p in enumerate(parts):  # part i: the ranks' rows in rank order
        start, offset = sum(parts[:i]), sum(parts[:i]) * world
        got = torch.cat([lay.index()[start:start + p] for lay in layouts])
        assert torch.equal(got, torch.arange(offset, offset + p * world))

    def draw(shape, seed=4):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed))

    local = [lay.draw(draw, (sum(parts), 5, 3)) for lay in layouts]
    assert torch.equal(_assemble(local, parts),
                       draw((sum(parts) * world, 5, 3)))


# -------------------------------------------------------------------- BN
@pytest.mark.parametrize("world", [2, 4])
def test_bn_global_statistics(world, tmp_path):
    """Output, input and parameter gradients and running statistics of the
    ranks' BatchNorm against one process and against flax's BatchNorm on
    the concatenated rows (float64)."""
    import flax.linen as fnn

    rng = np.random.default_rng(world)
    x = torch.from_numpy(rng.normal(size=(8, 5, 6)) * 2 + 0.5)
    cot = torch.from_numpy(rng.normal(size=(8, 5, 6)))
    bn = BatchNorm(6).double()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(size=6)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6)))
    args = dict(x=x, cot=cot, state=bn.state_dict())
    ranks = W.launch("bn", world, args, tmp_path)
    one = W.bn_job(args)  # this process: no group
    got = dict(y=_assemble([r["y"] for r in ranks], (8 // world,)),
               dx=_assemble([r["dx"] for r in ranks], (8 // world,)))
    for r in ranks:
        for k in ("dw", "db", "mean", "var"):
            assert torch.equal(r[k], ranks[0][k]), k
    got.update({k: ranks[0][k] for k in ("dw", "db", "mean", "var")})
    _assert_dicts_close(got, one, BN_TOL)

    with S.jax_float64():
        params = {"scale": jnp.asarray(_np(bn.weight)),
                  "bias": jnp.asarray(_np(bn.bias))}
        stats = {"mean": jnp.asarray(_np(bn.running_mean)),
                 "var": jnp.asarray(_np(bn.running_var))}
        fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)

        def loss(p, xx):
            y, upd = fbn.apply({"params": p, "batch_stats": stats}, xx,
                               mutable=["batch_stats"])
            return jnp.sum(y * jnp.asarray(_np(cot))), (y, upd)

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(_np(x)))
    want = dict(y=y, dx=gx, dw=gp["scale"], db=gp["bias"],
                mean=upd["batch_stats"]["mean"],
                var=upd["batch_stats"]["var"])
    _assert_dicts_close(got, {k: np.asarray(v) for k, v in want.items()},
                        BN_TOL)


# --------------------------------------------- supervised step vs JAX
@pytest.fixture(scope="module")
def sup_run(tmp_path_factory):
    """The supervised step at 2 ranks x 2 scenes and JAX's on the 4."""
    b = 4
    params, stats, model = S.weights(1)
    pts, boxes, labels, valid = S.scenes(SUP_SEED, b)
    aug = S.sample_aug(np.random.default_rng(SUP_SEED + 100), b)
    key = jax.random.PRNGKey(5)
    data = dict(points=pts[0], gt_boxes=boxes, gt_labels=labels,
                gt_valid=valid, aug=aug)
    with S.jax_float64():
        jmodel = JVoteNetNesie(**S.TINY)
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(
            {"params": params, "batch_stats": stats}, tx)
        step = jstep.make_supervised_train_step(jmodel, tx)
        new, metrics = step(state, _jax_batch(data), key)
        jax_side = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))
        noise = S.jitter_noise(key, (b, P, 3))
    args = dict(kind="sup", model=S.TINY, state=model.state_dict(),
                batch=_batch_tensors(data), parts=(2,), noise=noise,
                steps=1, lr=LR)
    ranks = W.launch("step", 2, args, tmp_path_factory.mktemp("sup"))
    return jax_side, ranks


def test_sup_step_loss_terms_match_jax(sup_run):
    j, ranks = sup_run
    for r in ranks:
        got = r["metrics"][0]
        assert set(got) == set(j["metrics"])
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **LOSS_TOL)


def test_sup_step_gradients_match_jax(sup_run):
    j, ranks = sup_run
    assert set(ranks[0]["grads"]) == set(j["grads"])
    _assert_dicts_close(ranks[0]["grads"], j["grads"], TOL)


def test_sup_step_params_bn_and_teacher_match_jax(sup_run):
    j, ranks = sup_run
    _assert_dicts_close(ranks[0]["params"], j["params"], TOL)
    _assert_dicts_close(ranks[0]["teacher"], j["teacher"], TOL)
    assert ranks[0]["step"] == ranks[1]["step"] == 1


# ------------------------------------------------ semi step vs JAX
def _semi_data(seed, n_l, n_u, labels_mod=None):
    """A global semi batch of n_l labeled + n_u unlabeled scenes (numpy)."""
    b = n_l + n_u
    pts, boxes, labels, valid = S.scenes(seed, b, views=2)
    if labels_mod:
        labels = labels % labels_mod
    rng = np.random.default_rng(seed + 100)
    scan_idx = np.concatenate([np.zeros(n_l, np.int64),
                               np.resize(SCAN_IDX_U, n_u)])
    return dict(points_raw_s=pts[0], points_raw_t=pts[1], gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid, aug_s=S.sample_aug(rng, b),
                aug_t=S.identity_aug(b), ulb_scan_idx=scan_idx)


@pytest.fixture(scope="module")
def semi_run(tmp_path_factory):
    """The Nesie semi step at 2 ranks x (1 + 2) and JAX's on 2 + 4."""
    n_l, n_u = 2, 4
    params, stats, model = S.weights(0)
    data = _semi_data(SEMI_SEED, n_l, n_u)
    key = jax.random.PRNGKey(3)
    seen = {}

    def get_pseudo_labels(teacher_results, acc, cfg):
        lab = jpl.get_pseudo_labels(teacher_results, acc, cfg)
        jax.debug.callback(
            lambda *xs: seen.setdefault("teacher", [np.array(x) for x in xs]),
            teacher_results["aggregated_indices"], lab.valid, lab.labels,
            lab.quality)
        return lab

    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsemi, "get_pseudo_labels", get_pseudo_labels)
        jmodel = JVoteNetNesie(**S.TINY)
        jbatch = _jax_batch(data)
        tx = optax.chain(S.record_grads(), jstate.make_optimizer(
            jstate.make_lr_schedule(LR, 10)))
        state = jstate.create_train_state(
            {"params": params, "batch_stats": stats}, tx)
        ulb0 = jsemi.UlbState(*(jnp.asarray(x) for x in _initial_ulb()))
        step = jsemi.make_semi_train_step(
            jmodel, tx, n_labeled=n_l, num_labeled_scans=NUM_LABELED_SCANS,
            pl_cfg=jpl.PseudoLabelConfig(**PL))
        step = step.lower(state, ulb0, jbatch, key).compile(
            compiler_options=JAX_COMPILE)
        new, new_ulb, metrics = step(state, ulb0, jbatch, key)
        jax.block_until_ready(metrics)
        _, rng_s = jax.random.split(key)
        noise = S.jitter_noise(rng_s, (n_l + n_u, P, 3))
        jax_side = dict(
            seen=seen["teacher"],
            metrics={k: float(v) for k, v in metrics.items()},
            ulb=[np.asarray(x) for x in new_ulb],
            grads=state_dict_from_flax(new.opt_state[0]),
            params=state_dict_from_flax(new.params, new.batch_stats),
            teacher=state_dict_from_flax(new.ema_params))
    args = dict(kind="semi", model=S.TINY, state=model.state_dict(),
                batch=_batch_tensors(data), parts=(1, 2), noise=noise,
                steps=1, lr=LR, pl=PL, num_labeled_scans=NUM_LABELED_SCANS,
                ulb=[torch.from_numpy(x) for x in _initial_ulb()])
    ranks = W.launch("step", 2, args, tmp_path_factory.mktemp("semi"))
    return jax_side, ranks


def test_semi_step_fps_and_pseudo_labels_match_jax(semi_run):
    """The teacher's vote-mode FPS indices, and the pseudo-labels (validity
    and classes exactly, quality within TOL) of the global batch."""
    j, ranks = semi_run
    j_agg, j_valid, j_labels, j_quality = j["seen"]
    got = [_assemble([r["seen"]["teacher_agg"] for r in ranks], (1, 2))]
    got += [_assemble([r["seen"]["pl"][i] for r in ranks], (1, 2))
            for i in range(3)]
    np.testing.assert_array_equal(
        _np(got[0]), j_agg, err_msg="the vote-mode FPS picked other points "
        "than JAX (a near-tie); choose another SEMI_SEED")
    assert j_valid[2:].sum() > 0  # the comparison is not vacuous
    np.testing.assert_array_equal(_np(got[1]), j_valid)
    np.testing.assert_array_equal(_np(got[2]), j_labels)
    np.testing.assert_allclose(_np(got[3]), j_quality, **TOL)


def test_semi_step_ulb_state_matches_jax(semi_run):
    """Scan 4 is drawn by both ranks: the global last row (rank 1's)
    wins, as in the JAX step."""
    j, ranks = semi_run
    for r in ranks:
        for got, want in zip(r["ulb"], j["ulb"]):
            np.testing.assert_array_equal(_np(got), want)
    assert j["ulb"][1][4] == 0 and j["ulb"][0][4].sum() > 0


def test_semi_step_loss_terms_match_jax(semi_run):
    j, ranks = semi_run
    assert j["metrics"]["num_pseudo"] > 0
    for r in ranks:
        got = r["metrics"][0]
        assert set(got) == set(j["metrics"])
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **LOSS_TOL)


def test_semi_step_gradients_match_jax(semi_run):
    j, ranks = semi_run
    assert set(ranks[0]["grads"]) == set(j["grads"])
    _assert_dicts_close(ranks[0]["grads"], j["grads"], TOL)


def test_semi_step_params_bn_and_teacher_match_jax(semi_run):
    j, ranks = semi_run
    _assert_dicts_close(ranks[0]["params"], j["params"], TOL)
    _assert_dicts_close(ranks[0]["teacher"], j["teacher"], TOL)


# ------------------------------- steps vs the port's one-process step
def _port_weights(model_kw, seed):
    model = VoteNetNesie(**model_kw)
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    return model.double().state_dict()


def _semi_args(model_kw, world, n_l, n_u, seed, steps, labels_mod=None,
               num_classes=18):
    data = _semi_data(seed, n_l * world, n_u * world, labels_mod)
    return dict(kind="semi", model=model_kw,
                state=_port_weights(model_kw, seed),
                batch=_batch_tensors(data), parts=(n_l, n_u), seed=7,
                steps=steps, lr=LR, pl=dict(PL, num_classes=num_classes),
                num_labeled_scans=NUM_LABELED_SCANS,
                ulb=[torch.from_numpy(x) for x in _initial_ulb(num_classes)])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Two Nesie semi steps at 4 ranks x (1 + 2), the draws from seeded
    generators, and the same two steps in one process on 4 + 8 (TINY with
    16 proposals: the CPU time of 12 scenes)."""
    args = _semi_args(TINY16, 4, 1, 2, seed=2, steps=2)
    ranks = W.launch("step", 4, args, tmp_path_factory.mktemp("four"))
    one = W.step_job(dict(args, parts=(4, 8)))
    return one, ranks


def test_four_ranks_match_one_process(four_ranks):
    one, ranks = four_ranks
    assert one["metrics"][0]["num_pseudo"] > 0
    for step in range(2):
        got, want = ranks[0]["metrics"][step], one["metrics"][step]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{step} {k}",
                                       **PORT_TOL)
    _assert_dicts_close(ranks[0]["grads"], one["grads"], PORT_TOL)
    _assert_dicts_close(ranks[0]["params"], one["params"], PORT_TOL)
    _assert_dicts_close(ranks[0]["teacher"], one["teacher"], PORT_TOL)
    for got, want in zip(ranks[0]["adam"], one["adam"]):
        np.testing.assert_allclose(_np(got), _np(want), **PORT_TOL)
    for got, want in zip(ranks[0]["ulb"], one["ulb"]):
        assert torch.equal(got, want)
    # the first step's pseudo-labels: validity and classes exactly
    pl = [_assemble([r["seen"]["pl"][i] for r in ranks], (1, 2))
          for i in range(3)]
    assert torch.equal(pl[0], one["seen"]["pl"][0])
    assert torch.equal(pl[1], one["seen"]["pl"][1])
    np.testing.assert_allclose(_np(pl[2]), _np(one["seen"]["pl"][2]),
                               **PORT_TOL)


def test_replicas_bit_identical_after_two_steps(four_ranks):
    """Parameters, buffers, teacher, AdamW moments, UlbState and metrics
    are the same bits on every rank."""
    _, ranks = four_ranks
    ref = ranks[0]
    for r in ranks[1:]:
        assert r["step"] == ref["step"] == 2
        assert r["metrics"] == ref["metrics"]
        for key in ("params", "teacher"):
            for k, v in ref[key].items():
                assert torch.equal(r[key][k], v), (key, k)
        for a, b in zip(r["adam"] + r["ulb"], ref["adam"] + ref["ulb"]):
            assert torch.equal(a, b)


def test_saqe_semi_step_two_ranks_match_one_process(tmp_path):
    """The SAQE semi step at 2 ranks x (1 + 2) against one process on
    2 + 4 (generators seeded alike)."""
    args = _semi_args(SAQE_TINY, 2, 1, 2, seed=3, steps=1,
                      labels_mod=SAQE_C, num_classes=SAQE_C)
    ranks = W.launch("step", 2, args, tmp_path)
    one = W.step_job(dict(args, parts=(2, 4)))
    want = one["metrics"][0]
    assert {"angle_loss", "unsup_iou_loss"} <= set(want)
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][0][k], v, err_msg=k,
                                       **PORT_TOL)
    _assert_dicts_close(ranks[0]["grads"], one["grads"], PORT_TOL)
    _assert_dicts_close(ranks[0]["params"], one["params"], PORT_TOL)
    _assert_dicts_close(ranks[0]["teacher"], one["teacher"], PORT_TOL)
    for got, want in zip(ranks[1]["ulb"], one["ulb"]):
        assert torch.equal(got, want)


def test_literal_cbl_threshold_reads_the_global_batch(tmp_path):
    """``literal_reference_cbl`` indexes the flattened classes of the
    whole batch with class values: with a class-dependent threshold, the
    ranks' pseudo-labels equal one process's on the global batch."""
    rng = np.random.default_rng(11)
    b, p, c = 6, 8, 18  # P < C: the lookup reaches past the first row

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    sem = t(b, p, c) * 3
    teacher = dict(sem_scores=sem, bbox_preds=torch.cat(
        [t(b, p, 3), t(b, p, 3).abs() + 0.2, t(b, p, 1)], -1),
        obj_scores=t(b, p, 2) * 3, iou_scores=torch.sigmoid(t(b, p, c)),
        side_scores=torch.sigmoid(t(b, p, 6, c)))
    pl = dict(num_classes=c, max_num_obj=8, obj_thr=0.2, cls_thr_base=0.3,
              cls_thr_scale=0.6, cls_thr_cap=0.95, iou_thr_base=0.1,
              iou_thr_scale=0.5, iou_thr_cap=0.6)
    args = dict(teacher=teacher, acc=torch.from_numpy(rng.uniform(size=c)),
                pl=pl, parts=(1, 2))
    ranks = W.launch("pseudo_labels", 2, args, tmp_path)
    one = W.pseudo_label_job(dict(args, parts=(2, 4)))
    assert one["valid"].sum() > 0 and not one["valid"].all()
    for k in ("valid", "labels", "boxes", "quality"):
        got = _assemble([r[k] for r in ranks], (1, 2))
        assert torch.equal(got, one[k]), k
    # the local lookup would have read other classes for rank 0's rows
    local = W.pseudo_label_job(dict(args, teacher={
        k: v[RowLayout((1, 2), 2, 0).index()] for k, v in teacher.items()},
        parts=(1, 2)))
    assert not torch.equal(local["valid"], ranks[0]["valid"])


# -------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Pretrain then semi (``--load-from``) through the train CLI at 2
    ranks with ``--autoscale-lr`` and ``--multihost`` (torchrun's
    environment is there), then ``tools/test.py --num-devices 2`` on the
    semi checkpoint."""
    root = write_synthetic_scannet(tmp_path_factory.mktemp("data"), 12, 4,
                                   seed=0)
    work = tmp_path_factory.mktemp("work")
    common = ["--data-root", str(root), "--work-dir", str(work),
              "--device", "cpu", "--num-devices", "2", "--autoscale-lr",
              "--multihost"]
    pre_ckpt = work / PRETRAIN / "checkpoints"
    semi_ckpt = work / SEMI / "checkpoints"
    test_args = [SEMI, str(semi_ckpt), "--data-root", str(root), "--device",
                 "cpu", "--batch-size", "2", "--cfg-options", *MODEL_OVER]
    args = dict(train=[
        [PRETRAIN, *common, "--cfg-options", *TRAIN_OVER],
        [SEMI, *common, "--load-from", str(pre_ckpt), "--cfg-options",
         *TRAIN_OVER]], test=test_args + ["--num-devices", "2"])
    ranks = W.launch("cli", 2, args, tmp_path_factory.mktemp("cli"))
    return dict(root=root, work=work, ranks=ranks, test_args=test_args,
                semi_ckpt=semi_ckpt)


def test_cli_rank0_alone_writes_checkpoints(cli_run):
    r0, r1 = cli_run["ranks"]
    assert r1["saves"] == []
    # 6 labeled scenes of 12, 2 a step: 3 steps an epoch, a save an epoch
    assert r0["saves"] == [dict(step=s, mesh_size=2) for s in (3, 6, 3, 6)]
    assert r0["steps"] == r1["steps"] == [6, 6]
    payload = trunner.CheckpointManager(cli_run["semi_ckpt"].parent).load()
    assert payload["meta"] == {"mesh_size": 2} and payload["step"] == 6


def test_cli_autoscale_lr_uses_world_over_8(cli_run):
    for name in (PRETRAIN, SEMI):
        cfg = tconfig.get_config(name)
        got = json.loads((cli_run["work"] / name / "config.json").read_text())
        assert got["optim"]["lr"] == pytest.approx(cfg.optim.lr * 2 / 8,
                                                   rel=1e-12)
        assert got["num_devices"] == 2


def test_cli_labeled_rows_are_slices_of_the_shared_order(cli_run):
    """Every semi step's labeled rows: rank r holds element r of the
    step's pair of the shared scene order (``default_rng(seed)``)."""
    ranks = cli_run["ranks"]
    order_rng = np.random.default_rng(0)
    n = 6
    want = [[], []]
    for _ in range(2):  # epochs
        order = order_rng.permutation(n)
        for it in range(n // 2):
            for r in range(2):
                want[r].append([int(order[2 * it + r])])
    assert [r["labeled"] for r in ranks] == want


def test_cli_one_process_resume_rescales_the_step(cli_run, tmp_path):
    """The 2-rank semi checkpoint (step 6 = 2 epochs of 3 steps) resumed
    by one process (6 steps an epoch) starts at step 12, epoch 2 (a copy
    of the work dir, which the other tests read)."""
    shutil.copytree(cli_run["work"] / SEMI, tmp_path / SEMI)
    cfg = tconfig.apply_overrides(tconfig.get_config(SEMI), TRAIN_OVER)
    cfg = dataclasses.replace(cfg, work_dir=str(tmp_path),
                              optim=dataclasses.replace(cfg.optim,
                                                        max_epochs=3))
    root = cli_run["root"]
    ds = tds.SimiScanNetScenes(root, root / cfg.data.train_ann_file,
                               root / cfg.data.label_list_file,
                               ratio=cfg.data.unlabeled_ratio)
    epochs = []
    state = trunner.train_semi(cfg, ds, resume=True, device="cpu",
                               epoch_callback=lambda e, s: epochs.append(
                                   (e, s.step)))
    assert epochs == [(2, 18)] and state.step == 18


def test_test_cli_two_ranks_print_one_process_metrics(cli_run, monkeypatch):
    """``tools/test.py --num-devices 2`` at 2 scenes a rank: the detections
    rank 0 gathers (boxes, scores, classes, scene by scene) and the
    metrics are one process's at 2 scenes a batch, exactly (each rank's
    forward is one process's forward of the same two scenes)."""
    import nesie_tpu_torch.eval as teval

    r0, r1 = cli_run["ranks"]
    assert r1["results"] is None and r1["detections"] is None
    seen, real = {}, teval.indoor_eval

    def recording_eval(gt_annos, dt_annos, **kw):
        seen["dt"] = W.detections(dt_annos)
        return real(gt_annos, dt_annos, **kw)

    monkeypatch.setattr(teval, "indoor_eval", recording_eval)
    one = ttest.main(cli_run["test_args"])
    assert len(seen["dt"]["counts"]) == 4  # the val scenes
    assert seen["dt"]["counts"].sum() > 0  # the comparison is not vacuous
    for k, v in seen["dt"].items():
        assert torch.equal(r0["detections"][k], v), k
    assert r0["results"].keys() == one.keys()
    assert r0["results"] == {k: float(v) for k, v in one.items()}
    assert 0.0 <= one["mAP_0.25"] <= 1.0
