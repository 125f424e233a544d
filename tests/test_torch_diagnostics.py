"""The port's diagnostic tools held to the JAX package's on the CPU:
``tools.overfit_check``, ``tools.probe_thresholds``, ``tools.jitter_delta``,
``tools.diagnose_teacher`` and ``tools.flops_analysis``.

The JAX tools are scripts without functions to call, so each JAX side
below is the tool's own loop or calls, written out: the batch draws,
``make_supervised_train_step`` steps, ``model.apply`` + ``get_pseudo_labels``,
the teacher with and without jitter, the ``jax.tree.map`` blend. The
weights go from the port to flax through ``convert_state_dict``; the
steps and forwards that are compared run in float64 on both sides, the JAX
model's neighbour searches on the jnp versions of
``test_torch_train_support`` (see there why), the JAX step jitted.

Tolerances:
* ``overfit_check``'s batch draws (numpy): identical to the JAX tool's;
  three steps' losses (float64): 1e-8 relative;
* ``probe_thresholds``' percentiles (float64): 1e-5; its sweep counts
  identical;
* ``jitter_delta``'s score deltas (float64): 1e-8; its selection counts
  identical, given the JAX side's jitter noise;
* ``diagnose_teacher``'s pairings: identical (the same float32 blend);
* ``flops_analysis``: the matmul FLOPs of the tiny eval forward equal to
  2·M·K·N summed over its Linear layers (M the rows each one sees).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_support as S
from nesie_tpu.config import get_config as jget_config
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.data.dataset import SubScanNetScenes as JSubScanNetScenes
from nesie_tpu.data.synthetic import make_synthetic_scenes as jmake_scenes
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu.train import pseudo_label as jpl
from nesie_tpu.train import state as jstate
from nesie_tpu.train import step as jstep
from nesie_tpu_torch.config import apply_overrides
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data.synthetic import write_synthetic_scannet
from nesie_tpu_torch.nn.detector import init_weights_flax_
from nesie_tpu_torch.tools import (
    diagnose_teacher,
    flops_analysis,
    jitter_delta,
    overfit_check,
    probe_thresholds,
)
from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
from nesie_tpu_torch.train.step import make_supervised_train_step

torch.set_num_threads(1)
SEED, STEPS, BATCH, LR = 0, 3, 2, 4e-3
TINY_POINTS = overfit_check.TINY_POINTS


def _tiny_weights(seed=0):
    """overfit_check's tiny model with flax-style weights: (params, stats)
    as float64 trees for the JAX model, and the port model in float64."""
    model = overfit_check.build_model(tiny=True)
    init_weights_flax_(model, torch.Generator().manual_seed(seed))
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return S.to64(params), S.to64(stats), model.double()


# ---- overfit_check ----

def _jax_draws(steps, batch, num_points, seed=SEED, scenes=16):
    """The JAX tool's training draws, then its first eval batch."""
    sc = jmake_scenes(scenes, seed=seed)
    ds = JSubScanNetScenes(scenes=sc, labeled_ids=[s.scene_id for s in sc])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.choice(len(ds), size=batch, replace=True)
        b = ds.eval_batch(list(idx), rng, num_points)
        b.pop("scene_ids")
        out.append(b)
    idx = list(range(0, min(batch, len(ds))))
    ev = ds.eval_batch(idx, rng, num_points)
    ev.pop("scene_ids")
    return out, ev


def test_overfit_batches_are_the_jax_tools():
    want, want_eval = _jax_draws(5, 8, TINY_POINTS)
    ds = overfit_check.make_dataset(16, SEED)
    rng = np.random.default_rng(SEED)
    for w in want:
        got = overfit_check.draw_batch(ds, rng, 8, TINY_POINTS)
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    ev = ds.eval_batch(list(range(8)), rng, TINY_POINTS)
    for k in want_eval:
        np.testing.assert_array_equal(ev[k], want_eval[k], err_msg=k)


@pytest.fixture(scope="module")
def overfit_losses():
    params, stats, model = _tiny_weights(SEED)
    draws, _ = _jax_draws(STEPS, BATCH, TINY_POINTS)
    P = overfit_check.TINY_MODEL["num_proposal"]
    with S.jax_float64():
        jmodel = JVoteNetNesie(**overfit_check.TINY_MODEL)
        tx = jstate.make_optimizer(jstate.make_lr_schedule(LR, STEPS))
        state = jstate.create_train_state(
            {"params": params, "batch_stats": stats}, tx)
        step = jstep.make_supervised_train_step(jmodel, tx)
        key = jax.random.PRNGKey(SEED)
        jax_losses, noises = [], []
        for b in draws:
            key, sub = jax.random.split(key)
            batch = {k: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f"
                                    else v.dtype) for k, v in b.items()}
            state, m = step(state, batch, sub)
            jax_losses.append(float(m["loss"]))
            noises.append(S.jitter_noise(sub, (BATCH, P, 3)))

    tstate = create_train_state(model, make_lr_schedule(LR, STEPS),
                                device="cpu")
    step_fn = make_supervised_train_step()

    def step64(state, batch, **kw):
        return step_fn(state, {k: v.double() if v.is_floating_point() else v
                               for k, v in batch.items()}, **kw)

    log = overfit_check.train_steps(
        tstate, step64, overfit_check.make_dataset(16, SEED),
        np.random.default_rng(SEED), STEPS, BATCH, TINY_POINTS, "cpu",
        noises=noises)
    return jax_losses, log


def test_overfit_steps_match_jax_in_float64(overfit_losses):
    jax_losses, log = overfit_losses
    assert len(log["losses"]) == STEPS
    np.testing.assert_allclose(log["losses"], jax_losses, rtol=1e-8, atol=0)
    assert len(set(jax_losses)) == STEPS  # the steps moved the loss


def _patched_eval(monkeypatch, map25):
    """``indoor_eval`` as the tool calls it, its mAP@0.25 replaced: the
    floor cannot hold after 2 steps."""
    import nesie_tpu_torch.eval as teval

    real = teval.indoor_eval
    seen = {}

    def fake(*args, **kw):
        res = real(*args, **kw)
        seen.update(res)
        return dict(res, **{"mAP_0.25": map25})

    monkeypatch.setattr(teval, "indoor_eval", fake)
    return seen


ARGV = ["--tiny", "--device", "cpu", "--steps", "2", "--scenes", "4",
        "--batch", "2"]


def test_overfit_main_runs_through_its_eval(monkeypatch, capsys):
    seen = _patched_eval(monkeypatch, 0.151)
    assert overfit_check.main(ARGV) == 0
    out = capsys.readouterr().out
    assert "overfit check PASSED" in out and "mAP_0.25: 0.1510" in out
    assert "proposals kept after NMS" in out
    assert 0.0 <= seen["mAP_0.50"] <= 1.0 and "mAR_0.25" in seen


def test_overfit_floor_is_checked(monkeypatch):
    _patched_eval(monkeypatch, overfit_check.MAP_FLOOR)
    with pytest.raises(AssertionError, match="overfit sanity failed"):
        overfit_check.main(ARGV)


@pytest.mark.parametrize("tool", [overfit_check, probe_thresholds,
                                  jitter_delta, diagnose_teacher,
                                  flops_analysis])
def test_entry_points_refuse_to_run_without_a_card(tool, monkeypatch, capsys):
    """``--device cuda`` (the default) with no card: return 1 and say so,
    never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ---- probe_thresholds and jitter_delta, against the JAX calls ----

@pytest.fixture(scope="module")
def teacher_outputs():
    """The teacher-style forwards of both packages on the same float64
    weights and scenes: seed mode without jitter (probe_thresholds), vote
    mode with and without jitter (jitter_delta)."""
    params, stats, model = S.weights(2)
    pts, _, _, _ = S.scenes(3, 2)
    pts = pts[0]
    key = jax.random.PRNGKey(11)
    P = S.TINY["num_proposal"]
    with S.jax_float64():
        jmodel = JVoteNetNesie(**S.TINY)

        @functools.partial(jax.jit, static_argnums=(0, 1))
        def apply(sample_mod, with_jitter):
            return jmodel.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(pts),
                sample_mod, key, train=True, with_jitter=with_jitter,
                mutable=["batch_stats"])[0]

        def teacher(sample_mod, with_jitter):
            return jax.tree.map(np.asarray, apply(sample_mod, with_jitter))

        j = dict(seed=teacher("seed", False), on=teacher("vote", True),
                 off=teacher("vote", False))
        noise = S.jitter_noise(key, (2, P, 3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.from_numpy(pts)
    t = dict(seed=probe_thresholds.teacher_forward(model, x, "seed"))
    t["on"], t["off"] = jitter_delta.teacher_pair(model, x, "vote",
                                                  noise=noise)
    for k, v in model.state_dict().items():  # the statistics stay
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    return j, t


def _jgate(out):
    pos_obj = np.asarray(jax.nn.softmax(out["obj_scores"], axis=-1)[..., 1])
    argmax = np.argmax(out["sem_scores"], axis=-1)
    iou = np.take_along_axis(out["iou_scores"], argmax[..., None], -1)[..., 0]
    return dict(pos_obj=pos_obj, iou_pred=iou,
                max_cls=np.max(out["sem_scores"], axis=-1))


def test_probe_percentiles_match_jax(teacher_outputs):
    j, t = teacher_outputs
    got = {k: v.detach().numpy()
           for k, v in probe_thresholds.gate_scores(t["seed"]).items()}
    for k, want in _jgate(j["seed"]).items():
        np.testing.assert_allclose(probe_thresholds.percentiles(got[k]),
                                   probe_thresholds.percentiles(want),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_probe_sweep_counts_match_jax(teacher_outputs):
    j, t = teacher_outputs
    got = probe_thresholds.sweep(t["seed"], 18, 64)
    total = 0
    with S.jax_float64():
        for obj_thr, counts in got.items():
            for tag, (cls_b, iou_b) in probe_thresholds.GATES.items():
                cfg = jpl.PseudoLabelConfig(
                    num_classes=18, max_num_obj=64, obj_thr=obj_thr,
                    cls_thr_base=cls_b, iou_thr_base=iou_b)
                pl = jpl.get_pseudo_labels(
                    jax.tree.map(jnp.asarray, j["seed"]), jnp.zeros(18), cfg)
                want = int(np.asarray(pl.valid).sum())
                assert counts[tag] == want, (obj_thr, tag)
                total += want
    assert total > 0  # the sweep passes some proposals at these weights


def test_probe_report_layout(teacher_outputs, capsys):
    _, t = teacher_outputs
    report = probe_thresholds.probe(t["seed"], 18, 64, 2)
    assert set(report) == {"pos_obj", "iou_pred", "max_cls", "sweep"}
    assert report["pos_obj"].startswith("p50=")
    sweep = json.loads(json.dumps(report))["sweep"]
    assert set(sweep) == {str(o) for o in probe_thresholds.OBJ_THRS}
    assert "obj_thr=0.9" in capsys.readouterr().out


def _jax_agreement(out_on, out_off, acc, cfg):
    """tools/jitter_delta.py's selection agreement, as it computes it."""
    pl_on = jpl.get_pseudo_labels(out_on, acc, cfg)
    pl_off = jpl.get_pseudo_labels(out_off, acc, cfg)
    von, voff = np.asarray(pl_on.valid), np.asarray(pl_off.valid)
    bon = np.asarray(pl_on.boxes)[von]
    boff = np.asarray(pl_off.boxes)[voff]
    inter = 0
    for row in bon:
        if len(boff) and np.any(np.all(np.isclose(boff, row, atol=1e-4),
                                       axis=1)):
            inter += 1
    return dict(on=int(von.sum()), off=int(voff.sum()), inter=inter)


def test_jitter_delta_matches_jax(teacher_outputs):
    j, t = teacher_outputs
    jcfg = jget_config("nesie-votenet-scannet-train-010").pseudo
    jrelaxed = dataclasses.replace(
        jcfg, obj_thr=0.5, cls_thr_base=0.0, cls_thr_cap=0.5,
        iou_thr_base=0.05, iou_thr_cap=0.1)
    # a looser gate too, so that the random weights select boxes
    jloose = dataclasses.replace(jrelaxed, obj_thr=0.3)
    tcfg = PseudoLabelConfig(**dataclasses.asdict(jcfg))
    tcfgs = {"reference": tcfg, "relaxed": jitter_delta.relaxed_config(tcfg),
             "loose": dataclasses.replace(jitter_delta.relaxed_config(tcfg),
                                          obj_thr=0.3)}
    got = jitter_delta.compare(t["on"], t["off"], torch.zeros(18), tcfgs)
    with S.jax_float64():
        on = jax.tree.map(jnp.asarray, j["on"])
        off = jax.tree.map(jnp.asarray, j["off"])
        for tag, cfg in (("reference", jcfg), ("relaxed", jrelaxed),
                         ("loose", jloose)):
            assert got["agree"][tag] == _jax_agreement(
                on, off, jnp.zeros(18), cfg), tag
    d_iou = np.abs(j["on"]["iou_scores"] - j["off"]["iou_scores"])
    d_obj = np.abs(j["on"]["obj_scores"] - j["off"]["obj_scores"])
    np.testing.assert_allclose(got["d_iou_max"], d_iou.max(), atol=1e-8)
    np.testing.assert_allclose(got["d_iou_mean"], d_iou.mean(), atol=1e-8)
    np.testing.assert_allclose(got["d_obj_max"], d_obj.max(), atol=1e-8)
    assert got["d_iou_max"] > 0  # the jittered copies move the BN batch
    assert got["agree"]["loose"]["on"] > 0
    summary = jitter_delta.summarize([got, got], 7)
    assert summary["selection_agreement"]["loose"]["on"] == \
        2 * got["agree"]["loose"]["on"]
    assert summary["checkpoint_step"] == 7 and summary["batches"] == 2


# ---- diagnose_teacher ----

def test_pairings_equal_the_jax_tools_blend():
    _, _, pre = S.weights(4)
    _, _, student = S.weights(5)
    pre, student = pre.float(), student.float()
    pre_sd = diagnose_teacher.snapshot(pre)
    st_sd = diagnose_teacher.snapshot(student)
    jpre, jpre_stats = convert_state_dict(
        {k: v.numpy() for k, v in pre_sd.items()})
    jst, jst_stats = convert_state_dict(
        {k: v.numpy() for k, v in st_sd.items()})
    mid = jax.tree.map(lambda a, b: 0.5 * a + 0.5 * b, jpre, jst)
    want = state_dict_from_flax(jax.tree.map(np.asarray, mid), jst_stats)
    got = diagnose_teacher.pairing(diagnose_teacher.blend(pre_sd, st_sd, pre),
                                   st_sd, pre)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # parameters from one, BN statistics from the other
    mixed = diagnose_teacher.pairing(st_sd, pre_sd, pre)
    for name, _ in pre.named_parameters():
        assert torch.equal(mixed[name], st_sd[name]), name
    for name, _ in pre.named_buffers():
        assert torch.equal(mixed[name], pre_sd[name]), name
    with pytest.raises(AssertionError, match="step 0"):
        diagnose_teacher.check_step0({"mAP_0.25": 0.5}, {"mAP_0.25": 0.4})


# ---- the tools end to end on a generated dataset ----

@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """diagnose_teacher (pretrain 1 epoch, semi 1 epoch) on 8 + 4 scenes,
    then probe_thresholds and jitter_delta on the pretrain it leaves. The
    epochs are cut from the tool's 10 repeats of the 2 labeled scenes to
    2 (1 pretrain step, 2 semi steps) to keep the CPU run short."""
    out = tmp_path_factory.mktemp("study")
    write_synthetic_scannet(out / "data", 8, 4, seed=0)
    common = ["--device", "cpu", "--num-points", "1024"]
    configs = diagnose_teacher.configs

    def short(args, path):
        return tuple(apply_overrides(c, ["data.repeat=2"])
                     for c in configs(args, path))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(diagnose_teacher, "configs", short)
        report = diagnose_teacher.run(diagnose_teacher.parse_args(
            ["--out", str(out), "--pretrain-epochs", "1", "--semi-epochs",
             "1", "--eval-every", "1"] + common))
    pre_dir = out / "work" / diagnose_teacher.PRETRAIN
    probe = probe_thresholds.run(probe_thresholds.parse_args(
        ["--out", str(out), "--pretrain-dir", str(pre_dir), "--split", "010",
         "--pretrain-epochs", "1", "--pretrain-repeat", "2", "--n-scenes",
         "4", "--model-overrides", "--json-out", str(out / "probe.json")]
        + common))
    jitter = jitter_delta.run(jitter_delta.parse_args(
        ["--root", str(out), "--batches", "1"] + common))
    return out, report, probe, jitter


def test_diagnose_teacher_report(study):
    out, report, _, _ = study
    probes = report["probes"]
    assert probes["teacher_step0"] == probes["pretrain"]  # the sanity check
    assert set(probes) == {"pretrain", "teacher_step0", "student_final",
                           "teacher+student_stats", "teacher+pretrain_stats",
                           "pretrain+student_stats", "midpoint+student_stats"}
    assert [c["epoch"] for c in report["curve"]] == [0]
    for m in probes.values():
        assert 0.0 <= m["mAP_0.25"] <= 1.0
    assert json.loads((out / "diagnose_teacher.json").read_text())["probes"] \
        == json.loads(json.dumps(probes))


def test_probe_and_jitter_read_its_pretrain(study):
    out, _, probe, jitter = study
    # the pretrain was restored, not trained again
    assert sorted(p.name for p in (out / "work").iterdir()) == [
        diagnose_teacher.PRETRAIN, diagnose_teacher.SEMI]
    assert json.loads((out / "probe.json").read_text()) == \
        json.loads(json.dumps(probe))
    assert jitter["checkpoint_step"] > 0 and jitter["batches"] == 1
    assert set(jitter["selection_agreement"]) == {"reference", "relaxed"}


# ---- flops_analysis ----

def test_flop_count_equals_the_linear_layers():
    model = overfit_check.build_model(tiny=True)
    init_weights_flax_(model, torch.Generator().manual_seed(0))
    pts = torch.from_numpy(S.scenes(0, 2)[0][0].astype(np.float32))
    gemm = []

    def hook(mod, inp, _):
        rows = inp[0].numel() // mod.in_features
        gemm.append(2 * rows * mod.in_features * mod.out_features)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Linear)]
    res = flops_analysis.count(flops_analysis.eval_forward(model, pts))
    for h in hooks:
        h.remove()
    by_op = res["by_op"]
    assert by_op["aten.mm"] + by_op["aten.addmm"] == sum(gemm)
    assert res["flops"] == sum(by_op.values())
    # the point kernels a forward: FPS 1, ball query 5, three-NN 4
    assert {k: v["launches"] for k, v in res["point_ops"].items()} == dict(
        fps=1, ball_query=5, three_nn=4)
    b, n = pts.shape[:2]
    assert res["point_ops"]["fps"]["ops"] == flops_analysis.fps_ops(
        b, n, overfit_check.TINY_MODEL["num_points"][0])


def test_flops_tool_runs(capsys):
    assert flops_analysis.main(["--device", "cpu", "--tiny"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["semi_step"]["flops"] > last["eval_forward"]["flops"] > 0
    # the semi step's student and teacher forwards: 2 x (2, 5, 4)
    assert {k: v["launches"] for k, v in last["semi_step"]["point_ops"].items()
            } == dict(fps=4, ball_query=10, three_nn=8)
    assert any("point kernel ball_query" in line for line in lines)

