"""The port's runner, checkpoints, eval loop and CLIs against the JAX
package's, on the CPU.

* The training loops with their steps replaced by recorders: both runners
  must hand their steps the same batches (exactly), epoch for epoch, and
  checkpoint at the same steps, also on resume.
* Checkpoints of a real tiny run: save, restore and resume bit for bit,
  the step rescale, ``weights_only_load``.
* The eval slice: JAX ``init_state`` weights converted with
  ``state_dict_from_flax``; JAX's eval forward (its Pallas kernels in
  interpret mode), ``decode_and_nms`` and ``indoor_eval`` against the
  port's ``evaluate``: decoded boxes within atol 1e-4, the metrics within
  1e-6.
* The CLIs: pretrain, semi with ``--load-from``, test, on the CPU.
"""
import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.config as jconfig
import nesie_tpu.data.dataset as jds
import nesie_tpu.ops.pointops as jpo
import nesie_tpu.train.runner as jrunner
import nesie_tpu_torch.config as tconfig
import nesie_tpu_torch.data.dataset as tds
import nesie_tpu_torch.train.runner as trunner
from nesie_tpu.data.synthetic import write_synthetic_scannet
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.train.semi import UlbState
from nesie_tpu_torch.tools import test as ttest
from nesie_tpu_torch.tools import train as ttrain

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

MODEL16 = dict(num_proposal=16, reg_max=8, num_points=(64, 32, 16, 16),
               num_samples=(8, 8, 4, 4),
               sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                            (32, 32, 32)),
               fp_channels=((32, 32), (32, 32)))
# sample and proposal counts of 128, so that the JAX forward takes its
# Pallas ball query (tests/test_torch_slice.py)
MODEL128 = dict(MODEL16, num_proposal=128, num_points=(256, 128, 128, 128))
N_POINTS = 1024


def _over(model, **extra):
    items = [f"model.{k}={v}" for k, v in model.items()]
    items += [f"data.num_points={N_POINTS}"]
    return items + [f"{k}={v}" for k, v in extra.items()]


def _cfg(name, model=MODEL16, work=None, **extra):
    """The same named config with the same overrides, JAX's and the
    port's, on one device."""
    over = _over(model, **extra)
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.apply_overrides(mod.get_config(name), over)
        out.append(dataclasses.replace(cfg, num_devices=1,
                                       work_dir=str(work or "work_dirs")))
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_scannet")
    return write_synthetic_scannet(root, 10, 4, seed=0)


def _np(x):
    return np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(batch):
    out = {}
    for k, v in batch.items():
        if hasattr(v, "_asdict"):  # AugParams, JAX's or the port's
            out[k] = {f: _np(a) for f, a in v._asdict().items()}
        else:
            out[k] = _np(v)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], dict):
                for f in w[k]:
                    np.testing.assert_array_equal(g[k][f], w[k][f], err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


class Recorder:
    """Stands in for both runners' step factories and checkpoint saves."""

    def __init__(self, real_save=False):
        self.batches, self.saves, self.epochs = [], [], []
        self.real_save = real_save

    def patch(self, mp, runner, jax_side):
        rec = self
        if jax_side:
            def sup(state, batch, key):
                rec.batches.append(_host(batch))
                return (state._replace(step=state.step + 1),
                        {"loss": jnp.zeros(())})

            def semi(state, ulb_state, batch, key):
                rec.batches.append(_host(batch))
                return (state._replace(step=state.step + 1), ulb_state,
                        {"loss": jnp.zeros(()), "num_pseudo": jnp.ones(())})
        else:
            def sup(state, batch, generator=None):
                rec.batches.append(_host(batch))
                state.step += 1
                return {"loss": torch.zeros(())}

            def semi(state, ulb_state, batch, generator=None,
                     teacher_generator=None):
                rec.batches.append(_host(batch))
                state.step += 1
                return ulb_state, {"loss": torch.zeros(()),
                                   "num_pseudo": torch.ones((),
                                                            dtype=torch.int64)}
        mp.setattr(runner, "_sup_step_fn", lambda *a, **k: sup)
        mp.setattr(runner, "_semi_step_fn", lambda *a, **k: semi)
        save = runner.CheckpointManager.save

        def record_save(mgr, step, state, ulb_state=None, meta=None):
            rec.saves.append((int(step), meta))
            if rec.real_save:
                save(mgr, step, state, ulb_state, meta)

        mp.setattr(runner.CheckpointManager, "save", record_save)

    def callback(self, epoch, state):
        self.epochs.append((epoch, int(state.step)))


@pytest.fixture(scope="module")
def jax_state():
    """A small JAX TrainState for every recorder run: a recorder reads
    only its step, and JAX's checkpoints save and restore it."""
    import optax

    from nesie_tpu.train.state import create_train_state

    variables = {"params": {"w": jnp.zeros(2)},
                 "batch_stats": {"m": jnp.zeros(2)}}
    return create_train_state(variables, optax.sgd(0.1)), None


def _run_both(name, root, tmp_path, jax_state, resume_epochs=None,
              **extra):
    """Both runners with recorders; with ``resume_epochs``, a second run
    of each resumes from the first one's checkpoints with that many
    epochs."""
    recs = {}
    for side, runner, mod in (("jax", jrunner, jds), ("port", trunner, tds)):
        jcfg, tcfg = _cfg(name, work=tmp_path / side, **extra)
        cfg = jcfg if side == "jax" else tcfg
        split = root / cfg.data.label_list_file
        ann = root / cfg.data.train_ann_file
        runs = [(cfg, False)]
        if resume_epochs:
            runs.append((dataclasses.replace(cfg, optim=dataclasses.replace(
                cfg.optim, max_epochs=resume_epochs)), True))
        recs[side] = []
        for run_cfg, resume in runs:
            rec = Recorder(real_save=resume_epochs is not None)
            with pytest.MonkeyPatch.context() as mp:
                rec.patch(mp, runner, side == "jax")
                if side == "jax":
                    mp.setattr(runner, "init_state",
                               lambda *a, **k: jax_state)
                kw = {} if side == "jax" else dict(device="cpu")
                if cfg.mode == "pretrain":
                    ds = mod.SubScanNetScenes(root, ann, split)
                    runner.train_supervised(run_cfg, ds, resume=resume,
                                            epoch_callback=rec.callback, **kw)
                else:
                    ds = mod.SimiScanNetScenes(root, ann, split, ratio=2)
                    runner.train_semi(run_cfg, ds, resume=resume,
                                      epoch_callback=rec.callback, **kw)
            recs[side].append(rec)
    for got, want in zip(recs["port"], recs["jax"]):
        _assert_batches_equal(got.batches, want.batches)
        assert got.epochs == want.epochs
        assert got.saves == want.saves
    return recs["port"]


@pytest.mark.parametrize("name", ["nesie-votenet-scannet-pretrain-050",
                                  "nesie-votenet-scannet-train-050"])
def test_runner_loop_replays_jax_batches(name, data_root, tmp_path,
                                         jax_state):
    """5 labeled scenes, batch 2, repeat 2: 5 steps an epoch (the last
    labeled scene of each repeat wraps into the next step), 3 epochs,
    checkpoints every second epoch."""
    rec, = _run_both(name, data_root, tmp_path, jax_state, **{
        "optim.max_epochs": 3, "data.repeat": 2, "data.samples_per_step": 2,
        "checkpoint_interval_epochs": 2, "log_interval": 2})
    assert rec.epochs == [(0, 5), (1, 10), (2, 15)]
    assert rec.saves == [(10, {"mesh_size": 1})]
    b = 2 if name.endswith("pretrain-050") else 6
    assert len(rec.batches) == 15
    key = "points" if b == 2 else "points_raw_s"
    assert rec.batches[0][key].shape == (b, N_POINTS, 4)


@pytest.mark.parametrize("name", ["nesie-votenet-scannet-pretrain-050",
                                  "nesie-votenet-scannet-train-050"])
def test_runner_resume_replays_jax(name, data_root, tmp_path, jax_state):
    """Two epochs, then a resumed run to four: it starts at epoch
    step // steps_per_epoch = 2 with the batches JAX's resumed run
    draws."""
    first, resumed = _run_both(
        name, data_root, tmp_path, jax_state, resume_epochs=4,
        **{"optim.max_epochs": 2, "data.repeat": 1,
           "data.samples_per_step": 2, "log_interval": 1})
    assert first.epochs == [(0, 2), (1, 4)]
    assert resumed.epochs == [(2, 6), (3, 8)]
    assert [s for s, _ in resumed.saves] == [6, 8]


# ------------------------------------------------------------ checkpoints
def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return out


def _assert_state_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys() and len(ta) > 0
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    """A real tiny semi run (2 epochs of 2 steps: the 2 labeled scenes of
    split 010, one a step) from a pretrain run of the same shape, as the
    CLIs would chain them."""
    work = tmp_path_factory.mktemp("work")
    _, pcfg = _cfg("nesie-votenet-scannet-pretrain-010", work=work,
                   **{"optim.max_epochs": 2, "data.repeat": 1,
                      "data.samples_per_step": 1, "log_interval": 1})
    ann = data_root / pcfg.data.train_ann_file
    split = data_root / pcfg.data.label_list_file
    pre = trunner.train_supervised(pcfg, tds.SubScanNetScenes(
        data_root, ann, split), device="cpu")
    _, scfg = _cfg("nesie-votenet-scannet-train-010", work=work,
                   **{"optim.max_epochs": 2, "data.repeat": 1,
                      "data.samples_per_step": 1, "log_interval": 1})
    fresh = trunner.init_state(scfg, trunner.build_model(scfg), 1, "cpu")
    load = trunner.weights_only_load(fresh, pre)
    ds = tds.SimiScanNetScenes(data_root, ann, split, ratio=2)
    stats = {}
    semi = trunner.train_semi(scfg, ds, load, run_stats=stats, device="cpu")
    return dict(pcfg=pcfg, scfg=scfg, pre=pre, semi=semi, ds=ds,
                stats=stats)


def test_checkpoint_roundtrip_is_bit_identical(trained):
    scfg, semi, ds = trained["scfg"], trained["semi"], trained["ds"]
    mgr = trunner.CheckpointManager(Path(scfg.work_dir) / scfg.name)
    assert mgr.all_steps() == [2, 4]
    fresh = trunner.init_state(scfg, trunner.build_model(scfg), 1, "cpu")
    ulb = UlbState.create(ds.num_unlabeled, 18, device="cpu")
    restored, ulb2, step = mgr.restore(fresh, ulb)
    assert step == 4
    _assert_state_equal(restored, semi)
    payload = mgr.load()
    assert payload["meta"] == {"mesh_size": 1}
    assert float(ulb2.ulb_flag.sum()) < ds.num_unlabeled  # scans visited
    assert set(trained["stats"]) == {"num_pseudo_per_step",
                                     "num_pseudo_mean"}
    assert len(trained["stats"]["num_pseudo_per_step"]) == 2


def test_checkpoint_keeps_three_and_rescales_step(trained, tmp_path):
    semi = trained["semi"]
    mgr = trunner.CheckpointManager(tmp_path)
    for s in (1, 2, 3, 4):
        mgr.save(s, semi, meta={"mesh_size": 4})
    assert mgr.all_steps() == [2, 3, 4]
    scfg = trained["scfg"]
    fresh = trunner.init_state(scfg, trunner.build_model(scfg), 1, "cpu")
    _, _, step = mgr.restore(fresh, mesh_size=1)
    assert step == fresh.step == 4 * 4  # written on 4 devices, read on 1
    _, _, step = mgr.restore(fresh, step=3)
    assert (step, fresh.step) == (3, semi.step)  # as JAX: the dir's step
    empty = trunner.CheckpointManager(tmp_path / "none")
    assert empty.restore(fresh) == (fresh, None, 0)


def test_weights_only_load_matches_jax_semantics(trained):
    """Student and BN statistics from the loaded state, the teacher a copy
    of the loaded student, the fresh optimizer and step; no tensor
    shared."""
    pre, scfg = trained["pre"], trained["scfg"]
    fresh = trunner.init_state(scfg, trunner.build_model(scfg), 1, "cpu")
    out = trunner.weights_only_load(fresh, pre)
    assert out is fresh and out.step == 0
    assert out.optimizer.state_dict()["state"] == {}
    want = pre.model.state_dict()
    for mod in (out.model, out.teacher):
        for k, v in mod.state_dict().items():
            assert torch.equal(v, want[k]), k
            assert v.data_ptr() != want[k].data_ptr(), k
    assert not all(torch.equal(v, pre.teacher.state_dict()[k])
                   for k, v in out.teacher.state_dict().items())


def test_resume_continues_at_step_over_steps_per_epoch(trained):
    """The semi run resumed with one more epoch starts at epoch 2."""
    scfg = dataclasses.replace(trained["scfg"], optim=dataclasses.replace(
        trained["scfg"].optim, max_epochs=3))
    epochs = []
    state = trunner.train_semi(scfg, trained["ds"], resume=True,
                               epoch_callback=lambda e, s: epochs.append(
                                   (e, s.step)), device="cpu")
    assert epochs == [(2, 6)] and state.step == 6


@pytest.mark.parametrize("over", ["num_devices=2"])
def test_missing_options_raise(over):
    """The one setting the port refuses: a ``num_devices`` that is not the
    launched world size (one process here), with a ``ValueError`` that
    names torchrun."""
    cfg = tconfig.apply_overrides(
        tconfig.get_config("nesie-votenet-scannet-train-010"), [over])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        trunner.build_model(cfg)


@pytest.fixture(scope="module")
def tiny_checkpoint(data_root, tmp_path_factory):
    """A one-step pretrain checkpoint of MODEL16 written by the train
    CLI."""
    work = tmp_path_factory.mktemp("options_work")
    ttrain.main(["nesie-votenet-scannet-pretrain-010", "--data-root",
                 str(data_root), "--work-dir", str(work), "--device", "cpu",
                 "--cfg-options", *_over(MODEL16), "optim.max_epochs=1",
                 "data.repeat=1", "data.samples_per_step=1"])
    return work / "nesie-votenet-scannet-pretrain-010" / "checkpoints"


# the options of ExperimentConfig that the port once refused, each through
# the CLI that reads it: a semi step of the train CLI, or the test CLI on
# a checkpoint
OPTION_CASES = [
    ("train", "sample_mod_train=random"),
    ("train", "sample_mod_train=spec"),
    ("train", "model.compute_dtype=bfloat16"),
    ("train", "teacher_jitter=true"),
    ("test", "test.sample_mod=random"),
    ("test", "test.sample_mod=spec"),
    ("test", "model.compute_dtype=bfloat16"),
    ("test", "test.iou_opt=true"),
]


@pytest.mark.parametrize("cli,over", OPTION_CASES,
                         ids=[f"{c}-{o}" for c, o in OPTION_CASES])
def test_supported_options_run(cli, over, data_root, tiny_checkpoint,
                               tmp_path):
    """``get_config`` + ``apply_overrides`` with the option builds the
    model, and the CLI runs it on the CPU at MODEL16: one semi step
    (finite losses, a moved student) or an evaluation (mAP in [0, 1])."""
    name = "nesie-votenet-scannet-train-010"
    cfg = tconfig.apply_overrides(tconfig.get_config(name),
                                  _over(MODEL16) + [over])
    model = trunner.build_model(cfg)
    if over == "model.compute_dtype=bfloat16":
        conv = model.backbone.SA_modules[0].mlps[0].layer0
        assert conv.dtype == torch.bfloat16
    if cli == "train":
        state = ttrain.main([
            name, "--data-root", str(data_root), "--work-dir",
            str(tmp_path), "--device", "cpu", "--cfg-options",
            *_over(MODEL16), "optim.max_epochs=1", "data.repeat=1",
            "data.samples_per_step=1", "log_interval=1", over])
        assert state.step >= 1
        rows = [json.loads(line) for line in
                (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        assert rows and all(np.isfinite(v) for r in rows
                            for v in r.values())
        init = trunner.init_state(cfg, trunner.build_model(cfg), 1, "cpu")
        moved = [not torch.equal(v, init.model.state_dict()[k])
                 for k, v in state.model.state_dict().items()
                 if k.endswith("weight")]
        assert any(moved)
        return
    results = ttest.main([name, str(tiny_checkpoint), "--data-root",
                          str(data_root), "--device", "cpu", "--batch-size",
                          "2", "--cfg-options", *_over(MODEL16), over])
    for k in ("mAP_0.25", "mAR_0.25"):
        assert 0.0 <= results[k] <= 1.0


# ------------------------------------------------------------- eval slice
def _jax_eval(cfg, state, ds, batch_size, seed):
    """JAX's tools/test.py loop: padded tail batch, one numpy stream."""
    from nesie_tpu.data.scannet_meta import CLASS_NAMES
    from nesie_tpu.eval import decode_and_nms, indoor_eval
    from nesie_tpu.eval.postprocess import expand_per_class
    from nesie_tpu.train.step import make_eval_forward

    model = jrunner.build_model(cfg)
    fwd = make_eval_forward(model, cfg.test.sample_mod)
    rng, key = np.random.default_rng(seed), jax.random.PRNGKey(seed)
    gt_annos, dt_annos, n = [], [], len(ds)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        n_real = len(idx)
        idx = idx + [idx[-1]] * (batch_size - n_real)
        b = ds.eval_batch(idx, rng, cfg.data.num_points)
        key, sub = jax.random.split(key)
        pts = jnp.asarray(b["points"])
        out = fwd(state, pts, sub)
        dec = jax.tree.map(np.asarray, decode_and_nms(
            out, pts, nms_thr=cfg.test.nms_thr, score_thr=cfg.test.score_thr,
            use_iou_for_nms=cfg.test.use_iou_for_nms))
        for i in range(n_real):
            boxes, scores, labels = expand_per_class(
                {k: v[i] for k, v in dec.items()})
            dt_annos.append(dict(boxes=boxes, scores=scores, labels=labels))
            gb = b["gt_boxes"][i][b["gt_valid"][i]].copy()
            gb[:, 2] += gb[:, 5] / 2
            gt_annos.append(dict(boxes=gb,
                                 labels=b["gt_labels"][i][b["gt_valid"][i]]))
    return indoor_eval(gt_annos, dt_annos, class_names=list(CLASS_NAMES)), \
        dt_annos


@pytest.fixture(scope="module")
def slice_cfgs():
    """MODEL128 with size priors of 1 m (see the eval test), JAX's config,
    the port's, and JAX init_state's state for it."""
    jcfg, tcfg = _cfg("nesie-votenet-scannet-train-010", model=MODEL128,
                      **{"model.sizes": "(1.0,1.0,1.0)"})
    jstate, _ = jrunner.init_state(jcfg, jrunner.build_model(jcfg), 1)
    return jcfg, tcfg, jstate


def test_init_state_draws_from_flax_initializers(slice_cfgs):
    """The port's init_state draws every weight from the distribution
    JAX's does: Linear weights lecun_normal (truncated at 2 std), biases
    and BN shifts 0, BN scales 1; std within 10% on tensors of 1000
    values or more."""
    _, tcfg, jstate = slice_cfgs
    want = state_dict_from_flax(jstate.params, jstate.batch_stats)
    got = trunner.init_state(tcfg, trunner.build_model(tcfg), 1,
                             "cpu").model.state_dict()
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith(("bias", "running_mean", "running_var",
                       "num_batches_tracked")) or w.dim() == 1:
            torch.testing.assert_close(g, w.to(g.dtype), rtol=0, atol=0)
            continue
        bound = 2.0 / np.sqrt(w.shape[1]) / 0.87962566103423978
        for t in (g, w):
            assert t.abs().max() <= bound * (1 + 1e-6), k
        if w.numel() >= 1000:
            assert abs(g.std() / w.std() - 1) < 0.1, k
            checked += 1
    assert checked >= 20


def test_evaluate_matches_jax_pipeline(data_root, slice_cfgs, monkeypatch):
    """Batches of 2 over the 4 val scenes and 1 train scene (a padded
    tail), from JAX init_state weights. Size priors of 1 m put the random
    weights' boxes at the objects' scale, so that some GT is recalled and
    the metrics are not all 0."""
    from jax.experimental import pallas as pl

    jcfg, tcfg, jstate = slice_cfgs
    jds_ = jds.ScanNetScenes(data_root, data_root / "scannet_infos_val.pkl")
    tds_ = tds.ScanNetScenes(data_root, data_root / "scannet_infos_val.pkl")
    extra = jds.ScanNetScenes(data_root, data_root / "scannet_infos_train.pkl")
    jds_.scenes.append(extra.scenes[0])
    tds_.scenes.append(extra.scenes[0])

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")
    want, want_dt = _jax_eval(jcfg, jstate, jds_, 2, 9)

    model = trunner.build_model(tcfg)
    model.load_state_dict(state_dict_from_flax(jstate.params,
                                               jstate.batch_stats))
    seen = {}
    teval_pkg = importlib.import_module("nesie_tpu_torch.eval")
    real = teval_pkg.indoor_eval

    def capture(gt, dt, **kw):
        seen["dt"] = dt
        return real(gt, dt, **kw)

    monkeypatch.setattr(teval_pkg, "indoor_eval", capture)
    got = ttest.evaluate(tcfg, model, tds_, batch_size=2, seed=9,
                         device="cpu")
    assert got.keys() == want.keys()
    assert want["mAR_0.25"] > 0 and want["mAP_0.25"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert len(seen["dt"]) == len(want_dt) == 5
    n_boxes = 0
    for g, w in zip(seen["dt"], want_dt):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4,
                                   rtol=0)
        n_boxes += len(w["boxes"])
    assert n_boxes > 0  # the comparison is not vacuous


# ------------------------------------------------------------------- CLIs
def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed_keys(out):
    keys = [line.split(":")[0] for line in out.splitlines()
            if line.startswith(("mAP", "mAR"))]
    ap = [line for line in out.splitlines() if line.startswith("{")]
    return keys, sorted(eval(ap[-1]).keys())  # noqa: S307 (own output)


def test_cli_round_trip_prints_jax_keys(data_root, tmp_path, capsys,
                                        monkeypatch):
    """pretrain -> semi --load-from -> test (student and teacher) through
    the port's CLIs on the CPU; the printed metric keys equal those of
    JAX's tools/test.py on the same val split."""
    model = _over(MODEL128)  # JAX's eager init as in the slice test
    train = model + ["optim.max_epochs=1", "data.repeat=1",
                     "data.samples_per_step=2", "log_interval=1"]
    work = tmp_path / "work"
    common = ["--data-root", str(data_root), "--work-dir", str(work),
              "--device", "cpu"]
    ttrain.main(["nesie-votenet-scannet-pretrain-010", *common,
                 "--cfg-options", *train])
    pre = work / "nesie-votenet-scannet-pretrain-010" / "checkpoints"
    semi = ttrain.main(["nesie-votenet-scannet-train-010", *common,
                        "--load-from", str(pre), "--cfg-options", *train])
    assert semi.step == 1
    assert (work / "nesie-votenet-scannet-train-010" / "config.json").exists()
    ckpt = work / "nesie-votenet-scannet-train-010" / "checkpoints"
    capsys.readouterr()
    test_args = ["nesie-votenet-scannet-train-010", str(ckpt), "--data-root",
                 str(data_root), "--batch-size", "3", "--cfg-options", *model]
    student = ttest.main(test_args + ["--device", "cpu"])
    got = _printed_keys(capsys.readouterr().out)
    teacher = ttest.main(test_args + ["--device", "cpu", "--teacher"])
    assert _printed_keys(capsys.readouterr().out) == got
    assert student.keys() == teacher.keys()

    # apis.init_detector in the JAX package's form serves that checkpoint
    payload = trunner.CheckpointManager(ckpt.parent).load()
    for who in ("model", "teacher"):
        det = init_detector("nesie-votenet-scannet-train-010", ckpt,
                            device="cpu", teacher=who == "teacher",
                            cfg_options=model)
        for k, v in det.model.state_dict().items():
            assert torch.equal(v, payload[who][k]), (who, k)
    cloud = np.fromfile(str(next((data_root / "points").glob("*.bin"))),
                        np.float32).reshape(-1, 6)
    res = det(cloud)
    assert det.cfg.num_points == N_POINTS
    assert np.isfinite(res["boxes_3d"]).all()

    jtest = _load_jax_tool("test")
    monkeypatch.setattr("sys.argv", ["test.py", *test_args[:1],
                                     str(tmp_path / "none" / "checkpoints"),
                                     *test_args[2:6], "--num-devices", "1",
                                     "--cfg-options", *model])
    jtest.main()
    assert got == _printed_keys(capsys.readouterr().out)
    assert len(got[0]) == 4 and len(got[1]) > 0
