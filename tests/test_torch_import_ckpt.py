"""Importing a reference ``.pth`` on the port (``tools/import_torch_ckpt``
and ``convert.extract_ema`` / ``load_torch_checkpoint``) against the JAX
package's ``tools/import_torch_ckpt.py`` (CPU).

The ``.pth`` is built with ``tests/helpers/torch_ref_model.py``: the
reference's names, 1x1 convolutions with their unit dims, randomised BN,
``ema_*`` teacher buffers perturbed from the student, ``meta`` and
``optimizer``.

* The port's imported student and teacher equal exactly
  ``convert.state_dict_from_flax`` of the JAX import's ``params`` /
  ``batch_stats`` and ``ema_params`` / ``ema_batch_stats``.
* A pretrain ``.pth`` (no ``ema_*``): teacher == student == the
  ``.pth``.
* A wrong architecture, a missing and an unexpected key: ``SystemExit``
  naming the keys.
* The port's ``tools/test.py`` on its import and JAX's ``tools/test.py``
  on its own (Pallas kernels in interpret mode): the same student
  detections, boxes and scores within atol 1e-4, on weights whose boxes
  survive NMS (flax-initialised, the objectness logit raised, box size
  priors of 1 m, as ``tests/test_torch_saqe_runner.py`` makes them); the
  port's ``--teacher`` run serves the EMA weights.
* ``tools/train.py --load-from`` and ``init_detector`` (config name with
  the checkpoints dir, or with the ``.pth``) take the imported weights.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import nesie_tpu.eval as jeval
import nesie_tpu.ops.pointops as jpo
import nesie_tpu.train.runner as jrunner
import nesie_tpu_torch.eval as teval
import nesie_tpu_torch.train.runner as trunner
from nesie_tpu.data.synthetic import write_synthetic_scannet
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_flax_
from nesie_tpu_torch.convert import (
    extract_ema,
    load_torch_checkpoint,
    state_dict_from_flax,
)
from nesie_tpu_torch.tools import import_torch_ckpt as timport
from nesie_tpu_torch.tools import test as ttest
from nesie_tpu_torch.tools import train as ttrain
from test_torch_runner import MODEL16, MODEL128, _cfg, _load_jax_tool, _over

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from torch_ref_model import (  # noqa: E402
    build_ref_named_model,
    randomize_bn,
    register_ema_buffers,
    save_reference_checkpoint,
)

torch.set_num_threads(1)
NAME = "nesie-votenet-scannet-train-010"
SIZES = {"model.sizes": "(1.0,1.0,1.0)"}
OBJ_BIAS = "bbox_head.conv_pred.conv_cls.bias"
RAISE = 4.0


def _ref_model(ema: bool, seed: int = 0):
    """The reference-named model with flax-initialised weights (the port's
    ``init_weights_flax_``), randomised BN and the objectness logit
    raised, so that boxes survive NMS; with ``ema``, its ``ema_*``
    buffers."""
    model = build_ref_named_model(
        sa_channels=MODEL16["sa_channels"], fp_channels=MODEL16["fp_channels"],
        reg_max=MODEL16["reg_max"])
    port = VoteNetNesie(**MODEL16)
    init_weights_flax_(port, torch.Generator().manual_seed(seed))
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict({k: v.reshape(shapes[k])
                           for k, v in port.state_dict().items()})
    randomize_bn(model, seed=seed)
    with torch.no_grad():
        model.get_parameter(OBJ_BIAS)[1] += RAISE  # the "object" logit
    if ema:
        register_ema_buffers(model, perturb=0.02, seed=seed + 1)
    return model


def _save_pth(tmp, ema: bool) -> Path:
    pth = tmp / f"ref_{'ema' if ema else 'pretrain'}.pth"
    save_reference_checkpoint(_ref_model(ema), pth)
    return pth


def _port_import(tmp, pth, model=MODEL128):
    """The port's import of ``pth``: its checkpoints dir and payload."""
    _, tcfg = _cfg(NAME, model=model, **SIZES)
    tdir = timport.import_checkpoint(tcfg, pth, tmp / "port", device="cpu")
    assert tdir == tmp / "port" / NAME / "checkpoints"
    ckpt = trunner.CheckpointManager(tdir.parent).load()
    assert ckpt["step"] == 0
    return tdir, ckpt


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A reference .pth with ema_* buffers imported by both tools: the
    path, the port's checkpoints dir and payload, JAX's checkpoints dir
    and its restored state."""
    tmp = tmp_path_factory.mktemp("import_ema")
    pth = _save_pth(tmp, ema=True)
    tdir, ckpt = _port_import(tmp, pth)
    jcfg, _ = _cfg(NAME, model=MODEL128, **SIZES)
    jdir = _load_jax_tool("import_torch_ckpt").import_checkpoint(
        jcfg, pth, tmp / "jax")
    jstate, _ = jrunner.init_state(jcfg, jrunner.build_model(jcfg), 1)
    jstate, _, step = jrunner.CheckpointManager(jdir.parent).restore(jstate)
    assert step == 0
    return pth, ckpt, jstate, tdir, jdir


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_sd_equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), (what, k)


def test_import_equals_jax_import(imported):
    pth, ckpt, jstate, _, _ = imported
    _assert_sd_equal(ckpt["model"], state_dict_from_flax(
        _np(jstate.params), _np(jstate.batch_stats)), "student")
    _assert_sd_equal(ckpt["teacher"], state_dict_from_flax(
        _np(jstate.ema_params), _np(jstate.ema_batch_stats)), "teacher")
    assert ckpt["optimizer"]["state"] == {}  # a fresh AdamW
    assert ckpt["meta"] == {"mesh_size": 1, "imported_from": str(pth)}
    # the teacher is the EMA buffers (perturbed), its BN the student's
    sd = load_torch_checkpoint(pth)
    diff = [k for k in ckpt["model"]
            if not torch.equal(ckpt["model"][k], ckpt["teacher"][k])]
    assert diff and all(f"ema_{k.replace('.', '_')}" in sd for k in diff)
    stats = [k for k in ckpt["model"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert stats and not set(stats) & set(diff)


def test_extract_ema_and_unit_dims(imported):
    pth = imported[0]
    raw = torch.load(pth, map_location="cpu", weights_only=True)["state_dict"]
    sd = load_torch_checkpoint(pth)
    assert sd.keys() == raw.keys()
    name = "backbone.SA_modules.0.mlps.0.layer0.conv.weight"
    assert raw[name].shape[2:] == (1, 1) and sd[name].dim() == 2
    assert torch.equal(sd[name], raw[name][:, :, 0, 0])
    teacher = extract_ema(sd)
    assert not any(k.startswith("ema_") for k in teacher)
    assert teacher.keys() == {k for k in sd if not k.startswith("ema_")}
    assert torch.equal(teacher[name],
                       sd["ema_" + name.replace(".", "_")])
    assert extract_ema({k: v for k, v in sd.items()
                        if not k.startswith("ema_")}) is None


def test_pretrain_pth_teacher_is_student(tmp_path):
    pth = _save_pth(tmp_path, ema=False)
    _, ckpt = _port_import(tmp_path, pth, model=MODEL16)
    _assert_sd_equal(ckpt["teacher"], ckpt["model"], "teacher")
    _assert_sd_equal(ckpt["model"], load_torch_checkpoint(pth), "student")


def test_wrong_architecture_exits_naming_keys(imported, tmp_path):
    pth = imported[0]
    _, bad = _cfg(NAME, model=dict(MODEL16, reg_max=16), **SIZES)
    with pytest.raises(SystemExit, match="conv_pred.conv_bbox.weight"):
        timport.import_checkpoint(bad, pth, tmp_path / "a", device="cpu")
    _, cfg = _cfg(NAME, model=MODEL16, **SIZES)
    raw = torch.load(pth, map_location="cpu", weights_only=True)
    sd = raw["state_dict"]
    sd["bbox_head.extra.weight"] = sd.pop(
        "bbox_head.conv_pred.conv_heading.bias")
    torch.save(raw, tmp_path / "renamed.pth")
    with pytest.raises(SystemExit) as exc:
        timport.import_checkpoint(cfg, tmp_path / "renamed.pth",
                                  tmp_path / "b", device="cpu")
    assert "bbox_head.conv_pred.conv_heading.bias" in str(exc.value)
    assert "bbox_head.extra.weight" in str(exc.value)
    assert not (tmp_path / "b").exists()


def _jax_cli(jdir, jstate, data_root, teacher, monkeypatch):
    """JAX's tools/test.py on its import; the detections it scored. Its
    restore target is the state restored once already (the same tree;
    the restore replaces every leaf), which saves the model init."""
    seen = {}
    real = jeval.indoor_eval

    def capture(gt, dt, **kw):
        seen["dt"] = dt
        return real(gt, dt, **kw)

    monkeypatch.setattr(jeval, "indoor_eval", capture)
    monkeypatch.setattr(jrunner, "init_state",
                        lambda cfg, model, steps_per_epoch: (jstate, None))
    monkeypatch.setattr(sys, "argv", [
        "test.py", NAME, str(jdir), "--data-root", str(data_root),
        "--batch-size", "2", "--num-devices", "1", "--cfg-options",
        *_over(MODEL128, **SIZES)] + (["--teacher"] if teacher else []))
    _load_jax_tool("test").main()
    return seen["dt"]


def _port_cli(tdir, data_root, teacher, monkeypatch):
    seen = {}
    real = teval.indoor_eval

    def capture(gt, dt, **kw):
        seen["dt"] = dt
        return real(gt, dt, **kw)

    monkeypatch.setattr(teval, "indoor_eval", capture)
    ttest.main([NAME, str(tdir), "--data-root", str(data_root), "--device",
                "cpu", "--batch-size", "2", "--cfg-options",
                *_over(MODEL128, **SIZES)] + (["--teacher"] if teacher else []))
    return seen["dt"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_synthetic_scannet(tmp_path_factory.mktemp("data"), 6, 4,
                                   seed=0)


def test_test_cli_on_import_matches_jax(imported, data_root, monkeypatch):
    """The student's detections; the teacher's differ from them (its
    weights are the perturbed EMA buffers)."""
    from jax.experimental import pallas as pl

    _, _, jstate, tdir, jdir = imported
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")
    want = _jax_cli(jdir, jstate, data_root, False, monkeypatch)
    got = _port_cli(tdir, data_root, False, monkeypatch)
    assert len(got) == len(want) == 4
    kept = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4,
                                   rtol=0)
        kept += len(w["boxes"])
    assert kept >= 4 * 18  # boxes survive NMS and the score threshold
    teacher = _port_cli(tdir, data_root, True, monkeypatch)
    assert len(teacher) == 4 and any(
        t["scores"].shape != g["scores"].shape
        or not np.array_equal(t["scores"], g["scores"])
        for t, g in zip(teacher, got))


def test_load_from_and_init_detector_take_import(imported, data_root,
                                                 tmp_path, monkeypatch):
    pth, ckpt, _, tdir, _ = imported
    seen = {}
    real = trunner.train_semi

    def capture(cfg, ds, load_state, **kw):
        seen["student"] = {k: v.clone() for k, v in
                           load_state.model.state_dict().items()}
        seen["teacher"] = {k: v.clone() for k, v in
                           load_state.teacher.state_dict().items()}
        return real(cfg, ds, load_state, **kw)

    monkeypatch.setattr(trunner, "train_semi", capture)
    state = ttrain.main([NAME, "--data-root", str(data_root), "--work-dir",
                         str(tmp_path / "work"), "--device", "cpu",
                         "--load-from", str(tdir), "--cfg-options",
                         *_over(MODEL128, **SIZES), "optim.max_epochs=1",
                         "data.repeat=1", "data.samples_per_step=2"])
    assert state.step > 0
    _assert_sd_equal(seen["student"], ckpt["model"], "--load-from student")
    # --load-from starts the teacher as a copy of the loaded student
    _assert_sd_equal(seen["teacher"], ckpt["model"], "--load-from teacher")

    over = _over(MODEL128, **SIZES)
    for teacher in (False, True):
        want = ckpt["teacher" if teacher else "model"]
        for source in (tdir, pth):
            det = init_detector(NAME, source, device="cpu", teacher=teacher,
                                cfg_options=over)
            _assert_sd_equal(det.model.state_dict(), want,
                             f"init_detector({source.name}, {teacher})")
