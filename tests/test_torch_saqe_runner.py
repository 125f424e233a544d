"""The SAQE configs through the port's runner, eval loop, CLIs and
validation tool, against the JAX package, on the CPU; and the eval
pipeline of both heads on weights whose boxes survive NMS.

* Eval parity where boxes survive: converted weights with the
  objectness logit raised (Nesie: the prediction head's; SAQE: the
  quality module's R_obj branch), JAX's eval pipeline (forward with its
  Pallas kernels in interpret mode, ``decode_and_nms``,
  ``expand_per_class``, ``indoor_eval``) against the port's ``evaluate``:
  the same kept boxes and labels, box coordinates within atol 1e-4
  (float32 forwards), scores within atol 1e-5, the metrics within 1e-6,
  some AP above 0. For SAQE, raising the prediction head's objectness
  instead changes nothing: decode reads ``R_obj_scores``.
* ``init_state`` of a SAQE config against JAX's: the same initializer
  distributions over every parameter of the SAQE model.
* The CLIs: SAQE pretrain, semi with ``--load-from``, test (student and
  teacher) and ``init_detector``, the printed keys those of JAX's
  ``tools/test.py``; ``validation_run --head saqe`` on a few scenes.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import nesie_tpu.data.dataset as jds
import nesie_tpu.ops.pointops as jpo
import nesie_tpu.train.runner as jrunner
import nesie_tpu_torch.data.dataset as tds
import nesie_tpu_torch.train.runner as trunner
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.data.synthetic import write_synthetic_scannet
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.nn.detector import init_weights_flax_
from nesie_tpu_torch.tools import test as ttest
from nesie_tpu_torch.tools import train as ttrain
from nesie_tpu_torch.tools import validation_run as tvalidation
from test_torch_runner import (
    MODEL16,
    MODEL128,
    _cfg,
    _jax_eval,
    _load_jax_tool,
    _over,
    _printed_keys,
)

torch.set_num_threads(1)

# the objectness logit each head's decode reads, and the other one
OBJ_BIAS = {"nesie": "bbox_head.conv_pred.conv_cls.bias",
            "saqe": "bbox_head.grid_conv.mlps_head.6.6.bias"}
RAISE = 4.0


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_scannet_saqe")
    return write_synthetic_scannet(root, 10, 4, seed=0)


def _eval_sets(root):
    """The 4 val scenes and 1 train scene (a padded tail at batch 2), as
    JAX's and the port's datasets."""
    out = []
    for mod in (jds, tds):
        ds = mod.ScanNetScenes(root, root / "scannet_infos_val.pkl")
        extra = mod.ScanNetScenes(root, root / "scannet_infos_train.pkl")
        ds.scenes.append(extra.scenes[0])
        out.append(ds)
    return out


def _port_eval(tcfg, model, ds, monkeypatch):
    """The port's ``evaluate`` at batch 2, and the detections it scored."""
    seen = {}
    pkg = importlib.import_module("nesie_tpu_torch.eval")
    real = pkg.indoor_eval

    def capture(gt, dt, **kw):
        seen["dt"] = dt
        return real(gt, dt, **kw)

    monkeypatch.setattr(pkg, "indoor_eval", capture)
    got = ttest.evaluate(tcfg, model, ds, batch_size=2, seed=9, device="cpu")
    return got, seen["dt"]


@pytest.mark.parametrize("head", ["nesie", "saqe"])
def test_evaluate_matches_jax_where_boxes_survive(head, data_root,
                                                  monkeypatch):
    from jax.experimental import pallas as pl

    extra = {"model.sizes": "(1.0,1.0,1.0)"} if head == "nesie" else {}
    jcfg, tcfg = _cfg(f"{head}-votenet-scannet-train-010", model=MODEL128,
                      **extra)
    model = trunner.build_model(tcfg)
    init_weights_flax_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        bias = model.get_parameter(OBJ_BIAS[head])
        bias[1 if head == "nesie" else -1] += RAISE  # the "object" logit
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, head=head)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats)
    jset, tset = _eval_sets(data_root)

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")
    want, want_dt = _jax_eval(jcfg, jstate, jset, 2, 9)
    got, got_dt = _port_eval(tcfg, model, tset, monkeypatch)

    assert got.keys() == want.keys()
    assert max(v for k, v in want.items() if k.startswith("mAP")) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert len(got_dt) == len(want_dt) == 5
    n_kept = 0
    for g, w in zip(got_dt, want_dt):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5,
                                   rtol=0)
        n_kept += len(w["boxes"]) // tcfg.model.num_classes
    # boxes survive NMS, the score threshold and the non-empty filter
    assert n_kept >= 5

    if head == "saqe":  # the prediction head's objectness is not read
        with torch.no_grad():
            model.get_parameter(OBJ_BIAS["nesie"])[:2] += torch.tensor(
                [RAISE, -RAISE])
        again, again_dt = _port_eval(tcfg, model, tset, monkeypatch)
        assert again == got
        for g, a in zip(got_dt, again_dt):
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(a[k], g[k])


def test_saqe_init_state_draws_from_flax_initializers():
    """The port's init_state for a SAQE config draws every weight from
    the distribution JAX's does: Linear weights lecun_normal (truncated
    at 2 std), biases and BN shifts 0, BN scales 1; std within 10% on
    tensors of 1000 values or more."""
    jcfg, tcfg = _cfg("saqe-votenet-scannet-pretrain-010")
    jstate, _ = jrunner.init_state(jcfg, jrunner.build_model(jcfg), 1)
    want = state_dict_from_flax(jstate.params, jstate.batch_stats)
    got = trunner.init_state(tcfg, trunner.build_model(tcfg), 1,
                             "cpu").model.state_dict()
    assert got.keys() == want.keys()
    assert any(k.startswith("bbox_head.grid_conv.mlps_head.6.") for k in got)
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
    assert checked >= 30


def test_saqe_cli_round_trip_prints_jax_keys(data_root, tmp_path, capsys,
                                             monkeypatch):
    """SAQE pretrain -> semi --load-from -> test (student and teacher)
    through the port's CLIs; ``init_detector`` serves the checkpoint; the
    printed metric keys equal those of JAX's tools/test.py."""
    model = _over(MODEL16)
    train = model + ["optim.max_epochs=1", "data.repeat=1",
                     "data.samples_per_step=2", "log_interval=1"]
    work = tmp_path / "work"
    common = ["--data-root", str(data_root), "--work-dir", str(work),
              "--device", "cpu"]
    pre_name, semi_name = ("saqe-votenet-scannet-pretrain-010",
                           "saqe-votenet-scannet-train-010")
    pre = ttrain.main([pre_name, *common, "--cfg-options", *train])
    assert pre.step >= 1
    semi = ttrain.main([semi_name, *common, "--load-from",
                        str(work / pre_name / "checkpoints"),
                        "--cfg-options", *train])
    assert semi.step == 1
    assert type(semi.model.bbox_head).__name__ == "SAQEHead"
    ckpt = work / semi_name / "checkpoints"
    capsys.readouterr()
    test_args = [semi_name, str(ckpt), "--data-root", str(data_root),
                 "--batch-size", "3", "--cfg-options", *model]
    student = ttest.main(test_args + ["--device", "cpu"])
    got = _printed_keys(capsys.readouterr().out)
    teacher = ttest.main(test_args + ["--device", "cpu", "--teacher"])
    assert _printed_keys(capsys.readouterr().out) == got
    assert student.keys() == teacher.keys()

    payload = trunner.CheckpointManager(ckpt.parent).load()
    for who in ("model", "teacher"):
        det = init_detector(semi_name, ckpt, device="cpu",
                            teacher=who == "teacher", cfg_options=model)
        assert type(det.model.bbox_head).__name__ == "SAQEHead"
        for k, v in det.model.state_dict().items():
            assert torch.equal(v, payload[who][k]), (who, k)
    cloud = np.fromfile(str(next((data_root / "points").glob("*.bin"))),
                        np.float32).reshape(-1, 6)
    res = det(cloud)
    assert np.isfinite(res["boxes_3d"]).all()

    jtest = _load_jax_tool("test")
    monkeypatch.setattr("sys.argv", ["test.py", *test_args[:1],
                                     str(tmp_path / "none" / "checkpoints"),
                                     *test_args[2:6], "--num-devices", "1",
                                     "--cfg-options", *model])
    jtest.main()
    assert got == _printed_keys(capsys.readouterr().out)
    assert len(got[0]) == 4 and len(got[1]) > 0


def test_validation_run_head_saqe(tmp_path, capsys):
    """``--head saqe`` trains and evaluates the saqe-* configs; the
    summary names the head and prints each seed's mAP."""
    args = ["--out", str(tmp_path / "v"), "--n-train", "8", "--n-val", "2",
            "--num-points", "1024", "--data-classes", "4",
            "--pretrain-epochs", "1", "--semi-epochs", "1",
            "--pretrain-repeat", "1", "--semi-repeat", "1", "--seeds", "0",
            "--split", "050", "--head", "saqe", "--device", "cpu",
            "--model-overrides",
            *[f"model.{k}={v}" for k, v in MODEL16.items()]]
    payload = tvalidation.main(args)
    out = capsys.readouterr().out
    assert "head saqe" in out and "seed 0: pretrain " in out
    r = payload["per_seed"][0]
    assert r["pretrain"].keys() >= {"mAP_0.25", "mAR_0.25"}
    assert set(r["variants"]["default"]) >= {"student", "teacher"}
    work = tmp_path / "v" / "work_s0"
    assert (work / "saqe-votenet-scannet-pretrain-050_s0").is_dir()
