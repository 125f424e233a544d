"""The harness's own arithmetic and contracts, on the CPU: what it
imports, the idle share, the tail, finding files by name, the result
line, and that a broken program comes out as not correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.harness import main as hm
from perfbench.harness import trace
from perfbench.harness.cell import BENCH, ROOT, Cell, load_spec
from perfbench.tests.tiny import narrow, tiny_cell  # noqa: F401

WORKLOADS = [w["name"] for w in load_spec()["workloads"]]


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=1200).stdout


def test_no_jax_in_any_cell():
    """Every module the harness loads for a cell (its kind, metric
    readers, counts, the reference and the port), driven through a tiny
    traced run of every cell, has a top-level name other than jax, jaxlib, flax
    and nesie_tpu, compared whole."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from perfbench.harness import main as hm
from perfbench.harness.cell import load_spec
from perfbench.tests.tiny import narrow_port, tiny_cell
narrow_port()
spec = load_spec()
for w in {WORKLOADS!r}:  # a traced run loads what an untraced one does
    hm.measure(tiny_cell(w), spec, 0.05, True, lambda: 0.0,
               log=lambda s: None)
print(json.dumps([hm.forbidden_modules(),
                  "nesie_tpu_torch" in sys.modules]))
"""
    found, port = json.loads(_run(code).strip().splitlines()[-1])
    assert found == []
    assert port  # the comparison is whole: the port's name passes


def test_reference_imports_nothing_of_the_port():
    code = f"""
import sys, json, pkgutil, importlib
sys.path.insert(0, {str(ROOT)!r})
import perfbench.reference as r
for m in pkgutil.walk_packages(r.__path__, "perfbench.reference."):
    importlib.import_module(m.name)
import perfbench.counts.flops
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("nesie_tpu_torch", "nesie_tpu",
                                               "jax", "jaxlib", "flax"))))
"""
    assert json.loads(_run(code).strip().splitlines()[-1]) == []


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nesie_tpu_torch_like", sys)
    assert hm.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nesie_tpu.ops", sys)
    assert hm.forbidden_modules() == ["nesie_tpu.ops"]


def test_idle_share_is_a_union_of_intervals():
    # two streams overlapping on [2, 3]; a host op covers the gap [4, 6]
    dev = [("gemm", 1.0, 3.0), ("bn", 2.0, 4.0), ("fps", 6.0, 7.0),
           ("copy", 6.5, 6.8)]
    host = [("perfbench.step", 0.0, 10.0), ("aten::item", 4.0, 6.0)]
    t = trace.reduce_timeline(dev, host, (0.0, 8.0))
    assert t["busy_s"] == pytest.approx(4.0)  # [1, 4] and [6, 7]
    assert t["window_s"] == pytest.approx(8.0)
    assert dict(t["device_ops"]) == pytest.approx(
        {"gemm": 2.0, "bn": 2.0, "fps": 1.0, "copy": 0.3})
    # gaps [0, 1] and [7, 8] under the step, [4, 6] under aten::item
    assert dict(t["idle_gaps"]) == pytest.approx(
        {"aten::item": 2.0, "perfbench.step": 2.0})
    ctx = dict(timeline=t)
    idle = hm.load_metric(BENCH, "idle_share.train").read(ctx)
    assert idle == pytest.approx(50.0)
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == \
        pytest.approx(3.0)


def test_p95_over_all_requests():
    from perfbench.harness.kinds.serve_closed import Kind

    kind = Kind(tiny_cell("saqe-scannet.serve"))
    lat = list(np.random.default_rng(0).exponential(20.0, 997))
    kind.latencies = lat
    got = kind.window_metrics(len(lat), 10.0)["request_p95_ms"]
    assert got == pytest.approx(np.percentile(lat, 95))
    assert got == max(np.sort(lat)[:int(0.95 * 996) + 1]) or got <= max(lat)


def test_new_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix and metric are found by name from
    files of their own, with no edit to an existing file."""
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "reference", "tests"))
    spec = load_spec()
    cfg = json.loads((bench / "configs" / "nesie-scannet.json").read_text())
    (bench / "configs" / "nesie-new.json").write_text(json.dumps(
        dict(cfg, name="nesie-new")))
    (bench / "traffic" / "eval-b8.json").write_text(json.dumps(dict(
        kind="eval_batch", batch=8, points=40000, objects=[6, 12],
        batches=2, checked=2)))
    (bench / "limits" / "nesie-new.eval-b8.json").write_text(
        (bench / "limits" / "nesie-scannet.eval-b32.json").read_text())
    (bench / "metrics" / "answer.eval.py").write_text(
        "SOURCE = 'program_span'\ndef read(ctx):\n    return 42.0\n")
    spec["configs"].append(dict(name="nesie-new", source="x",
                                file="perfbench/configs/nesie-new.json",
                                reduced=[]))
    spec["workloads"].append(dict(name="nesie-new.eval-b8",
                                  config="nesie-new", traffic="eval-b8",
                                  chips=1, why="x"))
    for m in spec["end_to_end"]:
        if m["name"] == "eval_scenes_per_s":
            m["workloads"].append("nesie-new.eval-b8")
    spec["per_layer"].append(dict(name="answer.eval", unit="ms",
                                  better="lower", source="program_span",
                                  layer="x", moves="eval_scenes_per_s",
                                  workloads=["nesie-new.eval-b8"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Cell.load("nesie-new.eval-b8", 1, "cpu", tmp_path)
    assert cell.traffic["batch"] == 8 and cell.cfg["name"] == "nesie-new"
    wanted = [m["name"] for m in hm.cell_metrics(spec, cell.name, True)]
    assert wanted == ["answer.eval"]
    assert hm.load_metric(bench, "answer.eval").read({}) == 42.0
    assert [m["name"] for m in hm.cell_metrics(spec, cell.name, False)] \
        == ["eval_scenes_per_s", "setup_s"]


def test_result_line_keys():
    res = dict(correct=True, attempted=3, failed=0,
               metrics={"setup_s": dict(value=1.0, unit="s")},
               checks={"loss_gap": dict(value=0.0, limit=1e-4)},
               busy_s=1.0, window_s=2.0,
               breakdown=dict(device_ops=[], idle_gaps=[]))
    dev = dict(platform="gpu", kind="card", count=1, memory_peak_bytes=1)
    assert list(hm.result_line(res, dev, False)) == [
        "correct", "attempted", "failed", "metrics", "device", "checks"]
    line = hm.result_line(res, dev, True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.0 and \
        line["device"]["window_s"] == 2.0
    assert set(line) - {"checks"} <= {"correct", "attempted", "failed",
                                      "metrics", "device", "breakdown"}


def test_the_spec_keeps_to_the_contract():
    spec = load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = hm.cell_metrics(spec, w["name"], True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer and {m["moves"] for m in layer} <= {m["name"]
                                                         for m in e2e}
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for m in spec["per_layer"]:
        assert m["moves"] in names
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


# ---------------------------------------------------------------- faults
def _patch_semi_half(monkeypatch):
    """The step leaves out half of the labeled and of the unlabeled rows
    and takes its means over the rest."""
    import nesie_tpu_torch.train.semi as semi

    make = semi.make_semi_train_step

    def half_maker(n_labeled, *a, **kw):
        step = make(n_labeled // 2, *a, **kw)

        def half(state, ulb, batch, noise=None, **k):
            b = batch["points_raw_s"].shape[0]
            rows = torch.tensor(list(range(n_labeled // 2)) + list(range(
                n_labeled, n_labeled + (b - n_labeled) // 2)))
            sub = {key: (type(v)(*(f[rows] for f in v))
                         if isinstance(v, tuple) else v[rows])
                   for key, v in batch.items()}
            return step(state, ulb, sub, noise=tuple(x[rows] for x in noise),
                        **k)
        return half

    monkeypatch.setattr(semi, "make_semi_train_step", half_maker)


def _patch_semi_unchanged(monkeypatch):
    """The step returns its state unchanged."""
    import nesie_tpu_torch.train.semi as semi

    monkeypatch.setattr(semi, "apply_gradients",
                        lambda state, loss: torch.zeros(()))
    monkeypatch.setattr(semi, "ema_update", lambda *a, **k: 0.0)
    monkeypatch.setattr(semi, "update_ulb_state", lambda ulb, *a: ulb)


def _patch_semi_teacher(monkeypatch):
    """The step leaves the EMA teacher unchanged."""
    import nesie_tpu_torch.train.semi as semi

    monkeypatch.setattr(semi, "ema_update", lambda *a, **k: 0.0)


def _patch_semi_momentum(monkeypatch):
    """The EMA teacher moves with twice its momentum."""
    import nesie_tpu_torch.train.semi as semi

    ema = semi.ema_update
    monkeypatch.setattr(semi, "ema_update", lambda state, m, *a, **k:
                        ema(state, 2 * m, *a, **k))


def _patch_semi_ulb(monkeypatch):
    """The step leaves the unlabeled scans' state unchanged."""
    import nesie_tpu_torch.train.semi as semi

    monkeypatch.setattr(semi, "update_ulb_state", lambda ulb, *a: ulb)


def _patch_semi_loss(monkeypatch):
    """The loss altered where the step produces it."""
    import nesie_tpu_torch.train.semi as semi

    sup = semi.nesie_supervised_loss

    def altered(*a, **kw):
        total, terms = sup(*a, **kw)
        return total * 1.01, terms
    monkeypatch.setattr(semi, "nesie_supervised_loss", altered)


def _patch_eval_half(monkeypatch):
    """The forward leaves out half of the batch."""
    from nesie_tpu_torch.nn.detector import VoteNetNesie

    fwd = VoteNetNesie.forward
    monkeypatch.setattr(VoteNetNesie, "forward", lambda self, pts, *a, **k:
                        fwd(self, pts[:max(1, pts.shape[0] // 2)], *a, **k))


def _patch_decode(monkeypatch, module):
    """One answer altered where decode_and_nms produces it."""
    import nesie_tpu_torch.eval.postprocess as post

    dec = post.decode_and_nms

    def altered(*a, **kw):
        out = dec(*a, **kw)
        out["bbox"] = out["bbox"].clone()
        out["bbox"][0, 0, 0] += 0.05
        out["obj_scores"] = out["obj_scores"].clone()
        out["obj_scores"][0, 0] += 0.01
        return out
    monkeypatch.setattr(module, "decode_and_nms", altered)


def _eval_decode(monkeypatch):
    import nesie_tpu_torch.eval.postprocess as post
    _patch_decode(monkeypatch, post)


def _serve_decode(monkeypatch):
    import nesie_tpu_torch.apis as apis
    _patch_decode(monkeypatch, apis)


FAULTS = [
    ("nesie-scannet.semi-train", _patch_semi_unchanged),
    ("nesie-scannet.semi-train", _patch_semi_teacher),
    ("nesie-scannet.semi-train", _patch_semi_momentum),
    ("nesie-scannet.semi-train", _patch_semi_ulb),
    ("nesie-scannet.semi-train", _patch_semi_half),
    ("nesie-scannet.semi-train", _patch_semi_loss),
    ("nesie-scannet.eval-b32", _patch_eval_half),
    ("nesie-scannet.eval-b32", _eval_decode),
    ("saqe-scannet.serve", _serve_decode),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}"
                              for w, f in FAULTS])
def test_a_broken_program_is_not_correct(monkeypatch, narrow, workload,
                                         fault):
    """The rest of a run (set-up, window, reference, comparison, with the
    look for a card skipped) on a tiny cell sees ``correct`` false when
    the timed path is broken underneath; and true when it is not."""
    spec = load_spec()
    res = hm.measure(tiny_cell(workload), spec, 0.2, False, lambda: 0.0,
                     log=lambda s: None)
    assert res["correct"], res["checks"]
    fault(monkeypatch)
    res = hm.measure(tiny_cell(workload), spec, 0.2, False, lambda: 0.0,
                     log=lambda s: None)
    assert not res["correct"], res["checks"]
