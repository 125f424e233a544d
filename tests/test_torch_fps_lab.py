"""The port's FPS lab (``ops/fps_variants.py``, ``tools/fps_lab.py``,
``tools/fps_experiments.py``) against the JAX lab on the CPU.

The JAX lab's step bodies (``tools/fps_lab.py``, ``tools/fps_experiments.py``)
run in Pallas interpret mode on numpy-seeded clouds, a random one and a
tie-heavy one (40 distinct points tiled to N); each must give indices
identical to its variant's plain version in the port and to ``fps_ref``.
The JAX tools are loaded from their files, unchanged. The host side of
the kernels' launches is checked too: each variant's plan against the
shipped FPS's (``fps_onchip_plan`` faked, since it needs the card), and
``fps_experiments``' ``v0`` against the dispatch.
"""
import importlib.util
import inspect
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nesie_tpu_torch.ops import fps_variants, pointops
from nesie_tpu_torch.ops.fps import fps_ref
from nesie_tpu_torch.ops.fps_variants import (
    EXPERIMENT_VARIANTS,
    LAB_VARIANTS,
    VARIANTS,
    fps_variant_cuda,
    fps_variant_plan,
    fps_variant_ref,
)
from nesie_tpu_torch.tools import fps_experiments
from nesie_tpu_torch.tools.fps_lab import CHECK_SHAPE, check_clouds

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
K6_SHAPE = dict(batch=4, n=256, m=16, rows=2)


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_lab():
    return _load("tools/fps_lab.py")


@pytest.fixture(scope="module")
def jax_exp():
    return _load("tools/fps_experiments.py")


def _k6_variant(ex, name):
    rows, n, m = K6_SHAPE["rows"], K6_SHAPE["n"], K6_SHAPE["m"]
    if name in ("v4", "v5"):
        return ex.make_stacked_variant(rows, n, m, ex._tie_bitcast,
                                       unroll=4 if name == "v5" else 1,
                                       interpret=True)
    kernel = ex._kernel_v3 if name == "v3" else ex._kernel_v12
    tie = ex._tie_argmax_sum if name == "v1" else ex._tie_bitcast
    return ex.make_variant(kernel, tie, rows, n, m, interpret=True)


def _assert_all_agree(jax_out, pts, m, name):
    got = torch.from_numpy(np.array(jax_out))
    plain = fps_variant_ref(pts, m, name)
    assert torch.equal(plain, fps_ref(pts, m))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("cloud", ["rand", "dup"])
@pytest.mark.parametrize("name", list(LAB_VARIANTS))
def test_lab_variant_matches_jax(jax_lab, name, cloud):
    b, n, m = CHECK_SHAPE
    pts = check_clouds(b, n)[cloud]
    out = jax_lab.VARIANTS[name](jnp.asarray(pts.numpy()), m, interpret=True)
    _assert_all_agree(out, pts, m, name)


@pytest.mark.parametrize("cloud", ["rand", "dup"])
@pytest.mark.parametrize("name", list(EXPERIMENT_VARIANTS))
def test_experiment_variant_matches_jax(jax_exp, name, cloud):
    b, n = K6_SHAPE["batch"], K6_SHAPE["n"]
    if cloud == "rand":
        rng = np.random.default_rng(0)
        pts = torch.from_numpy(
            rng.normal(size=(b, n, 3)).astype(np.float32) * 3.0)
    else:
        pts = check_clouds(b, n)["dup"]
    out = _k6_variant(jax_exp, name)(jnp.asarray(pts.numpy()))
    _assert_all_agree(out, pts, K6_SHAPE["m"], name)


def test_tables_name_the_jax_variants(jax_lab, jax_exp):
    """A variant dropped from either side fails; each entry points at the
    TPU step body it replaces."""
    assert set(LAB_VARIANTS) == set(jax_lab.VARIANTS)
    names = set(re.findall(r'"(v\d+|xla)":', inspect.getsource(jax_exp.main)))
    assert set(EXPERIMENT_VARIANTS) == names - {"xla", "v0"}
    for variant in VARIANTS.values():
        path, lines = variant.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(lines.split(",")[0]) - 1].startswith("def _")
    assert [v.rows for v in VARIANTS.values()].count(2) == 1  # v3 alone


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_kernel_refuses_cpu_tensor(name):
    """The wrapper never runs the plain version in the kernel's place."""
    pts = check_clouds(1, 64)["rand"]
    with pytest.raises(ValueError, match="CUDA"):
        fps_variant_cuda(pts, 8, name)


@pytest.mark.parametrize("argv", [
    ["nesie_tpu_torch.tools.fps_lab", "check", "--device", "cpu"],
    ["nesie_tpu_torch.tools.fps_experiments", "--device", "cpu", "--batch",
     "4", "--n", "256", "--m", "16", "--iters", "1"],
])
def test_lab_entry_points_on_cpu(argv):
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MISMATCH" not in proc.stdout and "=False" not in proc.stdout


def test_lab_entry_points_need_the_card_by_default():
    """Without ``--device cpu`` the lab runs on the card or fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "nesie_tpu_torch.tools.fps_lab", "bench"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def _fake_onchip_plan(calls, ppt):
    """A stand-in for ``fps_onchip_plan`` (which needs the card): records
    its arguments and answers a plan with ``ppt`` points a thread."""
    def plan(batch, n):
        calls.append((batch, n))
        return dict(cluster=batch % 7 + 1, threads=128, points_per_thread=ppt,
                    smem_bytes=4096, scratch=False, resident_clusters=33,
                    exchange="mailbox")
    return plan


@pytest.mark.parametrize("b,n", [(8, 40000), (32, 40000), (3, 600)])
@pytest.mark.parametrize("name", [v for v in VARIANTS if v != "v3"])
def test_variant_plan_is_the_shipped_plan(monkeypatch, name, b, n):
    """A one-row variant launches with the shipped FPS's plan itself."""
    calls = []
    fake = _fake_onchip_plan(calls, 48)
    monkeypatch.setattr(fps_variants, "fps_onchip_plan", fake)
    assert fps_variant_plan(name, b, n) == fake(b, n)
    assert calls == [(b, n), (b, n)]


@pytest.mark.parametrize("b,ppt,per_row", [
    (8, 40, 20), (32, 64, 32), (7, 24, 12), (3, 12, 8), (1, 8, 4),
    (1, 20, 12), (2, 4, 4)])
def test_two_row_plan_counts_both_rows(monkeypatch, b, ppt, per_row):
    """v3 takes the shipped plan of ceil(B / 2) rows of 2N points, with half
    its points a thread (up to a multiple of 4) for each row."""
    calls = []
    monkeypatch.setattr(fps_variants, "fps_onchip_plan",
                        _fake_onchip_plan(calls, ppt))
    plan = fps_variant_plan("v3", b, 40000)
    assert calls == [(-(-b // 2), 80000)]
    assert plan == dict(cluster=-(-b // 2) % 7 + 1, threads=128,
                        points_per_thread=per_row, resident_clusters=33,
                        exchange="mailbox", rows=2)
    assert 2 * per_row >= ppt and per_row % 4 == 0


def test_experiments_v0_is_the_shipped_fps(monkeypatch):
    """``v0`` of ``fps_experiments`` is the dispatch, as in the JAX tool,
    and ``exact_vs_v0`` is held against it."""
    assert fps_experiments.furthest_point_sample is \
        pointops.furthest_point_sample
    calls = []

    def dispatch(xyz, m):
        calls.append(tuple(xyz.shape))
        return pointops.furthest_point_sample(xyz, m)

    monkeypatch.setattr(fps_experiments, "furthest_point_sample", dispatch)
    res = fps_experiments.run(batch=2, n=64, m=8, iters=1,
                              variants=["v0", "v2"], device="cpu")
    assert calls and set(calls) == {(2, 64, 3)}
    assert res["v0"]["exact_vs_xla"] and res["v2"]["exact_vs_v0"]
