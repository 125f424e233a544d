"""The frozen plain reference held to the port on the CPU at a small
size, on the same seeded weights and inputs: the forward of both heads,
the semi step's readings, and the Detector's request path. And, on a
card (``gpu`` marker), the control at a size a test run holds: the
reference in TF32 fails a limit that the port in float32 keeps."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness import weights
from perfbench.harness.cell import load_spec
from perfbench.harness.kinds.semi_train import precision
from perfbench.harness.main import load_kind, window
from perfbench.reference import build
from perfbench.tests.tiny import cell_of, narrow, tiny, tiny_cell  # noqa: F401

WORKLOADS = [w["name"] for w in load_spec()["workloads"]]


@pytest.mark.parametrize("name", ["nesie-scannet", "saqe-scannet"])
@pytest.mark.parametrize("mode", ["seed", "vote"])
def test_forward_matches_the_port(narrow, name, mode):
    from nesie_tpu_torch.config import get_config
    from nesie_tpu_torch.train.runner import build_model

    cell = tiny(cell_of(name, "semi-4-8"))
    port = build_model(get_config(cell.cfg["port_configs"]["train"])).eval()
    spec = weights.spec(port.state_dict())
    w = weights.make_weights(spec, cell.gen("weights"))
    port.load_state_dict(w)
    ref = build.model(cell.cfg).eval()
    assert weights.spec(ref.state_dict()) == spec
    ref.load_state_dict(w)
    pts = torch.rand(2, 512, 4, generator=cell.gen("pts")) * 4.0
    with torch.no_grad():
        a, b = port(pts, mode), ref(pts, mode)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None
        else:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_matches_the_reference(narrow, workload):
    """Set-up, a short window and the comparison of every cell, cut to a
    tiny size: on the CPU the port runs the same plain code as the
    reference, so every number reads 0."""
    cell = tiny_cell(workload)
    kind = load_kind(cell.traffic["kind"])(cell)
    kind.setup()
    units, _ = window(kind, 0.2)
    assert units >= 1 and kind.outcome()[1] == 0
    kind.free()
    numbers = kind.numbers(kind.reference())
    assert all(numbers[k] == 0 for k in cell.limits["checks"]), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_a_limit(card, workload):
    """At the published widths on fewer points and scenes: the port's
    numbers keep every limit of the cell, the control (the reference with
    TF32 on) fails at least one."""
    from perfbench.harness.cell import Cell

    cell = Cell.load(workload, 5, card)
    t = cell.traffic
    cell.traffic = dict(t, **{"semi_train": dict(points=8192, batches=3),
                              "eval_batch": dict(batch=4, batches=1,
                                                 checked=1),
                              "serve_closed": dict(clouds=2, checked=2),
                              }[t["kind"]])
    kind = load_kind(t["kind"])(cell)
    kind.setup()
    window(kind, 0.5)
    kind.free()
    ref = kind.reference()
    limits = cell.limits["checks"]
    prog = kind.numbers(ref)
    ctl = kind.numbers_from(kind.reference(tf32=True), ref)
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_precision_switch_restores():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with precision(True):
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
