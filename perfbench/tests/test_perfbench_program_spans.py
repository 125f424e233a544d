"""The readers of the program's own spans (``metrics/_program.py`` and the
six metrics on it) on synthetic span records: only the first ``units``
unit spans are read, device ms are summed a unit, counts are summed over
a unit's spans, and nothing is read where there is no unit."""
from __future__ import annotations

import pytest

from perfbench.harness import main as hm
from perfbench.harness.cell import BENCH


class Trace:
    """Span records as ``nesie_tpu_torch.utils.span_records`` gives them."""

    def __init__(self):
        self.recs: list = []

    def add(self, name, parent=None, device_ms=None, **counts):
        self.recs.append(dict(index=len(self.recs), name=name, parent=parent,
                              attrs={}, counts=counts, start_ns=0, end_ns=0,
                              device_ms=device_ms))
        return len(self.recs) - 1


def train_trace(steps):
    """(teacher ms, update ms, ema ms) a step."""
    t = Trace()
    for teacher, update, ema in steps:
        s = t.add("semi.step")
        t.add("semi.augment", s)
        te = t.add("semi.teacher", s, teacher)
        t.add("nn.forward", te, teacher - 1.0)
        t.add("semi.pseudo_label", s, host_sync=3)
        st = t.add("semi.student", s, 50.0)
        t.add("nn.forward", st, 49.0)
        t.add("train.backward", s, 80.0)
        t.add("train.update", s, update)
        t.add("semi.ema", s, ema)
    return t.recs


def eval_trace(batches):
    """(forward ms, NMS loop tests) a batch."""
    t = Trace()
    for fwd, tests in batches:
        f = t.add("nn.forward", None, fwd)
        t.add("pointops.fps", f, 2.0)
        t.add("postprocess.decode_and_nms", None, 70.0, host_sync=tests)
    return t.recs


def serve_trace(requests):
    """(forward ms, NMS loop tests) a request."""
    t = Trace()
    for fwd, tests in requests:
        r = t.add("detector.request")
        t.add("detector.preprocess", r)
        t.add("detector.to_device", r, host_sync=1)
        f = t.add("nn.forward", r, fwd)
        t.add("pointops.fps", f, 1.9)
        t.add("postprocess.decode_and_nms", r, 3.0, host_sync=tests)
        t.add("detector.fetch", r, host_sync=4)
        t.add("detector.expand", r)
    return t.recs


STEPS = [(30.0, 12.0, 3.0), (32.0, 14.0, 5.0), (999.0, 999.0, 999.0)]
BATCHES = [(60.0, 64), (64.0, 70), (999.0, 999)]
REQUESTS = [(4.0, 2), (6.0, 4), (999.0, 999)]
CASES = [
    ("teacher_ms.train", train_trace(STEPS), 31.0),
    ("update_ms.train", train_trace(STEPS), (12 + 3 + 14 + 5) / 2),
    ("forward_ms.eval", eval_trace(BATCHES), 62.0),
    ("host_syncs.eval", eval_trace(BATCHES), 67.0),
    ("forward_ms.serve", serve_trace(REQUESTS), 5.0),
    ("host_syncs.serve", serve_trace(REQUESTS), (1 + 2 + 4 + 1 + 4 + 4) / 2),
]


@pytest.fixture
def program(monkeypatch):
    """Serve ``records`` as the program's span records; tracing off again
    after the test (a reader turns it on when it is loaded)."""
    from nesie_tpu_torch import utils

    held = {"records": []}
    monkeypatch.setattr(utils, "span_records", lambda: held["records"])
    was = utils.set_tracing(False)
    yield held
    utils.set_tracing(was)


@pytest.mark.parametrize("name,recs,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reads_the_first_units(program, name, recs, want):
    from nesie_tpu_torch import utils

    reader = hm.load_metric(BENCH, name)
    assert reader.SOURCE == "program_span"
    assert utils.set_tracing(True) is True  # loading turned spans on
    program["records"] = recs
    assert reader.read(dict(units=2)) == pytest.approx(want)


@pytest.mark.parametrize("name,recs,want", CASES,
                         ids=[c[0] for c in CASES])
def test_nothing_to_read(program, name, recs, want):
    reader = hm.load_metric(BENCH, name)
    program["records"] = []
    assert reader.read(dict(units=2)) is None
    program["records"] = recs
    assert reader.read(dict(units=0)) is None
    # spans of another unit only: an eval trace holds no request
    program["records"] = (serve_trace(REQUESTS) if name.endswith(".train")
                          else train_trace(STEPS))
    assert reader.read(dict(units=2)) is None


def test_device_ms_summed_a_unit(program):
    reader = hm.load_metric(BENCH, "update_ms.train")
    program["records"] = train_trace([(1.0, 2.0, 0.5), (1.0, 4.0, 1.5)])
    assert reader.read(dict(units=5)) == pytest.approx((2.5 + 5.5) / 2)
    # a device span with no device time (no card) reads nothing
    recs = train_trace([(1.0, 2.0, 0.5)])
    recs[-1]["device_ms"] = None
    program["records"] = recs
    assert reader.read(dict(units=1)) is None


def test_a_program_without_spans(monkeypatch):
    """On a checkout whose port records no spans, loading and reading a
    metric raise nothing and read nothing."""
    import nesie_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "set_tracing")
    monkeypatch.delattr(utils, "span_records")
    reader = hm.load_metric(BENCH, "forward_ms.serve")
    assert reader.read(dict(units=3)) is None
