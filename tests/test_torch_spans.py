"""The port's spans and counts (``nesie_tpu_torch.utils``) and where the
program places them: tracing off records nothing; nesting, parents and
counts; the semi step's and a ``Detector`` request's phases; the NMS
fixpoint's ``host_sync`` count; the Chrome trace of ``utils.trace``;
the kernels' launch counts. ``host_sync`` counts the warnings of the
card's sync debug mode, which the CPU never gives: here a stand-in warns
as the card would, and the ``gpu`` test holds the count to the warnings
the card's debug mode gives outside tracing. This file imports no jax:
``python -m pytest --noconftest tests/test_torch_spans.py -m gpu`` runs on
the card's machine.
"""
import contextlib
import copy
import time
import warnings

import numpy as np
import pytest
import torch

from nesie_tpu_torch import utils
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.config import InferenceConfig
from nesie_tpu_torch.core.nms import greedy_keep_fixpoint
from nesie_tpu_torch.data.synthetic import make_scene, semi_batch
from nesie_tpu_torch.eval.postprocess import decode_and_nms
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_
from nesie_tpu_torch.ops import _build, fps_variants
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule

TINY = dict(reg_max=8, num_proposal=16, num_points=(64, 32, 16, 16),
            num_samples=(8, 8, 4, 4),
            sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                         (32, 32, 32)),
            fp_channels=((32, 32), (32, 32)))
SEMI_PHASES = ["semi.augment", "semi.teacher", "semi.pseudo_label",
               "semi.ulb_state", "semi.student", "semi.targets", "semi.loss",
               "train.backward", "train.update", "semi.ema"]
REQUEST_PHASES = ["detector.preprocess", "detector.to_device", "nn.forward",
                  "postprocess.decode_and_nms", "detector.fetch",
                  "detector.expand"]
SYNC = "called a synchronizing CUDA operation"  # the card's debug mode


@pytest.fixture
def traced():
    """Spans on and no records, for one test; off again after it."""
    utils.clear_spans()
    was = utils.set_tracing(True)
    yield
    utils.set_tracing(was)
    utils.clear_spans()


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent["index"]]


def test_tracing_off_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing off made a CUDA event or a range")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    utils.clear_spans()
    assert utils.set_tracing(False) is False
    a = utils.span("semi.step", step=3)
    b = utils.span("nn.forward", device=True, b=1)
    assert a is b and a is utils.span("x")
    with a as rec:
        with b:
            utils.count("host_sync")
    assert rec is None
    assert utils.span_records() == []


def test_nesting_parents_and_counts(traced):
    before = utils.counts("test.").get("test.c", 0)
    with utils.span("outer", request=7) as outer:
        utils.count("test.c")
        with utils.span("inner", device=True):
            utils.count("test.c", 2)
        utils.count("test.d")
        with utils.span("second"):
            pass
    with utils.span("after"):
        pass
    recs = utils.span_records()
    assert [r["name"] for r in recs] == ["outer", "inner", "second", "after"]
    assert [r["parent"] for r in recs] == [None, 0, 0, None]
    assert [r["index"] for r in recs] == [0, 1, 2, 3]
    assert recs[0]["attrs"] == {"request": 7} and outer["name"] == "outer"
    assert recs[0]["counts"] == {"test.c": 1, "test.d": 1}
    assert recs[1]["counts"] == {"test.c": 2}
    assert recs[2]["counts"] == {} and recs[3]["counts"] == {}
    assert utils.counts("test.")["test.c"] == before + 3
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        assert r["device_ms"] is None  # no card here
        assert "events" not in r
    assert recs[0]["start_ns"] <= recs[1]["start_ns"] <= recs[1]["end_ns"] \
        <= recs[2]["start_ns"] <= recs[0]["end_ns"] <= recs[3]["start_ns"]
    utils.clear_spans()
    assert utils.span_records() == []


def test_finished_records_leave_the_collector(traced):
    """A finished span is kept as plain values, which Python's collector
    stops tracking, so a long traced window adds no full collections."""
    import gc

    for i in range(50):
        with utils.span("unit", request=i):
            with utils.span("phase", b=2):
                pass
    with utils.span("open"):
        for _ in range(3):
            gc.collect()
        assert not any(gc.is_tracked(r) for r in utils._RECORDS[:-1])
    recs = utils.span_records()
    assert recs[0]["attrs"] == {"request": 0} and recs[1]["parent"] == 0
    assert len(recs) == 101 and recs[-1]["name"] == "open"


def test_counts_run_with_tracing_off():
    utils.set_tracing(False)
    utils.reset_counts("test.off")
    utils.count("test.off", 4)
    utils.count("test.off")
    assert utils.counts("test.off") == {"test.off": 5}
    utils.reset_counts("test.off")
    assert utils.counts("test.off") == {}


def _semi_setup(dev=torch.device("cpu")):
    model = VoteNetNesie(**TINY)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, make_lr_schedule(8e-3, 100),
                               device=dev)
    batch = semi_batch(np.random.default_rng(3), 1, 2, 1024, 8, 3, dev)
    return state, UlbState.create(4, 18, device=dev), batch


def test_semi_step_phases_and_same_result(traced):
    state, ulb, batch = _semi_setup()
    step = make_semi_train_step(1, 4)
    runs = []
    for on in (False, True):
        utils.set_tracing(on)
        s = copy.deepcopy(state)
        new_ulb, metrics = step(s, ulb, batch,
                                generator=torch.Generator().manual_seed(5),
                                teacher_generator=torch.Generator()
                                .manual_seed(6))
        runs.append((s, new_ulb, metrics))
    recs = utils.span_records()
    (off, ulb_off, m_off), (on, ulb_on, m_on) = runs
    assert torch.equal(m_off["loss"], m_on["loss"])
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for a, b in zip(off.model.parameters(), on.model.parameters()):
        assert torch.equal(a.grad, b.grad) and torch.equal(a, b)
    for a, b in zip(off.teacher.state_dict().values(),
                    on.teacher.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(ulb_off.ulb_list, ulb_on.ulb_list)
    assert torch.equal(ulb_off.ulb_flag, ulb_on.ulb_flag)

    steps = [r for r in recs if r["name"] == "semi.step"]
    assert len(steps) == 1 and steps[0]["parent"] is None
    assert steps[0]["attrs"] == {"step": 0}
    assert _children(recs, steps[0]) == SEMI_PHASES
    for phase in ("semi.teacher", "semi.student"):
        rec = next(r for r in recs if r["name"] == phase)
        assert _children(recs, rec) == ["nn.forward"]
    fwd = [r for r in recs if r["name"] == "nn.forward"]
    assert [r["attrs"] for r in fwd] == [dict(b=3, n=1024)] * 2


def test_detector_request_phases(traced):
    det = init_detector(device="cpu", cfg=InferenceConfig(num_points=1024),
                        **TINY)
    cloud = make_scene(np.random.default_rng(1), 1500)
    det(cloud)
    det(cloud)
    recs = utils.span_records()
    reqs = [r for r in recs if r["name"] == "detector.request"]
    assert [r["attrs"] for r in reqs] == [{"request": 1}, {"request": 2}]
    assert all(r["parent"] is None for r in reqs)
    for req in reqs:
        assert _children(recs, req) == REQUEST_PHASES
    # nothing waits for a card on the CPU
    assert not any("host_sync" in r["counts"] for r in recs)


def test_sync_warnings_count_as_host_sync(traced, monkeypatch):
    """With tracing on, each sync warning counts ``host_sync`` on the
    innermost span and is not shown; other warnings are shown as before;
    tracing off puts the filters and ``showwarning`` back."""
    shown = []
    utils.set_tracing(False)
    filters = list(warnings.filters)
    monkeypatch.setattr(warnings, "showwarning",
                        lambda msg, *a, **k: shown.append(str(msg)))
    utils.set_tracing(True)
    before = utils.counts("host_sync").get("host_sync", 0)
    with utils.span("outer"):
        warnings.warn(SYNC)
        with utils.span("inner"):
            warnings.warn(SYNC)
            warnings.warn(SYNC)  # every one, not once a line
            warnings.warn("something else")
    recs = utils.span_records()
    assert [r["counts"] for r in recs] == [{"host_sync": 1},
                                           {"host_sync": 2}]
    assert utils.counts("host_sync")["host_sync"] == before + 3
    assert shown == ["something else"]
    utils.set_tracing(False)
    assert warnings.filters == filters and warnings.showwarning is not \
        utils._show_warning


def _card_syncs(monkeypatch):
    """Warn at each ``bool()`` of a tensor, as the card's sync debug
    mode does at each ``bool()`` of a device tensor."""
    as_bool = torch.Tensor.__bool__

    def warned(self):
        warnings.warn(SYNC)
        return as_bool(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", warned)


@pytest.mark.parametrize("sup,valid,keep,tests", [
    # 0 suppresses 1, 1 would suppress 2: kept 0 then 2, three updates
    ([[0, 1, 0], [0, 0, 1], [0, 0, 0]], [1, 1, 1], [1, 0, 1], 4),
    # nothing suppresses: one update, then the test that it is still
    ([[0, 0], [0, 0]], [1, 1], [1, 1], 2),
    ([], [], [], 0),
])
def test_host_sync_counts_the_fixpoint_tests(sup, valid, keep, tests,
                                             traced, monkeypatch):
    n = len(valid)
    sup = torch.tensor(sup, dtype=torch.bool).reshape(n, n)
    scores = torch.arange(n, 0, -1, dtype=torch.float32)
    valid = torch.tensor(valid, dtype=bool)
    _card_syncs(monkeypatch)
    with utils.span("nms"):
        got = greedy_keep_fixpoint(sup, scores, valid)
    monkeypatch.undo()
    assert got.tolist() == [bool(k) for k in keep]
    assert utils.span_records()[0]["counts"].get("host_sync", 0) == tests


def test_trace_writes_the_spans(tmp_path):
    utils.set_tracing(False)
    with utils.trace("semi", tmp_path):
        with utils.span("semi.step", step=0):
            with utils.span("semi.teacher", device=True):
                torch.ones(4, 4) @ torch.ones(4, 4)
    assert utils.set_tracing(False) is False  # restored after the block
    text = (tmp_path / "semi.trace.json").read_text()
    assert '"semi.teacher"' in text and '"semi.step"' in text
    utils.clear_spans()


def test_launch_counts_read_as_before(monkeypatch):
    class Lib:
        def nesie_three_nn(self, *args):
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    _build.reset_launch_counts()
    fps_variants.reset_launch_counts()
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    _build.launch("three_nn", "nesie_three_nn", device=torch.device("cpu"))
    _build.launch("three_nn", "nesie_three_nn", device=torch.device("cpu"))
    assert _build.launch_counts() == dict(
        dict.fromkeys(_build.KERNELS, 0), three_nn=2)
    assert utils.counts("launch.") == {"launch.three_nn": 2}
    utils.count("fps_variant.v2_merged")
    _build.reset_launch_counts()
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    assert fps_variants.launch_counts() == dict(
        dict.fromkeys(fps_variants.VARIANTS, 0), v2_merged=1)
    fps_variants.reset_launch_counts()
    assert not any(fps_variants.launch_counts().values())


def _syncs_seen(fn) -> int:
    """Syncs that the card's debug mode reports over ``fn()``, tracing
    off (torch's own warnings, such as the one that setting the mode
    gives, are not syncs)."""
    torch.cuda.synchronize()
    utils.set_tracing(False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC in str(w.message) for w in caught)


def _syncs_counted(fn) -> tuple[int, int]:
    """(``host_sync`` counted over ``fn()`` with tracing on, the part of
    it that landed in spans)."""
    torch.cuda.synchronize()
    utils.clear_spans()
    utils.set_tracing(True)
    try:
        before = utils.counts("host_sync").get("host_sync", 0)
        fn()
        counted = utils.counts("host_sync")["host_sync"] - before
    finally:
        utils.set_tracing(False)
    recs = utils.span_records()
    utils.clear_spans()
    return counted, sum(r["counts"].get("host_sync", 0) for r in recs)


@pytest.mark.gpu
def test_host_sync_matches_the_cards_syncs():
    """``host_sync`` over a request, a B=2 decode and a semi step equals
    the syncs the card's debug mode reports on the same work with tracing
    off, and each lands in the work's spans; a request (replayed graphs)
    makes exactly five."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    dev = torch.device("cuda")
    det = init_detector(device=dev, head="saqe")
    cloud = make_scene(np.random.default_rng(1), 50000)
    det(cloud)  # builds the kernels

    def request():
        det.generator.manual_seed(0)
        det(cloud)

    seen = _syncs_seen(request)
    # a replayed request waits only for the copy in and the four copies out
    assert _syncs_counted(request) == (seen, seen) and seen == 5
    model = VoteNetNesie()
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    pts = torch.from_numpy(np.stack([
        make_scene(np.random.default_rng(i), 40000) for i in (2, 3)]))
    pts = torch.cat([pts, pts[..., 2:3]], -1).to(dev)
    with torch.inference_mode():
        out = model(pts, "seed")
        seen = _syncs_seen(lambda: decode_and_nms(out, pts))
        assert _syncs_counted(lambda: decode_and_nms(out, pts)) == (seen,
                                                                     seen)
    # the decode's kernels make the host wait for nothing
    assert seen == 0
    # and a semi step (a narrow model) on copies of one state
    state, ulb, batch = _semi_setup(dev)
    states = [copy.deepcopy(state) for _ in range(3)]
    step = make_semi_train_step(1, 4)

    def semi():
        step(states.pop(), ulb, batch,
             generator=torch.Generator(dev).manual_seed(5))

    semi()
    seen = _syncs_seen(semi)
    assert _syncs_counted(semi) == (seen, seen) and seen >= 10


def test_profile_timeline_names_the_innermost_span():
    """The profiling tools' timeline on the CPU: no device work, so the
    whole window between the first span's start and the last one's end
    is one idle gap, put under the span open at its middle."""
    from torch.profiler import ProfilerActivity, profile

    from nesie_tpu_torch.tools.profile_train_step import timeline

    with utils.trace("timeline"), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with utils.span("semi.step"):
            with utils.span("semi.teacher"):
                time.sleep(0.02)
    utils.clear_spans()
    tl = timeline(prof)
    assert tl["busy_ms"] == 0.0 and tl["window_ms"] >= 20.0
    assert list(tl["idle_ms"]) == ["semi.teacher"]
    assert tl["idle_ms"]["semi.teacher"] == pytest.approx(tl["window_ms"])


def test_runner_logs_wall_seconds_between_logged_steps(monkeypatch):
    """The runner's s/it: the wall time between two logged steps (each
    read after the logging step's wait for the card) over the steps
    between them, not the time to enqueue one step."""
    from nesie_tpu_torch.train import runner

    now = iter([100.0, 103.0, 103.5, 109.5])
    monkeypatch.setattr(runner.time, "perf_counter", lambda: next(now))
    clock = runner._StepClock(step=10)      # the loop starts at 100 s
    assert clock.per_step(12) == 1.5         # steps 11, 12 by 103 s
    assert clock.per_step(13) == 0.5
    assert clock.per_step(16) == 2.0         # three steps in 6 s
