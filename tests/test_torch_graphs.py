"""The ``Detector``'s CUDA graphs (``nesie_tpu_torch.graphs``) and what
makes the B=1 path capturable: the model's constants cached on the device
(equal to the expressions they replace, and in no ``state_dict``), the
Detector's choice between replay and the eager path and its counts, and,
on the card (``gpu``), replayed requests against eager ones: the same
answers bit for bit, the same launches and FPS spans, one ``nn.forward``
span with device time. The eager reference is the steps the Detector ran
before it had graphs, which every caller of the model still runs. This
file imports no jax: ``python -m pytest --noconftest
tests/test_torch_graphs.py -m gpu`` runs on the card's machine.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from nesie_tpu_torch import apis, utils
from nesie_tpu_torch.apis import eager_reason, init_detector
from nesie_tpu_torch.config import InferenceConfig
from nesie_tpu_torch.core.boxes import rotate_points_z
from nesie_tpu_torch.data import io
from nesie_tpu_torch.data.synthetic import make_scene
from nesie_tpu_torch.eval.postprocess import decode_and_nms, expand_per_class
from nesie_tpu_torch.nn.detector import VoteNetNesie
from nesie_tpu_torch.nn.layers import device_constant
from nesie_tpu_torch.nn.nesie_head import side2box
from nesie_tpu_torch.nn.quality_estimation import (
    _KEEP_AXIS,
    keep_axis_mask,
    make_saqe_side_grids,
)
from nesie_tpu_torch.nn.side_pooling import (
    _face_indices,
    face_indices,
    make_box_grids,
)
from nesie_tpu_torch.ops import _build, pointops

TINY = dict(reg_max=8, num_proposal=16, num_points=(64, 32, 16, 16),
            num_samples=(8, 8, 4, 4),
            sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                         (32, 32, 32)),
            fp_channels=((32, 32), (32, 32)))
# sorted state_dict keys of the two heads' flagship models: count, sha256
STATE_KEYS = {
    "saqe": (316, "de5fda37120d01aae5c11983eb6bc64e40b139af285737ab0fe8b29"
                  "54514b38f"),
    "nesie": (374, "57336c7efb1928a5ffcd8851166b0a554cf546385a2e1211a1e698"
                   "d251455943"),
}
ANSWER = ("boxes_3d", "scores_3d", "labels_3d")


def eager_answer(det, cloud):
    """The steps of a request without graphs: (the decode's arrays before
    the per-class expansion, the answer)."""
    pts = io.add_height(np.asarray(cloud, np.float32)[:, :3])
    pts = io.sample_points(pts, det.cfg.num_points,
                           np.random.default_rng(det.cfg.seed))[None]
    pts = torch.from_numpy(np.ascontiguousarray(pts)).to(det.device)
    with torch.inference_mode():
        out = det.model(pts, det.cfg.sample_mod, with_jitter=False,
                        generator=det.generator)
        dec = decode_and_nms(out, pts, nms_thr=det.cfg.nms_thr,
                             score_thr=det.cfg.score_thr,
                             use_iou_for_nms=det.cfg.use_iou_for_nms)
    dec = {k: v[0].cpu().numpy() for k, v in dec.items()}
    boxes, scores, labels = expand_per_class(dec)
    return dec, dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels)


def _old_side2box_scale(sizes, like):
    return torch.tensor(list(sizes) + list(sizes), dtype=torch.float32,
                        device=like.device).expand_as(like)


def _old_keep_mask(dtype, device):
    mask = torch.zeros((6, 1, 3), dtype=dtype, device=device)
    mask[torch.arange(6), 0, torch.tensor(_KEEP_AXIS)] = 1.0
    return mask


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("g", [3, 4])
def test_face_indices_equal_the_numpy_ones(g):
    want = torch.from_numpy(_face_indices(g))
    got = face_indices(g, torch.device("cpu"))
    assert _equal(got, want) and got is face_indices(g, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_keep_axis_mask_equals_the_expression(dtype):
    assert _equal(keep_axis_mask(dtype, torch.device("cpu")),
                  _old_keep_mask(dtype, "cpu"))


@pytest.mark.parametrize("sizes", [(3.0, 3.0, 2.5), (1, 2, 3)])
def test_side2box_scale_equals_the_expression(sizes):
    g = torch.Generator().manual_seed(0)
    pts = torch.randn((2, 5, 3), generator=g)
    off = torch.rand((2, 5, 6), generator=g)
    heading = torch.randn((2, 5, 2), generator=g)
    surface, scale, bbox = side2box(pts, off, heading, sizes)
    want = _old_side2box_scale(sizes, off)
    assert _equal(scale, want)
    lo = pts - off[..., :3] * want[..., :3]
    hi = pts + off[..., 3:] * want[..., 3:]
    assert _equal(surface, torch.cat([lo, hi], dim=-1))


def test_box_grids_equal_the_expressions():
    """The grids built on the cached indices and mask equal those built
    on fresh ones, bit for bit."""
    g = torch.Generator().manual_seed(1)
    center = torch.randn((2, 4, 3), generator=g)
    size = torch.rand((2, 4, 3), generator=g) + 0.1
    heading = torch.randn((2, 4), generator=g)
    bbox_grid, side_grid = make_box_grids(center, size, heading, 4)
    step = torch.linspace(-1.0, 1.0, 4)
    local = torch.stack(torch.meshgrid(step, step, step, indexing="ij"),
                        -1).reshape(-1, 3)[None, None] * (size[..., None, :]
                                                          / 2.0)
    faces = local[:, :, torch.from_numpy(_face_indices(4))]
    assert _equal(bbox_grid, rotate_points_z(local, heading)
                  + center[:, :, None, :])
    assert _equal(side_grid, rotate_points_z(faces, heading)
                  + center[:, :, None, :])
    saqe = make_saqe_side_grids(center, size, heading, 3)
    step = torch.linspace(-1.0, 1.0, 3)
    local = torch.stack(torch.meshgrid(step, step, step, indexing="ij"),
                        -1).reshape(-1, 3)[None, None] * (size[..., None, :]
                                                          / 2.0)
    faces = local[:, :, torch.from_numpy(_face_indices(3))].unflatten(
        2, (6, 9))
    zero = faces * 0.1 * _old_keep_mask(torch.float32, "cpu")
    side = torch.cat([faces - zero, faces, faces + zero], dim=3).flatten(2, 3)
    assert _equal(saqe, rotate_points_z(side, heading) + center[:, :, None, :])


def test_constant_made_under_inference_mode_serves_training():
    """A constant first made inside a request (inference mode) is a normal
    tensor, which a training step may save for backward."""
    with torch.inference_mode():
        const = device_constant(("test_graphs", 1), "cpu",
                                lambda: torch.full((3,), 2.0))
    assert not const.is_inference()
    x = torch.ones(3, requires_grad=True)
    (x * const).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))


@pytest.mark.parametrize("head", ["saqe", "nesie"])
def test_state_dict_keys_unchanged(head):
    keys = sorted(VoteNetNesie(head=head).state_dict())
    digest = hashlib.sha256("\n".join(keys).encode()).hexdigest()
    assert (len(keys), digest) == STATE_KEYS[head]


@pytest.mark.parametrize("args,want", [
    (("cpu", "seed", False, (1, 1024, 4), 1024), "cpu"),
    (("cuda", "random", False, (1, 1024, 4), 1024), "sample_mod_random"),
    (("cuda", "seed", True, (1, 1024, 4), 1024), "train_mode"),
    (("cuda", "seed", False, (1, 1000, 4), 1024), "shape"),
    (("cuda", "vote", False, (2, 1024, 4), 1024), "shape"),
    (("cuda", "seed", False, (1, 1024, 4), 1024), None),
    (("cuda", "spec", False, (1, 1024, 4), 1024), None),
])
def test_eager_reason(args, want):
    assert eager_reason(*args) == want


def test_fps_on_the_cpu_takes_no_capture_boundary(monkeypatch):
    class Refuse:
        def fps(self, *a):
            raise AssertionError("a CPU FPS reached the capture boundary")

    monkeypatch.setattr(pointops, "_CAPTURE", Refuse())
    xyz = torch.rand((1, 50, 3), generator=torch.Generator().manual_seed(2))
    assert pointops.furthest_point_sample(xyz, 8).shape == (1, 8)


def test_detector_on_the_cpu_counts_eager_and_answers_as_before():
    det = init_detector(device="cpu", cfg=InferenceConfig(num_points=1024),
                        head="saqe", **TINY)
    before = utils.counts()
    for seed in (3, 4):
        cloud = make_scene(np.random.default_rng(seed), 1500)
        got = det(cloud)
        _, want = eager_answer(det, cloud)
        for k in ANSWER:
            assert np.array_equal(got[k], want[k]), k
    after = utils.counts()
    made = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("detector.eager", "eager.cpu", "detector.graphed")}
    assert made == {"detector.eager": 2, "eager.cpu": 2,
                    "detector.graphed": 0}
    assert det._graphs is None


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _detector(dev, variant):
    """``saqe``, ``nesie`` (one FPS a forward, SA1's) or ``nesie_five_fps``
    (the real FPS in SA2-SA4 and the head's seed sampling: five)."""
    det = init_detector(device=dev, head="saqe" if variant == "saqe"
                        else "nesie")
    if variant == "nesie_five_fps":
        for sa in det.model.backbone.SA_modules:
            sa.input_fps_ordered = False
        det.model.bbox_head.seed_fps_prefix_opt = False
    return det


def _clouds():
    """8 clouds: 50000 points (sampled without replacement), 40000 (all
    taken) and fewer (sampled with replacement)."""
    sizes = (50000, 40000, 31000, 50000, 40000, 12000, 50000, 39999)
    return [make_scene(np.random.default_rng(10 + i), n)
            for i, n in enumerate(sizes)]


def _made(before: dict, prefix: str) -> dict:
    after = utils.counts(prefix)
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("tracing", ["off", "on", "capture_on"])
@pytest.mark.parametrize("variant", ["saqe", "nesie", "nesie_five_fps"])
def test_graphed_detector_matches_eager(cuda, monkeypatch, variant, tracing):
    """Every replayed request returns the eager steps' answer, and its
    decode before the expansion, bit for bit; tracing off, on after the
    capture, or on from the capture."""
    det = _detector(cuda, variant)
    decodes = []
    real = apis.expand_per_class
    monkeypatch.setattr(apis, "expand_per_class",
                        lambda d: decodes.append(d) or real(d))
    clouds = _clouds()
    utils.clear_spans()
    utils.set_tracing(tracing == "capture_on")
    try:
        first = det(clouds[0])  # eager, then the capture
        assert det._graphs is not None, "the capture failed"
        utils.set_tracing(tracing != "off")
        before = utils.counts("detector.")
        got = [det(c) for c in clouds]
        made = _made(before, "detector.")
    finally:
        utils.set_tracing(False)
        utils.clear_spans()
    assert made == {"detector.graphed": len(clouds)}
    graphed = decodes[1:]
    monkeypatch.setattr(apis, "expand_per_class", real)
    for i, cloud in enumerate(clouds):
        dec, want = eager_answer(det, cloud)
        for k in dec:
            assert np.array_equal(graphed[i][k], dec[k]), (i, k)
        for k in ANSWER:
            assert np.array_equal(got[i][k], want[k]), (i, k)
    for k in ANSWER:
        assert np.array_equal(first[k], got[0][k]), k


def _request_trace(det, cloud, graphed: bool):
    """One request (the Detector's, or the eager steps) with tracing on:
    (its launch counts, its span records)."""
    _build.reset_launch_counts()
    utils.clear_spans()
    utils.set_tracing(True)
    try:
        if graphed:
            det(cloud)
        else:
            with utils.span("detector.request"):
                eager_answer(det, cloud)
        launches = _build.launch_counts()
        recs = utils.span_records()
    finally:
        utils.set_tracing(False)
        utils.clear_spans()
    return launches, recs


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["saqe", "nesie", "nesie_five_fps"])
def test_replayed_request_counts_spans_and_launches(cuda, variant):
    """A replayed request counts ``detector.graphed`` once, opens one
    ``nn.forward`` span with device time, and makes the eager steps'
    launches and ``pointops.fps`` spans."""
    det = _detector(cuda, variant)
    cloud = make_scene(np.random.default_rng(7), 50000)
    det(cloud)
    assert det._graphs is not None, "the capture failed"
    before = utils.counts("detector.")
    launches, recs = _request_trace(det, cloud, graphed=True)
    assert _made(before, "detector.") == {"detector.graphed": 1}
    want_launches, want_recs = _request_trace(det, cloud, graphed=False)
    assert launches == want_launches
    assert sum(launches.values()) > 0
    names = [r["name"] for r in recs]
    fps = names.count("pointops.fps")
    assert fps == [r["name"] for r in want_recs].count("pointops.fps")
    assert fps == (5 if variant == "nesie_five_fps" else 1)
    forward = [r for r in recs if r["name"] == "nn.forward"]
    assert len(forward) == 1 and forward[0]["device_ms"] > 0
    top = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in top] == ["detector.request"]
    assert all(r["parent"] == forward[0]["index"]
               for r in recs if r["name"] == "pointops.fps")


@pytest.mark.gpu
def test_detector_captures_again_for_another_cfg(cuda):
    """A new ``cfg`` makes the next request eager (``warm_up``) and
    captures for it; a train-mode model stays eager."""
    det = _detector(cuda, "saqe")
    cloud = make_scene(np.random.default_rng(8), 50000)
    det(cloud)
    det.cfg = dataclasses.replace(det.cfg, nms_thr=0.5, score_thr=0.0)
    before = utils.counts()
    first, again = det(cloud), det(cloud)
    _, want = eager_answer(det, cloud)
    det.model.train()  # its BN then updates the running statistics
    try:
        det(cloud)
    finally:
        det.model.eval()
    made = _made(before, "")
    assert {k: made.get(k, 0) for k in (
        "detector.eager", "eager.warm_up", "eager.train_mode",
        "detector.graphed")} == {"detector.eager": 2, "eager.warm_up": 1,
                                 "eager.train_mode": 1,
                                 "detector.graphed": 1}
    for k in ANSWER:
        assert np.array_equal(first[k], want[k])
        assert np.array_equal(again[k], want[k])
