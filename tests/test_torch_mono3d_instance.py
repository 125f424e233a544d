"""The port's mono3d shell, ScanNet instance benchmark and last public
names held to the JAX package on the same numpy-seeded inputs (CPU):
``nn.mono3d``, ``eval.instance_seg``, ``nn.layers.MLP``,
``nn.heads.AngleIntegral`` and ``utils.trace``. The mono3d cases follow
``tests/test_visualizer_mono3d.py``'s, the instance case
``tests/test_eval.py``'s.

Tolerances:
* ``flip_mono3d_outputs`` / ``merge_aug_mono3d_outputs``: 1e-6 (flip and
  the channel remap are exact; the merge's mean is the one rounding);
* the mono3d shell's forward with the flax shell's weights (HWIO -> OIHW
  through ``convert.module_state_dict_from_flax``), ``MLP`` (eval and
  train mode, with its running-statistics update) and ``AngleIntegral``:
  float32, 1e-5;
* ``eval.instance_seg`` (numpy on both sides): every public function
  identical, NaN where the JAX module gives NaN.
"""
import dataclasses
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.eval.instance_seg as jis
from nesie_tpu.nn import heads as jheads
from nesie_tpu.nn import layers as jlayers
from nesie_tpu.nn import mono3d as jmono3d
import nesie_tpu_torch.eval.instance_seg as tis
from nesie_tpu_torch import utils
from nesie_tpu_torch.convert import module_state_dict_from_flax
from nesie_tpu_torch.nn import heads as theads
from nesie_tpu_torch.nn import layers as tlayers
from nesie_tpu_torch.nn import mono3d as tmono3d

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _maps(rng, shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _cases(seed, pred_velo):
    """test_visualizer_mono3d.py's maps (one stride) and a second stride
    at another size; reg channels 9 with velocity, 8 without."""
    rng = np.random.default_rng(seed)
    reg_c = 9 if pred_velo else 8
    shapes = [(1, 6, 8), (2, 3, 5)]
    cls = _maps(rng, [(b, 4, h, w) for b, h, w in shapes])
    reg = [rng.uniform(size=(b, reg_c, h, w)).astype(np.float32)
           for b, h, w in shapes]
    dirs = _maps(rng, [(b, 2, h, w) for b, h, w in shapes])
    attr = _maps(rng, [(b, 3, h, w) for b, h, w in shapes])
    return cls, reg, dirs, attr


def _assert_groups(got, want, tol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b is None:
                assert a is None
                continue
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=0)


@pytest.mark.parametrize("pred_velo", [True, False])
@pytest.mark.parametrize("extra", ["groups", "none_group", "absent"])
def test_flip_matches_jax(pred_velo, extra):
    cls, reg, dirs, attr = _cases(1, pred_velo)
    j_extra = t_extra = None
    if extra == "groups":
        j_extra = [[jnp.asarray(d) for d in dirs],
                   [jnp.asarray(a) for a in attr]]
        t_extra = [[torch.from_numpy(d) for d in dirs],
                   [torch.from_numpy(a) for a in attr]]
    elif extra == "none_group":
        j_extra = [None, [jnp.asarray(a) for a in attr]]
        t_extra = [None, [torch.from_numpy(a) for a in attr]]
    want = jmono3d.flip_mono3d_outputs(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        j_extra, pred_velo=pred_velo)
    t_reg = [torch.from_numpy(r) for r in reg]
    got = tmono3d.flip_mono3d_outputs(
        [torch.from_numpy(c) for c in cls], t_reg, t_extra,
        pred_velo=pred_velo)
    _assert_groups(got[:2], want[:2])
    if extra == "absent":
        assert got[2] is None and want[2] is None
    else:
        _assert_groups(got[2], want[2])
    for r, t in zip(reg, t_reg):  # the caller's maps are left as they are
        np.testing.assert_array_equal(t.numpy(), r)
    # flipping twice is the identity
    back = tmono3d.flip_mono3d_outputs(got[0], got[1], got[2],
                                       pred_velo=pred_velo)
    np.testing.assert_allclose(back[1][0].numpy(), reg[0], atol=1e-5)
    np.testing.assert_array_equal(back[0][0].numpy(), cls[0])


@pytest.mark.parametrize("pred_velo", [True, False])
@pytest.mark.parametrize("views", [2, 3])
def test_merge_matches_jax(pred_velo, views):
    cls, reg, dirs, attr = _cases(2, pred_velo)
    outs = []
    for v in range(views):
        outs.append(([c + v for c in cls], [r + 0.5 * v for r in reg],
                     [d - v for d in dirs], [a * (v + 1) for a in attr],
                     None))
    want = jmono3d.merge_aug_mono3d_outputs(
        [tuple(None if g is None else [jnp.asarray(m) for m in g]
               for g in o) for o in outs])
    got = tmono3d.merge_aug_mono3d_outputs(
        [tuple(None if g is None else [torch.from_numpy(m) for m in g]
               for g in o) for o in outs])
    _assert_groups(got, want)
    # test_visualizer_mono3d.py's semantics: rotation onward from view 0,
    # dir_cls view 0 whole, groups >= 3 averaged
    np.testing.assert_array_equal(got[1][0][:, 6:].numpy(), reg[0][:, 6:])
    np.testing.assert_array_equal(got[2][0].numpy(), dirs[0])


def test_merge_passes_none_maps_through():
    cls, reg, _, _ = _cases(3, True)
    outs = [([torch.from_numpy(c) for c in cls],
             [torch.from_numpy(r) for r in reg], [None]) for _ in range(2)]
    want = jmono3d.merge_aug_mono3d_outputs(
        [([jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
          [None]) for _ in range(2)])
    got = tmono3d.merge_aug_mono3d_outputs(outs)
    assert got[2] == [None] and want[2] == [None]
    _assert_groups(got[:2], want[:2])


# ---- the shell, with test_visualizer_mono3d.py:135's tiny modules ----

class JTinyBackbone(fnn.Module):
    @fnn.compact
    def __call__(self, img, train=False):
        return fnn.Conv(8, (3, 3), name="stem")(img)


class JTinyHead(fnn.Module):
    @fnn.compact
    def __call__(self, feats, train=False):
        cls = fnn.Conv(4, (1, 1), name="cls")(feats)
        reg = fnn.Conv(9, (1, 1), name="reg")(feats)
        return ([jnp.moveaxis(cls, -1, 1)], [jnp.moveaxis(reg, -1, 1)])


class TTinyBackbone(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, 8, 3, padding=1)  # flax "SAME"

    def forward(self, img):
        return self.stem(img)


class TTinyHead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cls = torch.nn.Conv2d(8, 4, 1)
        self.reg = torch.nn.Conv2d(8, 9, 1)

    def forward(self, feats):
        return [self.cls(feats)], [self.reg(feats)]

    def loss(self, feats, targets):
        cls, reg = self(feats)
        return dict(loss_cls=((cls[0] - targets["cls"]) ** 2).mean(),
                    loss_reg=((reg[0] - targets["reg"]) ** 2).mean())


@pytest.fixture(scope="module")
def shells():
    jdet = jmono3d.SingleStageMono3DDetector(backbone=JTinyBackbone(),
                                             bbox_head=JTinyHead())
    img = np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    variables = jdet.init(jax.random.PRNGKey(0), jnp.asarray(img))
    tdet = tmono3d.SingleStageMono3DDetector(backbone=TTinyBackbone(),
                                             bbox_head=TTinyHead())
    tdet.load_state_dict(module_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"])), strict=True)
    return jdet, variables, tdet, img


def test_shell_forward_matches_flax(shells):
    jdet, variables, tdet, img = shells
    jcls, jreg = jdet.apply(variables, jnp.asarray(img))
    tcls, treg = tdet.eval()(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert tuple(tcls[0].shape) == (2, 4, 16, 16)
    assert tuple(treg[0].shape) == (2, 9, 16, 16)
    np.testing.assert_allclose(tcls[0].detach().numpy(), np.asarray(jcls[0]),
                               **TOL)
    np.testing.assert_allclose(treg[0].detach().numpy(), np.asarray(jreg[0]),
                               **TOL)


def test_shell_neck_and_forward_train(shells):
    """A neck runs between backbone and head; ``forward_train`` is the
    head's loss on the extracted features, here against the flax shell's
    outputs."""
    jdet, variables, tdet, img = shells
    rng = np.random.default_rng(5)
    targets = dict(cls=rng.normal(size=(2, 4, 16, 16)).astype(np.float32),
                   reg=rng.normal(size=(2, 9, 16, 16)).astype(np.float32))
    jcls, jreg = jdet.apply(variables, jnp.asarray(img))
    losses = tdet.forward_train(torch.from_numpy(img).permute(0, 3, 1, 2),
                                {k: torch.from_numpy(v)
                                 for k, v in targets.items()})
    np.testing.assert_allclose(
        losses["loss_cls"].item(),
        ((np.asarray(jcls[0]) - targets["cls"]) ** 2).mean(), **TOL)
    np.testing.assert_allclose(
        losses["loss_reg"].item(),
        ((np.asarray(jreg[0]) - targets["reg"]) ** 2).mean(), **TOL)
    neck = tmono3d.SingleStageMono3DDetector(
        backbone=tdet.backbone, bbox_head=tdet.bbox_head,
        neck=torch.nn.ReLU())
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    torch.testing.assert_close(neck(x)[0][0],
                               tdet.bbox_head(torch.relu(tdet.backbone(x)))[0][0])


# ---- MLP, AngleIntegral, trace ----

@pytest.mark.parametrize("train", [False, True])
def test_mlp_matches_jax(train):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    jm = jlayers.MLP(conv_channels=(16, 8))
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # running statistics other than flax's init, so eval mode uses them
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.5, 1.5, np.shape(a)).astype(
            np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    tm = tlayers.MLP(6, (16, 8))
    tm.load_state_dict(module_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]), stats), strict=True)
    assert all(tm.mlp[j].conv.bias is not None for j in range(2))
    if train:
        want, upd = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        got = tm.train()(torch.from_numpy(x))
        new = module_state_dict_from_flax(
            jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, upd["batch_stats"]))
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), new[k].numpy(), **TOL)
    else:
        want = jm.apply(variables, jnp.asarray(x))
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bins", [12, 25])
def test_angle_integral_matches_jax(bins):
    logits = np.random.default_rng(bins).normal(
        size=(3, 7, bins), scale=3.0).astype(np.float32)
    want = jheads.AngleIntegral().apply({}, jnp.asarray(logits))
    got = theads.AngleIntegral()(torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) <= math.pi + 1e-6


def test_trace_writes_a_chrome_trace(tmp_path, caplog):
    with caplog.at_level("INFO", logger=utils.LOGGER_NAME):
        with utils.trace("mlp", tmp_path) as prof:
            tlayers.MLP(6, (8,)).eval()(torch.ones(1, 4, 6))
        with utils.trace("untraced") as none:
            pass
    assert prof is not None and none is None
    path = tmp_path / "mlp.trace.json"
    assert path.stat().st_size > 0
    assert "traceEvents" in path.read_text()
    assert any("mlp took" in r.message for r in caplog.records)
    assert any("untraced took" in r.message for r in caplog.records)


# ---- eval.instance_seg ----

def test_instance_seg_constants_equal():
    assert tis.SCANNET_BENCHMARK_IDS == jis.SCANNET_BENCHMARK_IDS
    assert tis.SCANNET_BENCHMARK_CLASSES == jis.SCANNET_BENCHMARK_CLASSES
    assert tis.BENCHMARK_OVERLAPS == jis.BENCHMARK_OVERLAPS
    assert tis.MIN_REGION_SIZE == jis.MIN_REGION_SIZE


def _same(got, want):
    """Equal results, NaN where NaN, through dicts, lists, tuples and the
    modules' dataclasses."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        _same(dataclasses.asdict(got), dataclasses.asdict(want))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want


def test_evaluate_instance_segmentation_eval_case():
    """tests/test_eval.py:80's case."""
    n = 100
    g1 = np.zeros(n, bool)
    g1[:30] = True
    g2 = np.zeros(n, bool)
    g2[50:80] = True
    gt = [dict(masks=np.stack([g1, g2]), labels=np.array([0, 1]))]
    p2 = np.zeros(n, bool)
    p2[50:60] = True
    p3 = np.zeros(n, bool)
    p3[90:] = True
    dt = [dict(masks=np.stack([g1, p2, p3]), scores=np.array([0.9, 0.8, 0.7]),
               labels=np.array([0, 1, 0]))]
    got = tis.evaluate_instance_segmentation(gt, dt)
    _same(got, jis.evaluate_instance_segmentation(gt, dt))
    assert got["0_AP_0.25"] == 1.0 and got["1_AP_0.50"] == 0.0
    _same(tis.evaluate_instance_segmentation(gt, dt, class_names=["a", "b"]),
          jis.evaluate_instance_segmentation(gt, dt, class_names=["a", "b"]))
    _same(tis.mask_iou(g1, p3), jis.mask_iou(g1, p3))
    _same(tis.mask_iou(g2, p2), jis.mask_iou(g2, p2))


def make_scan(rng, n=3000):
    """One generated scan and predictions on it: benchmark instances of
    100-500 vertices, two under MIN_REGION_SIZE, group instances (ids
    < 1000), unannotated and non-benchmark vertices; predictions perturbed
    from the GT (some twice, the duplicates), small ones, random ones, one
    of a non-benchmark class, some confidences tied."""
    ids = np.zeros(n, np.int64)
    order = rng.permutation(n)
    pos, insts = 0, []
    classes = rng.choice(jis.SCANNET_BENCHMARK_IDS[:6], 6)
    for j, cls in enumerate(classes):
        size = int(rng.integers(40, 80)) if j < 2 else int(rng.integers(100, 500))
        members = order[pos:pos + size]
        pos += size
        ids[members] = cls * 1000 + j + 1
        insts.append((cls, members))
    for g in (5, 7):  # group instances
        ids[order[pos:pos + 150]] = g
        pos += 150
    ids[order[pos:pos + 100]] = 1 * 1000 + 1  # nyu40 id 1: not benchmark
    masks, labels, confs = [], [], []
    for cls, members in insts:
        for _ in range(2 if rng.uniform() < 0.5 else 1):
            m = np.zeros(n, bool)
            keep = members[rng.uniform(size=len(members)) < rng.uniform(0.3, 1.0)]
            m[keep] = True
            m[rng.choice(n, int(rng.integers(0, 120)), replace=False)] = True
            masks.append(m)
            labels.append(cls if rng.uniform() < 0.85 else rng.choice(
                jis.SCANNET_BENCHMARK_IDS))
            confs.append(round(float(rng.uniform()), 1))
    for _ in range(4):  # random and small predictions
        m = np.zeros(n, bool)
        m[rng.choice(n, int(rng.integers(60, 400)), replace=False)] = True
        masks.append(m)
        labels.append(rng.choice(jis.SCANNET_BENCHMARK_IDS[:6]))
        confs.append(float(rng.uniform()))
    m = np.zeros(n, bool)
    m[:200] = True
    masks.append(m)
    labels.append(2)  # not a benchmark class
    confs.append(0.5)
    return ids, dict(mask=np.stack(masks), label_id=np.array(labels),
                     conf=np.array(confs))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scannet_instance_benchmark_matches_jax(seed):
    rng = np.random.default_rng(seed)
    scans = [make_scan(rng) for _ in range(3)]
    gt_ids = [s[0] for s in scans]
    infos = [s[1] for s in scans]
    got = tis.scannet_instance_benchmark(gt_ids, infos)
    want = jis.scannet_instance_benchmark(gt_ids, infos)
    _same(got, want)
    assert 0.0 < want["all_ap_25%"] <= 1.0
    # a class with no GT anywhere is NaN in the JAX module and here
    assert any(math.isnan(c["ap"]) for c in want["classes"].values())

    base = 0
    t_scans, j_scans = [], []
    for ids, info in scans:
        t = tis.assign_scan(ids, info["mask"], info["label_id"],
                            info["conf"], uid_base=base)
        j = jis.assign_scan(ids, info["mask"], info["label_id"],
                            info["conf"], uid_base=base)
        _same(t, j)
        base += len(info["label_id"])
        t_scans.append(t)
        j_scans.append(j)
    small = sum(1 for _, p in j_scans for ps in p.values() for q in ps
                for _, _, is_small in q.gt_overlaps if is_small)
    dup = sum(1 for g, _ in j_scans for gs in g.values() for x in gs
              if len(x.cands) > 1)
    assert small > 0 and dup > 0  # the small-GT and duplicate branches
    for cls in jis.SCANNET_BENCHMARK_IDS[:8]:
        for th in (0.25, 0.5, 0.9):
            _same(tis._class_overlap_ap(t_scans, cls, th),
                  jis._class_overlap_ap(j_scans, cls, th))


@pytest.mark.parametrize("seed", [0, 1])
def test_ap_from_curve_matches_jax(seed):
    rng = np.random.default_rng(seed)
    y_true = (rng.uniform(size=40) < 0.6).astype(np.float64)
    y_score = np.round(rng.uniform(size=40), 1)  # tied scores
    for hard in (0, 3):
        _same(tis._ap_from_curve(y_true, y_score, hard),
              jis._ap_from_curve(y_true, y_score, hard))
    _same(tis._ap_from_curve(np.zeros(0), np.zeros(0), 2),
          jis._ap_from_curve(np.zeros(0), np.zeros(0), 2))


# ---- the join of the two packages ----

# what the port leaves out or holds under another name (ROADMAP §1)
ELSEWHERE = {
    "convert_torch": "convert (its inverse: flax -> the port's names)",
    "ops.pallas_fps": "ops.fps + csrc/fps_onchip.cu",
    "ops.pallas_ball_query": "ops.ball_query + csrc/ball_query.cu",
    "ops.pallas_three_nn": "ops.three_nn + csrc/three_nn.cu",
}
NOT_PORTED = {
    "nn.layers": {"SyncBatchNorm"},
    "ops.pointops": {"set_fps_impl", "set_ball_query_impl",
                     "set_three_nn_impl"},
    "parallel.mesh": {"data_sharding", "shard_batch"},
    "utils": {"enable_compile_cache"},
}
TOOLS_NOT_PORTED = {"benchmark", "impl_ab", "profile_forward",
                    "profile_semi"}


def _modules(pkg):
    import pkgutil

    return {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")}


def test_join_leaves_only_the_recorded_names():
    """Every module, public function and class of the JAX package and
    every script of ``tools/`` has a counterpart of the same name in the
    port, except what ROADMAP §1 records as not ported on purpose or held
    under another name."""
    import importlib
    import inspect
    from pathlib import Path

    import nesie_tpu
    import nesie_tpu_torch

    jmods, tmods = _modules(nesie_tpu), _modules(nesie_tpu_torch)
    assert jmods - tmods == set(ELSEWHERE)
    missing = {}
    for name in sorted(jmods & tmods):
        jm = importlib.import_module(f"nesie_tpu.{name}")
        tm = importlib.import_module(f"nesie_tpu_torch.{name}")
        public = {n for n, v in vars(jm).items() if not n.startswith("_")
                  and (inspect.isfunction(v) or inspect.isclass(v))
                  and v.__module__ == jm.__name__}
        gone = public - set(dir(tm))
        if gone:
            missing[name] = gone
    assert missing == NOT_PORTED
    root = Path(__file__).resolve().parents[1]
    jtools = {p.stem for p in (root / "tools").glob("*.py")}
    ttools = {p.stem for p in (root / "nesie_tpu_torch" / "tools").glob("*.py")}
    assert jtools - ttools == TOOLS_NOT_PORTED
