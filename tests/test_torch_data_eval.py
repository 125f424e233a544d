"""The port's config, data layer and AP evaluation against the JAX
package's, on the CPU.

Every module here is a copy (the port imports nothing of ``nesie_tpu``),
so the checks are equality: configs by ``dataclasses.asdict``, files by
their bytes, host batches array for array from the same seed, the native
loader's output for the same seed. The AP evaluation is float64 numpy on
both sides and agrees within 1e-12.
"""
import dataclasses
import importlib
import pickle

import numpy as np
import pytest
import torch

import nesie_tpu.config as jconfig
import nesie_tpu.data.dataset as jds
import nesie_tpu.data.native_loader as jnative
import nesie_tpu.data.synthetic as jsyn
import nesie_tpu.eval.np_iou as jiou
import nesie_tpu_torch.config as tconfig
import nesie_tpu_torch.data.dataset as tds
import nesie_tpu_torch.data.native_loader as tnative
import nesie_tpu_torch.data.synthetic as tsyn
import nesie_tpu_torch.eval.np_iou as tiou
from nesie_tpu_torch.data.augment import AugParams

# the eval packages export a function named indoor_eval over the module
jeval = importlib.import_module("nesie_tpu.eval.indoor_eval")
teval = importlib.import_module("nesie_tpu_torch.eval.indoor_eval")

# the verify skill's TINY overrides (its drive 3)
TINY = ["optim.max_epochs=2", "data.repeat=1", "data.num_points=1024",
        "data.samples_per_step=2", "log_interval=1", "model.num_proposal=16",
        "model.reg_max=8", "model.num_points=(64,32,16,16)",
        "model.num_samples=(8,8,4,4)",
        "model.sa_channels=((16,16,32),(32,32,32),(32,32,32),(32,32,32))",
        "model.fp_channels=((32,32),(32,32))"]
NAMES = [f"{fam}-votenet-{ds}-{phase}-{split}"
         for fam in ("nesie", "saqe") for ds in ("scannet", "sunrgbd")
         for phase in ("pretrain", "train")
         for split in ("005", "010", "020", "050", "all")]
NAMES += [f"{fam}-votenet-{ds}-test" for fam in ("nesie", "saqe")
          for ds in ("scannet", "sunrgbd")]
BAD_NAMES = ["votenet", "nesie-votenet-scannet", "foo-votenet-scannet-train-010",
             "nesie-votenet-kitti-train-010", "nesie-votenet-scannet-finetune-010"]
N_POINTS = 512


@pytest.mark.parametrize("name", NAMES)
def test_get_config_matches_jax(name):
    want = jconfig.apply_overrides(jconfig.get_config(name), TINY)
    got = tconfig.apply_overrides(tconfig.get_config(name), TINY)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tconfig.get_config(name)) == \
        dataclasses.asdict(jconfig.get_config(name))


@pytest.mark.parametrize("name", BAD_NAMES)
def test_bad_config_names_raise_in_both(name):
    with pytest.raises(ValueError):
        jconfig.get_config(name)
    with pytest.raises(ValueError):
        tconfig.get_config(name)


def test_overrides_parse_like_jax():
    over = ["seed=3", "teacher_jitter=False", "ema_bn_stats=TRUE",
            "optim.lr=0.004", "optim.lr_milestones=(3,4)",
            "data.label_list_file=meta_data/x.txt", "num_devices=1",
            "pseudo.obj_thr=0.7", "loss.iou_pred_weight=2"]
    base = "nesie-votenet-scannet-train-050"
    got = tconfig.apply_overrides(tconfig.get_config(base), over)
    want = jconfig.apply_overrides(jconfig.get_config(base), over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ema_bn_stats is True and got.loss.iou_pred_weight == 2.0


def _assert_tree_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One synthetic ScanNet-format directory from each writer."""
    root = tmp_path_factory.mktemp("synthetic")
    kw = dict(num_classes=4, num_objects=(3, 6))
    return (jsyn.write_synthetic_scannet(root / "jax", 10, 4, seed=3, **kw),
            tsyn.write_synthetic_scannet(root / "port", 10, 4, seed=3, **kw))


def test_write_synthetic_scannet_matches_jax(datasets):
    jroot, troot = datasets
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                    if p.is_file())
    tfiles = sorted(p.relative_to(troot) for p in troot.rglob("*")
                    if p.is_file())
    assert jfiles == tfiles and len(jfiles) == 10 + 4 + 2 + 5
    for rel in jfiles:
        if rel.suffix == ".pkl":
            with open(jroot / rel, "rb") as f, open(troot / rel, "rb") as g:
                _assert_tree_equal(pickle.load(g), pickle.load(f), str(rel))
        else:
            assert (jroot / rel).read_bytes() == (troot / rel).read_bytes(), rel


def _both(datasets, cls_name, split="meta_data/scannetv2_train_0.5.txt",
          **kw):
    jroot, troot = datasets
    out = []
    for mod, root in ((jds, jroot), (tds, troot)):
        cls = getattr(mod, cls_name)
        if cls_name == "ScanNetScenes":
            out.append(cls(root, root / "scannet_infos_val.pkl"))
        else:
            out.append(cls(root, root / "scannet_infos_train.pkl",
                           root / split, **kw))
    return out


def _host(batch):
    """A batch's arrays, the aug records as dicts of numpy arrays."""
    out = {}
    for k, v in batch.items():
        if k.startswith("aug"):
            v = v._asdict() if hasattr(v, "_asdict") else v
            out[k] = {f: np.asarray(a) for f, a in v.items()}
        else:
            out[k] = v
    return out


def test_eval_batch_matches_jax(datasets):
    jd, td = _both(datasets, "ScanNetScenes")
    assert [s.scene_id for s in jd.scenes] == [s.scene_id for s in td.scenes]
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    for idx in ([0, 1, 2], [3, 3]):
        _assert_tree_equal(td.eval_batch(idx, trng, N_POINTS),
                           jd.eval_batch(idx, jrng, N_POINTS))


@pytest.mark.parametrize("native", [False, True])
def test_train_batch_matches_jax(datasets, native):
    jd, td = _both(datasets, "SubScanNetScenes")
    jd.cache_scenes = td.cache_scenes = not native
    jrng, trng = np.random.default_rng([5, 0]), np.random.default_rng([5, 0])
    aug = dict(rot_range=0.3, scale_range=(0.9, 1.1), translation_std=0.2)
    for idx in ([0, 1], [2, 4]):
        want = jd.train_batch(idx, jrng, jds.AugConfig(**aug), N_POINTS)
        got = td.train_batch(idx, trng, tds.AugConfig(**aug), N_POINTS)
        _assert_tree_equal(_host(got), _host(want))


def test_semi_batch_and_histogram_match_jax(datasets):
    jd, td = _both(datasets, "SimiScanNetScenes", ratio=2)
    assert (td.num_labeled, td.num_unlabeled) == (jd.num_labeled,
                                                  jd.num_unlabeled) == (5, 10)
    np.testing.assert_array_equal(td.labeled_class_histogram(4),
                                  jd.labeled_class_histogram(4))
    jrng, trng = np.random.default_rng([5, 0]), np.random.default_rng([5, 0])
    for idx, n_ulb in (([0, 1], None), ([3, 4], 3)):
        want = jd.semi_batch(idx, jrng, num_points=N_POINTS,
                             n_unlabeled=n_ulb)
        got = td.semi_batch(idx, trng, num_points=N_POINTS,
                            n_unlabeled=n_ulb)
        _assert_tree_equal(_host(got), _host(want))


def test_presampled_scenes_match_jax(datasets, tmp_path):
    """A dump in ``tools/dump_eval_set.py``'s layout reads the same."""
    jroot, _ = datasets
    infos = jds.io.load_infos(jroot / "scannet_infos_val.pkl")
    rng = np.random.default_rng(0)
    (tmp_path / "points").mkdir()
    scenes = []
    for info in infos:
        sid = info["point_cloud"]["lidar_idx"]
        np.save(tmp_path / f"points/{sid}.npy",
                rng.normal(size=(N_POINTS, 4)).astype(np.float32))
        scenes.append(dict(scene_id=sid, pts_file=f"points/{sid}.npy",
                           info=info))
    with open(tmp_path / "presampled_infos.pkl", "wb") as f:
        pickle.dump(dict(num_points=N_POINTS, scenes=scenes), f)
    jd = jds.PresampledScanNetScenes(tmp_path)
    td = tds.PresampledScanNetScenes(tmp_path)
    assert td.num_points == jd.num_points == N_POINTS
    _assert_tree_equal(td.eval_batch([0, 2], np.random.default_rng(1), N_POINTS),
                       jd.eval_batch([0, 2], np.random.default_rng(1), N_POINTS))
    with pytest.raises(ValueError):
        td.eval_batch([0], np.random.default_rng(1), N_POINTS + 1)


def test_native_loader_matches_jax(datasets):
    if not jnative.native_available():
        pytest.skip("the JAX package's native loader does not build here")
    assert tnative.native_available()
    _, troot = datasets
    path = next((troot / "points").glob("*.bin"))
    aam = np.eye(4, dtype=np.float32)
    aam[:3, 3] = [0.5, -1.0, 0.25]
    aam[:2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    for n, seed in ((700, 7), (100000, 8)):  # without and with replacement
        for m in (aam, None):
            want = jnative.load_scene_native(path, m, n, seed=seed)
            got = tnative.load_scene_native(path, m, n, seed=seed)
            np.testing.assert_array_equal(got, want)


def test_batch_to_device_makes_aug_params(datasets):
    _, td = _both(datasets, "SubScanNetScenes")
    batch = td.train_batch([0, 1], np.random.default_rng(0),
                           num_points=N_POINTS)
    dev = tds.batch_to_device(batch, "cpu")
    assert isinstance(dev["aug"], AugParams)
    assert dev["scene_ids"] == batch["scene_ids"]
    for k in ("points", "gt_boxes", "gt_labels", "gt_valid"):
        assert isinstance(dev[k], torch.Tensor)
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])
    for f in AugParams._fields:
        np.testing.assert_array_equal(getattr(dev["aug"], f).numpy(),
                                      batch["aug"][f])


def _random_boxes(rng, n, yaw):
    b = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                        rng.uniform(0.2, 1.5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)) if yaw
                        else np.zeros((n, 1))], axis=1)
    return b


@pytest.mark.parametrize("bev", ["ccw", "cw_kernel"])
@pytest.mark.parametrize("yaw", [False, True])
def test_pairwise_iou3d_matches_jax(bev, yaw):
    rng = np.random.default_rng(4)
    a, b = _random_boxes(rng, 40, yaw), _random_boxes(rng, 30, yaw)
    b[:10] = a[:10] + rng.normal(0, 0.05, (10, 7))  # overlapping pairs
    got = tiou.pairwise_iou3d(a, b, bev=bev)
    want = jiou.pairwise_iou3d(a, b, bev=bev)
    assert (want > 0.25).sum() >= 5  # the check is not vacuous
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert tiou.pairwise_iou3d(a[:0], b).shape == (0, 30)


@pytest.mark.parametrize("bev", ["ccw", "cw_kernel"])
def test_indoor_eval_matches_jax(bev):
    """Seeded annotations: GT per scene, detections near some GT boxes
    (matches at both thresholds), others at random."""
    rng = np.random.default_rng(11)
    gt, dt = [], []
    for _ in range(6):
        g = _random_boxes(rng, int(rng.integers(1, 7)), yaw=True)
        gl = rng.integers(0, 5, len(g))
        near = g[rng.integers(0, len(g), 8)] + rng.normal(0, 0.1, (8, 7))
        d = np.concatenate([near, _random_boxes(rng, 6, yaw=True)])
        dl = np.concatenate([gl[rng.integers(0, len(g), 8)],
                             rng.integers(0, 5, 6)])
        gt.append(dict(boxes=g, labels=gl))
        dt.append(dict(boxes=d, scores=rng.uniform(size=len(d)), labels=dl))
    names = ["a", "b", "c", "d", "e"]
    got = teval.indoor_eval(gt, dt, class_names=names, bev=bev)
    want = jeval.indoor_eval(gt, dt, class_names=names, bev=bev)
    assert got.keys() == want.keys()
    assert 0 < want["mAP_0.25"] < 1 and want["mAP_0.50"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0,
                                   err_msg=k)
    rec, prec = rng.uniform(size=20).cumsum() / 20, rng.uniform(size=20)
    assert teval.average_precision(rec, prec) == \
        jeval.average_precision(rec, prec)
