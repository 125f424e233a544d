"""Data preparation on the port against the JAX package, on generated
raw trees (CPU).

* Raw ScanNet scans (``chip_smoke.write_raw_scannet``: PLY vertices,
  segments, aggregation, an axis alignment of each scan's own, the label
  TSV) through both packages' ``scannet_prep``: the PLY round trip, the
  label map, the alignment and the ``export_scan`` dicts exactly equal;
  ``write_infos``' pkl equal key by key, every ``points/*.bin``
  byte-equal.
* SUN RGB-D: a raw tree with ``.png`` depth (as
  ``tests/test_sunrgbd_raw_e2e.py`` builds it) and one with ``.npy``
  depth (``chip_smoke.write_raw_sunrgbd``), exactly equal.
* ``tools/create_data`` (both subcommands) in-process on both packages:
  the same files, the infos equal, the ``.bin`` files byte-equal (one
  ``default_rng(0)`` stream through every scan that is subsampled).
* ``tools/dump_eval_set`` on both packages, each replaying the legacy
  global ``np.random`` from the same saved state: identical ``.npy``
  files and manifests; the port's ``PresampledScanNetScenes`` reads the
  port's dump.
* A tiny train -> test round trip through the port's CLIs on the infos
  its ``create_data`` wrote.
"""
import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import nesie_tpu.data.scannet_prep as jscannet
import nesie_tpu.data.sunrgbd_prep as jsun
import nesie_tpu_torch.data.scannet_prep as tscannet
import nesie_tpu_torch.data.sunrgbd_prep as tsun
from nesie_tpu_torch.data.dataset import PresampledScanNetScenes
from nesie_tpu_torch.data.synthetic import make_synthetic_scenes
from nesie_tpu_torch.tools import create_data as tcreate
from nesie_tpu_torch.tools import dump_eval_set as tdump
from nesie_tpu_torch.tools import test as ttest
from nesie_tpu_torch.tools import train as ttrain
from test_sunrgbd_raw_e2e import _write_raw_tree

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# > 50000 vertices a scan, so export_scan subsamples and draws
SCANNET = dict(floor_points=50400, points_per_object=120)
MODEL16 = ["model.num_proposal=16", "model.reg_max=8",
           "model.num_points=(64,32,16,16)", "model.num_samples=(8,8,4,4)",
           "model.sa_channels=((16,16,32),(32,32,32),(32,32,32),(32,32,32))",
           "model.fp_channels=((32,32),(32,32))", "data.num_points=1024"]


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(got, want, path="root"):
    """Nested dicts / lists / tuples / arrays equal exactly, with the
    same keys, types, dtypes and shapes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def assert_same_tree(got: Path, want: Path):
    """Two output directories: the same files; pkls equal when loaded,
    every other file byte-equal."""
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*")
                           if p.is_file())
    assert files
    for rel in files:
        if rel.suffix == ".pkl":
            with open(got / rel, "rb") as g, open(want / rel, "rb") as w:
                assert_same(pickle.load(g), pickle.load(w), str(rel))
        else:
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def raw_scannet(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw_scannet")
    scenes = make_synthetic_scenes(4, seed=3, **SCANNET)
    ids = [s.scene_id for s in scenes]
    scans = chip_smoke.write_raw_scannet(
        root, scenes, {"train": ids[:2], "val": ids[2:]})
    return scans, scenes


@pytest.fixture(scope="module")
def raw_sunrgbd(tmp_path_factory):
    png = tmp_path_factory.mktemp("raw_sun_png")
    _write_raw_tree(png, n_samples=3)
    npy = tmp_path_factory.mktemp("raw_sun_npy")
    scenes = make_synthetic_scenes(3, seed=4, num_classes=10,
                                   floor_points=50200, yaw_range=1.0)
    chip_smoke.write_raw_sunrgbd(npy, scenes, {"train": [0, 2], "val": [1]})
    return {"png": png, "npy": npy}


def test_scannet_readers_and_export_match_jax(raw_scannet):
    scans, scenes = raw_scannet
    tsv = scans.parent / "scannetv2-labels.combined.tsv"
    assert_same(tscannet.read_label_mapping(tsv),
                jscannet.read_label_mapping(tsv))
    for scene in scenes:
        d, sid = scans / scene.scene_id, scene.scene_id
        ply = d / f"{sid}_vh_clean_2.ply"
        got = tscannet.read_ply_vertices(ply)
        assert_same(got, jscannet.read_ply_vertices(ply))
        aam = tscannet.read_axis_align_matrix(d / f"{sid}.txt")
        assert_same(aam, jscannet.read_axis_align_matrix(d / f"{sid}.txt"))
        # the PLY round trip: aligned vertices are the generated points
        xyz = np.stack([got["x"], got["y"], got["z"]], 1).astype(np.float64)
        np.testing.assert_allclose(xyz @ aam[:3, :3].T + aam[:3, 3],
                                   scene.points[:, :3], atol=1e-5)
        assert_same(tscannet.read_mesh_vertices_rgb(ply),
                    jscannet.read_mesh_vertices_rgb(ply))
        for max_points in (50000, 10 ** 6):
            got = tscannet.export_scan(d, sid, tsv, max_num_points=max_points,
                                       rng=np.random.default_rng(5))
            want = jscannet.export_scan(d, sid, tsv, max_num_points=max_points,
                                        rng=np.random.default_rng(5))
            assert_same(got, want)
        assert len(got["boxes"]) == len(scene.boxes)
        assert (got["semantic_ids"] == 2).any()  # the floor: no box


def test_scannet_write_infos_match_jax(raw_scannet, tmp_path):
    scans, scenes = raw_scannet
    tsv = scans.parent / "scannetv2-labels.combined.tsv"
    exports = [(s.scene_id, tscannet.export_scan(scans / s.scene_id,
                                                 s.scene_id, tsv))
               for s in scenes]
    got = tscannet.write_infos(exports, tmp_path / "port", "train")
    want = jscannet.write_infos(exports, tmp_path / "jax", "train")
    assert_same(got, want)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("depth", ["png", "npy"])
def test_sunrgbd_prep_matches_jax(raw_sunrgbd, depth, tmp_path):
    root = raw_sunrgbd[depth]
    ids = sorted(p.stem for p in (root / "calib").glob("*.txt"))
    assert tsun.CLASS_NAMES == jsun.CLASS_NAMES
    samples = []
    for sid in ids:
        assert_same(tsun.read_calib(root / "calib" / f"{sid}.txt"),
                    jsun.read_calib(root / "calib" / f"{sid}.txt"))
        assert_same(tsun.read_label(root / "label" / f"{sid}.txt"),
                    jsun.read_label(root / "label" / f"{sid}.txt"))
        got = tsun.export_sample(root, sid, rng=np.random.default_rng(1))
        want = jsun.export_sample(root, sid, rng=np.random.default_rng(1))
        assert_same(got, want)
        assert len(got["boxes"]) > 0 and len(got["points"]) > 1000
        samples.append((sid, got))
    if depth == "png":
        rtilt, k = tsun.read_calib(root / "calib" / f"{ids[0]}.txt")
        import imageio.v3 as iio

        raw = iio.imread(root / "depth" / f"{ids[0]}.png")
        assert_same(tsun.decode_sunrgbd_depth(raw),
                    jsun.decode_sunrgbd_depth(raw))
        meters = tsun.decode_sunrgbd_depth(raw)
        assert_same(tsun.depth_to_points(meters, k, rtilt),
                    jsun.depth_to_points(meters, k, rtilt))
    assert_same(tsun.write_infos(samples, tmp_path / "port", "train"),
                jsun.write_infos(samples, tmp_path / "jax", "train"))
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("dataset", ["scannet", "sunrgbd-png", "sunrgbd-npy"])
def test_create_data_cli_matches_jax(dataset, raw_scannet, raw_sunrgbd,
                                     tmp_path, monkeypatch, capsys):
    if dataset == "scannet":
        scans = raw_scannet[0]
        args = ["scannet", "--raw-dir", str(scans),
                "--splits-dir", str(scans.parent / "meta")]
    else:
        args = ["sunrgbd", "--raw-dir", str(raw_sunrgbd[dataset[8:]])]
    tcreate.main(args + ["--out-dir", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["create_data.py", *args, "--out-dir",
                                      str(tmp_path / "jax")])
    _load_jax_tool("create_data").main()
    assert port_out == capsys.readouterr().out
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    name = dataset.split("-")[0]
    for split in ("train", "val"):
        assert (tmp_path / "port" / f"{name}_infos_{split}.pkl").exists()


@pytest.fixture(scope="module")
def prepared(raw_scannet, tmp_path_factory):
    """The port's create_data output for the raw ScanNet tree, with a
    labeled-scene list for the train configs."""
    scans = raw_scannet[0]
    out = tmp_path_factory.mktemp("prepared")
    tcreate.main(["scannet", "--raw-dir", str(scans), "--splits-dir",
                  str(scans.parent / "meta"), "--out-dir", str(out)])
    ids = (scans.parent / "meta" / "scannetv2_train.txt").read_text()
    (out / "meta_data").mkdir()
    (out / "meta_data" / "scannetv2_train_0.1.txt").write_text(ids)
    return out


def test_dump_eval_set_matches_jax(prepared, tmp_path):
    ann = prepared / "scannet_infos_val.pkl"
    jdump = _load_jax_tool("dump_eval_set")
    state = np.random.get_state()
    try:
        outs = []
        for tool, name in ((tdump, "port"), (jdump, "jax")):
            np.random.set_state(state)
            outs.append(tool.dump_eval_set(prepared, ann, tmp_path / name,
                                           2048, seed=3))
            outs.append(np.random.get_state())
    finally:
        np.random.set_state(state)
    assert_same(outs[1], outs[3])  # both drew the same stream to its end
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    ds = PresampledScanNetScenes(tmp_path / "port")
    assert ds.num_points == 2048 and len(ds) == 2
    for scene in ds.scenes:
        assert scene.points.shape == (2048, 4) and scene.points.dtype == np.float32
        assert len(scene.boxes) == len(scene.labels) > 0


def test_train_test_round_trip_on_prepared_infos(prepared, tmp_path,
                                                 capsys):
    """pretrain (1 epoch) then test, student and teacher, on the infos
    the port's create_data wrote; and on a presampled dump of them."""
    work = tmp_path / "work"
    name = "nesie-votenet-scannet-pretrain-010"
    ttrain.main([name, "--data-root", str(prepared), "--work-dir", str(work),
                 "--device", "cpu", "--cfg-options", *MODEL16,
                 "optim.max_epochs=1", "data.repeat=1",
                 "data.samples_per_step=2", "log_interval=1"])
    ckpt = work / name / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["1"]
    common = [name, str(ckpt), "--data-root", str(prepared), "--device",
              "cpu", "--batch-size", "2", "--cfg-options", *MODEL16]
    for extra in ([], ["--teacher"]):
        res = ttest.main(common + extra)
        for k in ("mAP_0.25", "mAR_0.25", "mAP_0.50"):
            assert 0.0 <= res[k] <= 1.0, k
    dump = tdump.main(["--data-root", str(prepared), "--out",
                       str(tmp_path / "dump"), "--num-points", "1024"])
    res = ttest.main(common + ["--presampled", str(dump)])
    assert "mAP_0.25" in capsys.readouterr().out
    assert 0.0 <= res["mAP_0.25"] <= 1.0
