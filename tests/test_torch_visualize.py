"""The port's visualiser, ``apis.show_result_meshlab`` and
``tools/demo.py`` against the JAX package's (CPU, where cv2, matplotlib
and imageio are installed).

* ``.obj`` files: vertices parsed as floats within 1e-6 (box corners are
  float32 on both sides, rotated by torch's einsum here and by XLA's
  there), ``l`` lines and colours equal.
* ``Visualizer.render`` (boxes with yaw, points-in-box recolouring,
  ``xyzrgb``, ``rot_axis`` 1, ``camera_bottom``, ``add_seg_mask``) and
  ``show_pts_boxes``: identical images.
* ``project_pts_on_img`` and ``draw_bbox3d_on_img``: identical images.
* ``show_result_meshlab``: the same files, with the same contents.
* ``tools/demo.py`` on the same ``.npy`` cloud and weights (a reference
  ``.pth``; JAX serves a checkpoint of the same weights, its Pallas
  kernels in interpret mode): the same printed detections and ``.obj``
  files, the predicted boxes' corners within the detections' atol 1e-4
  (two float32 forwards).
"""
import importlib.util
import re
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.apis as japis
import nesie_tpu.config as jconfig
import nesie_tpu.eval.visualize as jvis
import nesie_tpu.ops.pointops as jpo
import nesie_tpu.train.runner as jrunner
import nesie_tpu_torch.apis as tapis
import nesie_tpu_torch.config as tconfig
import nesie_tpu_torch.eval.visualize as tvis
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.train.state import create_train_state
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_flax_
from nesie_tpu_torch.tools import demo as tdemo

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from torch_ref_model import (  # noqa: E402
    build_ref_named_model,
    save_reference_checkpoint,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _scene(seed=0, n=3000, k=4):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3, -3, 0], [3, 3, 2.5], (n, 3))
    boxes = np.concatenate([rng.uniform([-2, -2, 0.3], [2, 2, 1.0], (k, 3)),
                            rng.uniform(0.5, 1.5, (k, 3)),
                            rng.uniform(-np.pi, np.pi, (k, 1))], 1)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float64)
    return pts, boxes, rgb


def _parse_obj(path):
    verts, lines = [], []
    for row in Path(path).read_text().splitlines():
        tag, *vals = row.split()
        if tag == "v":
            verts.append([float(v) for v in vals])
        else:
            assert tag == "l"
            lines.append(tuple(vals))
    return np.array(verts), lines


def assert_same_obj(got, want, atol=1e-6):
    gv, gl = _parse_obj(got)
    wv, wl = _parse_obj(want)
    assert gv.shape == wv.shape and gl == wl
    np.testing.assert_allclose(gv, wv, atol=atol, rtol=0)


def assert_same_image(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_obj_writers_match_jax(tmp_path):
    pts, boxes, rgb = _scene()
    for mod, name in ((tvis, "port"), (jvis, "jax")):
        d = tmp_path / name
        d.mkdir()
        mod.write_points_obj(d / "points.obj", pts)
        mod.write_points_obj(d / "colored.obj", pts, colors=rgb)
        mod.write_boxes_obj(d / "boxes.obj", boxes)
    for f in ("points.obj", "colored.obj", "boxes.obj"):
        assert_same_obj(tmp_path / "port" / f, tmp_path / "jax" / f)
    _, lines = _parse_obj(tmp_path / "port" / "boxes.obj")
    assert len(lines) == 12 * len(boxes)


VIS_CASES = {
    "boxes": dict(),
    "xyzrgb": dict(mode="xyzrgb"),
    "rot_axis_1": dict(rot_axis=1, center_mode="camera_bottom"),
    "seg_mask": dict(seg=True),
}


@pytest.mark.parametrize("case", list(VIS_CASES))
def test_visualizer_render_matches_jax(case):
    kw = dict(VIS_CASES[case])
    seg = kw.pop("seg", False)
    pts, boxes, rgb = _scene(1)
    cloud = np.concatenate([pts, rgb], 1) if kw.get("mode") else pts
    imgs = []
    for mod in (tvis, jvis):
        vis = mod.Visualizer(cloud, bbox3d=boxes, width=320, height=240, **kw)
        vis.add_bboxes(boxes[:2] + [0.1, 0, 0, 0, 0, 0, 0.2],
                       bbox_color=(0, 0, 1))
        if seg:
            vis.add_seg_mask(np.concatenate([pts, rgb], 1))
        imgs.append(vis.render())
    assert imgs[0].shape == (240, 320, 3) and imgs[0].dtype == np.uint8
    assert len(np.unique(imgs[0].reshape(-1, 3), axis=0)) > 3
    assert_same_image(*imgs)


def test_show_pts_boxes_matches_jax(tmp_path):
    pts, boxes, _ = _scene(2)
    got = tvis.show_pts_boxes(pts, boxes, save_path=tmp_path / "port.png")
    want = jvis.show_pts_boxes(pts, boxes, save_path=tmp_path / "jax.png")
    assert got.shape == (600, 800, 3)
    assert_same_image(got, want)
    from matplotlib import image as mpimg

    assert_same_image(mpimg.imread(tmp_path / "port.png"),
                      mpimg.imread(tmp_path / "jax.png"))


def _camera():
    """A pinhole 4x4 projection looking along +y from 6 m back."""
    k = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]])
    rt = np.array([[1.0, 0, 0, 0], [0, 0, -1, 1.0], [0, 1, 0, 6.0]])
    proj = np.eye(4)
    proj[:3] = k @ rt
    return proj


def test_image_projections_match_jax():
    pts, boxes, _ = _scene(3)
    img = np.random.default_rng(0).integers(0, 256, (240, 320, 3),
                                            dtype=np.uint8)
    proj = _camera()
    got = tvis.project_pts_on_img(pts, img, proj)
    assert (got != img).any()
    assert_same_image(got, jvis.project_pts_on_img(pts, img, proj))
    got = tvis.draw_bbox3d_on_img(boxes, img, proj, thickness=2)
    assert (got != img).any()
    assert_same_image(got, jvis.draw_bbox3d_on_img(boxes, img, proj,
                                                   thickness=2))


def test_show_result_meshlab_matches_jax(tmp_path):
    pts, boxes, _ = _scene(4)
    img = np.zeros((240, 320, 3), np.uint8)
    seg = np.random.default_rng(1).integers(0, 5, len(pts))
    kw = dict(points=pts, gt_boxes=boxes[:2], pred_boxes=boxes, img=img,
              proj=_camera(), seg_labels=seg)
    got = tapis.show_result_meshlab(tmp_path / "port", "scene", **kw)
    want = japis.show_result_meshlab(tmp_path / "jax", "scene", **kw)
    files = sorted(p.name for p in want.iterdir())
    assert files == sorted(p.name for p in got.iterdir())
    assert files == ["scene_gt.obj", "scene_points.obj", "scene_pred.obj",
                     "scene_pred_img.png", "scene_seg.obj"]
    for f in files[:3] + files[4:]:
        assert_same_obj(got / f, want / f)
    import imageio.v3 as iio

    assert_same_image(iio.imread(got / files[3]), iio.imread(want / files[3]))


MODEL128 = dict(num_proposal=128, reg_max=8, num_points=(256, 128, 128, 128),
                num_samples=(8, 8, 4, 4),
                sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                             (32, 32, 32)),
                fp_channels=((32, 32), (32, 32)))
DEMO_OVER = [f"model.{k}={v}" for k, v in MODEL128.items()] + [
    "model.sizes=(1.0,1.0,1.0)", "data.num_points=1024"]
DEMO_CONFIG = "nesie-votenet-scannet-train-010"


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _detections(out: str):
    lines = [l for l in out.splitlines() if not l.startswith("wrote ")]
    assert re.match(r"\d+ detections above 0.3", lines[0]), lines
    return lines


def test_demo_matches_jax(tmp_path, capsys, monkeypatch):
    """Both demos on a tiny model (the config with ``DEMO_OVER``, served
    through each package's ``get_config``): the port from a reference
    ``.pth``, JAX from a checkpoint of the same weights."""
    from jax.experimental import pallas as pl

    port = VoteNetNesie(**MODEL128)
    init_weights_flax_(port, torch.Generator().manual_seed(0))
    ref = build_ref_named_model(sa_channels=MODEL128["sa_channels"],
                                fp_channels=MODEL128["fp_channels"],
                                reg_max=MODEL128["reg_max"])
    shapes = {k: v.shape for k, v in ref.state_dict().items()}
    ref.load_state_dict({k: v.reshape(shapes[k])
                         for k, v in port.state_dict().items()})
    with torch.no_grad():  # the "object" and the first class's logits:
        # scores above 0.3
        ref.get_parameter("bbox_head.conv_pred.conv_cls.bias")[[1, 2]] += 4.0
    pth = tmp_path / "ref.pth"
    save_reference_checkpoint(ref, pth)

    for mod, owner in ((jconfig, japis), (tconfig, tapis)):
        real = mod.get_config
        monkeypatch.setattr(owner, "get_config", lambda name, real=real,
                            mod=mod: mod.apply_overrides(real(name),
                                                         DEMO_OVER))
    # JAX's checkpoint of the same weights (as its import tool writes
    # one, without the tool's model init)
    jcfg = japis.get_config(DEMO_CONFIG)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    params["bbox_head"]["conv_pred"]["conv_cls"]["bias"][[1, 2]] += 4.0
    jnp_tree = partial(jax.tree.map, jnp.asarray)
    state = create_train_state(
        {"params": jnp_tree(params), "batch_stats": jnp_tree(stats)},
        jrunner._make_tx(jcfg.optim, 1))
    ckpt = jrunner.CheckpointManager(tmp_path / "jax_work")
    ckpt.save(0, state, meta={"mesh_size": 1})
    ckpt.mgr.wait_until_finished()
    jdir = tmp_path / "jax_work" / "checkpoints"
    # JAX's init_detector restores into init_state's tree; a tree of the
    # same structure saves its model init (the restore replaces every leaf)
    monkeypatch.setattr(jrunner, "init_state",
                        lambda cfg, model, steps_per_epoch: (state, None))
    rng = np.random.default_rng(5)
    cloud = np.concatenate([rng.uniform([-3, -3, 0], [3, 3, 0.02], (3000, 3)),
                            rng.uniform([-1, -1, 0], [1, 1, 1.2], (2000, 3))])
    npy = tmp_path / "cloud.npy"
    np.save(npy, cloud.astype(np.float32))

    tdemo.main([DEMO_CONFIG, str(npy), "--checkpoint", str(pth),
                "--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = _detections(capsys.readouterr().out)
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")
    monkeypatch.setattr(sys, "argv", [
        "demo.py", DEMO_CONFIG, str(npy), "--checkpoint", str(jdir),
        "--out-dir", str(tmp_path / "jax")])
    _load_jax_tool("demo").main()
    want = _detections(capsys.readouterr().out)
    assert got == want
    assert int(got[0].split()[0]) > 0
    out = (tmp_path / "port" / "cloud", tmp_path / "jax" / "cloud")
    assert_same_obj(*(d / "cloud_points.obj" for d in out))
    # the boxes come from two float32 forwards: within the detections'
    # atol 1e-4
    assert_same_obj(*(d / "cloud_pred.obj" for d in out), atol=1e-4)
