"""The port's eval slice against the JAX package, end to end on the CPU:
the tiny VoteNetNesie forward, decode + NMS, the per-class expansion, and
one ``Detector`` request.

SA sample counts and the proposal count are multiples of 128, so the JAX
side takes its Pallas ball query (run in interpret mode, as are its FPS
and three-NN kernels); neighbour indices then agree exactly with the
port's plain versions. Float outputs: atol 1e-4, rtol 1e-4 (float32
matmuls summed in another order).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.ops.pointops as jpo
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.data import io
from nesie_tpu.eval import postprocess as jpost
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.config import InferenceConfig
from nesie_tpu_torch.eval import postprocess as tpost
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(
    reg_max=8,
    num_proposal=128,
    num_points=(256, 128, 128, 128),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
N_POINTS = 1024
JAX_KEYS = ("bbox_preds", "obj_scores", "sem_scores", "iou_scores",
            "side_scores", "seed_indices", "aggregated_points")


def _room(rng, n):
    """A cloud in a 3 x 3 x 1.5 m room with the height channel."""
    xyz = rng.uniform(size=(n, 3)) * np.array([3.0, 3.0, 1.5])
    return xyz.astype(np.float32)


@pytest.fixture(scope="module")
def slice_setup():
    """Seeded port weights converted to flax, and a jitted JAX forward
    with the Pallas kernels in interpret mode."""
    from jax.experimental import pallas as pl

    src = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(0)
    init_weights_(src, gen)
    randomize_bn_(src, gen)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    variables = {"params": params, "batch_stats": stats}
    jmodel = JVoteNetNesie(**TINY)

    def forward(v, pts):
        out = jmodel.apply(v, pts, "seed", jax.random.PRNGKey(0),
                           train=False, with_jitter=False)
        return {k: out[k] for k in JAX_KEYS}

    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
            mp.setattr(jpo, name, "pallas")
        yield variables, jax.jit(forward)


def _points(seed):
    rng = np.random.default_rng(seed)
    return np.stack([io.add_height(_room(rng, N_POINTS)) for _ in range(2)])


@pytest.fixture(scope="module")
def both_forwards(slice_setup):
    variables, jforward = slice_setup
    pts = _points(1)
    want = jforward(variables, jnp.asarray(pts))
    det = init_detector(variables, device="cpu", **TINY)
    with torch.no_grad():
        got = det.model(torch.from_numpy(pts))
    return pts, want, got


def test_forward_matches_jax(both_forwards):
    _, want, got = both_forwards
    for k in JAX_KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def _jax_decode(out, pts):
    return jax.tree.map(np.asarray, jpost.decode_and_nms(
        {k: jnp.asarray(np.asarray(v)) for k, v in out.items()},
        jnp.asarray(pts)))


def test_decode_and_nms_matches_jax(both_forwards):
    """The port's decode on the JAX head outputs gives the JAX keep mask;
    on its own outputs it gives the same mask too."""
    pts, want, got = both_forwards
    jdec = _jax_decode(want, pts)
    assert jdec["selected"].any(axis=1).all()  # the check is not vacuous
    from_jax = tpost.decode_and_nms(
        {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
        torch.from_numpy(pts))
    own = tpost.decode_and_nms(got, torch.from_numpy(pts))
    for dec in (from_jax, own):
        np.testing.assert_array_equal(dec["selected"].numpy(),
                                      jdec["selected"])
        for k in ("bbox", "obj_scores", "sem_scores"):
            np.testing.assert_allclose(dec[k].numpy(), jdec[k], err_msg=k,
                                       **TOL)


def test_expand_per_class_matches_jax(both_forwards):
    pts, want, _ = both_forwards
    dec = {k: v[0] for k, v in _jax_decode(want, pts).items()}
    for g, w in zip(tpost.expand_per_class(dec), jpost.expand_per_class(dec)):
        np.testing.assert_array_equal(g, w)


def test_detector_request_matches_jax(slice_setup):
    """One Detector call on a raw numpy cloud equals the JAX pipeline on
    the same sampled points (the JAX forward runs the cloud twice to reuse
    its compiled batch of two)."""
    variables, jforward = slice_setup
    cloud = _room(np.random.default_rng(2), 3000)
    cfg = InferenceConfig(num_points=N_POINTS)
    det = init_detector(variables, device="cpu", cfg=cfg, **TINY)
    got = det(cloud)

    pts = io.sample_points(io.add_height(cloud), N_POINTS,
                           np.random.default_rng(cfg.seed))
    pts = np.stack([pts, pts])
    dec = _jax_decode(jforward(variables, jnp.asarray(pts)), pts)
    boxes, scores, labels = jpost.expand_per_class(
        {k: v[0] for k, v in dec.items()})
    assert len(boxes) > 0
    np.testing.assert_array_equal(got["labels_3d"], labels)
    np.testing.assert_allclose(got["boxes_3d"], boxes, **TOL)
    np.testing.assert_allclose(got["scores_3d"], scores, **TOL)


def test_port_never_imports_jax():
    """Neither jax nor the JAX package is loaded by the port."""
    code = ("import sys, nesie_tpu_torch.apis, nesie_tpu_torch.ops, "
            "nesie_tpu_torch.train.semi, nesie_tpu_torch.train.step, "
            "nesie_tpu_torch.data.synthetic, "
            "nesie_tpu_torch.tools.fps_cluster_sweep, "
            "nesie_tpu_torch.tools.fps_onchip_sweep, "
            "nesie_tpu_torch.tools.fps_step_split, "
            "nesie_tpu_torch.tools.profile_train_step, "
            "nesie_tpu_torch.ops.fps_variants, "
            "nesie_tpu_torch.tools.fps_lab, "
            "nesie_tpu_torch.tools.fps_experiments, "
            "nesie_tpu_torch.config, nesie_tpu_torch.utils, "
            "nesie_tpu_torch.train.runner, nesie_tpu_torch.data.dataset, "
            "nesie_tpu_torch.data.prefetch, "
            "nesie_tpu_torch.data.native_loader, "
            "nesie_tpu_torch.data.scannet_meta, nesie_tpu_torch.eval, "
            "nesie_tpu_torch.eval.np_iou, nesie_tpu_torch.eval.indoor_eval, "
            "nesie_tpu_torch.eval.iou_opt, "
            "nesie_tpu_torch.tools.train, nesie_tpu_torch.tools.test, "
            "nesie_tpu_torch.tools.validation_run, "
            "nesie_tpu_torch.nn.saqe_head, "
            "nesie_tpu_torch.nn.quality_estimation, "
            "nesie_tpu_torch.train.saqe_loss, nesie_tpu_torch.parallel, "
            "nesie_tpu_torch.parallel.launch, nesie_tpu_torch.nn.vote_head, "
            "nesie_tpu_torch.nn.segmentor, nesie_tpu_torch.ops.paconv, "
            "nesie_tpu_torch.losses.consistency, nesie_tpu_torch.eval.tta, "
            "nesie_tpu_torch.eval.seg_metrics, "
            "nesie_tpu_torch.train.votehead_loss, "
            "nesie_tpu_torch.data.scannet_prep, "
            "nesie_tpu_torch.data.sunrgbd_prep, "
            "nesie_tpu_torch.tools.create_data, "
            "nesie_tpu_torch.tools.dump_eval_set, "
            "nesie_tpu_torch.tools.import_torch_ckpt, "
            "nesie_tpu_torch.tools.demo, nesie_tpu_torch.eval.visualize, "
            "nesie_tpu_torch.convert, nesie_tpu_torch.core, "
            "nesie_tpu_torch.losses, nesie_tpu_torch.nn.heads, "
            "nesie_tpu_torch.nn.layers, nesie_tpu_torch.train.state; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'flax', 'nesie_tpu') "
            "or m.startswith(('jax.', 'flax.', 'nesie_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
