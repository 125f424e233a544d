"""Shared set-up of the port's training parity tests (no tests here).

The end-to-end train steps are compared in float64 on both sides. In
float32 the train-mode BatchNorm (batch statistics, flax's fast variance)
amplifies the two frameworks' different summation orders until the
quality module's outputs differ by more than 1e-4 for most proposals of a
tiny model (286 of 384 IoU scores in one teacher forward), and a neighbour
search then flips on a near-tie. In float64 both sides agree to far below
the stated tolerances, so a comparison fails only on a real difference.

The Pallas kernels do not trace with x64 enabled (their loop carries turn
int64), so in float64 the JAX model takes its neighbour indices from the
jnp functions below, on float32 copies of the coordinates. They have the
Pallas kernels' semantics (exact ``(a-b)^2`` distances in float32, first
index on ties), which ``tests/test_torch_pointops.py`` holds the port's
plain versions to against the Pallas kernels in interpret mode; the
package's own XLA versions use the matmul distance form instead. The
three-NN distances are recomputed from the indices, as the JAX package's
Pallas branch does, so they stay differentiable.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.nn.pointnet2 as jpointnet2
import nesie_tpu.nn.side_pooling as jside_pooling
from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.ops.pointops import group_points as jgroup_points
from nesie_tpu_torch.convert import state_dict_from_flax
from nesie_tpu_torch.data import io
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_

TINY = dict(
    reg_max=8,
    num_proposal=128,
    num_points=(256, 128, 128, 128),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)
N_POINTS, MAX_GT = 1024, 8
AUG_FIELDS = ("flip_h", "flip_v", "rot", "scale", "trans")


def _sq(a, b):
    """Exact squared distances in float32: a (B, M, 3), b (B, N, 3) ->
    (B, M, N), ((dx*dx + dy*dy) + dz*dz), no gradient."""
    a = jax.lax.stop_gradient(a).astype(jnp.float32)
    b = jax.lax.stop_gradient(b).astype(jnp.float32)
    d = a[:, :, None, :] - b[:, None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def j_fps(xyz, num_samples, valid_mask=None):
    assert valid_mask is None
    b, n, _ = xyz.shape
    x = jax.lax.stop_gradient(xyz).astype(jnp.float32)

    def body(i, carry):
        dist, out, last = carry
        p = jnp.take_along_axis(x, last[:, None, None], axis=1)
        dist = jnp.minimum(dist, _sq(p, x)[:, 0])
        nxt = jnp.argmax(dist, axis=-1).astype(jnp.int32)
        return dist, out.at[:, i].set(nxt), nxt

    init = (jnp.full((b, n), 1e10, jnp.float32),
            jnp.zeros((b, num_samples), jnp.int32), jnp.zeros((b,), jnp.int32))
    return jax.lax.fori_loop(1, num_samples, body, init)[1]


def j_ball_query(xyz, centers, radius, num_samples, min_radius=0.0,
                 valid_mask=None, **_):
    assert valid_mask is None
    d2 = _sq(centers, xyz)
    ok = (d2 <= 0) | ((d2 >= np.float32(min_radius * min_radius))
                      & (d2 < np.float32(radius * radius)))
    n = d2.shape[-1]
    order = jnp.where(ok, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    first_k = jnp.sort(order, axis=-1)[..., :num_samples]
    count = jnp.sum(ok, axis=-1, keepdims=True, dtype=jnp.int32)
    slot = jnp.arange(num_samples, dtype=jnp.int32)
    idx = jnp.where(slot < count, first_k, first_k[..., :1])
    return jnp.where(count == 0, jnp.int32(0), idx).astype(jnp.int32)


def j_three_nn(query, source, valid_mask=None, **_):
    assert valid_mask is None
    idx = jnp.argsort(_sq(query, source), axis=-1, stable=True)[..., :3]
    idx = idx.astype(jnp.int32)
    d = query[:, :, None, :] - jgroup_points(source, idx)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return jnp.sqrt(jnp.maximum(d2, 0.0)), idx


@contextlib.contextmanager
def jax_float64(x64: bool = True):
    """x64 on (off with ``x64=False``), the JAX model's neighbour searches
    on the jnp versions."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
        mp.setattr(jpointnet2, "furthest_point_sample", j_fps)
        mp.setattr(jpointnet2, "ball_query", j_ball_query)
        mp.setattr(jpointnet2, "three_nn", j_three_nn)
        mp.setattr(jside_pooling, "three_nn", j_three_nn)
        yield


def to64(tree):
    """Every floating leaf of a (nested dict) tree as float64 numpy."""
    if isinstance(tree, dict):
        return {k: to64(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def weights(seed=0):
    """Seeded port weights with randomised BN: (params, batch_stats) as
    the JAX package's float64 trees, and the port model (float64)."""
    src = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(seed)
    init_weights_(src, gen)
    randomize_bn_(src, gen)
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    model = VoteNetNesie(**TINY)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return to64(params), to64(stats), model.double()


def scenes(seed, b, views=1):
    """Scenes of boxes on a floor: per scene ``views`` independent point
    samples (N_POINTS, 4) with the height channel, and padded GT (5 valid
    bottom-centered boxes). Returns (points (views, b, N, 4), boxes,
    labels, valid), float64 points and boxes."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, MAX_GT, 7))
    labels = np.zeros((b, MAX_GT), np.int32)
    valid = np.zeros((b, MAX_GT), bool)
    pts = np.zeros((views, b, N_POINTS, 4))
    for i in range(b):
        k = 5
        c = rng.uniform([0.5, 0.5, 0.0], [2.5, 2.5, 0.0], (k, 3))
        s = rng.uniform(0.3, 0.9, (k, 3))
        boxes[i, :k] = np.concatenate([c, s, rng.uniform(-0.3, 0.3, (k, 1))],
                                      -1)
        labels[i, :k] = rng.integers(0, 18, k)
        valid[i, :k] = True
        for v in range(views):
            which = rng.integers(0, k, N_POINTS // 2)
            obj = c[which] + rng.uniform(-0.5, 0.5, (N_POINTS // 2, 3)) \
                * s[which]
            obj[:, 2] = np.abs(obj[:, 2])
            floor = rng.uniform([0, 0, 0], [3, 3, 0.05], (N_POINTS // 2, 3))
            p = np.concatenate([obj, floor])[rng.permutation(N_POINTS)]
            pts[v, i] = io.add_height(p)
    return pts, boxes, labels, valid


def sample_aug(rng, b):
    """Strong-view augmentation parameters, float64 (numpy dict)."""
    return dict(flip_h=rng.uniform(size=b) < 0.5,
                flip_v=rng.uniform(size=b) < 0.5,
                rot=rng.uniform(-np.pi / 36, np.pi / 36, b),
                scale=rng.uniform(0.85, 1.15, b),
                trans=rng.normal(size=(b, 3)) * 0.1)


def identity_aug(b):
    return dict(flip_h=np.zeros(b, bool), flip_v=np.zeros(b, bool),
                rot=np.zeros(b), scale=np.ones(b), trans=np.zeros((b, 3)))


def jitter_noise(key, shape):
    """The two normal draws of the JAX head's ``jitter_boxes`` under
    ``key`` (the head splits its key, then jitter_boxes splits again), as
    torch tensors. Call inside ``jax_float64``."""
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                 for k in (k1, k2))


def record_grads():
    """An optax stage that keeps the raw gradients in its state."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (g, g))


def assert_state_dicts_close(got: dict, want: dict, tol: dict):
    """Every entry of ``want`` (numpy or torch) against ``got`` (torch),
    BN batch counters aside."""
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                   err_msg=k, **tol)
