"""The port's point ops (plain PyTorch versions, as CPU tensors take them)
against the JAX package's ops on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, selected through
``pointops._FPS_IMPL/_BQ_IMPL/_3NN_IMPL``: those kernels and the port use
the same exact ``(a-b)^2`` distance, so integer outputs must be identical.
Float outputs: atol 1e-6 (float32 sums of three terms, summed in another
order at most).
"""
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.ops.pointops as jpo
from nesie_tpu_torch.ops import _build
from nesie_tpu_torch.ops import pointops as tpo

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fps_cases():
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1)
    grid = grid.reshape(1, -1, 3)  # integer lattice: many exact ties
    dup = rng.uniform(size=(2, 150, 3))
    dup = np.concatenate([dup, dup], axis=1)  # every point twice
    return {
        "normal": (rng.normal(size=(2, 300, 3)), 64),
        "lattice_ties": (grid, 100),
        "duplicates": (dup, 200),
    }


@pytest.mark.parametrize("case", ["normal", "lattice_ties", "duplicates"])
def test_fps_matches_pallas(pallas_interpret, case):
    xyz, m = _fps_cases()[case]
    xyz = xyz.astype(np.float32)
    want = jax.jit(partial(jpo.furthest_point_sample, num_samples=m))(
        jnp.asarray(xyz))
    got = tpo.furthest_point_sample(_t(xyz), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bq_cases():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(size=(2, 300, 3)).astype(np.float32)
    far = xyz[:, :128] + 10.0  # no source within any radius
    mixed = np.concatenate([xyz[:, :64], far[:, :64]], axis=1)
    return {
        # centers are source points: each has a d2 == 0 hit
        "dup_centers": (xyz, xyz[:, :128], 0.2, 8, 0.0),
        "no_neighbour": (xyz, mixed, 0.15, 6, 0.0),
        "min_radius": (xyz, xyz[:, 128:256], 0.3, 16, 0.1),
        "saturated": (xyz, rng.uniform(size=(2, 128, 3)), 0.5, 4, 0.0),
    }


@pytest.mark.parametrize(
    "case", ["dup_centers", "no_neighbour", "min_radius", "saturated"])
def test_ball_query_matches_pallas(pallas_interpret, case):
    xyz, centers, radius, k, min_r = _bq_cases()[case]
    centers = centers.astype(np.float32)
    fn = jax.jit(partial(jpo.ball_query, radius=radius, num_samples=k,
                         min_radius=min_r))
    want = np.asarray(fn(jnp.asarray(xyz), jnp.asarray(centers)))
    got = tpo.ball_query(_t(xyz), _t(centers), radius, k, min_radius=min_r)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "no_neighbour":
        assert (got[:, 64:] == 0).all()


def test_ball_query_ref_chunks_agree(monkeypatch):
    """The plain version's chunking over centers changes nothing."""
    # the package exports the function under the module's name
    bq = importlib.import_module("nesie_tpu_torch.ops.ball_query")

    rng = np.random.default_rng(2)
    xyz = _t(rng.uniform(size=(2, 200, 3)).astype(np.float32))
    centers = _t(rng.uniform(size=(2, 50, 3)).astype(np.float32))
    whole = bq.ball_query_ref(xyz, centers, 0.3, 8)
    monkeypatch.setattr(bq, "_CHUNK_ELEMENTS", 2 * 200 * 7)  # chunks of 7
    np.testing.assert_array_equal(
        bq.ball_query_ref(xyz, centers, 0.3, 8).numpy(), whole.numpy())


@pytest.mark.parametrize("case", ["normal", "duplicate_sources"])
def test_three_nn_matches_pallas(pallas_interpret, case):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 300, 3)).astype(np.float32)
    s = rng.normal(size=(2, 200, 3)).astype(np.float32)
    if case == "duplicate_sources":
        s[:, 100:] = s[:, :100]  # every source twice: ties at each rank
        q[:, :50] = s[:, :50]    # queries on top of a duplicated source
    want_d, want_i = jax.jit(jpo.three_nn)(jnp.asarray(q), jnp.asarray(s))
    got_d, got_i = tpo.three_nn(_t(q), _t(s))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-6,
                               rtol=0)
    if case == "duplicate_sources":
        np.testing.assert_array_equal(got_i[:, :50, 0].numpy(),
                                      np.arange(50)[None].repeat(2, 0))
        np.testing.assert_array_equal(got_i[:, :50, 1].numpy(),
                                      np.arange(100, 150)[None].repeat(2, 0))


def test_gather_group_interpolate_match_jax():
    rng = np.random.default_rng(4)
    data = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, size=(2, 12)).astype(np.int32)
    gidx = rng.integers(0, 40, size=(2, 12, 3)).astype(np.int32)
    w = rng.uniform(size=(2, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tpo.gather_points(_t(data), _t(idx)).numpy(),
        np.asarray(jpo.gather_points(jnp.asarray(data), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tpo.group_points(_t(data), _t(gidx)).numpy(),
        np.asarray(jpo.group_points(jnp.asarray(data), jnp.asarray(gidx))))
    np.testing.assert_allclose(
        tpo.three_interpolate(_t(data), _t(gidx), _t(w)).numpy(),
        np.asarray(jpo.three_interpolate(jnp.asarray(data), jnp.asarray(gidx),
                                         jnp.asarray(w))),
        atol=1e-6, rtol=0)


def test_cpu_tensors_take_plain_versions():
    """CPU tensors never reach a kernel: no build, no launch counted."""
    _build.reset_launch_counts()
    rng = np.random.default_rng(5)
    xyz = _t(rng.uniform(size=(1, 64, 3)).astype(np.float32))
    idx = tpo.furthest_point_sample(xyz, 16)
    centers = tpo.gather_points(xyz, idx)
    tpo.ball_query(xyz, centers, 0.3, 4)
    tpo.three_nn(centers, xyz)
    assert _build.launch_counts() == {"fps": 0, "ball_query": 0,
                                      "three_nn": 0}
    assert _build._lib is None


def test_three_nn_distance_is_differentiable():
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(1, 8, 3)).astype(np.float32)).requires_grad_()
    s = _t(rng.normal(size=(1, 16, 3)).astype(np.float32))
    dist, _ = tpo.three_nn(q, s)
    dist.sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
