"""Shared set-up of the point-based tail's parity tests (no tests here):
``tests/test_torch_votehead.py`` and ``tests/test_torch_segmentor.py``.

Weights: a flax module is initialised from a seed, its norm affines and
BN running statistics are drawn away from 1 / 0 (so that a comparison
exercises every tensor), and the port module is loaded from those numpy
variables through ``state_dict_from_flax`` / ``module_state_dict_from_flax``.
Both sides then take the same seeded numpy inputs.

The JAX side runs its XLA point ops on the CPU, as its own tests do; the
``pallas_interpret`` fixture switches one case of each module to the
Pallas kernels in interpret mode. In float64 (``jax_float64``) it takes
the exact jnp neighbour searches of ``test_torch_train_support``, since
the Pallas kernels do not trace with x64.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nesie_tpu.nn.vote_head as jvote_head
import nesie_tpu.ops.pointops as jpo
import test_torch_train_support as S

TOL = dict(atol=1e-4, rtol=1e-4)     # float32 forwards
TOL64 = dict(atol=1e-12, rtol=1e-9)  # float64 losses and gradients


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    for name in ("_FPS_IMPL", "_BQ_IMPL", "_3NN_IMPL"):
        monkeypatch.setattr(jpo, name, "pallas")


@contextlib.contextmanager
def jax_float64():
    """x64 on, the JAX modules' neighbour searches (the backbone's, the
    VoteHead's seed FPS) on the exact jnp versions."""
    with S.jax_float64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvote_head, "furthest_point_sample", S.j_fps)
        yield


def _numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _randomize(tree, rng):
    """Norm affines (dicts with ``scale`` and ``bias``) and running
    statistics (``mean`` and ``var``) drawn away from 1 / 0, in place."""
    for v in tree.values():
        if isinstance(v, dict):
            _randomize(v, rng)
    if "scale" in tree and "bias" in tree:
        tree["scale"] = (1.0 + rng.uniform(-0.5, 0.5, tree["scale"].shape)
                         ).astype(np.float32)
        tree["bias"] = rng.uniform(-0.5, 0.5, tree["bias"].shape
                                   ).astype(np.float32)
    if "mean" in tree and "var" in tree:
        tree["mean"] = rng.uniform(-0.5, 0.5, tree["mean"].shape
                                   ).astype(np.float32)
        tree["var"] = (1.0 + rng.uniform(-0.5, 0.5, tree["var"].shape)
                       ).astype(np.float32)


def flax_variables(module, *args, seed=0, **kwargs):
    """(params, batch_stats) of ``module.init`` as numpy trees, the norms
    randomised; batch_stats {} for a module without BN."""
    v = _numpy(module.init(jax.random.PRNGKey(seed), *args, **kwargs))
    rng = np.random.default_rng(seed + 1000)
    params, stats = v["params"], v.get("batch_stats", {})
    _randomize(params, rng)
    _randomize(stats, rng)
    return params, stats


def jvars(params, stats):
    return {"params": params, "batch_stats": stats}


def t32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol=TOL, msg=""):
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(g), np.asarray(want), err_msg=msg,
                               **tol)


def to64(tree):
    return S.to64(tree)


def grads_by_name(model: torch.nn.Module) -> dict:
    return {k: p.grad for k, p in model.named_parameters()}


def to_port64(convert, params, stats=None) -> dict:
    """``convert(params[, stats])`` (a flax -> port mapping, which casts to
    float32) of float64 trees, to float64: the mapping only moves and
    transposes, so it is applied to the float32 head and to the float32
    remainder of every leaf, and the two are summed in float64."""
    def split(tree):
        hi = jax.tree.map(lambda a: np.asarray(a, np.float64).astype(
            np.float32), tree)
        lo = jax.tree.map(lambda a, h: (np.asarray(a, np.float64) - h).astype(
            np.float32), tree, hi)
        return hi, lo

    ph, pl = split(params)
    if stats is None:
        a, b = convert(ph), convert(pl)
    else:
        sh, sl = split(stats)
        a, b = convert(ph, sh), convert(pl, sl)
    return {k: a[k].double() + b[k].double() if a[k].is_floating_point()
            else a[k] for k in a}


def assert_grads_match(model, jgrads, sd_from_flax, tol=TOL64):
    """The port model's .grad against the JAX gradient tree mapped onto
    the port's names (``sd_from_flax(params-shaped tree)``, in float64);
    every parameter has a gradient on both sides."""
    want = to_port64(sd_from_flax, jax.tree.map(np.asarray, jgrads))
    got = grads_by_name(model)
    assert set(got) == set(want)
    for k, g in got.items():
        assert g is not None, k
        close(g, want[k], tol, msg=k)


def jnp64(a):
    return jnp.asarray(np.asarray(a, np.float64))
