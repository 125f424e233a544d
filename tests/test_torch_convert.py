"""Weights carried between the JAX package and the port.

``state_dict_from_flax`` and ``nesie_tpu.convert_torch.convert_state_dict``
must be exact inverses on the port's names, the port must load the result
with ``strict=True``, and a reference-named ``.pth`` (1x1 conv weights,
``ema_*`` buffers) must load into the port.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nesie_tpu.convert_torch import convert_state_dict
from nesie_tpu.nn.detector import VoteNetNesie as JVoteNetNesie
from nesie_tpu_torch.apis import init_detector
from nesie_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_, randomize_bn_

sys.path.insert(0, str(Path(__file__).parent / "helpers"))
from torch_ref_model import (  # noqa: E402
    build_ref_named_model,
    randomize_bn,
    register_ema_buffers,
    save_reference_checkpoint,
)

torch.set_num_threads(1)

TINY = dict(
    reg_max=8,
    num_proposal=16,
    num_points=(64, 32, 16, 16),
    num_samples=(8, 8, 4, 4),
    sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32), (32, 32, 32)),
    fp_channels=((32, 32), (32, 32)),
)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _random_flax_variables(seed=0):
    """The JAX model's variable tree (from its own init, traced only) with
    every leaf drawn at random."""
    model = JVoteNetNesie(**TINY)
    key = jax.random.PRNGKey(0)
    pts = jax.ShapeDtypeStruct((1, 256, 4), np.float32)
    shapes = jax.eval_shape(
        lambda p: model.init({"params": key}, p, "seed", key, train=False),
        pts)
    rng = np.random.default_rng(seed)

    def fill(tree, stats=False):
        return {k: fill(v, stats) if isinstance(v, dict) else (
            rng.uniform(0.5, 1.5, v.shape) if stats and k == "var"
            else rng.normal(size=v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return fill(shapes["params"]), fill(shapes["batch_stats"], stats=True)


def test_flax_to_port_to_flax_is_exact():
    params, stats = _random_flax_variables()
    model = VoteNetNesie(**TINY)
    sd = state_dict_from_flax(params, stats)
    model.load_state_dict(sd, strict=True)
    back_p, back_s = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    for want, got in ((params, back_p), (stats, back_s)):
        want, got = _flat(want), _flat(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_to_flax_to_port_is_exact():
    model = VoteNetNesie(**TINY)
    gen = torch.Generator().manual_seed(1)
    init_weights_(model, gen)
    randomize_bn_(model, gen)
    sd = model.state_dict()
    params, stats = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    back = state_dict_from_flax(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_params_only_tree_maps_onto_parameter_names():
    """A params-shaped tree (gradients, the EMA teacher) maps onto exactly
    the port's parameter names, the BN running statistics left out."""
    params, stats = _random_flax_variables(seed=2)
    model = VoteNetNesie(**TINY)
    sd = state_dict_from_flax(params)
    assert set(sd) == {n for n, _ in model.named_parameters()}
    full = state_dict_from_flax(params, stats)
    for k, v in sd.items():
        assert torch.equal(v, full[k]), k


def test_reference_pth_loads_into_port(tmp_path):
    """A reference-layout checkpoint (Conv1d/Conv2d weights with unit
    dims, teacher ema_* buffers) loads with strict=True, and the port's
    weights then convert to exactly what the reference tensors convert
    to."""
    ref = build_ref_named_model(
        sa_channels=TINY["sa_channels"], fp_channels=TINY["fp_channels"],
        reg_max=TINY["reg_max"])
    randomize_bn(ref, seed=0)
    register_ema_buffers(ref)
    path = tmp_path / "ref.pth"
    save_reference_checkpoint(ref, path)

    model = VoteNetNesie(**TINY)
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    ref_sd = {k: v.numpy() for k, v in ref.state_dict().items()
              if not k.startswith("ema_")}
    want = _flat(dict(zip(("params", "stats"), convert_state_dict(ref_sd))))
    got = _flat(dict(zip(("params", "stats"), convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("source", ["seed", "flax", "pth"])
def test_init_detector_weight_sources(tmp_path, source):
    if source == "seed":
        a = init_detector(None, device="cpu", seed=3, **TINY)
        b = init_detector(None, device="cpu", seed=3, **TINY)
        c = init_detector(None, device="cpu", seed=4, **TINY)
        sa, sb, sc = (d.model.state_dict() for d in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not all(torch.equal(sa[k], sc[k]) for k in sa)
        return
    if source == "flax":
        params, stats = _random_flax_variables(seed=5)
        det = init_detector({"params": params, "batch_stats": stats},
                            device="cpu", **TINY)
        want = state_dict_from_flax(params, stats)
    else:
        ref = build_ref_named_model(
            sa_channels=TINY["sa_channels"],
            fp_channels=TINY["fp_channels"], reg_max=TINY["reg_max"])
        path = tmp_path / "ref.pth"
        save_reference_checkpoint(ref, path)
        det = init_detector(path, device="cpu", **TINY)
        want = load_reference_state_dict(path)
    got = det.model.state_dict()
    assert not det.model.training
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
