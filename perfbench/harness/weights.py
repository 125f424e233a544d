"""Weights made on the device from the seed, by parameter name and shape.

One ``torch.randn`` call on a device generator fills every floating
tensor of a state dict; each tensor then takes its share, scaled by its
kind: a Linear weight (2-D) by 1/sqrt(fan_in); a Linear bias by 0.1 /
sqrt(fan_in) of the weight beside it; a BatchNorm layer (a module with a
``running_mean``) weight 1 + 0.1 u, bias 0.1 u, running mean 0.1 u and
running variance 1 + 0.1 |u|. The same dict is loaded into the port and
handed to the reference. Random, not trained.
"""
from __future__ import annotations

import torch


def spec(state_dict: dict) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every tensor of ``state_dict``, in order."""
    return [(k, tuple(v.shape), v.dtype) for k, v in state_dict.items()]


def make_weights(names: list[tuple[str, tuple, torch.dtype]],
                 gen: torch.Generator) -> dict:
    """A state dict for ``names`` (``spec``'s list) drawn from ``gen`` on
    its device."""
    bn = {n.rsplit(".", 1)[0] for n, _, _ in names
          if n.endswith(".running_mean")}
    floats = [(n, s) for n, s, d in names if d.is_floating_point]
    total = sum(_numel(s) for _, s in floats)
    flat = torch.randn(total, generator=gen, device=gen.device)
    fan_in = {n.rsplit(".", 1)[0]: s[1] for n, s in floats
              if n.endswith(".weight") and len(s) == 2}
    out, at = {}, 0
    for name, shape, dtype in names:
        if not dtype.is_floating_point:  # num_batches_tracked
            out[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
            continue
        u = flat[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        module, leaf = name.rsplit(".", 1)
        if module in bn:
            out[name] = {"weight": 1.0 + 0.1 * u, "bias": 0.1 * u,
                         "running_mean": 0.1 * u,
                         "running_var": 1.0 + 0.1 * u.abs()}[leaf]
        elif leaf == "weight":
            out[name] = u / shape[1] ** 0.5
        else:
            out[name] = 0.1 * u / fan_in.get(module, 1) ** 0.5
        out[name] = out[name].to(dtype).contiguous()
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
