"""Weights carried across from the JAX package and from reference
checkpoints.

``state_dict_from_flax`` maps the JAX package's VoteNetNesie variables
(nested dicts of numpy arrays; Nesie or SAQE head), or a params-shaped
tree alone, onto the port's ``state_dict``. The port's
names are the reference's, so ``nesie_tpu.convert_torch.convert_state_dict``
maps the port's ``state_dict()`` back: the two are inverses.

A flax Dense kernel is ``(in, out)``; an ``nn.Linear`` weight is
``(out, in)``. A reference ``.pth`` stores 1x1 convolutions as
``(out, in, 1[, 1])``; ``load_reference_state_dict`` drops the unit dims.
"""
from __future__ import annotations

import numpy as np
import torch


def _linear(sd: dict, prefix: str, dense: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(dense["kernel"], np.float32).T
    if "bias" in dense:
        sd[f"{prefix}.bias"] = np.asarray(dense["bias"], np.float32)


def _sub(stats, *keys):
    """stats[k0][k1]...; None for a params-only conversion."""
    for k in keys:
        if stats is None:
            return None
        stats = stats[k]
    return stats


def _bn(sd: dict, prefix: str, params: dict, stats) -> None:
    sd[f"{prefix}.weight"] = np.asarray(params["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)
    if stats is None:
        return
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"], np.float32)
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"], np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _point_mlp(sd, prefix, params, stats, name="layer{}"):
    """flax PointMLP dense{j}/norm{j} -> ``<prefix>.<name>.conv/bn``."""
    j = 0
    while f"dense{j}" in params:
        t = f"{prefix}.{name.format(j)}"
        _linear(sd, f"{t}.conv", params[f"dense{j}"])
        _bn(sd, f"{t}.bn", params[f"norm{j}"], _sub(stats, f"norm{j}"))
        j += 1


def _mini_pointnet(sd, prefix, params, stats):
    _linear(sd, f"{prefix}.first_conv.0", params["first0"])
    _bn(sd, f"{prefix}.first_conv.1", params["bn0"], _sub(stats, "bn0"))
    _linear(sd, f"{prefix}.first_conv.3", params["first1"])
    _linear(sd, f"{prefix}.second_conv.0", params["second0"])
    _bn(sd, f"{prefix}.second_conv.1", params["bn1"], _sub(stats, "bn1"))
    _linear(sd, f"{prefix}.second_conv.3", params["second1"])


def _quality_head(sd, prefix, trunk_p, trunk_s, out):
    _linear(sd, f"{prefix}.0", trunk_p["dense0"])
    _bn(sd, f"{prefix}.1", trunk_p["norm0"], _sub(trunk_s, "norm0"))
    _linear(sd, f"{prefix}.3", trunk_p["dense1"])
    _bn(sd, f"{prefix}.4", trunk_p["norm1"], _sub(trunk_s, "norm1"))
    _linear(sd, f"{prefix}.6", out)


def _saqe_side_head(sd, prefix, trunk_p, trunk_s, out):
    """QualityEstimation's side head: Linear-BN-ReLU, Linear."""
    _linear(sd, f"{prefix}.0", trunk_p["dense0"])
    _bn(sd, f"{prefix}.1", trunk_p["norm0"], _sub(trunk_s, "norm0"))
    _linear(sd, f"{prefix}.3", out)


def state_dict_from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """JAX VoteNetNesie variables, Nesie or SAQE head (told apart by the
    quality module's ``global_trunk``), -> the port's state_dict (name ->
    torch.Tensor).

    With ``batch_stats=None`` only the parameters are mapped, so that a
    params-shaped tree (gradients, an optimizer's moments, the EMA
    teacher's ``ema_params``) lands on the port's parameter names; BN
    running statistics are then left out."""
    sd: dict = {}
    bp, bs = params["backbone"], _sub(batch_stats, "backbone")
    i = 0
    while f"sa{i}" in bp:
        _point_mlp(sd, f"backbone.SA_modules.{i}.mlps.0", bp[f"sa{i}"]["mlp"],
                   _sub(bs, f"sa{i}", "mlp"))
        i += 1
    i = 0
    while f"fp{i}" in bp:
        _point_mlp(sd, f"backbone.FP_modules.{i}.mlps", bp[f"fp{i}"]["mlp"],
                   _sub(bs, f"fp{i}", "mlp"))
        i += 1

    hp, hs = params["bbox_head"], _sub(batch_stats, "bbox_head")
    _point_mlp(sd, "bbox_head.vote_module.vote_conv",
               hp["vote_module"]["trunk"], _sub(hs, "vote_module", "trunk"),
               name="{}")
    _linear(sd, "bbox_head.vote_module.conv_out", hp["vote_module"]["out"])
    _point_mlp(sd, "bbox_head.vote_aggregation.mlps.0",
               hp["vote_aggregation"]["mlp"],
               _sub(hs, "vote_aggregation", "mlp"))
    cp, cs = hp["conv_pred"], _sub(hs, "conv_pred")
    _point_mlp(sd, "bbox_head.conv_pred.shared_convs", cp["shared"],
               _sub(cs, "shared"))
    for name in ("conv_cls", "conv_bbox", "conv_heading"):
        _linear(sd, f"bbox_head.conv_pred.{name}", cp[name])

    gp, gs = hp["grid_conv"], _sub(hs, "grid_conv")
    saqe = "global_trunk" in gp  # SAQE's QualityEstimation
    minis = [f"side_mini{i}" for i in range(6)] + ([] if saqe else ["box_mini"])
    for i, name in enumerate(minis):
        _mini_pointnet(sd, f"bbox_head.grid_conv.mlps_before.{i}", gp[name],
                       _sub(gs, name))
    heads = [(f"side_head{i}_trunk", f"side_head{i}_out") for i in range(6)]
    heads.append(("global_trunk", "global_out") if saqe
                 else ("iou_head_trunk", "iou_head_out"))
    for i, (trunk, out) in enumerate(heads):
        convert = _saqe_side_head if saqe and i < 6 else _quality_head
        convert(sd, f"bbox_head.grid_conv.mlps_head.{i}", gp[trunk],
                _sub(gs, trunk), gp[out])
    return {k: torch.tensor(v) for k, v in sd.items()}


def load_reference_state_dict(path, model: torch.nn.Module) -> dict:
    """Read a reference-named ``.pth`` (a bare state_dict or one under
    ``"state_dict"``) and reshape its 1x1 convolution weights to the
    port's ``(out, in)``. The teacher's ``ema_*`` buffers are dropped: the
    student's weights are loaded."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    target = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith("ema_"):
            continue
        if k in target and v.dim() > target[k].dim():
            v = v.reshape(target[k].shape)
        out[k] = v
    return out
