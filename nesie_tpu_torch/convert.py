"""Weights carried across from the JAX package and from reference
checkpoints.

``state_dict_from_flax`` maps the JAX package's VoteNetNesie variables
(nested dicts of numpy arrays; Nesie or SAQE head), a PointNet2SASSG +
VoteHead detector's or a PointNet2Segmentor's, or a params-shaped tree
alone, onto the port's ``state_dict``; ``module_state_dict_from_flax``
one SA module's (plain, MSG, PAConv), conv head's, sparse convolution's
or SparseBasicBlock's. The port's
names are the reference's, so ``nesie_tpu.convert_torch.convert_state_dict``
maps the port's ``state_dict()`` back: the two are inverses.

The mapping follows the tree, so it carries any output width (a quality
module with ``iou_class_depend=False``), and a model with
``compute_dtype="bfloat16"`` loads the same float32 state_dict (its
parameters stay float32).

A flax Dense kernel is ``(in, out)``; an ``nn.Linear`` weight is
``(out, in)``. A reference ``.pth`` stores 1x1 convolutions as
``(out, in, 1[, 1])``; ``load_torch_checkpoint`` drops the unit dims, and
``extract_ema`` rebuilds the EMA teacher from its ``ema_*`` buffers.
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


def _gn(sd: dict, prefix: str, params: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(params["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)


def _point_mlp(sd, prefix, params, stats, name="layer{}", norm="bn"):
    """flax PointMLP dense{j}/norm{j} -> ``<prefix>.<name>.conv`` and
    ``.bn`` (``.gn`` with ``norm="gn"``); a layer without norm{j} (the
    last of a ``final_activation=False`` stack) is its conv alone."""
    j = 0
    while f"dense{j}" in params:
        t = f"{prefix}.{name.format(j)}"
        _linear(sd, f"{t}.conv", params[f"dense{j}"])
        if f"norm{j}" in params:
            if norm == "gn":
                _gn(sd, f"{t}.gn", params[f"norm{j}"])
            else:
                _bn(sd, f"{t}.bn", params[f"norm{j}"],
                    _sub(stats, f"norm{j}"))
        j += 1


def _paconv(sd, prefix, params, stats):
    """flax PAConv -> ``<prefix>.weight_bank`` (same layout), ``.bn`` and
    ``.scorenet.mlps.layer{i}.conv/.bn``."""
    sd[f"{prefix}.weight_bank"] = np.asarray(params["weight_bank"], np.float32)
    if "bn" in params:
        _bn(sd, f"{prefix}.bn", params["bn"], _sub(stats, "bn"))
    sp, ss = params["scorenet"], _sub(stats, "scorenet")
    i = 0
    while f"layer{i}_conv" in sp:
        t = f"{prefix}.scorenet.mlps.layer{i}"
        _linear(sd, f"{t}.conv", sp[f"layer{i}_conv"])
        if f"layer{i}_bn" in sp:
            _bn(sd, f"{t}.bn", sp[f"layer{i}_bn"], _sub(ss, f"layer{i}_bn"))
        i += 1


def _sa(sd, prefix, params, stats):
    """Any of the three SA modules: PointSAModule (``mlp``),
    PointSAModuleMSG (``mlp{i}``) or PAConvSAModule (``layer{i}``)."""
    if "mlp" in params:
        _point_mlp(sd, f"{prefix}.mlps.0", params["mlp"], _sub(stats, "mlp"))
        return
    i = 0
    while f"mlp{i}" in params:
        _point_mlp(sd, f"{prefix}.mlps.{i}", params[f"mlp{i}"],
                   _sub(stats, f"mlp{i}"))
        i += 1
    i = 0
    while f"layer{i}" in params:
        _paconv(sd, f"{prefix}.mlps.0.layer{i}", params[f"layer{i}"],
                _sub(stats, f"layer{i}"))
        i += 1


def _backbone(sd, prefix, bp, bs):
    """PointNet2SASSG: sa{i} -> SA_modules.{i}, fp{i} -> FP_modules.{i}."""
    i = 0
    while f"sa{i}" in bp:
        _sa(sd, f"{prefix}.SA_modules.{i}", bp[f"sa{i}"], _sub(bs, f"sa{i}"))
        i += 1
    i = 0
    while f"fp{i}" in bp:
        _point_mlp(sd, f"{prefix}.FP_modules.{i}.mlps", bp[f"fp{i}"]["mlp"],
                   _sub(bs, f"fp{i}", "mlp"))
        i += 1


def _conv_head(sd, prefix, params, stats):
    """BaseConvBboxHead or ReliableConvBboxHead: ``shared`` and the branch
    stacks that are there (``heading_convs`` with GroupNorm), then every
    output Linear."""
    if "shared" in params:
        _point_mlp(sd, f"{prefix}.shared_convs", params["shared"],
                   _sub(stats, "shared"))
    for stack in ("cls_convs", "reg_convs", "bbox_convs"):
        if stack in params:
            _point_mlp(sd, f"{prefix}.{stack}", params[stack],
                       _sub(stats, stack))
    if "heading_convs" in params:  # GroupNorm: no running statistics
        _point_mlp(sd, f"{prefix}.heading_convs", params["heading_convs"],
                   None, norm="gn")
    for name in ("conv_cls", "conv_reg", "conv_bbox", "conv_heading"):
        if name in params:
            _linear(sd, f"{prefix}.{name}", params[name])


def _sparse_conv(sd, prefix, params):
    """flax SubMConv3d / SparseConv3d: the kernel is already
    ``(k^3, C_in, C_out)``."""
    sd[f"{prefix}.weight"] = np.asarray(params["kernel"], np.float32)
    if "bias" in params:
        sd[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)


def _sparse_block(sd, prefix, params, stats):
    """flax SparseBasicBlock: conv1/conv2, bn{1,2}/BatchNorm_0, the
    optional ``down`` Dense."""
    for i in (1, 2):
        _sparse_conv(sd, f"{prefix}.conv{i}", params[f"conv{i}"])
        _bn(sd, f"{prefix}.bn{i}", params[f"bn{i}"]["BatchNorm_0"],
            _sub(stats, f"bn{i}", "BatchNorm_0"))
    if "down" in params:
        _linear(sd, f"{prefix}.down", params["down"])


def _tensors(sd: dict) -> dict:
    return {k: torch.tensor(v) for k, v in sd.items()}


def module_state_dict_from_flax(params: dict,
                                batch_stats: dict | None = None) -> dict:
    """One module's flax variables -> the port module's state_dict: a
    PointSAModule, PointSAModuleMSG or PAConvSAModule, a
    BaseConvBboxHead or ReliableConvBboxHead, a SubMConv3d or SparseConv3d,
    or a SparseBasicBlock (told apart by their keys)."""
    sd: dict = {}
    if "shared" in params or "conv_cls" in params:
        _conv_head(sd, "x", params, batch_stats)
    elif "conv1" in params and "bn1" in params:
        _sparse_block(sd, "x", params, batch_stats)
    elif np.ndim(params.get("kernel")) == 3:
        _sparse_conv(sd, "x", params)
    else:
        _sa(sd, "x", params, batch_stats)
    return _tensors({k[2:]: v for k, v in sd.items()})


def _segmentor(sd, params, stats):
    _backbone(sd, "backbone", params["backbone"], _sub(stats, "backbone"))
    _point_mlp(sd, "fp_final.mlps", params["fp_final"]["mlp"],
               _sub(stats, "fp_final", "mlp"))
    for head, cls in (("head", "cls"), ("aux_head", "aux_cls")):
        if head in params:
            _point_mlp(sd, head, params[head], _sub(stats, head))
            _linear(sd, cls, params[cls])


def _votenet(sd, params, stats):
    _backbone(sd, "backbone", params["backbone"], _sub(stats, "backbone"))
    hp, hs = params["bbox_head"], _sub(stats, "bbox_head")
    _point_mlp(sd, "bbox_head.vote_module.vote_conv",
               hp["vote_module"]["trunk"], _sub(hs, "vote_module", "trunk"),
               name="{}")
    _linear(sd, "bbox_head.vote_module.conv_out", hp["vote_module"]["out"])
    _sa(sd, "bbox_head.vote_aggregation", hp["vote_aggregation"],
        _sub(hs, "vote_aggregation"))
    _point_mlp(sd, "bbox_head.trunk", hp["trunk"], _sub(hs, "trunk"))
    _linear(sd, "bbox_head.conv_out", hp["conv_out"])


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
    """JAX model variables -> the port's state_dict (name ->
    torch.Tensor): VoteNetNesie, Nesie or SAQE head (told apart by the
    quality module's ``global_trunk``); a PointNet2SASSG + VoteHead
    detector (``nn.vote_head.VoteNet``: its head has ``conv_out``); or a
    PointNet2Segmentor, with or without its auxiliary head (``fp_final``).

    With ``batch_stats=None`` only the parameters are mapped, so that a
    params-shaped tree (gradients, an optimizer's moments, the EMA
    teacher's ``ema_params``) lands on the port's parameter names; BN
    running statistics are then left out."""
    sd: dict = {}
    if "fp_final" in params:
        _segmentor(sd, params, batch_stats)
        return _tensors(sd)
    if "conv_out" in params["bbox_head"]:
        _votenet(sd, params, batch_stats)
        return _tensors(sd)
    _backbone(sd, "backbone", params["backbone"],
              _sub(batch_stats, "backbone"))

    hp, hs = params["bbox_head"], _sub(batch_stats, "bbox_head")
    _point_mlp(sd, "bbox_head.vote_module.vote_conv",
               hp["vote_module"]["trunk"], _sub(hs, "vote_module", "trunk"),
               name="{}")
    _linear(sd, "bbox_head.vote_module.conv_out", hp["vote_module"]["out"])
    _point_mlp(sd, "bbox_head.vote_aggregation.mlps.0",
               hp["vote_aggregation"]["mlp"],
               _sub(hs, "vote_aggregation", "mlp"))
    _conv_head(sd, "bbox_head.conv_pred", hp["conv_pred"],
               _sub(hs, "conv_pred"))

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
    return _tensors(sd)


def load_torch_checkpoint(path) -> dict:
    """Every tensor of a reference ``.pth`` (a bare state_dict or one
    under ``"state_dict"``), the teacher's ``ema_*`` buffers included,
    with the 1x1 convolution weights ``(out, in, 1[, 1])`` reshaped to the
    port's ``(out, in)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.reshape(v.shape[:2]) if v.dim() > 2 and v.shape[2:].numel() == 1
            else v for k, v in sd.items()}


def extract_ema(sd: dict) -> dict | None:
    """The teacher's state_dict from the ``ema_<name with . -> _>``
    buffers of a reference state_dict: every parameter that has an EMA
    buffer takes it, everything else (BN running statistics, which the
    reference's SimiTeacherHook never averages: simi_teacher_hook.py:46-52,
    86-92) is the student's. None when there is no ``ema_*`` buffer (a
    pretrain ``.pth``)."""
    mangled = {k.replace(".", "_"): k for k in sd if not k.startswith("ema_")}
    overlay = {}
    for k, v in sd.items():
        if k.startswith("ema_") and k[4:] in mangled:
            overlay[mangled[k[4:]]] = v
    if not overlay:
        return None
    return {k: overlay.get(k, v) for k, v in sd.items()
            if not k.startswith("ema_")}


def load_reference_state_dicts(path) -> tuple[dict, dict]:
    """The student's and the teacher's state_dicts from a reference
    ``.pth``: the student without the ``ema_*`` buffers, the teacher from
    them (``extract_ema``), or the student itself when there are none."""
    sd = load_torch_checkpoint(path)
    student = {k: v for k, v in sd.items() if not k.startswith("ema_")}
    return student, extract_ema(sd) or student


def load_reference_state_dict(path) -> dict:
    """The student's state_dict from a reference ``.pth``."""
    return load_reference_state_dicts(path)[0]
