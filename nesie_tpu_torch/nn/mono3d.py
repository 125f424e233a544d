"""Monocular single-stage 3D detector shell (reference
mmdet3d/models/detectors/single_stage_mono3d.py:14-221). Counterpart of
``nesie_tpu/nn/mono3d.py``.

The reference class is dispatch scaffolding: the repo ships no monocular
head or image backbone, and no shipped config uses it. What is ported is
the detector logic: ``forward_train`` (backbone, optional neck, head
loss), the forward, and the horizontal-flip test-time merge of
``aug_test`` (:110-178): flip every map back, remap the regression
channels (offset_x -> 1 - x, velo_x -> -velo_x, rot -> pi - rot), average
the views, but keep view 0's rotation / velocity slice and its
direction-classification maps.

Images and dense maps are NCHW here (the JAX shell takes NHWC images);
``convert.module_state_dict_from_flax`` carries a flax ``Conv``'s HWIO
kernel over as an ``nn.Conv2d``'s OIHW weight.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def flip_mono3d_outputs(cls_maps, reg_maps, extra_maps=None,
                        pred_velo: bool = False):
    """Undo a horizontal flip on dense mono3d head outputs.

    Args:
        cls_maps: list of (B, C, H, W) classification maps.
        reg_maps: list of (B, R, H, W) regression maps in the reference's
            channel layout (0: offset_x, 6: rotation, 7: velo_x).
        extra_maps: optional list of further map lists (dir_cls, attr,
            ...), each flipped as it is; a None entry passes through.
    Returns:
        (cls_maps, reg_maps, extra_maps) in the original frame
        (single_stage_mono3d.py:117-133).
    """
    cls_maps = [torch.flip(m, dims=(3,)) for m in cls_maps]
    flipped_reg = []
    for m in reg_maps:
        m = torch.flip(m, dims=(3,))  # a copy: the caller's map is kept
        m[:, 0] = 1.0 - m[:, 0]  # offset_x
        if pred_velo:
            m[:, 7] = -m[:, 7]
        m[:, 6] = -m[:, 6] + math.pi  # rotation
        flipped_reg.append(m)
    if extra_maps is not None:
        extra_maps = [
            None if ms is None else [torch.flip(m, dims=(3,)) for m in ms]
            for ms in extra_maps
        ]
    return cls_maps, flipped_reg, extra_maps


def merge_aug_mono3d_outputs(outs_list):
    """Average per-view dense outputs with the reference's merge
    (single_stage_mono3d.py:136-157): every group is averaged across
    views, except that the regression maps (group 1) keep view 0's
    channels >= 6 (rotation, velocity, 2D box) and the dir_cls group
    (group 2, exactly that one) keeps view 0 whole; later groups (attr,
    centerness, ...) are averaged. None groups pass through.

    Args:
        outs_list: list over views of (cls_maps, reg_maps, *extra) tuples,
            each a list over feature-map strides.
    Returns:
        one merged (cls_maps, reg_maps, *extra) tuple.
    """
    first = outs_list[0]
    merged = []
    for i, group in enumerate(first):
        if group is None or (group and group[0] is None):
            merged.append(group)
            continue
        maps = []
        for j, ref_map in enumerate(group):
            if i == 2:  # dir_cls keeps the original view (and only it)
                maps.append(ref_map)
                continue
            avg = torch.stack([outs[i][j] for outs in outs_list]).mean(dim=0)
            if i == 1:  # regression: rot/velo/2d keep the original view
                avg[:, 6:] = ref_map[:, 6:]
            maps.append(avg)
        merged.append(maps)
    return tuple(merged)


class SingleStageMono3DDetector(nn.Module):
    """Backbone (+ neck) -> dense mono3d head.

    ``backbone``, ``neck`` and ``bbox_head`` are injected modules. The head
    maps features to its outputs and, for ``forward_train``, exposes
    ``loss(feats, targets)`` (the reference delegates everything to
    ``bbox_head.forward_train``, single_stage_mono3d.py:63-68). Train or
    eval mode is the modules' own (``.train()`` / ``.eval()``).
    """

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: nn.Module | None = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head

    def extract_feat(self, img: torch.Tensor):
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, img: torch.Tensor):
        """Dense head outputs for one image batch (N, C, H, W)."""
        return self.bbox_head(self.extract_feat(img))

    def forward_train(self, img: torch.Tensor, targets):
        """The head's loss dict."""
        return self.bbox_head.loss(self.extract_feat(img), targets)
