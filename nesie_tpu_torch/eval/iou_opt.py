"""Test-time IoU optimisation (reference iou_opt_test,
votenet_nesie.py:501-571). Counterpart of ``nesie_tpu/eval/iou_opt.py``:
a few steps of gradient ascent on the predicted IoU score with respect
to the proposals' centres and sizes, before NMS.

The gradient runs through the quality module in eval mode (running-
statistics BN) and through the three-NN distances that
``ops.pointops.three_nn`` recomputes from the neighbour indices, as the
JAX package's gradient does. Off in every shipped config
(``test.iou_opt=False``).
"""
from __future__ import annotations

import torch


def iou_opt_boxes(model, results: dict, opt_rate: float = 5e-4,
                  opt_step: int = 10, dataset_name: str = "ScanNet") -> dict:
    """Returns a copy of ``results`` whose ``bbox_preds`` (B, P, 7) have
    their centres and sizes moved by ``opt_step + 1`` ascent steps of
    ``opt_rate`` on the sum of ``model.quality_scores``; headings are
    kept. The reference's ``while True: ...; count += 1; if count >
    opt_step: break`` applies ``opt_step + 1`` updates, and so does this.
    ``model`` is put in eval mode; its parameters collect no gradient."""
    model.eval()
    results = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in results.items()}
    bbox = results["bbox_preds"]
    heading = bbox[..., 6]
    heading_q = (torch.zeros_like(heading) if dataset_name == "ScanNet"
                 else heading)
    center, size = bbox[..., :3], bbox[..., 3:6]
    with torch.enable_grad():
        for _ in range(opt_step + 1):
            center = center.detach().requires_grad_(True)
            size = size.detach().requires_grad_(True)
            iou = model.quality_scores(results, center, size, heading_q)
            g_center, g_size = torch.autograd.grad(iou.sum(), (center, size))
            center = center + opt_rate * g_center
            size = size + opt_rate * g_size
    out = dict(results)
    out["bbox_preds"] = torch.cat(
        [center.detach(), size.detach(), heading[..., None]], dim=-1)
    return out
