"""High-level inference API. Counterpart of ``nesie_tpu/apis.py``
(``Detector``, ``init_detector``, ``inference_detector``).

``init_detector`` builds the port's VoteNetNesie (Nesie or SAQE head) on
an explicit device. In the JAX package's form it takes a config name
(``nesie-*`` or ``saqe-*``) and a checkpoint directory that the runner
wrote, and serves its student (or its teacher);
in the keyword form it loads weights from a reference-named ``.pth``, from
the JAX package's variables, or from a seed. A ``Detector`` call runs one
point cloud through height feature, point sampling, the eval forward,
decode + NMS and the per-class expansion.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch.config import InferenceConfig, apply_overrides, get_config
from nesie_tpu_torch.convert import load_reference_state_dict, state_dict_from_flax
from nesie_tpu_torch.data import io
from nesie_tpu_torch.eval.postprocess import decode_and_nms, expand_per_class
from nesie_tpu_torch.nn.detector import (
    VoteNetNesie,
    init_weights_,
    init_weights_flax_,
)


class Detector:
    def __init__(self, model: VoteNetNesie, cfg: InferenceConfig,
                 device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)

    @torch.inference_mode()
    def __call__(self, points) -> dict:
        """points: (N, >=3) numpy array or a .bin/.npy path. Returns
        dict(boxes_3d (S, 7) gravity-centered, scores_3d, labels_3d) as
        numpy arrays."""
        if isinstance(points, (str, Path)):
            p = Path(points)
            points = (np.load(p)[:, :3] if p.suffix == ".npy"
                      else io.load_points_bin(p))
        pts = io.add_height(np.asarray(points, np.float32)[:, :3])
        rng = np.random.default_rng(self.cfg.seed)
        pts = io.sample_points(pts, self.cfg.num_points, rng)[None]
        pts = torch.from_numpy(np.ascontiguousarray(pts)).to(self.device)

        out = self.model(pts, self.cfg.sample_mod, with_jitter=False)
        decoded = decode_and_nms(
            out, pts, nms_thr=self.cfg.nms_thr, score_thr=self.cfg.score_thr,
            use_iou_for_nms=self.cfg.use_iou_for_nms)
        decoded = {k: v[0].cpu().numpy() for k, v in decoded.items()}
        boxes, scores, labels = expand_per_class(decoded)
        return dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels)


def init_detector(checkpoint=None, checkpoint_dir=None, device="cuda",
                  seed: int = 0, cfg: InferenceConfig | None = None,
                  teacher: bool = False, cfg_options=(),
                  **model_kwargs) -> Detector:
    """Build a Detector.

    checkpoint: a config name (``get_config``'s, e.g.
    ``nesie-votenet-scannet-train-050``), served from ``checkpoint_dir``
    (a runner's ``.../checkpoints``, its latest step; the student, or the
    teacher with ``teacher``) or from weights seeded with the config's
    seed (as the runner's ``init_state`` draws them), with
    ``cfg_options`` applied as by the CLIs. Otherwise: None
    (weights from a ``torch.Generator`` seeded with ``seed``), a path to a
    reference-named ``.pth``, or the JAX package's variables as a dict
    with ``params`` and ``batch_stats``.
    model_kwargs: VoteNetNesie overrides of the keyword form (the defaults
    are the flagship; ``head="saqe"`` for SAQE).
    """
    if isinstance(checkpoint, str) and _is_config_name(checkpoint):
        return _detector_from_config(checkpoint, checkpoint_dir, device,
                                     teacher, cfg_options)
    model = VoteNetNesie(**model_kwargs)
    if checkpoint is None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    else:
        if isinstance(checkpoint, dict):
            sd = state_dict_from_flax(checkpoint["params"],
                                      checkpoint["batch_stats"])
        else:
            sd = load_reference_state_dict(checkpoint, model)
        model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    return Detector(model, cfg or InferenceConfig(), device)


def _is_config_name(name: str) -> bool:
    if Path(name).suffix or "/" in name:
        return False
    try:
        get_config(name)
    except ValueError:
        return False
    return True


def _detector_from_config(name, checkpoint_dir, device, teacher,
                          cfg_options) -> Detector:
    from nesie_tpu_torch.train.runner import CheckpointManager, build_model

    cfg = apply_overrides(get_config(name), list(cfg_options))
    model = build_model(cfg)
    if checkpoint_dir is None:  # the runner's initial weights
        init_weights_flax_(model, torch.Generator().manual_seed(cfg.seed))
    else:
        ckpt = CheckpointManager(Path(checkpoint_dir).parent).load()
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        model.load_state_dict(ckpt["teacher" if teacher else "model"])
    model = model.to(device).eval()
    return Detector(model, InferenceConfig.from_experiment(cfg), device)


def inference_detector(detector: Detector, points) -> dict:
    return detector(points)
