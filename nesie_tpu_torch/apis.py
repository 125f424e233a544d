"""High-level inference API. Counterpart of ``nesie_tpu/apis.py``
(``Detector``, ``init_detector``, ``inference_detector``,
``inference_segmentor``, ``show_result_meshlab``).

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
from nesie_tpu_torch.convert import (
    load_reference_state_dict,
    load_reference_state_dicts,
    state_dict_from_flax,
)
from nesie_tpu_torch.data import io
from nesie_tpu_torch.eval.postprocess import decode_and_nms, expand_per_class
from nesie_tpu_torch.nn.detector import (
    VoteNetNesie,
    init_weights_,
    init_weights_flax_,
)
from nesie_tpu_torch.graphs import FpsSplitGraph
from nesie_tpu_torch.utils import count, get_root_logger, span


class Detector:
    """Serves one model. ``cfg.sample_mod="random"`` draws its seed
    indices from the detector's generator (on ``device``, seeded with
    ``cfg.seed``), one draw a request.

    On a card, a request replays CUDA graphs of the forward and of the
    decode (``graphs.FpsSplitGraph``: split at each FPS launch, which runs
    eagerly), captured after a request has run eagerly, the first and
    again whenever the model, its mode or ``cfg`` changes. The graphs read
    the model's parameters and buffers in place. Each request counts
    ``detector.graphed`` or ``detector.eager``, the latter with
    ``eager.<reason>``: ``cpu``, ``sample_mod_random`` (the generator's
    draw), ``train_mode``, ``shape`` (a cloud other than
    (1, ``num_points``, 4)), ``warm_up`` (the eager request before a
    capture) or ``capture_failed`` (logged; the requests stay eager)."""

    def __init__(self, model: VoteNetNesie, cfg: InferenceConfig,
                 device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.requests = 0
        self._graphs = None  # the _Graphs last captured
        self._failed = None  # the key whose capture failed

    @torch.inference_mode()
    def __call__(self, points) -> dict:
        """points: (N, >=3) numpy array or a .bin/.npy path. Returns
        dict(boxes_3d (S, 7) gravity-centered, scores_3d, labels_3d) as
        numpy arrays. Spans: ``detector.request`` (``request``: this
        detector's count of calls) over its phases."""
        self.requests += 1
        with span("detector.request", request=self.requests):
            return self._request(points)

    def _request(self, points) -> dict:
        with span("detector.preprocess"):
            if isinstance(points, (str, Path)):
                p = Path(points)
                points = (np.load(p)[:, :3] if p.suffix == ".npy"
                          else io.load_points_bin(p))
            pts = io.add_height(np.asarray(points, np.float32)[:, :3])
            rng = np.random.default_rng(self.cfg.seed)
            pts = np.ascontiguousarray(
                io.sample_points(pts, self.cfg.num_points, rng)[None])
        key = (self.model, self.model.training, self.cfg)
        graphs = self._graphs
        reason = eager_reason(self.device.type, self.cfg.sample_mod,
                              self.model.training, pts.shape,
                              self.cfg.num_points)
        if reason is None and (graphs is None or graphs.key != key):
            reason = "capture_failed" if self._failed == key else "warm_up"
        if reason is None:
            count("detector.graphed")
            decoded = graphs.replay(pts)
        else:
            count("detector.eager")
            count(f"eager.{reason}")
            with span("detector.to_device"):
                pts = torch.from_numpy(pts).to(self.device)
            decoded = self._eager(pts)
            if reason == "warm_up":
                self._graphs = None  # frees those of another key first
                self._graphs = _Graphs.capture(self, pts, decoded, key)
                self._failed = None if self._graphs else key
        with span("detector.fetch"):
            decoded = {k: v[0].cpu().numpy() for k, v in decoded.items()}
        with span("detector.expand"):
            boxes, scores, labels = expand_per_class(decoded)
        return dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels)

    def _eager(self, pts: torch.Tensor) -> dict:
        out = self.model(pts, self.cfg.sample_mod, with_jitter=False,
                         generator=self.generator)
        return decode_and_nms(
            out, pts, nms_thr=self.cfg.nms_thr, score_thr=self.cfg.score_thr,
            use_iou_for_nms=self.cfg.use_iou_for_nms)


def eager_reason(device_type: str, sample_mod: str, training: bool,
                 shape: tuple, num_points: int) -> str | None:
    """Why a ``Detector`` request runs eagerly whatever graphs it holds,
    or None."""
    if device_type != "cuda":
        return "cpu"
    if sample_mod == "random":
        return "sample_mod_random"
    if training:
        return "train_mode"
    if tuple(shape) != (1, num_points, 4):
        return "shape"
    return None


class _Graphs:
    """A Detector's graphs of the forward and of the decode, captured for
    ``key`` (the model, its mode and the cfg), with their static tensors:
    the input cloud, the forward's results (which the decode reads) and
    the decode's."""

    def __init__(self, key, points, forward, results, decode, decoded):
        self.key = key
        self.points = points
        self.forward = forward
        self.results = results
        self.decode = decode
        self.decoded = decoded

    @staticmethod
    def capture(det: Detector, pts: torch.Tensor, eager: dict, key):
        """The graphs, captured on a copy of ``pts``, whose eager decode
        was ``eager``; None where capture failed or decoded otherwise."""
        cfg = det.cfg
        try:
            points = pts.clone()
            forward = FpsSplitGraph(det.device)
            results = forward.capture(lambda: det.model(
                points, cfg.sample_mod, with_jitter=False,
                generator=det.generator))
            decode = FpsSplitGraph(det.device, pool=forward.pool)
            decoded = decode.capture(lambda: decode_and_nms(
                results, points, nms_thr=cfg.nms_thr,
                score_thr=cfg.score_thr,
                use_iou_for_nms=cfg.use_iou_for_nms))
            if not all(torch.equal(decoded[k], eager[k]) for k in eager):
                raise RuntimeError("the graphs decode otherwise than the "
                                   "eager request")
        except Exception as e:  # noqa: BLE001 - requests stay eager
            get_root_logger().warning(
                "Detector: CUDA graph capture failed, requests stay eager: "
                "%s", e, exc_info=True)
            return None
        return _Graphs(key, points, forward, results, decode, decoded)

    def replay(self, pts: np.ndarray) -> dict:
        with span("detector.to_device"):
            self.points.copy_(torch.from_numpy(pts))
        b, n = pts.shape[:2]
        with span("nn.forward", device=True, b=b, n=n):
            self.forward.replay()
        with span("postprocess.decode_and_nms", b=b):
            self.decode.replay()
        return self.decoded


def init_detector(checkpoint=None, checkpoint_dir=None, device="cuda",
                  seed: int = 0, cfg: InferenceConfig | None = None,
                  teacher: bool = False, cfg_options=(),
                  **model_kwargs) -> Detector:
    """Build a Detector.

    checkpoint: a config name (``get_config``'s, e.g.
    ``nesie-votenet-scannet-train-050``), served from ``checkpoint_dir``
    (a runner's ``.../checkpoints``, its latest step, or a reference
    ``.pth``; the student, or the teacher with ``teacher``: a ``.pth``'s
    ``ema_*`` buffers, the student when it has none) or from weights
    seeded with the config's seed (as the runner's ``init_state`` draws
    them), with ``cfg_options`` applied as by the CLIs. Otherwise: None
    (weights from a ``torch.Generator`` seeded with ``seed``), a path to a
    reference-named ``.pth``, or the JAX package's variables as a dict
    with ``params`` and ``batch_stats``.
    model_kwargs: VoteNetNesie overrides of the keyword form (the defaults
    are the flagship; ``head="saqe"`` for SAQE, ``compute_dtype=
    "bfloat16"`` for the bf16 backbone, which loads the same float32
    weights). The config form takes ``test.sample_mod`` and
    ``model.compute_dtype`` from the config and ``cfg_options``.
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
            sd = load_reference_state_dict(checkpoint)
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
    elif Path(checkpoint_dir).suffix == ".pth":  # a reference checkpoint
        student, ema = load_reference_state_dicts(checkpoint_dir)
        model.load_state_dict(ema if teacher else student)
    else:
        ckpt = CheckpointManager(Path(checkpoint_dir).parent).load()
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
        model.load_state_dict(ckpt["teacher" if teacher else "model"])
    model = model.to(device).eval()
    return Detector(model, InferenceConfig.from_experiment(cfg), device)


def inference_detector(detector: Detector, points) -> dict:
    return detector(points)


@torch.inference_mode()
def inference_segmentor(model: torch.nn.Module, points, num_points=None,
                        seed: int = 0) -> dict:
    """Per-point semantic labels of one cloud (the JAX package's
    ``inference_segmentor``): points (N, >=3) numpy or a .bin/.npy path,
    the height feature added, ``num_points`` of them sampled with
    ``np.random.default_rng(seed)`` when given; ``model`` (a
    ``nn.segmentor.PointNet2Segmentor`` in eval mode) runs on its own
    device. Returns dict(semantic_mask (N',), seg_logits (N', classes),
    points (N', 4)) as numpy arrays."""
    if isinstance(points, (str, Path)):
        p = Path(points)
        points = np.load(p) if p.suffix == ".npy" else io.load_points_bin(p)
    pts = io.add_height(np.asarray(points, np.float32)[:, :3])
    if num_points is not None:
        pts = io.sample_points(pts, num_points, np.random.default_rng(seed))
    device = next(model.parameters()).device
    out = model(torch.from_numpy(np.ascontiguousarray(pts))[None].to(device))
    logits = out["seg_logits"] if isinstance(out, dict) else out
    logits = logits[0].cpu().numpy()
    return dict(semantic_mask=np.argmax(logits, axis=-1), seg_logits=logits,
                points=pts)


def show_result_meshlab(out_dir, name, points=None, gt_boxes=None,
                        pred_boxes=None, img=None, proj=None,
                        seg_labels=None, palette=None):
    """Dump meshlab-style artifacts (reference apis/inference.py:292-505
    ``show_det_result_meshlab``/``show_seg_result_meshlab``/
    ``show_proj_det_result_meshlab``): ``<name>_points.obj`` /
    ``_gt.obj`` / ``_pred.obj``, a colorized segmentation cloud, and a
    box-projection image when calibration is given (that one needs
    ``cv2`` and ``imageio``). Returns the output directory."""
    from nesie_tpu_torch.eval.visualize import (
        draw_bbox3d_on_img,
        show_result,
        write_points_obj,
    )

    out = show_result(out_dir, name, points=points, gt_boxes=gt_boxes,
                      pred_boxes=pred_boxes)
    if seg_labels is not None and points is not None:
        if palette is None:
            rng = np.random.default_rng(42)  # stable class colors
            palette = rng.integers(0, 256,
                                   size=(int(seg_labels.max()) + 1, 3))
        write_points_obj(out / f"{name}_seg.obj",
                         np.asarray(points)[:, :3],
                         colors=np.asarray(palette)[np.asarray(seg_labels)])
    if img is not None and proj is not None and pred_boxes is not None \
            and len(pred_boxes):
        import imageio.v3 as iio

        drawn = draw_bbox3d_on_img(np.asarray(pred_boxes), np.asarray(img),
                                   np.asarray(proj))
        iio.imwrite(out / f"{name}_pred_img.png", drawn.astype(np.uint8))
    return out
