"""Experiment configuration of the port: a copy of ``nesie_tpu/config.py``
(the reference's python-dict configs under configs/{Nesie,SAQE}/ map 1:1
onto these dataclasses), built on the port's own loss and pseudo-label
configs. That module imports the JAX training code, so the port does not
import it.

Reference recipe constants: configs/Nesie/nesie-votenet-scannet-train-010.py
(lr 8e-3, wd 0.01, clip 10, LR x0.1 @ 24/32 of 36 epochs, batch 4 labeled +
2x4 unlabeled, RepeatDataset x10, EMA momentum 1e-3 warm-up 10).

``InferenceConfig`` is the handful of test-time settings ``apis.Detector``
reads; ``InferenceConfig.from_experiment`` takes them from an
``ExperimentConfig``.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig
from nesie_tpu_torch.train.sup_loss import NesieLossConfig


@dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 18
    reg_max: int = 32
    num_proposal: int = 256
    in_channels: int = 4
    dataset_name: str = "ScanNet"
    sizes: Sequence[float] = (3.0, 3.0, 2.5)
    num_points: Sequence[int] = (2048, 1024, 512, 256)
    radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2)
    num_samples: Sequence[int] = (64, 32, 16, 16)
    sa_channels: Sequence[Sequence[int]] = (
        (64, 64, 128), (128, 128, 256), (128, 128, 256), (128, 128, 256),
    )
    fp_channels: Sequence[Sequence[int]] = ((256, 256), (256, 256))
    jitter_scale: float = 0.3
    jitter_size_bias: float = 0.0
    head: str = "nesie"  # or "saqe"
    compute_dtype: str | None = None  # "bfloat16" for bf16 backbone compute


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 8e-3
    weight_decay: float = 0.01
    grad_clip_norm: float = 10.0
    lr_milestones: Sequence[int] = (24, 32)
    lr_gamma: float = 0.1
    max_epochs: int = 36


@dataclass(frozen=True)
class DataConfig:
    data_root: str = ""
    train_ann_file: str = ""
    val_ann_file: str = ""
    label_list_file: str = ""
    num_points: int = 40000
    max_gt: int = 64
    samples_per_step: int = 4      # labeled scenes per step
    unlabeled_ratio: int = 2
    repeat: int = 10               # RepeatDataset times
    # strong-view augmentation (semi train defaults; the pretrain config
    # uses rot only — configs/Nesie/...pretrain-010.py:181-182)
    aug_rot_range: float = 3.1415926 / 36
    aug_scale_range: Sequence[float] = (0.85, 1.15)
    aug_translation_std: float = 0.1


@dataclass(frozen=True)
class TestConfig:
    sample_mod: str = "seed"
    nms_thr: float = 0.25
    score_thr: float = 0.05
    use_iou_for_nms: bool = True
    per_class_proposal: bool = True
    iou_opt: bool = False
    opt_rate: float = 5e-4
    opt_step: int = 10


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "nesie-votenet-scannet-train-010"
    mode: str = "semi"  # "pretrain" (supervised) or "semi"
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: NesieLossConfig = field(default_factory=NesieLossConfig)
    pseudo: PseudoLabelConfig = field(default_factory=PseudoLabelConfig)
    test: TestConfig = field(default_factory=TestConfig)
    sample_mod_train: str = "vote"
    # True runs the semi teacher on the jittered 2P proposal set as the
    # reference does (its quality module's train-mode BN statistics then
    # cover 2P rows); the default skips the jitter half.
    teacher_jitter: bool = False
    ema_momentum: float = 1e-3
    ema_warm_up: float = 10.0
    # EMA the teacher's BN running stats alongside its parameters instead
    # of sharing the student's live stats (the reference shares).
    ema_bn_stats: bool = False
    un_label_weight: float = 2.0
    pos_distance_thr: float = 0.3
    neg_distance_thr: float = 0.6
    seed: int = 0
    log_interval: int = 50
    checkpoint_interval_epochs: int = 1
    work_dir: str = "work_dirs"
    # data-parallel size; data.samples_per_step is per device. The port
    # runs on one device: None or 1.
    num_devices: Optional[int] = None


@dataclass(frozen=True)
class InferenceConfig:
    num_points: int = 40000      # points sampled per cloud
    sample_mod: str = "seed"
    nms_thr: float = 0.25
    score_thr: float = 0.05
    use_iou_for_nms: bool = True
    seed: int = 0                # the point-sampling RNG seed

    @staticmethod
    def from_experiment(cfg: ExperimentConfig) -> "InferenceConfig":
        return InferenceConfig(
            num_points=cfg.data.num_points, sample_mod=cfg.test.sample_mod,
            nms_thr=cfg.test.nms_thr, score_thr=cfg.test.score_thr,
            use_iou_for_nms=cfg.test.use_iou_for_nms, seed=cfg.seed)


def _override(cfg, dotted: str, value):
    """Apply one dot-path override to a (possibly nested) frozen dataclass."""
    head, _, rest = dotted.partition(".")
    if rest:
        sub = getattr(cfg, head)
        return dataclasses.replace(cfg, **{head: _override(sub, rest, value)})
    cur = getattr(cfg, head)
    if cur is not None and not isinstance(cur, (list, tuple, str)) and value is not None:
        value = type(cur)(value) if not isinstance(value, type(cur)) else value
    return dataclasses.replace(cfg, **{head: value})


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """--cfg-options style dot-path overrides (reference train.py:98-104)."""
    for item in overrides or []:
        key, _, raw = item.partition("=")
        if raw.lower() in ("true", "false"):  # accept non-Python casing —
            value = raw.lower() == "true"     # 'false' must never be truthy
        else:
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
        cfg = _override(cfg, key, value)
    return cfg


# ---------------------------------------------------------------------------
# Named experiment registry mirroring the reference config files
# ---------------------------------------------------------------------------

def _scannet_data(split: str) -> DataConfig:
    return DataConfig(
        train_ann_file="scannet_infos_train.pkl",
        val_ann_file="scannet_infos_val.pkl",
        label_list_file=f"meta_data/scannetv2_train_{split}.txt",
    )


def _sunrgbd_data(split: str) -> DataConfig:
    return DataConfig(
        train_ann_file="sunrgbd_infos_train.pkl",
        val_ann_file="sunrgbd_infos_val.pkl",
        label_list_file=f"sunrgbd_trainval/sunrgbd_v1_train_{split}.txt",
    )


def get_config(name: str) -> ExperimentConfig:
    """Names mirror the reference configs:
    {nesie,saqe}-votenet-{scannet,sunrgbd}-{pretrain,train}-{005,...,all}."""
    parts = name.split("-")
    if parts[-1] == "test" and len(parts) == 4:
        # the reference's {nesie,saqe}-votenet-scannet-test.py is its
        # train-010 config with RepeatDataset times=5 instead of 10
        # (the only diff); data repeat is irrelevant at eval time.
        cfg = get_config("-".join(parts[:-1]) + "-train-010")
        return dataclasses.replace(
            cfg, name=name,
            data=dataclasses.replace(cfg.data, repeat=5))
    if len(parts) < 5:
        raise ValueError(
            f"unknown config '{name}'; expected "
            "{nesie|saqe}-votenet-{scannet|sunrgbd}-{pretrain|train}-"
            "{005|010|020|050|all} or {nesie|saqe}-votenet-<dataset>-test"
        )
    family = parts[0]  # nesie | saqe
    dataset = parts[2]  # scannet | sunrgbd
    phase = parts[-2]  # pretrain | train
    split = parts[-1]  # 005 | 010 | ... | all
    if family not in ("nesie", "saqe") or dataset not in ("scannet", "sunrgbd") \
            or phase not in ("pretrain", "train"):
        raise ValueError(
            f"unknown config '{name}'; expected "
            "{nesie|saqe}-votenet-{scannet|sunrgbd}-{pretrain|train}-<split>"
        )
    split_str = {"005": "0.05", "010": "0.1", "020": "0.2", "050": "0.5",
                 "all": "1.0"}.get(split, split)

    model = ModelConfig(head=family)
    if family == "saqe":
        model = dataclasses.replace(
            model, jitter_scale=0.5, jitter_size_bias=0.2
        )
    if dataset == "sunrgbd":
        model = dataclasses.replace(
            model, num_classes=10, dataset_name="SUNRGBD"
        )
    cfg = ExperimentConfig(
        name=name,
        mode="pretrain" if phase == "pretrain" else "semi",
        model=model,
        data=_scannet_data(split_str) if dataset == "scannet"
        else _sunrgbd_data(split_str),
        loss=NesieLossConfig(num_classes=model.num_classes),
        pseudo=PseudoLabelConfig(
            num_classes=model.num_classes, dataset_name=model.dataset_name
        ),
    )
    if phase == "pretrain":
        # pretrain: heavier IoU-prediction QFL weight (3.0 vs 1.0,
        # configs/Nesie/nesie-votenet-scannet-pretrain-010.py:69) and milder
        # augmentation (rotation only, :181-182)
        cfg = dataclasses.replace(
            cfg,
            loss=dataclasses.replace(cfg.loss, iou_pred_weight=3.0),
            data=dataclasses.replace(
                cfg.data,
                aug_scale_range=(1.0, 1.0),
                aug_translation_std=0.0,
            ),
        )
    return cfg
