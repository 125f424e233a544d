"""The reference's model, semi step and test settings, built from a
benchmark configuration file (``perfbench/configs/<name>.json``)."""
from __future__ import annotations

from .nn.detector import VoteNetNesie
from .train.pseudo_label import PseudoLabelConfig
from .train.semi import make_semi_train_step
from .train.state import create_train_state
from .train.sup_loss import NesieLossConfig


def model(cfg: dict) -> VoteNetNesie:
    m = cfg["model"]
    return VoteNetNesie(
        num_classes=m["num_classes"], reg_max=m["reg_max"],
        num_proposal=m["num_proposal"], in_channels=m["in_channels"],
        dataset_name=m["dataset_name"], sizes=tuple(m["sizes"]),
        num_points=tuple(m["num_points"]), radii=tuple(m["radii"]),
        num_samples=tuple(m["num_samples"]),
        sa_channels=tuple(map(tuple, m["sa_channels"])),
        fp_channels=tuple(map(tuple, m["fp_channels"])),
        jitter_scale=m["jitter_scale"],
        jitter_size_bias=m["jitter_size_bias"], head=m["head"],
        compute_dtype=m["compute_dtype"])


def loss_config(cfg: dict) -> NesieLossConfig:
    loss = dict(cfg["loss"])
    loss["objectness_class_weight"] = tuple(loss["objectness_class_weight"])
    return NesieLossConfig(**loss)


def semi_step(cfg: dict, n_labeled: int, labeled_scans: int):
    s = cfg["semi"]
    return make_semi_train_step(
        n_labeled, labeled_scans, loss_cfg=loss_config(cfg),
        pl_cfg=PseudoLabelConfig(**cfg["pseudo"]),
        sample_mod=s["sample_mod_train"], ema_momentum=s["ema_momentum"],
        ema_warm_up=s["ema_warm_up"], un_label_weight=s["un_label_weight"],
        pos_distance_thr=s["pos_distance_thr"],
        neg_distance_thr=s["neg_distance_thr"],
        ema_bn_stats=s["ema_bn_stats"], head=cfg["model"]["head"],
        teacher_jitter=s["teacher_jitter"])


def train_state(cfg: dict, net, device):
    """The student, its EMA teacher and AdamW at the recipe's constant
    first-epoch learning rate (the milestones lie 24 epochs away)."""
    o = cfg["optim"]
    lr = o["lr"]
    return create_train_state(net, lambda step: lr, device=device,
                              weight_decay=o["weight_decay"],
                              grad_clip_norm=o["grad_clip_norm"])
