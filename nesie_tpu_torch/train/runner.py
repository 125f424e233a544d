"""Training runner: epoch loop, logging, checkpoints. Counterpart of
``nesie_tpu/train/runner.py``.

Replaces the reference's mmcv EpochBasedRunner / SimiEpochBasedRunner
(mmdet3d/runner/simi_epoch_based_runner.py) with a plain loop around the
port's steps, and the JAX package's loop step for step: the same steps per
epoch, global batch, scene order (one ``default_rng(seed)`` stream) and
data stream (``default_rng([seed, 0])``), log interval and checkpoint
cadence, so that one seed gives the JAX runner's batch sequence.

* The step's random draws (the student's proposal jitter) come from a
  ``torch.Generator`` on the run's device, seeded with ``cfg.seed``.
* The host waits for the device only on ``log_interval`` steps and once an
  epoch, for the pseudo-label count the semi loop sums on the device.
* A ``Prefetcher`` thread builds the next host batch and starts its copy
  to the device while the card runs the step.
* ``CheckpointManager`` writes ``<work_dir>/checkpoints/<step>/
  checkpoint.pth``: the student and the teacher, the optimizer, the step,
  the semi loop's ``UlbState`` and a ``meta`` dict; the reference's paired
  ``epoch_N.pth`` / ``epoch_N_ema.pth`` files in one.

The port runs on one device. Options it does not have yet raise
``NotImplementedError`` naming their ROADMAP item (``check_supported``).
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch.config import ExperimentConfig
from nesie_tpu_torch.data.dataset import (
    AugConfig,
    SimiScanNetScenes,
    SubScanNetScenes,
    batch_to_device,
)
from nesie_tpu_torch.data.prefetch import Prefetcher
from nesie_tpu_torch.nn.detector import VoteNetNesie, init_weights_flax_
from nesie_tpu_torch.nn.nesie_head import SUPPORTED_SAMPLE_MODS
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_lr_schedule,
)
from nesie_tpu_torch.train.step import make_supervised_train_step
from nesie_tpu_torch.utils import LOGGER_NAME, MetricsLogger, collect_env

log = logging.getLogger(LOGGER_NAME)

MESH_SIZE = 1  # devices a run spans; checkpoints record it


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` for every setting the port lacks."""
    missing = []
    for key, mode in (("sample_mod_train", cfg.sample_mod_train),
                      ("test.sample_mod", cfg.test.sample_mod)):
        if mode not in SUPPORTED_SAMPLE_MODS:
            missing.append(f"{key}={mode!r} (ROADMAP §1.3)")
    if cfg.model.compute_dtype is not None:
        missing.append(f"model.compute_dtype={cfg.model.compute_dtype!r} "
                       "(ROADMAP §1.3)")
    if cfg.teacher_jitter:
        missing.append("teacher_jitter=True (ROADMAP §1.3)")
    if cfg.test.iou_opt:
        missing.append("test.iou_opt=True (ROADMAP §1.3)")
    if cfg.num_devices not in (None, 1):
        missing.append(f"num_devices={cfg.num_devices} (ROADMAP §1.4, DDP)")
    if missing:
        raise NotImplementedError("nesie_tpu_torch does not support "
                                  + "; ".join(missing) + " yet")


def build_model(cfg: ExperimentConfig) -> VoteNetNesie:
    check_supported(cfg)
    m = cfg.model
    return VoteNetNesie(
        num_classes=m.num_classes,
        reg_max=m.reg_max,
        num_proposal=m.num_proposal,
        in_channels=m.in_channels,
        dataset_name=m.dataset_name,
        sizes=tuple(m.sizes),
        num_points=tuple(m.num_points),
        radii=tuple(m.radii),
        num_samples=tuple(m.num_samples),
        sa_channels=tuple(map(tuple, m.sa_channels)),
        fp_channels=tuple(map(tuple, m.fp_channels)),
        jitter_scale=m.jitter_scale,
        jitter_size_bias=m.jitter_size_bias,
        head=m.head,
    )


def strong_aug_config(cfg: ExperimentConfig) -> AugConfig:
    return AugConfig(
        rot_range=cfg.data.aug_rot_range,
        scale_range=tuple(cfg.data.aug_scale_range),
        translation_std=cfg.data.aug_translation_std,
    )


def _lr_schedule(cfg: ExperimentConfig, steps_per_epoch: int):
    o = cfg.optim
    return make_lr_schedule(o.lr, steps_per_epoch, o.lr_milestones,
                            o.lr_gamma)


def init_state(cfg: ExperimentConfig, model, steps_per_epoch: int,
               device="cuda") -> TrainState:
    """Weights from flax's default initializers, as the JAX package's
    ``init_state`` draws them, seeded through a CPU ``torch.Generator``
    (``cfg.seed``) and moved to ``device``; a teacher copy, AdamW and
    the LR schedule."""
    init_weights_flax_(model, torch.Generator().manual_seed(cfg.seed))
    return create_train_state(
        model, _lr_schedule(cfg, steps_per_epoch), device=device,
        weight_decay=cfg.optim.weight_decay,
        grad_clip_norm=cfg.optim.grad_clip_norm)


def _sup_step_fn(cfg: ExperimentConfig):
    return make_supervised_train_step(
        cfg.loss, cfg.sample_mod_train, cfg.ema_momentum, cfg.ema_warm_up,
        cfg.pos_distance_thr, cfg.neg_distance_thr,
        ema_bn_stats=cfg.ema_bn_stats, head=cfg.model.head)


def _semi_step_fn(cfg: ExperimentConfig, n_labeled: int,
                  num_labeled_scans: int):
    return make_semi_train_step(
        n_labeled, num_labeled_scans, loss_cfg=cfg.loss, pl_cfg=cfg.pseudo,
        sample_mod=cfg.sample_mod_train, ema_momentum=cfg.ema_momentum,
        ema_warm_up=cfg.ema_warm_up, un_label_weight=cfg.un_label_weight,
        pos_distance_thr=cfg.pos_distance_thr,
        neg_distance_thr=cfg.neg_distance_thr, ema_bn_stats=cfg.ema_bn_stats,
        head=cfg.model.head)


class CheckpointManager:
    """One directory a step under ``<work_dir>/checkpoints``, each with a
    ``checkpoint.pth``; the newest ``max_to_keep`` are kept."""

    FILE = "checkpoint.pth"

    def __init__(self, work_dir, max_to_keep: int = 3):
        self.path = Path(work_dir).absolute() / "checkpoints"
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        if not self.path.is_dir():
            return []
        return sorted(int(d.name) for d in self.path.iterdir()
                      if d.name.isdigit() and (d / self.FILE).exists())

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, ulb_state=None,
             meta: dict | None = None):
        payload = dict(
            model=state.model.state_dict(),
            teacher=state.teacher.state_dict(),
            optimizer=state.optimizer.state_dict(),
            step=state.step,
            ulb_state=None if ulb_state is None else ulb_state._asdict(),
            meta=meta or {})
        final = self.path / str(step)
        tmp = self.path / f".{step}.{os.getpid()}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        torch.save(payload, tmp / self.FILE)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path / str(old))

    def load(self, step=None):
        """The raw payload of ``step`` (default the latest) in host
        memory, or None when the directory holds no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.path / str(step) / self.FILE,
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, ulb_state=None, step=None,
                mesh_size=None):
        """Restore the latest checkpoint (or ``step``) into ``state`` in
        place; returns (state, ulb_state, the checkpoint's step). When ``mesh_size`` is
        given and the checkpoint was written under a different device
        count, the step counter is rescaled so the epoch position is
        preserved (reference simi_epoch_based_runner.py:220-231)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, ulb_state, 0
        # read to the host: load_state_dict copies each tensor to its
        # parameter's device, and leaves AdamW's step counts on the host
        # as a fresh optimizer keeps them (on the card they would cost a
        # sync per parameter and step)
        ckpt = self.load(step)
        state.model.load_state_dict(ckpt["model"])
        state.teacher.load_state_dict(ckpt["teacher"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        old_size = ckpt["meta"].get("mesh_size")
        if mesh_size and old_size and old_size != mesh_size:
            rescaled = int(step * old_size / mesh_size)
            log.info(
                "device count changed %d -> %d: rescaling resume step %d -> %d",
                old_size, mesh_size, step, rescaled,
            )
            step = state.step = rescaled
        if ulb_state is not None and ckpt["ulb_state"] is not None:
            dev = ulb_state.ulb_list.device
            ulb_state = UlbState(**{k: v.to(dev)
                                    for k, v in ckpt["ulb_state"].items()})
        return state, ulb_state, step


def weights_only_load(fresh_state: TrainState,
                      loaded_state: TrainState) -> TrainState:
    """--load-from semantics (reference train.py load_from vs
    resume_from): carry the student's parameters and BN statistics over,
    keep the fresh step counter and optimizer state so the new phase
    starts at epoch 0. The EMA teacher starts as a copy of the loaded
    student: the reference's SimiTeacherHook registers its ema buffers
    from the live parameters (simi_teacher_hook.py:47-52), and its
    pretrain checkpoints carry no EMA at all. (Resume restores the trained
    teacher instead.) ``load_state_dict`` copies, so the loaded state's
    tensors stay its own."""
    sd = loaded_state.model.state_dict()
    fresh_state.model.load_state_dict(sd)
    fresh_state.teacher.load_state_dict(sd)
    return fresh_state


def _host_values(metrics: dict) -> dict:
    """A step's 0-dim metric tensors as floats, in one copy to the host
    (the one wait for the device on a logging step)."""
    vals = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def _log_metrics(step, epoch, vals: dict, t_step):
    msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
    log.info("epoch %d step %d (%.2fs/it): %s", epoch, step, t_step, msg)


def _prepare(cfg: ExperimentConfig, load_state, steps_per_epoch, device):
    """The run's TrainState: ``load_state`` if given, else a fresh one;
    either way with this run's LR schedule."""
    if load_state is None:
        return init_state(cfg, build_model(cfg), steps_per_epoch, device)
    check_supported(cfg)
    load_state.lr_schedule = _lr_schedule(cfg, steps_per_epoch)
    return load_state


def train_supervised(cfg: ExperimentConfig, dataset: SubScanNetScenes,
                     load_state=None, resume: bool = False,
                     epoch_callback=None, device="cuda") -> TrainState:
    """Supervised pretrain loop (reference VoteNet phase, votenet.py:27)."""
    device = torch.device(device)
    bs = cfg.data.samples_per_step * MESH_SIZE
    n = len(dataset)
    steps_per_epoch = max(n * cfg.data.repeat // bs, 1)
    state = _prepare(cfg, load_state, steps_per_epoch, device)
    step_fn = _sup_step_fn(cfg)
    work = Path(cfg.work_dir) / cfg.name
    ckpt = CheckpointManager(work)
    if resume:
        state, _, at = ckpt.restore(state, mesh_size=MESH_SIZE)
        log.info("resumed from step %d", at)
    log.info("env: %s", collect_env())
    log.info("device %s, batch %d, %d steps an epoch", device, bs,
             steps_per_epoch)
    # the scene order and the point/augmentation draws are two streams,
    # as in the JAX runner (its process-local stream of process 0)
    order_rng = np.random.default_rng(cfg.seed)
    rng = np.random.default_rng([cfg.seed, 0])
    gen = torch.Generator(device).manual_seed(cfg.seed)
    aug_cfg = strong_aug_config(cfg)

    def epoch_batches(order):
        for it in range(steps_per_epoch):
            idx = order[it * bs: (it + 1) * bs]
            if len(idx) < bs:
                return
            batch = dataset.train_batch(idx, rng, aug_cfg=aug_cfg,
                                        num_points=cfg.data.num_points)
            batch.pop("scene_ids", None)
            yield batch_to_device(batch, device)

    start_epoch = state.step // steps_per_epoch
    with MetricsLogger(work) as mlog:
        for epoch in range(start_epoch, cfg.optim.max_epochs):
            order = np.concatenate(
                [order_rng.permutation(n) for _ in range(cfg.data.repeat)]
            )
            for it, batch in enumerate(Prefetcher(epoch_batches(order))):
                t0 = time.perf_counter()
                metrics = step_fn(state, batch, generator=gen)
                if it % cfg.log_interval == 0:
                    vals = _host_values(metrics)
                    _log_metrics(state.step, epoch, vals,
                                 time.perf_counter() - t0)
                    mlog.log(state.step, vals)
            if (epoch + 1) % cfg.checkpoint_interval_epochs == 0:
                ckpt.save(state.step, state, meta={"mesh_size": MESH_SIZE})
            if epoch_callback is not None:
                epoch_callback(epoch, state)
    return state


def train_semi(cfg: ExperimentConfig, dataset: SimiScanNetScenes,
               load_state=None, resume: bool = False,
               epoch_callback=None, run_stats: dict | None = None,
               device="cuda") -> TrainState:
    """Semi-supervised loop (reference SimiEpochBasedRunner +
    VoteNetNesie.forward_train). A step's batch is [labeled x bs;
    unlabeled x ratio*bs]: labeled rows from the scene order, unlabeled
    rows drawn at random from the data stream.

    ``run_stats`` (optional dict) is filled with per-epoch pseudo-label
    production: ``num_pseudo_per_step`` (one mean per epoch) and the overall
    ``num_pseudo_mean``. A whole epoch with ZERO accepted pseudo-labels
    means the teacher-student mechanism silently degenerated to
    labeled-only training (the reference has no guard for this either —
    its thresholds assume a fully-trained pretrain); the runner logs a
    WARNING so it is visible in the logs and in studies."""
    device = torch.device(device)
    bs = cfg.data.samples_per_step * MESH_SIZE  # labeled rows a step
    B = bs * (1 + dataset.ratio)
    n = dataset.num_labeled
    steps_per_epoch = max(n * cfg.data.repeat // bs, 1)
    state = _prepare(cfg, load_state, steps_per_epoch, device)
    step_fn = _semi_step_fn(cfg, bs, dataset.num_labeled)
    ulb_state = UlbState.create(dataset.num_unlabeled, cfg.model.num_classes,
                                device=device)
    work = Path(cfg.work_dir) / cfg.name
    ckpt = CheckpointManager(work)
    if resume:
        state, ulb_state, at = ckpt.restore(state, ulb_state,
                                             mesh_size=MESH_SIZE)
        log.info("resumed from step %d", at)
    log.info("env: %s", collect_env())
    log.info("device %s, batch %d+%d, %d steps an epoch", device, bs, B - bs,
             steps_per_epoch)
    order_rng = np.random.default_rng(cfg.seed)
    rng = np.random.default_rng([cfg.seed, 0])
    gen = torch.Generator(device).manual_seed(cfg.seed)
    aug_cfg = strong_aug_config(cfg)

    def epoch_batches(order):
        for it in range(steps_per_epoch):
            idx = order[it * bs: (it + 1) * bs]
            if len(idx) < bs:
                return
            batch = dataset.semi_batch(
                idx, rng, strong_cfg=aug_cfg,
                num_points=cfg.data.num_points, n_unlabeled=B - bs,
            )
            yield batch_to_device(batch, device)

    start_epoch = state.step // steps_per_epoch
    pseudo_means = [] if run_stats is None else run_stats.setdefault(
        "num_pseudo_per_step", [])
    with MetricsLogger(work) as mlog:
        for epoch in range(start_epoch, cfg.optim.max_epochs):
            order = np.concatenate(
                [order_rng.permutation(n) for _ in range(cfg.data.repeat)]
            )
            # device-side accumulator: no per-step host sync, one read an epoch
            ep_pseudo = torch.zeros((), device=device)
            ep_steps = 0
            for it, batch in enumerate(Prefetcher(epoch_batches(order))):
                t0 = time.perf_counter()
                ulb_state, metrics = step_fn(state, ulb_state, batch,
                                             generator=gen)
                ep_pseudo += metrics["num_pseudo"]
                ep_steps += 1
                if it % cfg.log_interval == 0:
                    vals = _host_values(metrics)
                    _log_metrics(state.step, epoch, vals,
                                 time.perf_counter() - t0)
                    mlog.log(state.step, vals)
            total_pseudo = float(ep_pseudo)
            mean_pseudo = total_pseudo / max(ep_steps, 1)
            pseudo_means.append(mean_pseudo)
            mlog.log(state.step, {"epoch_num_pseudo_mean": mean_pseudo})
            if total_pseudo == 0.0:
                log.warning(
                    "epoch %d produced ZERO pseudo-labels across %d steps — the "
                    "semi-supervised loop is training labeled-only (teacher not "
                    "confident enough for the pseudo.* thresholds)",
                    epoch, ep_steps,
                )
            if (epoch + 1) % cfg.checkpoint_interval_epochs == 0:
                ckpt.save(state.step, state, ulb_state,
                          meta={"mesh_size": MESH_SIZE})
            if epoch_callback is not None:
                epoch_callback(epoch, state)
        if run_stats is not None and pseudo_means:
            run_stats["num_pseudo_mean"] = float(np.mean(pseudo_means))
    return state
