"""Semi-supervised training: the window drives the port's semi step
(``train.semi.make_semi_train_step``) back to back on the traffic's
batches.

Set-up builds one train state (student, EMA teacher, AdamW) from the
seed's weights and drives it through the traffic's ``checked_steps``
first steps with the window's own call and feed (batches 0, 1, 2: rows
that all differ), recording the loss of each, the first gradient from
AdamW's state, every leaf of the student and of the EMA teacher after the
last, and the unlabeled scans' state (``UlbState``); the window then
carries the same state on. After the window the reference repeats those
steps from the same weights and inputs.
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.harness import compare, weights
from perfbench.harness.cell import Cell, Phases, check_port_config
from perfbench.harness.scenes import add_height, make_rooms

BETA1 = 0.9  # AdamW's first-moment decay, the recipe's


class Kind:
    unit = "step"
    spans = None
    e2e = "train_scenes_per_s"

    def __init__(self, cell: Cell):
        self.cell = cell
        t = cell.traffic
        self.n_l, self.n_u = t["labeled"], t["unlabeled"]
        self.b = self.n_l + self.n_u
        self.losses, self.kept = [], []

    # ------------------------------------------------------------ inputs
    def _batches(self) -> list:
        c, t = self.cell, self.cell.traffic
        gen = c.gen("scenes")
        n, g, k = t["points"], t["max_gt"], t["gt_boxes"]
        classes = c.cfg["model"]["num_classes"]
        out = []
        for _ in range(t["batches"]):
            pts, boxes, _ = make_rooms(gen, self.b, 2 * n, (k, k))
            gt = torch.zeros((self.b, g, 7), device=c.device)
            gt[:, :k] = boxes
            labels = torch.zeros((self.b, g), dtype=torch.long,
                                 device=c.device)
            labels[:, :k] = torch.randint(0, classes, (self.b, k),
                                          generator=gen, device=c.device)
            valid = torch.zeros((self.b, g), dtype=torch.bool,
                                device=c.device)
            valid[:, :k] = True
            out.append(dict(points_raw_s=add_height(pts[:, :n]),
                            points_raw_t=add_height(pts[:, n:]),
                            gt_boxes=gt, gt_labels=labels, gt_valid=valid))
        return out

    def _draws(self, gen: torch.Generator) -> dict:
        """One step's draws: the strong view's augmentation (the weak
        view's is the identity), the student's jitter noise and the
        unlabeled slots' scans."""
        a, dev = self.cell.cfg["augment"], self.cell.device
        b, p = self.b, self.cell.cfg["model"]["num_proposal"]

        def u(lo, hi):
            return lo + (hi - lo) * torch.rand((b,), generator=gen,
                                               device=dev)

        aug = (torch.rand((b,), generator=gen, device=dev) < a["flip_h"],
               torch.rand((b,), generator=gen, device=dev) < a["flip_v"],
               u(-a["rot_range"], a["rot_range"]), u(*a["scale_range"]),
               torch.randn((b, 3), generator=gen, device=dev)
               * a["translation_std"])
        noise = (torch.randn((b, p, 3), generator=gen, device=dev),
                 torch.randn((b, p, 3), generator=gen, device=dev))
        scans = torch.randint(0, self.cell.traffic["unlabeled_scans"],
                              (b,), generator=gen, device=dev)
        scans[:self.n_l] = 0
        return dict(aug=aug, noise=noise, scans=scans)

    @staticmethod
    def _feed(batch: dict, d: dict, aug_cls) -> dict:
        b = batch["points_raw_s"].shape[0]
        dev = batch["points_raw_s"].device
        return dict(batch, aug_s=aug_cls(*d["aug"]),
                    aug_t=aug_cls.identity((b,), device=dev),
                    ulb_scan_idx=d["scans"])

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from nesie_tpu_torch.config import get_config
        from nesie_tpu_torch.data.augment import AugParams
        from nesie_tpu_torch.train.runner import build_model
        from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
        from nesie_tpu_torch.train.state import (
            create_train_state,
            make_lr_schedule,
        )

        ph = self.phases = Phases()
        c, t = self.cell, self.cell.traffic
        name = c.cfg["port_configs"]["train"]
        pcfg = get_config(name)
        check_port_config(c.cfg, name, dict(
            model=pcfg.model, loss=pcfg.loss, pseudo=pcfg.pseudo,
            optim=dict(vars(pcfg.optim), repeat=pcfg.data.repeat),
            semi={k: getattr(pcfg, k) for k in c.cfg["semi"]}))
        model = build_model(pcfg)
        ph.mark("imports and model")
        self.spec = weights.spec(model.state_dict())
        model.load_state_dict(weights.make_weights(self.spec, c.gen("weights")))
        ph.mark("weights")
        o = c.cfg["optim"]
        steps_per_epoch = max(t["labeled_scans"] * o["repeat"] // self.n_l, 1)
        self.state = create_train_state(
            model, make_lr_schedule(o["lr"], steps_per_epoch,
                                    o["lr_milestones"], o["lr_gamma"]),
            device=c.device, weight_decay=o["weight_decay"],
            grad_clip_norm=o["grad_clip_norm"])
        ph.mark("create_train_state")
        self.ulb = UlbState.create(t["unlabeled_scans"],
                                   c.cfg["model"]["num_classes"],
                                   device=c.device)
        s = c.cfg["semi"]
        self.step = make_semi_train_step(
            self.n_l, t["labeled_scans"], loss_cfg=pcfg.loss,
            pl_cfg=pcfg.pseudo, sample_mod=s["sample_mod_train"],
            ema_momentum=s["ema_momentum"], ema_warm_up=s["ema_warm_up"],
            un_label_weight=s["un_label_weight"],
            pos_distance_thr=s["pos_distance_thr"],
            neg_distance_thr=s["neg_distance_thr"],
            ema_bn_stats=s["ema_bn_stats"], head=c.cfg["model"]["head"],
            teacher_jitter=s["teacher_jitter"])
        self.aug_cls = AugParams
        ph.mark("train state")
        self.batches = self._batches()
        self.draw_gen = c.gen("steps")
        self.checked = [self._draws(self.draw_gen)
                        for _ in range(t["checked_steps"])]
        self.sync()
        ph.mark("batches")
        self.prog = self._checked_steps()
        self.i = t["checked_steps"]
        self.sync()
        ph.mark("checked steps")

    def _one(self, batch: dict, d: dict) -> dict:
        self.ulb, metrics = self.step(self.state, self.ulb,
                                      self._feed(batch, d, self.aug_cls),
                                      noise=d["noise"])
        return metrics

    def _checked_steps(self) -> dict:
        before = snapshot(self.state)
        losses, grads = [], {}
        for j, d in enumerate(self.checked):
            m = self._one(self.batches[j], d)
            losses.append(float(m["loss"]))
            self.kept.append(float(m["num_pseudo"]))
            if j == 0:
                grads = first_gradients(self.state.model,
                                        self.state.optimizer)
        return readings(self.state, self.ulb, before, losses, grads)

    def run_unit(self) -> None:
        d = self._draws(self.draw_gen)
        m = self._one(self.batches[self.i % len(self.batches)], d)
        self.i += 1
        self.losses.append(m["loss"])
        self.kept.append(m["num_pseudo"])

    def sync(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def window_metrics(self, units: int, wall_s: float) -> dict:
        return {self.e2e: units * self.b / wall_s}

    def outcome(self) -> tuple[int, int]:
        """(attempted, failed): the window's steps and those whose loss
        is not finite."""
        if not self.losses:
            return 0, 0
        loss = torch.stack(self.losses).float().cpu()
        return len(self.losses), int((~torch.isfinite(loss)).sum())

    def notes(self) -> list[str]:
        kept = [float(k) for k in self.kept]
        return [self.phases.line(), f"pseudo-boxes kept a step (checked steps, then the "
                f"window): {kept[:3]} then {kept[3:][:12]}"
                f"{' ...' if len(kept) > 15 else ''}; total "
                f"{sum(kept):.0f} over {len(kept)} steps"]

    def free(self) -> None:
        keep = self.batches[:len(self.checked)]
        del self.state, self.ulb, self.step
        self.batches = keep
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ reference
    def reference(self, tf32: bool = False, fault: str | None = None,
                  device=None) -> dict:
        """The reference's readings of the checked steps. ``tf32``: the
        control's precision. ``fault``: one planted in the reference put
        in the program's place: "half" leaves out half of the labeled and
        of the unlabeled rows, "label" moves every GT box to the next
        class, "teacher" leaves the EMA teacher unchanged, "ulb" leaves
        the unlabeled scans' state unchanged. ``device``: where it runs,
        the cell's by default; on the CPU it is a sound float32 run in
        another order of operations."""
        from perfbench.reference import build
        from perfbench.reference.data.augment import AugParams
        from perfbench.reference.train import semi

        c, t = self.cell, self.cell.traffic
        dev = c.device if device is None else torch.device(device)
        with precision(tf32), planted(semi, fault):
            net = build.model(c.cfg)
            if weights.spec(net.state_dict()) != self.spec:
                raise RuntimeError("the reference's parameters differ from "
                                   "the program's by name or shape")
            net.load_state_dict(weights.make_weights(self.spec,
                                                     c.gen("weights")))
            state = build.train_state(c.cfg, net, dev)
            n_l = self.n_l // 2 if fault == "half" else self.n_l
            rows = (list(range(n_l))
                    + list(range(self.n_l, self.n_l
                                 + (self.n_u // 2 if fault == "half"
                                    else self.n_u))))
            step = build.semi_step(c.cfg, n_l, t["labeled_scans"])
            ulb = semi.UlbState.create(t["unlabeled_scans"],
                                       c.cfg["model"]["num_classes"],
                                       device=dev)
            before = snapshot(state)
            losses, grads = [], {}
            for j, d in enumerate(self.checked):
                batch = to_device(self._feed(self.batches[j], d, AugParams),
                                  dev)
                noise = to_device(d["noise"], dev)
                if fault == "half":
                    idx = torch.tensor(rows, device=dev)
                    batch = {k: (type(v)(*(f[idx] for f in v))
                                 if isinstance(v, AugParams) else v[idx])
                             for k, v in batch.items()}
                    noise = tuple(x[idx] for x in noise)
                if fault == "label":
                    batch["gt_labels"] = (batch["gt_labels"] + 1) % c.cfg[
                        "model"]["num_classes"]
                ulb, m = step(state, ulb, batch, noise=noise)
                losses.append(float(m["loss"]))
                if j == 0:
                    grads = first_gradients(state.model, state.optimizer)
            return readings(state, ulb, before, losses, grads)

    def numbers(self, ref: dict) -> dict:
        return compare.training_numbers(self.prog, ref)

    def numbers_from(self, readings: dict, ref: dict) -> dict:
        """The numbers of ``readings`` (the reference's form: a control
        or a planted fault) put in the program's place."""
        return compare.training_numbers(readings, ref)


def snapshot(state) -> dict:
    """Every leaf of the student and of the teacher, copied."""
    return {who: {k: v.detach().clone()
                  for k, v in getattr(state, who).state_dict().items()}
            for who in ("model", "teacher")}


def readings(state, ulb, before: dict, losses: list, grads: dict) -> dict:
    """What ``compare.training_numbers`` compares, after the checked
    steps: the losses, the first gradients, the change of every floating
    leaf of the student (``changes``) and of the teacher
    (``teacher_changes``) since ``before``, and the unlabeled scans'
    state."""
    out = dict(losses=losses, grads=grads,
               ulb=tuple(x.detach().clone() for x in ulb))
    for who, key in (("model", "changes"), ("teacher", "teacher_changes")):
        after = getattr(state, who).state_dict()
        out[key] = {k: (after[k].detach() - v).float()
                    for k, v in before[who].items() if v.is_floating_point()}
    return out


def to_device(x, dev):
    """Tensors of a dict, tuple or named tuple moved to ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_device(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def planted(semi, fault: str | None):
    """The reference's semi step with a state left unchanged: the EMA
    teacher ("teacher") or the unlabeled scans' state ("ulb")."""
    swaps = {"teacher": ("ema_update", lambda *a, **k: 0.0),
             "ulb": ("update_ulb_state", lambda ulb, *a: ulb)}
    if fault not in swaps:
        yield
        return
    name, fake = swaps[fault]
    real = getattr(semi, name)
    setattr(semi, name, fake)
    try:
        yield
    finally:
        setattr(semi, name, real)


def first_gradients(model, optimizer) -> dict:
    """Each parameter's gradient as AdamW got it in its first step, from
    its state: the first moment over 1 - beta1."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            out[name] = (st["exp_avg"] / (1.0 - BETA1)).detach().clone()
    return out


class precision:
    """float32 with TF32 off, or TF32 on (the control), for a block."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
