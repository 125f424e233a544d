"""Rank processes for ``tests/test_torch_ddp.py`` (no tests here).

This module imports no jax and nothing of the JAX package, so that the
ranks, spawned with ``torch.multiprocessing``, load only torch and the
port. ``launch`` starts ``world`` ranks on the CPU under gloo
(``parallel.launch.spawn_ranks``: the environment ``torchrun`` gives a
rank, every rank joined with a timeout); a job called in the test's own
process (no such environment, no process group) is the one-process run of
the same function.

The jobs take their inputs as tensors of the global batch and keep this
rank's rows of each part (``parallel.RowLayout``).
"""
from __future__ import annotations

import torch

from nesie_tpu_torch import parallel
from nesie_tpu_torch.parallel.launch import spawn_ranks
from nesie_tpu_torch.data.augment import AugParams
from nesie_tpu_torch.nn.detector import VoteNetNesie
from nesie_tpu_torch.nn.layers import BatchNorm
from nesie_tpu_torch.train import semi as tsemi
from nesie_tpu_torch.train import state as tstate
from nesie_tpu_torch.train.pseudo_label import PseudoLabelConfig, get_pseudo_labels
from nesie_tpu_torch.train.semi import UlbState, make_semi_train_step
from nesie_tpu_torch.train.state import create_train_state, make_lr_schedule
from nesie_tpu_torch.train.step import make_supervised_train_step
from nesie_tpu_torch.train.sup_loss import NesieLossConfig

JOIN_TIMEOUT_S = 300  # every rank of a launch must end within this


def launch(job: str, world: int, args: dict, out_dir) -> list:
    """Run ``JOBS[job](args)`` on ``world`` gloo ranks on the CPU; returns
    the ranks' results in rank order. Raises if a rank fails or outlives
    ``JOIN_TIMEOUT_S`` (every rank is then killed)."""
    return spawn_ranks(_run_job, world, (job, args), out_dir,
                       JOIN_TIMEOUT_S)


def _run_job(job_args):
    job, args = job_args
    torch.set_num_threads(1)
    parallel.make_mesh(device="cpu")
    return JOBS[job](args)


def _rows(x, layout):
    """This rank's rows of a global tensor (all of them in one process)."""
    return x if layout is None else x[layout.index()]


def _local(tree, layout):
    if isinstance(tree, dict):
        return {k: _local(v, layout) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_local(v, layout) for v in tree)
    return _rows(tree, layout)


# ------------------------------------------------------------------ jobs
def bn_job(args) -> dict:
    """Train-mode BatchNorm forward and backward of ``x`` (B, P, C) against
    the cotangent ``cot``: output, input gradient and the parameter
    gradients summed over the ranks, running statistics."""
    x, cot = args["x"], args["cot"]
    layout = parallel.part_rows(x.shape[0] // parallel.world_size())
    bn = BatchNorm(x.shape[-1]).double()
    bn.load_state_dict(args["state"])
    xl = _rows(x, layout).clone().requires_grad_()
    y = bn(xl)
    (y * _rows(cot, layout)).sum().backward()
    parallel.all_reduce_sum_([bn.weight.grad, bn.bias.grad])
    return dict(y=y.detach(), dx=xl.grad, dw=bn.weight.grad,
                db=bn.bias.grad, mean=bn.running_mean, var=bn.running_var)


def step_job(args) -> dict:
    """``args["steps"]`` supervised (``kind="sup"``) or semi steps of the
    port on this rank's rows of ``args["batch"]``, whose parts hold
    ``args["parts"]`` rows a rank. The draws: ``args["noise"]`` (the
    global batch's jitter noise) or generators seeded ``args["seed"]``
    (student) and ``seed + 1`` (teacher). Returns every step's metrics,
    the first step's gradients as the clip gets them, the teacher's
    aggregation indices and the pseudo-labels of the first step, and the
    student, the teacher, AdamW's state and ``UlbState`` after the last
    step."""
    parts = tuple(args["parts"])
    layout = parallel.part_rows(*parts)
    model = VoteNetNesie(**args["model"]).double()
    model.load_state_dict(args["state"])
    state = create_train_state(model, make_lr_schedule(args["lr"], 10),
                               device="cpu")
    batch = _local(args["batch"], layout)
    for k in [k for k in batch if k.startswith("aug")]:
        batch[k] = AugParams(**batch[k])
    noise = args.get("noise")
    draws = {}
    if noise is not None:
        draws["noise"] = _local(tuple(noise), layout)
    else:
        draws["generator"] = torch.Generator().manual_seed(args["seed"])
    names = [n for n, _ in state.model.named_parameters()]
    grads, seen = {}, {}
    clip, get_pl = tstate.clip_by_global_norm_, tsemi.get_pseudo_labels

    def recording_clip(gs, max_norm):
        if not grads:
            grads.update({n: g.clone() for n, g in zip(names, gs)})
        return clip(gs, max_norm)

    def recording_pl(teacher_results, acc, cfg, rows=None):
        lab = get_pl(teacher_results, acc, cfg, rows)
        seen.setdefault("teacher_agg", teacher_results["aggregated_indices"])
        seen.setdefault("pl", [lab.valid, lab.labels, lab.quality, lab.boxes])
        return lab

    loss_cfg = NesieLossConfig(num_classes=args["model"].get(
        "num_classes", 18))
    head = args["model"].get("head", "nesie")
    metrics, ulb = [], None
    tstate.clip_by_global_norm_ = recording_clip
    tsemi.get_pseudo_labels = recording_pl
    try:
        if args["kind"] == "sup":
            step = make_supervised_train_step(loss_cfg, head=head)
            for _ in range(args["steps"]):
                metrics.append(step(state, batch, **draws))
        else:
            step = make_semi_train_step(
                parts[0], args["num_labeled_scans"], loss_cfg=loss_cfg,
                pl_cfg=PseudoLabelConfig(**args["pl"]), head=head)
            if noise is None:
                draws["teacher_generator"] = torch.Generator().manual_seed(
                    args["seed"] + 1)
            ulb = UlbState(*args["ulb"])
            for _ in range(args["steps"]):
                ulb, m = step(state, ulb, batch, **draws)
                metrics.append(m)
    finally:
        tstate.clip_by_global_norm_, tsemi.get_pseudo_labels = clip, get_pl
    opt = state.optimizer.state_dict()["state"]
    return dict(
        metrics=[{k: float(v) for k, v in m.items()} for m in metrics],
        grads=grads, seen=seen, step=state.step,
        params=state.model.state_dict(), teacher=state.teacher.state_dict(),
        adam=[opt[i][k] for i in sorted(opt) for k in ("exp_avg",
                                                       "exp_avg_sq")],
        ulb=None if ulb is None else list(ulb))


def pseudo_label_job(args) -> dict:
    """``get_pseudo_labels`` on this rank's rows of a teacher's outputs
    (parts of ``args["parts"]`` rows a rank)."""
    layout = parallel.part_rows(*args["parts"])
    lab = get_pseudo_labels(_local(args["teacher"], layout), args["acc"],
                            PseudoLabelConfig(**args["pl"]), layout)
    return dict(valid=lab.valid, labels=lab.labels, quality=lab.quality,
                boxes=lab.boxes)


def cli_job(args) -> dict:
    """The train CLI on ``args["train"]`` (a list of argument lists, run in
    order), then the test CLI on ``args["test"]`` if given. Records the
    checkpoint saves this rank made, the labeled rows each semi batch
    held and the detections the AP evaluation got."""
    import nesie_tpu_torch.eval as teval
    from nesie_tpu_torch.data.dataset import SimiScanNetScenes
    from nesie_tpu_torch.tools import test as ttest
    from nesie_tpu_torch.tools import train as ttrain
    from nesie_tpu_torch.train import runner

    saves, labeled, seen = [], [], {}
    save, semi_batch = runner.CheckpointManager.save, \
        SimiScanNetScenes.semi_batch
    indoor_eval = teval.indoor_eval

    def recording_eval(gt_annos, dt_annos, **kw):
        seen["dt"] = detections(dt_annos)
        return indoor_eval(gt_annos, dt_annos, **kw)

    def recording_save(mgr, step, state, ulb_state=None, meta=None):
        saves.append(dict(step=int(step), **(meta or {})))
        return save(mgr, step, state, ulb_state, meta)

    def recording_batch(ds, labeled_indices, *a, **kw):
        labeled.append([int(i) for i in labeled_indices])
        return semi_batch(ds, labeled_indices, *a, **kw)

    runner.CheckpointManager.save = recording_save
    SimiScanNetScenes.semi_batch = recording_batch
    teval.indoor_eval = recording_eval
    try:
        steps = [int(ttrain.main(argv).step) for argv in args["train"]]
        results = ttest.main(args["test"]) if args.get("test") else None
        if results is not None:
            results = {k: float(v) for k, v in results.items()}
    finally:
        runner.CheckpointManager.save = save
        SimiScanNetScenes.semi_batch = semi_batch
        teval.indoor_eval = indoor_eval
    return dict(saves=saves, labeled=labeled, steps=steps, results=results,
                detections=seen.get("dt"))


def detections(dt_annos) -> dict:
    """The AP evaluation's detections as tensors: boxes, scores and labels
    of every scene in order, and each scene's count."""
    return dict(
        counts=torch.tensor([len(d["labels"]) for d in dt_annos]),
        **{k: torch.cat([torch.as_tensor(d[k]) for d in dt_annos])
           for k in ("boxes", "scores", "labels")})


JOBS = dict(bn=bn_job, step=step_job, pseudo_labels=pseudo_label_job,
            cli=cli_job)
