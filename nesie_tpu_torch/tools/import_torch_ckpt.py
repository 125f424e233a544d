#!/usr/bin/env python
"""Import a reference torch checkpoint (``.pth``) as a runner checkpoint
of the port (counterpart of ``tools/import_torch_ckpt.py``).

The reference trainer saves ``{"state_dict": ..., "meta": ...,
"optimizer": ...}``, with the EMA teacher riding as ``ema_<mangled>``
buffers inside the state_dict (train.py:203-213, simi_teacher_hook.py:
39-52). This tool builds the model of the named config, checks every
name and shape of the ``.pth`` against it (a wrong architecture or a
truncated file fails here, naming the keys, not later as NaN mAP), and
writes a step-0 checkpoint: the student from the state_dict, the teacher
from the ``ema_*`` buffers (a copy of the student when there are none, as
for a pretrain checkpoint), the teacher's BN statistics the student's,
and a fresh AdamW state::

    python -m nesie_tpu_torch.tools.import_torch_ckpt <config> ckpt.pth \\
        --work-dir WORK
    python -m nesie_tpu_torch.tools.test <config> WORK/<config>/checkpoints \\
        --data-root DATA [--teacher]

``tools/train.py --load-from`` and ``apis.init_detector(<config>,
<checkpoints dir>)`` read the same checkpoint.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path


def validate_state_dict(sd: dict, target: dict, what: str) -> None:
    """The names of ``sd`` are those of ``target`` and every shape
    agrees; else ``SystemExit`` naming the first 8 bad keys."""
    missing = sorted(set(target) - set(sd))
    extra = sorted(set(sd) - set(target))
    if missing or extra:
        raise SystemExit(
            f"{what}: the .pth does not match the model.\n"
            f"  missing from .pth: {missing[:8]}{'...' if len(missing) > 8 else ''}\n"
            f"  unexpected in .pth: {extra[:8]}{'...' if len(extra) > 8 else ''}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in target.items()
           if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise SystemExit(f"{what}: shape mismatches (key, .pth, model): "
                         f"{bad[:8]}")


def import_checkpoint(cfg, pth_path, work_dir, device="cuda") -> Path:
    """Write ``<work_dir>/<cfg.name>/checkpoints/0`` from the reference
    ``.pth`` at ``pth_path``; returns the checkpoints directory."""
    from nesie_tpu_torch.convert import load_reference_state_dicts
    from nesie_tpu_torch.train import runner

    state = runner.init_state(cfg, runner.build_model(cfg), 1, device)
    target = state.model.state_dict()

    student, teacher = load_reference_state_dicts(pth_path)
    validate_state_dict(student, target, "student")
    if teacher is student:
        logging.info("no ema_* buffers: the teacher is a copy of the "
                     "student (pretrain-checkpoint load_from semantics)")
    else:
        validate_state_dict(teacher, target, "teacher")
        logging.info("EMA teacher restored from the ema_* buffers")
    state.model.load_state_dict(student)
    state.teacher.load_state_dict(teacher)

    work = Path(work_dir) / cfg.name
    ckpt = runner.CheckpointManager(work)
    ckpt.save(0, state, meta={"mesh_size": 1, "imported_from": str(pth_path)})
    return ckpt.path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Import a reference .pth")
    p.add_argument("config")
    p.add_argument("pth")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)

    from nesie_tpu_torch.config import apply_overrides, get_config

    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    out = import_checkpoint(cfg, args.pth, args.work_dir, args.device)
    print(f"imported checkpoint at {out}")
    return out


if __name__ == "__main__":
    main()
