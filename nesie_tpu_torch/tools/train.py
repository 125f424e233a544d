#!/usr/bin/env python
"""Training CLI of the port (counterpart of ``tools/train.py``; reference
train.py).

Examples:
    python -m nesie_tpu_torch.tools.train nesie-votenet-scannet-pretrain-010 \\
        --data-root /data/scannet
    python -m nesie_tpu_torch.tools.train nesie-votenet-scannet-train-010 \\
        --data-root /data/scannet --load-from work_dirs/.../checkpoints

``--device cpu`` runs on the CPU (the kernels' plain versions).

Data-parallel, one process a card (gloo for ranks on the CPU or sharing a
card, NCCL otherwise; ``parallel.mesh``)::

    torchrun --nproc_per_node 4 -m nesie_tpu_torch.tools.train \
        nesie-votenet-scannet-train-010 --data-root /data/scannet \
        --load-from work_dirs/.../checkpoints

The global batch is ``data.samples_per_step`` times the ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a nesie_tpu_torch detector")
    p.add_argument("config", help="named config, e.g. nesie-votenet-scannet-train-010")
    p.add_argument("--data-root", required=True)
    p.add_argument("--work-dir", default="work_dirs")
    p.add_argument("--load-from", default=None,
                   help="checkpoint dir to initialize from (pretrain ckpt)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-node training: the process group comes from "
                        "torchrun's environment (--nnodes, --rdzv-endpoint); "
                        "fails without it")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel size; must equal the ranks torchrun "
                        "launched (default: that number)")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="linear-scale lr by num_devices/8 "
                        "(reference train.py:127-129)")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dot-path overrides, e.g. optim.lr=0.004")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)

    from nesie_tpu_torch import parallel
    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data.dataset import SimiScanNetScenes, SubScanNetScenes
    from nesie_tpu_torch.train import runner

    cfg = get_config(args.config)
    cfg = dataclasses.replace(cfg, seed=args.seed, work_dir=args.work_dir,
                              num_devices=args.num_devices)
    cfg = apply_overrides(cfg, args.cfg_options)
    mesh = parallel.make_mesh(cfg.num_devices, args.device)
    if args.multihost and mesh.backend is None:
        raise ValueError("--multihost needs the process group's environment: "
                         "launch with torchrun (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT)")
    if args.autoscale_lr:
        n_dev = cfg.num_devices or mesh.size
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, lr=cfg.optim.lr * n_dev / 8)
        )
        logging.info("autoscaled lr to %g for %d devices", cfg.optim.lr, n_dev)

    # dump the resolved config into the work dir (reference train.py:144)
    work = Path(args.work_dir) / cfg.name
    if mesh.rank == 0:
        work.mkdir(parents=True, exist_ok=True)
        (work / "config.json").write_text(
            json.dumps(dataclasses.asdict(cfg), indent=2, default=str))

    root = Path(args.data_root)
    ann = root / cfg.data.train_ann_file
    split = root / cfg.data.label_list_file

    load_state = None
    if args.load_from:
        loaded = runner.init_state(cfg, runner.build_model(cfg), 1,
                                   mesh.device)
        mgr = runner.CheckpointManager(Path(args.load_from).parent)
        loaded, _, step = mgr.restore(loaded)
        fresh = runner.init_state(cfg, runner.build_model(cfg), 1,
                                  mesh.device)
        load_state = runner.weights_only_load(fresh, loaded)
        logging.info("loaded weights at step %d from %s", step, args.load_from)

    if cfg.mode == "pretrain":
        ds = SubScanNetScenes(root, ann, split)
        return runner.train_supervised(cfg, ds, load_state, resume=args.resume,
                                       device=mesh.device)
    ds = SimiScanNetScenes(root, ann, split, ratio=cfg.data.unlabeled_ratio)
    return runner.train_semi(cfg, ds, load_state, resume=args.resume,
                             device=mesh.device)


if __name__ == "__main__":
    from nesie_tpu_torch import parallel

    try:
        main()
    finally:
        parallel.shutdown()
