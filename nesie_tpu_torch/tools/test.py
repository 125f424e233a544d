#!/usr/bin/env python
"""Evaluation CLI of the port (counterpart of ``tools/test.py``; reference
test.py): run the detector over the val split and report indoor
mAP@0.25/0.5.

    python -m nesie_tpu_torch.tools.test nesie-votenet-scannet-train-010 \\
        work_dirs/nesie-votenet-scannet-train-010/checkpoints \\
        --data-root /data/scannet [--teacher] [--batch-size 32]

``evaluate`` is the loop, for callers in-process. Data-parallel under
``torchrun`` (``--num-devices``, checked against the ranks launched): each
global batch of ``batch_size`` times the ranks is split by rank, the
detections are gathered to rank 0 in scene order, and rank 0 runs the AP
evaluation and prints the metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch import parallel

RAW_KEYS = ("bbox_preds", "obj_scores", "sem_scores", "iou_scores",
            "side_scores", "surface_pred", "aggregated_points", "bbox_probs")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a nesie_tpu_torch detector")
    p.add_argument("config")
    p.add_argument("checkpoint", help="checkpoint dir (<work>/checkpoints)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--batch-size", type=int, default=8,
                   help="scenes per step")
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel size; must equal the ranks torchrun "
                        "launched (default: that number)")
    p.add_argument("--teacher", action="store_true",
                   help="evaluate the EMA teacher weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--dump-raw", default=None,
                   help="directory to dump raw head outputs per scene "
                        "(the reference test_cfg.add_info equivalent)")
    p.add_argument("--presampled", default=None,
                   help="evaluate a tools/dump_eval_set.py dump (reference-"
                        "identical IndoorPointSample clouds) instead of "
                        "sampling from --data-root")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def class_names(cfg):
    from nesie_tpu_torch.data import scannet_meta

    if cfg.model.dataset_name == "SUNRGBD":
        return list(scannet_meta.SUNRGBD_CLASS_NAMES)
    return list(scannet_meta.CLASS_NAMES)


@torch.no_grad()
def evaluate(cfg, model, ds, batch_size: int = 8, seed: int = 9,
             device="cuda", dump_raw=None) -> dict:
    """Eval forward (``cfg.test.sample_mod``, no jitter; ``random`` draws
    from a generator seeded with ``seed``), with ``cfg.test.iou_opt`` the
    test-time IoU optimisation of the boxes, decode + NMS and
    ``indoor_eval`` over every scene of ``ds``; returns the metrics dict.

    Batches hold ``batch_size`` scenes; the tail batch is padded with its
    last scene. A loader thread builds the next host batch (one numpy
    stream seeded with ``seed``, drawn in order) while the device runs.
    A batch's decoded tensors are copied to pinned host memory behind its
    NMS and read after the next batch's forward is launched, so the host's
    per-class expansion and GT bookkeeping overlap the device.

    Under a launched process group a batch is ``batch_size`` scenes a rank:
    every rank loads the global batch (so the subsample draws follow one
    process's order), runs its rows, and rank 0 gathers the decoded
    detections in scene order, drops the padded tail and returns the
    metrics; the other ranks return None.
    """
    from nesie_tpu_torch.eval import decode_and_nms, indoor_eval
    from nesie_tpu_torch.eval.iou_opt import iou_opt_boxes
    from nesie_tpu_torch.eval.postprocess import expand_per_class

    device = torch.device(device)
    cuda = device.type == "cuda"
    model.eval()
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed)
    n = len(ds)
    gt_annos, dt_annos = [], []
    bs = batch_size * parallel.world_size()  # global batch
    lo, hi = parallel.process_local_rows(bs)
    rows = parallel.part_rows(batch_size)
    lead = parallel.rank() == 0  # gathers and evaluates

    def load(start):
        idx = list(range(start, min(start + bs, n)))
        n_real = len(idx)
        idx = idx + [idx[-1]] * (bs - n_real)  # pad the tail batch
        return start, n_real, ds.eval_batch(idx, rng, cfg.data.num_points)

    def to_host(tensors: dict):
        """Start the copies; returns (host tensors, event or None)."""
        host = {k: v.to("cpu", non_blocking=cuda) for k, v in tensors.items()}
        if not cuda:
            return host, None
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def postprocess(start, n_real, batch, out, decoded, ev):
        if ev is not None:
            ev.synchronize()
        decoded = {k: v.numpy() for k, v in decoded.items()}
        if dump_raw:  # each rank its own rows
            dump_dir = Path(dump_raw)
            dump_dir.mkdir(parents=True, exist_ok=True)
            raw = {k: out[k].cpu().numpy() for k in RAW_KEYS if k in out}
            for b in range(max(min(n_real, hi) - lo, 0)):
                np.savez(dump_dir / f"{batch['scene_ids'][lo + b]}.npz",
                         **{k: v[b] for k, v in raw.items()})
        if not lead:
            return
        for b in range(n_real):
            boxes, scores, labels = expand_per_class(
                {k: v[b] for k, v in decoded.items()})
            dt_annos.append(dict(boxes=boxes, scores=scores, labels=labels))
            gb = batch["gt_boxes"][b][batch["gt_valid"][b]].copy()
            gb[:, 2] += gb[:, 5] / 2  # bottom -> gravity center
            gt_annos.append(dict(
                boxes=gb, labels=batch["gt_labels"][b][batch["gt_valid"][b]]))
        logging.info("evaluated %d/%d scenes", start + n_real, n)

    with ThreadPoolExecutor(max_workers=1) as loader:
        pending = loader.submit(load, 0)
        in_flight = None  # the previous batch, its copies under way
        while pending is not None:
            start, n_real, batch = pending.result()
            nxt = start + bs
            pending = loader.submit(load, nxt) if nxt < n else None
            points = parallel.shard_host_batch(
                {"points": batch["points"]}, device, lo, hi)["points"]
            out = model(points, cfg.test.sample_mod, with_jitter=False,
                        generator=gen, rows=rows)
            if cfg.test.iou_opt:
                # test-time IoU optimisation (reference iou_opt_test,
                # votenet_nesie.py:501-571)
                out = iou_opt_boxes(model, out, cfg.test.opt_rate,
                                    cfg.test.opt_step,
                                    cfg.model.dataset_name)
            if in_flight is not None:
                postprocess(*in_flight)
            decoded = decode_and_nms(
                out, points, nms_thr=cfg.test.nms_thr,
                score_thr=cfg.test.score_thr,
                use_iou_for_nms=cfg.test.use_iou_for_nms)
            # every rank's rows, in scene order (a no-op on one process)
            decoded = {k: parallel.all_gather_rows(v)
                       for k, v in decoded.items()}
            host, ev = to_host(decoded)
            in_flight = (start, n_real, batch, out if dump_raw else None,
                         host, ev)
        if in_flight is not None:
            postprocess(*in_flight)

    if not lead:
        return None
    return indoor_eval(gt_annos, dt_annos, class_names=class_names(cfg))


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)

    from nesie_tpu_torch.config import apply_overrides, get_config
    from nesie_tpu_torch.data.dataset import PresampledScanNetScenes, ScanNetScenes
    from nesie_tpu_torch.train import runner

    cfg = get_config(args.config)
    cfg = apply_overrides(cfg, args.cfg_options)
    root = Path(args.data_root)
    if args.presampled:
        ds = PresampledScanNetScenes(args.presampled)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, num_points=ds.num_points))
    else:
        ds = ScanNetScenes(root, root / cfg.data.val_ann_file)
    model = runner.build_model(cfg)
    mgr = runner.CheckpointManager(Path(args.checkpoint).parent)
    ckpt = mgr.load()
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.checkpoint}")
    model.load_state_dict(ckpt["teacher" if args.teacher else "model"])
    mesh = parallel.make_mesh(args.num_devices, args.device)
    model = model.to(mesh.device)
    logging.info("restored step %d", ckpt["step"])

    results = evaluate(cfg, model, ds, args.batch_size, args.seed,
                       mesh.device, dump_raw=args.dump_raw)
    if results is None:  # not rank 0
        return None
    for k in sorted(results):
        if k.startswith("mAP") or k.startswith("mAR"):
            print(f"{k}: {results[k]:.4f}")
    print({k: round(v, 4) for k, v in results.items() if "_AP_" in k})
    return results


if __name__ == "__main__":
    try:
        main()
    finally:
        parallel.shutdown()
