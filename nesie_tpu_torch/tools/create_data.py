#!/usr/bin/env python
"""Dataset preprocessing CLI of the port (counterpart of
``tools/create_data.py``; reference data/scannet/batch_load_scannet_data.py
and the SUN RGB-D MATLAB extraction, rebuilt in Python). Numpy only: it
runs where the JAX package is not installed.

ScanNet:
    python -m nesie_tpu_torch.tools.create_data scannet \\
        --raw-dir /data/scans --out-dir /data/scannet \\
        --splits-dir data/meta_data

SUN RGB-D (VoteNet-style sunrgbd_trainval layout):
    python -m nesie_tpu_torch.tools.create_data sunrgbd \\
        --raw-dir /data/sunrgbd_trainval --out-dir /data/sunrgbd

Both subcommands draw their subsamples from one ``default_rng(0)`` stream,
scene after scene and split after split, as the JAX tool does, so the two
write the same files. The GT-paste database (``--gt-db``) waits for the
port of ``data/dbsampler``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def prep_scannet(args):
    from nesie_tpu_torch.data import scannet_prep

    raw = Path(args.raw_dir)
    splits = Path(args.splits_dir) if args.splits_dir else None

    def scan_list(split):
        if splits and (splits / f"scannetv2_{split}.txt").exists():
            return [l.strip() for l in open(splits / f"scannetv2_{split}.txt")
                    if l.strip()]
        return sorted(p.name for p in raw.iterdir() if p.is_dir())

    label_map = args.label_map or str(raw.parent / "scannetv2-labels.combined.tsv")
    rng = np.random.default_rng(0)
    for split in args.splits:
        names = scan_list(split)
        print(f"[{split}] {len(names)} scans")
        scans = []
        for i, name in enumerate(names):
            scans.append((name, scannet_prep.export_scan(
                raw / name, name, label_map, rng=rng)))
            if (i + 1) % 50 == 0:
                print(f"  {i + 1}/{len(names)}")
        scannet_prep.write_infos(scans, args.out_dir, split)
        print(f"  wrote scannet_infos_{split}.pkl")


def prep_sunrgbd(args):
    from nesie_tpu_torch.data import sunrgbd_prep

    raw = Path(args.raw_dir)
    rng = np.random.default_rng(0)
    for split in args.splits:
        ids_file = raw / f"{split}_data_idx.txt"
        if ids_file.exists():
            ids = [l.strip().zfill(6) for l in open(ids_file) if l.strip()]
        else:
            ids = sorted(p.stem for p in (raw / "calib").glob("*.txt"))
        print(f"[{split}] {len(ids)} samples")
        samples = [(i, sunrgbd_prep.export_sample(raw, i, rng=rng))
                   for i in ids]
        sunrgbd_prep.write_infos(samples, args.out_dir, split)
        print(f"  wrote sunrgbd_infos_{split}.pkl")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Preprocess raw datasets")
    p.add_argument("dataset", choices=["scannet", "sunrgbd"])
    p.add_argument("--raw-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--splits", nargs="*", default=["train", "val"])
    p.add_argument("--splits-dir", default=None)
    p.add_argument("--label-map", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dataset == "scannet":
        prep_scannet(args)
    else:
        prep_sunrgbd(args)


if __name__ == "__main__":
    main()
