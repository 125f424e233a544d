#!/usr/bin/env python3
"""Readings that set a cell's limits, many seeds in one process:

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--reorder-seeds 1,2] [--seconds 2] \
        [--out FILE]

For each seed of ``--seeds``: the program's set-up and a short window at
the cell's own size and load, then the numbers that decide ``correct``
against the reference (the lower readings). For each seed of
``--control-seeds`` also the control's: the reference computed with
TF32 on (the nearest precision below the configuration's float32 with
TF32 off) put in the program's place; and, for a training cell, each
fault planted in the reference put in its place (half of the batch left
out, one GT label changed, the EMA teacher or the unlabeled scans' state
left unchanged). For each seed of ``--reorder-seeds`` the reference run
on the CPU in float32 put in the program's place: a sound run whose
operations round in another order (a lower reading). One JSON line a
seed on standard output and in ``--out``. The benchmark's own runs do
not run this.
"""
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import argparse

    import torch

    from perfbench.harness.cell import Cell
    from perfbench.harness.main import load_kind, window

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--reorder-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    reorders = {int(s) for s in args.reorder_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = Cell.load(args.workload, seed, dev)
        kind = load_kind(cell.traffic["kind"])(cell)
        kind.setup()
        units, wall = window(kind, args.seconds)
        attempted, failed = kind.outcome()
        kind.free()
        ref = kind.reference()
        row = dict(workload=args.workload, seed=seed, units=units,
                   attempted=attempted, failed=failed,
                   program=kind.numbers(ref))
        if seed in controls:
            row["control_tf32"] = kind.numbers_from(
                kind.reference(tf32=True), ref)
            if cell.traffic["kind"] == "semi_train":
                for fault in ("half", "label", "teacher", "ulb"):
                    row[f"fault_{fault}"] = kind.numbers_from(
                        kind.reference(fault=fault), ref)
        if seed in reorders:
            t1 = time.perf_counter()
            row["reorder_cpu"] = kind.numbers_from(
                kind.reference(device="cpu"), ref)
            row["reorder_cpu_s"] = time.perf_counter() - t1
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del kind, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
