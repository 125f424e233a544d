#!/usr/bin/env python3
"""FPS step-body experiments: the variants of the TPU study
``tools/fps_experiments.py`` as CUDA kernels on the shipped FPS's on-chip
frame, beside the shipped FPS on the same input.

    python3 -m nesie_tpu_torch.tools.fps_experiments [--batch 32]
        [--n 40000] [--m 2048] [--rows 2] [--iters 5]
        [--variants xla,v0,v1,v2,v3,v4,v5] [--json-out PATH] [--device cpu]

``xla`` is the oracle ``fps_ref``; ``v0`` the shipped FPS, as in the JAX
tool: the dispatch ``ops.pointops.furthest_point_sample``, which runs
``csrc/fps_onchip.cu`` on the card (and ``fps_ref`` on the CPU); v1-v5 the
variants of ``EXPERIMENT_VARIANTS`` (``ops/fps_variants.py``); the lab's
(``v2_merged``, ``v3_blocked``, ``v4_blocked2``) may be named too. The
input is ``default_rng(0).normal(size=(batch, n, 3)) * 3``. For each
variant it prints the least time of one call over ``--iters`` calls
(CUDA events), the ms a step, ``exact_vs_xla`` (indices identical to
``fps_ref``) and ``exact_vs_v0`` (identical to the shipped FPS) and, for
a variant, its plan (``ops.fps_variants.fps_variant_plan``). ``--rows``
is the rows a CTA or cluster carries where a variant interleaves rows
(``v3``, which needs 2); the other variants carry one row, as the shipped
FPS does. ``--device cpu`` runs the plain versions with host-clock
times.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from nesie_tpu_torch.ops.fps import fps_ref
from nesie_tpu_torch.ops.fps_variants import (
    EXPERIMENT_VARIANTS,
    VARIANTS,
    fps_variant_cuda,
    fps_variant_plan,
    fps_variant_ref,
    plan_tag,
)
from nesie_tpu_torch.ops.pointops import furthest_point_sample

DEFAULT_VARIANTS = "xla,v0," + ",".join(EXPERIMENT_VARIANTS)


def make_cloud(batch: int, n: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(batch, n, 3)).astype(np.float32) * 3.0
    return torch.from_numpy(xyz).to(device)


def _call_ms(fn, device: str):
    """(result, ms) of one call: CUDA events on the card, host clock on
    the CPU."""
    if device == "cpu":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run(batch: int = 32, n: int = 40000, m: int = 2048, rows: int = 2,
        iters: int = 5, variants=DEFAULT_VARIANTS.split(","),
        device: str = "cuda") -> dict:
    """Check and time each variant; returns {name: {ms, ms_per_step,
    exact_vs_xla, exact_vs_v0[, plan]}}."""
    xyz = make_cloud(batch, n, device)
    on_card = device != "cpu"
    if "v3" in variants and rows != 2:
        raise ValueError("v3 interleaves two rows in a block: needs rows=2")
    run_variant = fps_variant_cuda if on_card else fps_variant_ref
    fns = {"xla": lambda: fps_ref(xyz, m),
           "v0": lambda: furthest_point_sample(xyz, m)}
    for name in VARIANTS:  # the lab's variants too, when asked for
        fns[name] = lambda name=name: run_variant(xyz, m, name)
    unknown = [v for v in variants if v not in fns]
    if unknown:
        raise ValueError(f"no variant {unknown} on {device}")
    want = fps_ref(xyz, m)
    want_v0 = fns["v0"]()
    print(f"device: {torch.cuda.get_device_name(0) if on_card else 'cpu'}  "
          f"batch {batch} n {n} m {m} rows {rows}")
    results = {}
    for name in variants:
        out = fns[name]()  # warm-up and the indices checked
        times = [_call_ms(fns[name], device)[1] for _ in range(iters)]
        ms = min(times)
        res = {"ms": ms, "ms_per_step": ms / max(m - 1, 1),
               "exact_vs_xla": torch.equal(out, want),
               "exact_vs_v0": torch.equal(out, want_v0)}
        plan = ""
        if on_card and name in VARIANTS:
            res["plan"] = plan_tag(fps_variant_plan(name, batch, n))
            plan = f"  [{res['plan']}]"
        results[name] = res
        print(f"{name}: {ms:.4f} ms ({res['ms_per_step'] * 1e3:.4f} us a "
              f"step)  exact_xla={res['exact_vs_xla']} "
              f"exact_v0={res['exact_vs_v0']}{plan}", flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n", type=int, default=40000)
    p.add_argument("--m", type=int, default=2048)
    p.add_argument("--rows", type=int, default=2, choices=(1, 2))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--variants", default=DEFAULT_VARIANTS)
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the plain versions")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fps_experiments: no CUDA device (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    variants = args.variants.split(",")
    if "v3" in variants and args.rows != 2:
        p.error("v3 interleaves two rows in a block: needs --rows 2")
    results = run(args.batch, args.n, args.m, args.rows, args.iters,
                  variants, args.device)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(
            {"batch": args.batch, "n": args.n, "m": args.m,
             "rows": args.rows, "device": args.device, "results": results},
            indent=2))
    print(json.dumps(results))
    return 0 if all(r["exact_vs_xla"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
