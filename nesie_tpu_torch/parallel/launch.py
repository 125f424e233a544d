"""Run a function on the ranks of one host, as ``torchrun`` would launch it,
from inside a Python program (a test, ``chip_smoke.py``).

``spawn_ranks`` starts one process a rank with ``torch.multiprocessing``'s
spawn method and the environment ``torchrun`` gives a rank (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), joins every rank with one deadline,
kills every rank still running at it, and returns each rank's result. A
rank's result and its traceback travel through files in ``out_dir``,
so that a rank that dies loses nothing the others wrote.
"""
from __future__ import annotations

import os
import socket
import time
import traceback
from pathlib import Path

import torch
import torch.multiprocessing as mp

from .mesh import shutdown


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, args, out_dir, timeout_s: float,
                env: dict | None = None) -> list:
    """``fn(args)`` in ``world`` rank processes; returns their results in
    rank order (each must be what ``torch.load(weights_only=True)`` reads:
    tensors, numbers, strings, None, and lists and dicts of them). ``fn``
    is pickled by name, so it is a module-level function; it starts the
    process group itself (``parallel.make_mesh``), which ends with the
    rank. ``env``: more environment for the ranks, set before they touch
    a card (``CUDA_VISIBLE_DEVICES`` to put every rank on one card).
    Raises ``RuntimeError`` with every failed rank's traceback, and
    ``TimeoutError`` when a rank outlives ``timeout_s``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for r in range(world):
        for suffix in ("pt", "err"):
            (out_dir / f"rank{r}.{suffix}").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, args, str(out_dir),
                               env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    errors = [(out_dir / f"rank{r}.err").read_text() for r in range(world)
              if (out_dir / f"rank{r}.err").exists()]
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after "
                           f"{timeout_s} s\n" + "\n".join(errors))
    codes = [p.exitcode for p in procs]
    if errors or any(codes):
        raise RuntimeError(f"rank exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=True)
            for r in range(world)]


def _rank_main(fn, rank, world, port, args, out_dir, env):
    os.environ.update(env)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    out = Path(out_dir)
    try:
        torch.save(fn(args), out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        shutdown()
