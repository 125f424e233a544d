"""Runtime utilities: logging, metrics, environment fingerprint (reference
mmdet3d/utils/logger.py, collect_env.py + the runner's log_buffer /
TextLoggerHook) and a profiler trace. Counterpart of
``nesie_tpu/utils.py``; the metrics go to ``metrics.jsonl`` only (no
TensorBoard writer).
"""
from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from pathlib import Path

LOGGER_NAME = "nesie_tpu_torch"


def get_root_logger(log_file=None, level=logging.INFO):
    logger = logging.getLogger(LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def no_card(device, tool: str) -> bool:
    """True, after saying so on stderr, when ``device`` is a CUDA device
    and this process has none: an entry point then returns 1 rather than
    carry on on the CPU, which it does only when asked (``--device
    cpu``)."""
    import sys

    import torch

    if torch.device(device).type != "cuda" or torch.cuda.is_available():
        return False
    print(f"{tool}: no CUDA device (--device cpu runs on the CPU)",
          file=sys.stderr)
    return True


def collect_env():
    """Environment fingerprint (reference utils/collect_env.py): python,
    torch, its CUDA and the card."""
    import platform

    import torch

    info = dict(
        python=platform.python_version(),
        platform=platform.platform(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        cuda_available=torch.cuda.is_available(),
    )
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    return info


class MetricsLogger:
    """JSONL metrics stream (``<work_dir>/metrics.jsonl``): the runner's
    log_buffer / TextLoggerHook equivalent. ``enabled=False`` (every rank
    but 0 of a data-parallel run, as the reference's master-only loggers)
    writes nothing."""

    def __init__(self, work_dir, enabled: bool = True):
        self.path = Path(work_dir)
        self.jsonl = None
        if not enabled:
            return
        self.path.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.path / "metrics.jsonl", "a")

    def log(self, step: int, metrics: dict):
        if self.jsonl is None:
            return
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextmanager
def trace(name: str, log_dir=None):
    """Log the block's wall time as ``"<name> took <s>s"``; with
    ``log_dir``, also run it under ``torch.profiler`` (the CPU, and the
    card when there is one) and write the Chrome trace to
    ``<log_dir>/<name>.trace.json``. Yields the profiler, or None.

        with trace("train", "build/prof"):
            step(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = None
    if log_dir is not None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
    t0 = time.perf_counter()
    try:
        if prof is None:
            yield None
        else:
            with prof:
                yield prof
    finally:
        logging.getLogger(LOGGER_NAME).info(
            "%s took %.3fs", name, time.perf_counter() - t0)
    if prof is not None:
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}.trace.json"))
