"""Spans placed by the benchmark around calls into the port.

A span is timed on the device (a pair of CUDA events on the current
stream: the device time of the work enqueued between them) or on the
host clock. ``Spans.wrap`` replaces a function by the name at which the
port looks it up (``module.attr``) with a timed copy, and ``restore``
puts every original back. A wrapped name that no longer exists is
reported, not raised: the metric that needs it is then left out.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.records: dict = {}   # span name -> list of [start, end, info]
        self.missing: dict = {}   # span name -> why it was not placed
        self._patched: list = []

    @contextlib.contextmanager
    def span(self, name: str, clock: str = "cuda", info: dict | None = None):
        rec = [None, None, info or {}]
        if clock == "cuda" and self.device.type == "cuda":
            rec[0] = torch.cuda.Event(enable_timing=True)
            rec[0].record()
            yield rec
            rec[1] = torch.cuda.Event(enable_timing=True)
            rec[1].record()
        else:
            rec[0] = time.perf_counter()
            yield rec
            rec[1] = time.perf_counter()
        self.records.setdefault(name, []).append(rec)

    def wrap(self, module: str, attr: str, name: str, clock: str = "cuda",
             measure=None) -> bool:
        """Time every call of ``module.attr`` as span ``name``;
        ``measure(args, kwargs, out) -> dict`` adds what the call did
        (shapes, counts) to the span. Returns whether it was placed."""
        try:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
        except (ImportError, AttributeError) as e:
            self.missing[name] = f"{module}.{attr} not found ({e})"
            return False

        def timed(*args, **kwargs):
            with self.span(name, clock) as rec:
                out = fn(*args, **kwargs)
            if measure is not None:
                rec[2].update(measure(args, kwargs, out))
            return out

        setattr(mod, attr, timed)
        self._patched.append((mod, attr, fn))
        return True

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched.clear()

    def results(self) -> dict:
        """span name -> list of dict(ms=..., **info), after a synchronize."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for name, recs in self.records.items():
            rows = []
            for start, end, info in recs:
                if isinstance(start, float):
                    ms = (end - start) * 1e3
                else:
                    ms = start.elapsed_time(end)
                rows.append(dict(info, ms=ms))
            out[name] = rows
        return out
