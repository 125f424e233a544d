"""Runtime utilities: logging, metrics, environment fingerprint (reference
mmdet3d/utils/logger.py, collect_env.py + the runner's log_buffer /
TextLoggerHook), a profiler trace, and the program's spans and counts.
Counterpart of ``nesie_tpu/utils.py``; the metrics go to
``metrics.jsonl`` only (no TensorBoard writer).

Spans and counts
----------------
``span(name, device=False, **attrs)`` marks a phase of the program at a
layer boundary (``semi.teacher``, ``detector.request``, ...);
``count(name, n)`` counts an event (``launch.<kernel>``, ``host_sync``).
Tracing is off by default: ``span`` then hands out one shared null
context after reading one module global, and records nothing.
``set_tracing(True)`` (or a ``trace`` block) turns it on
(``spans_suspended`` turns spans off for a block, a CUDA graph's
capture, and leaves the rest on); each span then
keeps, in memory, its name, its parent (the innermost span open on its
thread when it opened), its host start and end
(``time.perf_counter_ns``), its attributes and the counts made while it
was the innermost open span. Under a running ``torch.profiler`` it is
also a ``record_function`` range named ``name`` (attributes in its
``args``), which the profiler stamps on the clock of the device's events.
With ``device=True`` on a machine with a card it also records a CUDA
event at each end on the stream current when it opened: the device time
between them, idle time included. Those pairs are resolved as soon as the
card has passed them, each time a top-level span closes, and their
events reused; ``span_records()`` resolves the rest after one
synchronize. At most ``MAX_RECORDS`` records are kept (later spans count
``span.dropped``); ``clear_spans()`` drops them.

While tracing is on, the card's sync debug mode warns at each operation
that makes the host wait for the card, and each such warning counts
``host_sync`` instead of being shown. Counts are kept whether tracing is
on or off, per process.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import warnings
from contextlib import contextmanager, nullcontext
from pathlib import Path

LOGGER_NAME = "nesie_tpu_torch"

MAX_RECORDS = 200_000
_SYNC_WARNING = "called a synchronizing CUDA operation"

_TRACING = False
_RECORDS: list = []          # the spans opened while tracing, in order
_FIELDS = ("index", "name", "parent", "start_ns", "end_ns", "device_ms")
_PENDING: list = []          # (record, start, end) of unresolved device spans
_EVENTS: list = []           # resolved CUDA events, for reuse
_OPEN = threading.local()    # .stack: the spans open on this thread
_COUNTS: dict = {}
_COUNTS_LOCK = threading.Lock()
_CUDA = None                 # torch.cuda.is_available(), read once
_SYNC_HOOK = None            # what tracing replaced, to put back


_NULL_SPAN = nullcontext()   # what ``span`` hands out with tracing off


class _Span:
    __slots__ = ("rec", "device", "_range", "_stream", "_start")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.rec = dict(index=None, name=name, parent=None, attrs=attrs,
                        counts={}, start_ns=None, end_ns=None,
                        device_ms=None)
        self.device = device

    def __enter__(self):
        import torch

        global _CUDA
        rec = self.rec
        stack = _stack()
        if stack:
            rec["parent"] = stack[-1]["index"]
        if len(_RECORDS) < MAX_RECORDS and (not stack
                                            or rec["parent"] is not None):
            rec["index"] = len(_RECORDS)
            _RECORDS.append(rec)
        else:
            count("span.dropped")
        stack.append(rec)
        self._range = None
        if torch._C._autograd._profiler_enabled():
            args = ", ".join(f"{k}={v}" for k, v in rec["attrs"].items())
            self._range = torch.profiler.record_function(rec["name"],
                                                         args or None)
            self._range.__enter__()
        self._start = None
        if self.device and rec["index"] is not None:
            if _CUDA is None:
                _CUDA = torch.cuda.is_available()
            if _CUDA:
                self._stream = torch.cuda.current_stream()
                self._start = _event()
                self._start.record(self._stream)
        rec["start_ns"] = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        if self._start is not None:
            end = _event()
            end.record(self._stream)
            _PENDING.append((rec, self._start, end))
        elif rec["index"] is not None:
            _close(rec)
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if not stack and _PENDING:
            _resolve(wait=False)
        return False


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _event():
    import torch

    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


def _close(rec: dict) -> None:
    """Keep a finished record as a tuple of plain values, which Python's
    collector stops tracking at its next pass (it holds no other tuple):
    the tens of thousands of records of a traced window then cause no
    extra full collection. After the fields: the number of attributes,
    then the attributes' and the counts' keys and values, alternating."""
    i = rec["index"]
    if i < len(_RECORDS) and _RECORDS[i] is rec:
        attrs, counts = rec["attrs"], rec["counts"]
        _RECORDS[i] = (i, rec["name"], rec["parent"], rec["start_ns"],
                       rec["end_ns"], rec["device_ms"], len(attrs),
                       *[x for kv in attrs.items() for x in kv],
                       *[x for kv in counts.items() for x in kv])


def _resolve(wait: bool) -> None:
    """Device ms of the closed device spans, oldest first: all of them
    after a synchronize (``wait``), else those the card has passed."""
    if wait:
        import torch

        torch.cuda.synchronize()
    done = 0
    for rec, start, end in _PENDING:
        if not wait and not end.query():
            break
        rec["device_ms"] = start.elapsed_time(end)
        _close(rec)
        _EVENTS.extend((start, end))
        done += 1
    del _PENDING[:done]


def span(name: str, device: bool = False, **attrs):
    """A context manager marking one phase ``name``; see the module's
    docstring. ``device``: also time it on the card with CUDA events."""
    if not _TRACING:
        return _NULL_SPAN
    return _Span(name, device, attrs)


def set_tracing(on: bool) -> bool:
    """Turn spans, and the count of host syncs, on or off; returns the
    previous setting."""
    global _TRACING
    was, on = _TRACING, bool(on)
    if on != was:
        _hook_syncs(on)
    _TRACING = on
    return was


@contextmanager
def spans_suspended():
    """No spans for the block, with tracing left on otherwise (the count
    of host syncs too): a CUDA graph's capture records no span's CUDA
    event."""
    global _TRACING
    was, _TRACING = _TRACING, False
    try:
        yield
    finally:
        _TRACING = was


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    """``warnings.showwarning`` while tracing: a sync the card's debug
    mode reports counts ``host_sync``; any other warning is shown as
    before."""
    if _SYNC_WARNING in str(message):
        count("host_sync")
        return
    show = _SYNC_HOOK[0] if _SYNC_HOOK else warnings._showwarning_orig
    show(message, category, filename, lineno, file, line)


def _hook_syncs(on: bool) -> None:
    """With tracing on: every sync warning reaches ``_show_warning`` (the
    card's sync debug mode ``warn``, a filter that shows each one);
    off: put back what was there."""
    import torch

    global _SYNC_HOOK
    cuda = torch.cuda.is_available()
    if on:
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        _SYNC_HOOK = (warnings.showwarning, warnings.filters[0], mode)
        warnings.showwarning = _show_warning
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        return
    show, entry, mode = _SYNC_HOOK
    _SYNC_HOOK = None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    if warnings.showwarning is _show_warning:
        warnings.showwarning = show
    if entry in warnings.filters:
        warnings.filters.remove(entry)
        warnings._filters_mutated()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to count ``name``, and, with tracing on, to that of the
    innermost span open on this thread."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _TRACING:
        stack = _stack()
        if stack:
            own = stack[-1]["counts"]
            own[name] = own.get(name, 0) + n


def counts(prefix: str = "") -> dict:
    """The counts whose names start with ``prefix``."""
    with _COUNTS_LOCK:
        return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Set the counts whose names start with ``prefix`` to 0."""
    with _COUNTS_LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]


def span_records() -> list:
    """The spans recorded since the last ``clear_spans``, in the order
    they opened: dict(index, name, parent (an index or None), attrs,
    counts, start_ns, end_ns, device_ms). ``device_ms`` is the device time
    between a closed device span's events (one synchronize resolves
    those still pending), None for a host-only span or one still open."""
    if _PENDING:
        _resolve(wait=True)
    return [dict(r) if isinstance(r, dict) else _opened(r)
            for r in _RECORDS]


def _opened(r: tuple) -> dict:
    """A finished record's tuple (``_close``) as a dict."""
    n = len(_FIELDS) + 1 + 2 * r[len(_FIELDS)]
    attrs, counts = r[len(_FIELDS) + 1:n], r[n:]
    return dict(zip(_FIELDS, r), attrs=dict(zip(attrs[::2], attrs[1::2])),
                counts=dict(zip(counts[::2], counts[1::2])))


def clear_spans() -> None:
    """Drop the records; call it with no span open."""
    _RECORDS.clear()
    _PENDING.clear()


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


def time_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up
    call (CUDA events on the current stream); needs the card."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    """Log the block's wall time as ``"<name> took <s>s"``, with spans on
    for the block; with ``log_dir``, also run it under ``torch.profiler``
    (the CPU, and the card when there is one) and write the Chrome trace,
    which then shows the program's spans, to
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
    was = set_tracing(True)
    t0 = time.perf_counter()
    try:
        if prof is None:
            yield None
        else:
            with prof:
                yield prof
    finally:
        set_tracing(was)
        logging.getLogger(LOGGER_NAME).info(
            "%s took %.3fs", name, time.perf_counter() - t0)
    if prof is not None:
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}.trace.json"))
