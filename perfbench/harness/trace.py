"""The profiler's part of a traced run, reduced to what the result line
carries: the seconds in which an operation ran on the device (the union
of the device events' intervals, so that work on two streams at once
counts once), the length of the profiled window, the device operations
that took most time, and the longest idle gaps of the device, each
labelled by the innermost host event (a benchmark span or a host op)
that was running at its middle."""
from __future__ import annotations

import heapq

NAME_CHARS = 160  # of a kernel's name in the breakdown


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_timeline(device_events, host_events, window, top: int = 10):
    """device_events: (name, start_s, end_s); host_events: (name, start_s,
    end_s); window: (start_s, end_s) of the profiled part. Returns
    dict(busy_s, window_s, device_ops, idle_gaps)."""
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for n, s, e in device_events
           if e > w0 and s < w1]
    busy = union_seconds((s, e) for s, e, _ in dev)
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps between the merged busy intervals, inside the window
    spans = merged((s, e) for s, e, _ in dev)
    gaps, t = [], w0
    for s, e in spans:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    # the innermost host event covering each gap's middle: a sweep in
    # time, with the events begun so far on a heap by duration, those
    # that have ended dropped when they come to its top
    hosts = sorted((hs, he, name) for name, hs, he in host_events)
    by_label: dict = {}
    active: list = []
    j = 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while j < len(hosts) and hosts[j][0] <= mid:
            hs, he, name = hosts[j]
            heapq.heappush(active, (he - hs, he, j, name))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][3] if active else "no host event"
        by_label[label] = by_label.get(label, 0.0) + (e - s)
    idle_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy, window_s=w1 - w0,
                device_ops=[[n[:NAME_CHARS], v] for n, v in device_ops],
                idle_gaps=[[n[:NAME_CHARS], v] for n, v in idle_gaps])


def from_profiler(prof, window_label: str) -> dict:
    """``reduce_timeline`` over a finished ``torch.profiler.profile``:
    its CUDA-side events are the device's, its CPU-side events (ops and
    ``record_function`` spans) the host's, on one clock; the window is
    the host event named ``window_label``. A ``record_function`` range
    mirrored on the device's timeline is no device work and is left out.
    Reads the profiler's raw events, which take a small share of the time
    that building its ``events()`` takes."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window = [], [], None
    for name, device, start, end, annotation in _raw_events(prof):
        row = (name, start, end)
        if device == cuda:
            if not (annotation or name.startswith("perfbench.")):
                dev.append(row)
        elif name == window_label:
            window = (start, end)
        else:
            host.append(row)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {window_label!r} span")
    return reduce_timeline(dev, host, window)


def _raw_events(prof):
    """(name, device type, start s, end s, is a user annotation) of every
    event the profiler kept."""
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        flag = getattr(e, "is_user_annotation", None)
        annotation = (flag() if callable(flag) else
                      "user_annotation" in str(e.activity_type()))
        yield (e.name(), e.device_type(), start,
               start + e.duration_ns() * 1e-9, annotation)
