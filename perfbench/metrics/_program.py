"""What the readers of the program's own spans share: the port records
spans and counts itself (``nesie_tpu_torch.utils``: ``span``, ``count``,
``span_records``), and a reader turns them on when it is imported, which
the harness does only in a traced run, after set-up. A reader uses the
first ``ctx["units"]`` top-level spans of its unit, those of the window's
part under the spans (the profiled part follows them), and divides by
their number. On a program that records no spans it reads nothing."""
SOURCE = "program_span"


def start() -> None:
    """Turn the program's spans on, where the program has them."""
    try:
        from nesie_tpu_torch.utils import set_tracing
    except ImportError:
        return
    set_tracing(True)


def records():
    """The program's span records, or None where it has none."""
    try:
        from nesie_tpu_torch.utils import span_records
    except ImportError:
        return None
    return span_records()


def units(ctx, unit: str) -> list:
    """[(span, [its descendants])] of the first ``ctx["units"]``
    top-level spans named ``unit``; [] when there are none."""
    recs = records()
    n = ctx["units"]
    if not recs or not n:
        return []
    root, found = {}, {}
    for r in recs:  # a parent precedes its children
        top = r["index"] if r["parent"] is None else root.get(r["parent"])
        root[r["index"]] = top
        if r["parent"] is None and r["name"] == unit and len(found) < n:
            found[r["index"]] = (r, [])
        elif top in found:
            found[top][1].append(r)
    return list(found.values())


def device_ms(ctx, unit: str, names) -> float | None:
    """Device ms of the spans named in ``names`` (the unit itself or its
    descendants), a unit on average; None where no unit holds one or one
    has no device time."""
    got = units(ctx, unit)
    times = [r["device_ms"] for u, inner in got for r in [u, *inner]
             if r["name"] in names]
    if not times or None in times:
        return None
    return sum(times) / len(got)


def counted(ctx, unit: str, name: str) -> float | None:
    """Count ``name`` made in a unit (in its span or its descendants), a
    unit on average; None where there is no unit."""
    got = units(ctx, unit)
    if not got:
        return None
    return sum(r["counts"].get(name, 0) for u, inner in got
               for r in [u, *inner]) / len(got)
