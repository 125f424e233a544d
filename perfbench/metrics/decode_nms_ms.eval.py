"""decode_nms_ms.eval: device time from the call of ``decode_and_nms`` to
the detections' arrival on the host, a batch on average; the span is the
eval kind's own, around that call and the copy."""
SOURCE = "program_span"


def read(ctx):
    rows = ctx["spans"].get("decode_nms", [])
    if not rows or not ctx["units"]:
        return None
    return sum(r["ms"] for r in rows) / ctx["units"]
