"""preprocess_ms.serve: host time of the Detector's preprocessing
(``data.io.add_height`` and ``data.io.sample_points``, where ``apis``
looks them up), a request on average."""
SOURCE = "program_span"

WRAPS = [dict(module="nesie_tpu_torch.data.io", attr=a, span="preprocess",
              clock="host") for a in ("add_height", "sample_points")]


def read(ctx):
    rows = ctx["spans"].get("preprocess", [])
    if not rows or not ctx["units"]:
        return None
    return sum(r["ms"] for r in rows) / ctx["units"]
