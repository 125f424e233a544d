"""pseudo_label_ms.train: device time of ``get_pseudo_labels`` as
``train.semi`` calls it, a step on average (span part of a traced run)."""
SOURCE = "program_span"

WRAPS = [dict(module="nesie_tpu_torch.train.semi", attr="get_pseudo_labels",
              span="pseudo_label", clock="cuda")]


def read(ctx):
    rows = ctx["spans"].get("pseudo_label", [])
    if not rows or not ctx["units"]:
        return None
    return sum(r["ms"] for r in rows) / ctx["units"]
