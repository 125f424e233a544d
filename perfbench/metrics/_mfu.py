"""The whole unit's share of the chip's float32 peak: the matmul FLOPs
of the unit (``counts.flops``, from the configuration and the shapes)
times the units of the span part of a traced run, over its wall time."""
from perfbench.counts import flops
from perfbench.counts.peaks import FP32_FLOPS

SOURCE = "program_span"


def unit_flops(cell) -> int:
    t, cfg = cell.traffic, cell.cfg
    if t["kind"] == "semi_train":
        return flops.semi_step_flops(cfg, t)
    if t["kind"] == "eval_batch":
        return flops.eval_forward_flops(cfg, t["batch"], t["points"])
    return flops.eval_forward_flops(cfg, 1, cfg["test"]["num_points"])


def read(ctx):
    if ctx["wall_s"] <= 0 or not ctx["units"]:
        return None
    f = unit_flops(ctx["cell"])
    ctx["log"](f"[counts] matmul FLOPs a unit: {f}")
    return 100.0 * f * ctx["units"] / ctx["wall_s"] / FP32_FLOPS
