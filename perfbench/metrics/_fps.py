"""What the FPS roofline readers share: the span around the port's FPS
kernel, looked up where ``ops.pointops`` calls it, with each call's
shape; the share is the sum of the calls' bounds over the sum of their
device times."""
from perfbench.counts.pointops import fps_bound_s

SOURCE = "program_span"


def _shape(args, kwargs, out):
    xyz = args[0]
    return dict(b=xyz.shape[0], n=xyz.shape[1], m=int(out.shape[1]))


WRAPS = [dict(module="nesie_tpu_torch.ops.pointops", attr="fps_onchip_cuda",
              span="fps", clock="cuda", measure=_shape)]


def read(ctx):
    rows = ctx["spans"].get("fps", [])
    spent = sum(r["ms"] for r in rows) / 1e3
    if not rows or spent <= 0:
        return None
    bound = sum(fps_bound_s(r["b"], r["n"], r["m"]) for r in rows)
    return 100.0 * bound / spent
