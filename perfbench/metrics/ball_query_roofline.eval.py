"""ball_query_roofline.eval: the sum of the ball queries' bounds (their
work counted up to the K-th hit, from each call's output) over the sum
of their device times, the span placed where ``ops.pointops`` calls the
kernel."""
from perfbench.counts.pointops import ball_query_bound_s, ball_query_scanned

SOURCE = "program_span"


def _shape(args, kwargs, out):
    xyz, centers = args[0], args[1]
    return dict(b=xyz.shape[0], n=xyz.shape[1], m=centers.shape[1],
                k=int(out.shape[-1]),
                scanned=ball_query_scanned(out, xyz.shape[1]))


WRAPS = [dict(module="nesie_tpu_torch.ops.pointops", attr="ball_query_cuda",
              span="ball_query", clock="cuda", measure=_shape)]


def read(ctx):
    rows = ctx["spans"].get("ball_query", [])
    spent = sum(r["ms"] for r in rows) / 1e3
    if not rows or spent <= 0:
        return None
    bound = sum(ball_query_bound_s(float(r["scanned"]), r["b"], r["n"],
                                   r["m"], r["k"]) for r in rows)
    return 100.0 * bound / spent
