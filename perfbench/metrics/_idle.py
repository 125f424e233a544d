"""The device's idle share of the profiled part of a traced run: one
minus the union of the device operations' intervals over the window."""
SOURCE = "device_trace"


def read(ctx):
    t = ctx["timeline"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
