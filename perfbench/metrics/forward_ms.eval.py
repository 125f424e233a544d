"""forward_ms.eval: device time of the eval forward (the program's
top-level ``nn.forward`` span), a batch on average over the span part of
a traced run."""
from perfbench.metrics._program import SOURCE, device_ms, start  # noqa: F401

start()


def read(ctx):
    return device_ms(ctx, "nn.forward", {"nn.forward"})
