"""forward_ms.serve: device time of the B=1 forward inside a request (the
program's ``nn.forward`` span inside ``detector.request``), a request on
average over the span part of a traced run."""
from perfbench.metrics._program import SOURCE, device_ms, start  # noqa: F401

start()


def read(ctx):
    return device_ms(ctx, "detector.request", {"nn.forward"})
