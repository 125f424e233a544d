"""teacher_ms.train: device time of the semi step's teacher forward
(the program's ``semi.teacher`` span, under ``frozen_bn_stats``), a
``semi.step`` on average over the span part of a traced run."""
from perfbench.metrics._program import SOURCE, device_ms, start  # noqa: F401

start()


def read(ctx):
    return device_ms(ctx, "semi.step", {"semi.teacher"})
