"""update_ms.train: device time of the semi step's update (the program's
``train.update`` span: the gradients' all-reduce, the clip and AdamW)
and of its EMA of the teacher (``semi.ema``), a ``semi.step`` on
average over the span part of a traced run."""
from perfbench.metrics._program import SOURCE, device_ms, start  # noqa: F401

start()


def read(ctx):
    return device_ms(ctx, "semi.step", {"train.update", "semi.ema"})
