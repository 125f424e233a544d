"""host_syncs.eval: the program's ``host_sync`` count (each point where
the card's sync debug mode reports the host waiting for the card, such
as the NMS fixpoint's loop tests) inside
``postprocess.decode_and_nms``, a batch on average over the span part of
a traced run."""
from perfbench.metrics._program import SOURCE, counted, start  # noqa: F401

start()


def read(ctx):
    return counted(ctx, "postprocess.decode_and_nms", "host_sync")
