"""host_syncs.serve: the program's ``host_sync`` count (each point where
the card's sync debug mode reports the host waiting for the card: the
copy in, constants copied mid-forward, the NMS fixpoint's loop tests, the
copies back) inside ``detector.request``, a request on average over
the span part of a traced run."""
from perfbench.metrics._program import SOURCE, counted, start  # noqa: F401

start()


def read(ctx):
    return counted(ctx, "detector.request", "host_sync")
