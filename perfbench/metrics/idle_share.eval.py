"""idle_share.eval: see ``_idle``."""
from perfbench.metrics._idle import SOURCE, read  # noqa: F401
