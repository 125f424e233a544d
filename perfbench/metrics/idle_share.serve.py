"""idle_share.serve: see ``_idle``."""
from perfbench.metrics._idle import SOURCE, read  # noqa: F401
