"""idle_share.train: see ``_idle``."""
from perfbench.metrics._idle import SOURCE, read  # noqa: F401
