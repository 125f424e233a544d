"""mfu.eval: see ``_mfu``."""
from perfbench.metrics._mfu import SOURCE, read  # noqa: F401
