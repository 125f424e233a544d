"""fps_roofline.eval: see ``_fps``."""
from perfbench.metrics._fps import SOURCE, WRAPS, read  # noqa: F401
