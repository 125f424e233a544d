"""fps_roofline.train: see ``_fps``."""
from perfbench.metrics._fps import SOURCE, WRAPS, read  # noqa: F401
