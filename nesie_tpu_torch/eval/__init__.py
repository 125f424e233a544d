from .postprocess import decode_and_nms
from .indoor_eval import indoor_eval

__all__ = ["decode_and_nms", "indoor_eval"]
