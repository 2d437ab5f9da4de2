from .graph import CaptureError, graphed_step
from .step import make_train_step

__all__ = ["CaptureError", "graphed_step", "make_train_step"]
