from .engine import Request, ServeEngine
from .step import make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "make_prefill_step", "make_decode_step"]
