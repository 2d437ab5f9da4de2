from ..core.capture import CaptureError
from .engine import Request, ServeEngine
from .graph import graphed_decode, graphed_prefill
from .plans import DeadlineExceeded, PlanServer, PlanTicket, QueueFull
from .step import make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "make_prefill_step", "make_decode_step",
           "graphed_prefill", "graphed_decode", "CaptureError",
           "PlanServer", "PlanTicket", "QueueFull", "DeadlineExceeded"]
