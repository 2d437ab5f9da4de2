from .engine import Request, ServeEngine
from .plans import DeadlineExceeded, PlanServer, PlanTicket, QueueFull
from .step import make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "make_prefill_step", "make_decode_step",
           "PlanServer", "PlanTicket", "QueueFull", "DeadlineExceeded"]
