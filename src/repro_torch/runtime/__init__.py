from .ft import LoopRunner, SimulatedFailure, TrainRunner

__all__ = ["LoopRunner", "SimulatedFailure", "TrainRunner"]
