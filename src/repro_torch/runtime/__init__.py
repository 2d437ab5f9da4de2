from .ft import LoopRunner, PeerReplica, SimulatedFailure, TrainRunner

__all__ = ["LoopRunner", "PeerReplica", "SimulatedFailure", "TrainRunner"]
