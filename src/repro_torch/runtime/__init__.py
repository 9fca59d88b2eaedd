from .compression import ErrorFeedback, dequantize, quantize
from .fault_tolerance import Heartbeat, ResilientDriver
from .het_dp import HetDPTrainer, WorkerFailed, WorkerSpec

__all__ = [
    "ErrorFeedback",
    "dequantize",
    "quantize",
    "Heartbeat",
    "ResilientDriver",
    "HetDPTrainer",
    "WorkerFailed",
    "WorkerSpec",
]
