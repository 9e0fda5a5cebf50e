from .dispatcher import END_OF_STREAM, Defer, DeferHandle
from .mpmd import MpmdPipeline
from .spmd import SpmdPipeline

__all__ = ["END_OF_STREAM", "Defer", "DeferHandle", "MpmdPipeline",
           "SpmdPipeline"]
