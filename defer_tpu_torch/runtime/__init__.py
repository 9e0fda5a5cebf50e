from .dispatcher import Defer
from .mpmd import MpmdPipeline
from .spmd import SpmdPipeline

__all__ = ["Defer", "MpmdPipeline", "SpmdPipeline"]
