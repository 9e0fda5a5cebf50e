from .decode import PipelinedDecoder
from .dispatcher import END_OF_STREAM, Defer, DeferHandle
from .mpmd import MpmdPipeline
from .speculative import speculative_generate
from .spmd import SpmdPipeline
from .training import PipelineTrainer

__all__ = ["END_OF_STREAM", "Defer", "DeferHandle", "MpmdPipeline",
           "PipelineTrainer", "PipelinedDecoder", "SpmdPipeline",
           "speculative_generate"]
