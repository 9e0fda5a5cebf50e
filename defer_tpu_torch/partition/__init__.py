from .partitioner import partition
from .stage import StageModule, StageSpec, buffer_footprint

__all__ = ["partition", "StageModule", "StageSpec", "buffer_footprint"]
