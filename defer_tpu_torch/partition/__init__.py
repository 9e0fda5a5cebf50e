from .partitioner import fuse_stages, partition
from .stage import StageModule, StageSpec, buffer_footprint

__all__ = ["fuse_stages", "partition", "StageModule", "StageSpec",
           "buffer_footprint"]
