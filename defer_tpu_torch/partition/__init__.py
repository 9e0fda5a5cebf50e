from .partitioner import fuse_stages, partition, stage_specs_for_vertices
from .stage import JoinStageSpec, StageModule, StageSpec, buffer_footprint

__all__ = ["fuse_stages", "partition", "stage_specs_for_vertices",
           "JoinStageSpec", "StageModule", "StageSpec", "buffer_footprint"]
