from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, ModelLine,
                   all_gather, all_to_all, pipeline_mesh, pmean, ppermute,
                   psum, stage_axis_size)
from .ring_attention import (SEQ_AXIS, full_attention, ring_attention,
                             sequence_parallel_attention)
from .distributed import (initialize, multihost_pipeline_mesh,
                          process_local_batch)
from .expert import (EXPERT_AXIS, expert_parallel_fn, expert_parallel_mesh,
                     shard_moe_params)
from .tensor import shard_tp_params, tensor_parallel_fn, tensor_parallel_mesh
from .ulysses import (sequence_parallel_attention_ulysses,
                      ulysses_attention)
