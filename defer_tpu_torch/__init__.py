"""defer_tpu_torch — DEFER's pipelined DNN inference in PyTorch, on CUDA.

The port of the JAX package ``defer_tpu`` to PyTorch and an NVIDIA Hopper
card.  The JAX package stays the reference: the same graph, weights
(:func:`params_from_jax`) and inputs go through both, and the parity tests
compare the outputs.  This package imports ``torch`` and ``numpy`` and
never ``jax`` or anything of ``defer_tpu``.

Weights come from the port's own checkpoints (:func:`save_params` /
:func:`load_params`, ``.npz`` in the JAX package's layout; ``.pt``) or from
standard torchvision / Hugging Face files (:func:`load_pretrained`).
``Defer.serve_endpoint`` serves a pipeline to framed-TCP clients
(``transport.TensorClient``), on the wire codecs of :mod:`.codec`.
:class:`ServeFrontDoor` serves many tenants at once (:mod:`.serve`):
weighted-fair admission with SLO shedding in front of a
:class:`ContinuousBatchEngine`, in which GPT requests join and leave a
fixed set of KV slots between decode steps; :class:`ServeClient` is its
client.  :class:`PipelineTrainer` trains an :class:`SpmdPipeline`
deployment through its own ring (autograd, ``torch.optim``), and the
trained rows serve at once.  :mod:`.parallel` holds the meshes and the
collectives: the ring engines run pp x dp x tp on a one-card (data,
stage, model) mesh, and tensor, expert, ring and Ulysses parallelism run
over any mesh axis.

Entry points (:class:`Defer`, :class:`SpmdPipeline`,
:class:`MpmdPipeline`, :class:`PipelinedDecoder`,
:class:`ContinuousBatchEngine`) run on the CUDA card
unless the caller passes another device; with no device and no CUDA they
raise.

    import torch, numpy as np
    from defer_tpu_torch import Defer, DeferConfig, models
    g = models.resnet50()
    params = g.init(torch.Generator().manual_seed(0))
    out = Defer(DeferConfig(wire="int8", microbatch=8, chunk=4)).run(
        g, params, np.zeros((8, 8, 224, 224, 3), np.float32),
        cut_points=models.RESNET50_8STAGE_CUTS)
"""

from . import models
from . import plan
from .codec import (BlockFloatCodec, LosslessCodec, PipelineCodec, RawCodec,
                    native_available)
from .graph import fold_batchnorm, summary, to_dot
from .parallel import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS,
                       STAGE_AXIS, Mesh, expert_parallel_fn,
                       expert_parallel_mesh, initialize,
                       multihost_pipeline_mesh, pipeline_mesh,
                       process_local_batch, ring_attention,
                       sequence_parallel_attention,
                       sequence_parallel_attention_ulysses, shard_moe_params,
                       shard_tp_params, tensor_parallel_fn,
                       tensor_parallel_mesh, ulysses_attention)
from .partition import partition
from .runtime import (END_OF_STREAM, Defer, DeferHandle, MpmdPipeline,
                      PipelinedDecoder, PipelineTrainer, SpmdPipeline,
                      speculative_generate)
from .serve import (ContinuousBatchEngine, DecodeRequest, ServeClient,
                    ServeFrontDoor)
from .utils.config import DeferConfig
from .utils.checkpoint import (load_params, load_params_pt, save_params,
                               save_params_pt)
from .utils.convert import params_from_jax, params_to_jax
from .utils.pretrained import PRETRAINED_LOADERS, load_pretrained
from .utils.profiling import profile_pipeline, trace

__all__ = ["END_OF_STREAM", "Defer", "DeferConfig", "DeferHandle",
           "SpmdPipeline", "MpmdPipeline", "PipelineTrainer",
           "PipelinedDecoder", "partition",
           "models", "plan", "params_from_jax", "params_to_jax",
           "speculative_generate", "fold_batchnorm", "summary", "to_dot",
           "BlockFloatCodec", "LosslessCodec", "PipelineCodec", "RawCodec",
           "native_available", "save_params", "load_params",
           "save_params_pt", "load_params_pt", "load_pretrained",
           "PRETRAINED_LOADERS", "ServeFrontDoor", "ContinuousBatchEngine",
           "DecodeRequest", "ServeClient", "profile_pipeline", "trace",
           "Mesh", "pipeline_mesh", "STAGE_AXIS", "DATA_AXIS",
           "SEQ_AXIS", "ring_attention", "sequence_parallel_attention",
           "sequence_parallel_attention_ulysses", "ulysses_attention",
           "MODEL_AXIS", "shard_tp_params", "tensor_parallel_fn",
           "tensor_parallel_mesh", "EXPERT_AXIS", "expert_parallel_fn",
           "expert_parallel_mesh", "shard_moe_params", "initialize",
           "multihost_pipeline_mesh", "process_local_batch"]
