"""defer_tpu_torch — DEFER's pipelined DNN inference in PyTorch, on CUDA.

The port of the JAX package ``defer_tpu`` to PyTorch and an NVIDIA Hopper
card.  The JAX package stays the reference: the same graph, weights
(:func:`params_from_jax`) and inputs go through both, and the parity tests
compare the outputs.  This package imports ``torch`` and ``numpy`` and
never ``jax`` or anything of ``defer_tpu``.

Entry points (:class:`Defer`, :class:`SpmdPipeline`,
:class:`MpmdPipeline`, :class:`PipelinedDecoder`) run on the CUDA card
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
from .partition import partition
from .runtime import (END_OF_STREAM, Defer, DeferHandle, MpmdPipeline,
                      PipelinedDecoder, SpmdPipeline, speculative_generate)
from .utils.config import DeferConfig
from .utils.convert import params_from_jax

__all__ = ["END_OF_STREAM", "Defer", "DeferConfig", "DeferHandle",
           "SpmdPipeline", "MpmdPipeline", "PipelinedDecoder", "partition",
           "models", "params_from_jax", "speculative_generate"]
