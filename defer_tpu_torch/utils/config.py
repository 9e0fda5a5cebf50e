"""Typed configuration for the pipeline runtime, and device resolution.

The port's ``DeferConfig`` keeps the reference's fields and adds
``device``.  Entry points run on the card unless the caller names another
device: with no device given, :func:`resolve_device` picks ``cuda`` and
raises when CUDA is absent — it never drops to the CPU silently.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and is not available.
    """
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            how = "by default" if device is None else f"as {device!r}"
            raise RuntimeError(
                f"defer_tpu_torch runs on a CUDA device {how}, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if d.index is None:  # tensors report an indexed device
            d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass
class DeferConfig:
    # samples per microbatch (microbatch=1 is the reference's setting)
    microbatch: int = 1
    # pipeline steps run per push call (the reference's in-flight window)
    chunk: int = 16
    # dtype of the homogeneous inter-stage transfer buffer
    buffer_dtype: str = "float32"
    # dtype activations are cast to inside each stage (None = model dtype);
    # only None is supported by this port so far
    compute_dtype: str | None = None
    # keep weights in f32 and cast inside each stage (training recipe);
    # not supported by this port so far
    master_weights: bool = False
    # stage->stage hop encoding: "buffer" sends the raw transfer buffer;
    # "int8" block-quantizes every hop on the device (the analogue of the
    # reference's ZFP wire compression)
    wire: str = "buffer"
    # batch-parallel replicas / intra-stage sharding: multi-card only, not
    # supported by this port so far
    data_parallel: int = 1
    tensor_parallel: int = 1
    # "spmd" (ring engine, primary) or "mpmd" (per-stage relay, oracle)
    mode: str = "spmd"
    # device the pipeline runs on; None = the CUDA card
    device: str | None = None
