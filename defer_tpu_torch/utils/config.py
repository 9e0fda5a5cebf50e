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
    # dtype activations are cast to inside each stage (None = model dtype):
    # float32 or bfloat16; the ring engine then stores weights in it too
    compute_dtype: str | None = None
    # keep weights in f32 and cast inside each stage (training recipe)
    master_weights: bool = False
    # stage->stage hop encoding: "buffer" sends the raw transfer buffer;
    # "int8" block-quantizes every hop on the device (the analogue of the
    # reference's ZFP wire compression)
    wire: str = "buffer"
    # batch-parallel replicas (mesh "data" axis) and intra-stage
    # Megatron-style weight sharding (mesh "model" axis), on one card's
    # mesh (parallel/mesh.py)
    data_parallel: int = 1
    tensor_parallel: int = 1
    # "spmd" (ring engine, primary) or "mpmd" (per-stage relay, oracle)
    mode: str = "spmd"
    # device the pipeline runs on; None = the CUDA card
    device: str | None = None
    # seconds ``run_defer`` waits for more queue items before padding a
    # partial chunk with bubbles
    gather_timeout_s: float = 0.002
    # failure detection in ``run_defer``: once past the first dispatch, a
    # dispatch that makes no progress for max(watchdog_s, watchdog_scale *
    # slowest completed dispatch) seconds declares the serve thread hung
    # (None disables)
    watchdog_s: float | None = 60.0
    # multiplier on the slowest completed dispatch (the preflight included)
    watchdog_scale: float = 8.0
    # run a full-chunk bubble probe through the freshly built pipeline
    # before serving, so build failures surface as handle.error at once
    preflight: bool = True
    # how many times the watchdog rebuilds a hung SPMD pipeline and replays
    # the fed-but-unemitted microbatches before declaring it dead (0 =
    # detection only)
    max_recoveries: int = 1
