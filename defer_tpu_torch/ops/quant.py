"""Block-scale int8 quantization for inter-stage transfers.

The port of ``defer_tpu.ops.quant``.  Activations are quantized to int8
with one float32 scale per 256-value block on the device, immediately
before a stage-to-stage hop, and dequantized right after — the device-side
analogue of the reference's lossy ZFP activation compression.  Relative
error is <= 1/254 of each block's max |value|.

:func:`quantize_int8_blocks` dispatches on the tensor's device: a CPU
tensor takes :func:`quantize_int8_blocks_plain` (plain PyTorch), a CUDA
tensor launches the hand-written Hopper kernel (``ops/quant_cuda.py``) or
raises — there is no fallback from the card to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

#: values per shared scale
BLOCK = 256
#: f32(1/127).  The scale is ``amax * INV_127``, not ``amax / 127``: XLA
#: compiles the JAX package's ``amax / 127.0`` into this multiply (the
#: Pallas kernel and the jitted jnp path both do; only the eager jnp path
#: divides), so the compiled reference — what its pipeline runs — is
#: matched bit for bit.  See ROADMAP.md queue C.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _check_blocks(x: torch.Tensor) -> None:
    if x.dim() == 0 or x.shape[-1] % BLOCK:
        raise ValueError(f"last dim {tuple(x.shape)[-1:]} not a multiple of "
                         f"{BLOCK}")


def quantize_int8_blocks_plain(x: torch.Tensor):
    """[..., L] float -> ([..., L] int8, [..., L/BLOCK] f32 scales), in
    plain PyTorch: the reference math of ``defer_tpu.ops.quant`` and the
    version the CUDA kernel is held against.  Non-finite inputs are
    flushed to 0; ``x / scale`` is an IEEE division and ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    _check_blocks(x)
    *lead, n = x.shape
    xb = x.reshape(*lead, n // BLOCK, BLOCK).to(torch.float32)
    xb = torch.where(torch.isfinite(xb), xb, 0.0)
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * INV_127, 1.0)
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(*lead, n), scale


def quantize_int8_blocks(x: torch.Tensor):
    """[..., L] float -> ([..., L] int8, [..., L/BLOCK] f32 scales).

    L must be a multiple of BLOCK (the pipeline pads its transfer buffer
    up-front).  A CPU tensor takes the plain version; a CUDA tensor
    launches the CUDA kernel (which raises on what it cannot take)."""
    if x.device.type == "cpu":
        return quantize_int8_blocks_plain(x)
    if x.device.type == "cuda":
        from .quant_cuda import quantize_int8_blocks_cuda
        return quantize_int8_blocks_cuda(x)
    raise ValueError(f"quantize_int8_blocks: no implementation for device "
                     f"{x.device}")


def dequantize_int8_blocks(q: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_blocks` (plain PyTorch on every
    device, as in the reference)."""
    *lead, n = q.shape
    xb = q.reshape(*lead, n // BLOCK, BLOCK).to(torch.float32)
    return (xb * scale[..., None]).reshape(*lead, n).to(dtype)


def quantized_ring_hop(y: torch.Tensor, out_dtype) -> torch.Tensor:
    """The int8 stage->successor hop over a one-card ring ``[N, ...]``:
    block-quantize every slot in ONE launch, rotate the int8 payload and
    its scales one slot (slot k's output moves to slot k+1, the last wraps
    to slot 0 — ``lax.ppermute`` in the JAX package), dequantize.

    Quantizing the whole ring at once equals quantizing per device: the
    quant blocks never straddle two slots (each slot's length is a
    multiple of BLOCK)."""
    q, s = quantize_int8_blocks(y)
    return dequantize_int8_blocks(torch.roll(q, 1, 0), torch.roll(s, 1, 0),
                                  out_dtype)
