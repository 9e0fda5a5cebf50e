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


def quantized_ring_hop(y: torch.Tensor, out_dtype, cross=None) -> torch.Tensor:
    """The int8 stage->successor hop over a ring ``[N, ...]``: block-quantize
    every slot in ONE launch, rotate the int8 payload and its scales one
    slot (slot k's output moves to slot k+1, the last wraps to slot 0 —
    ``lax.ppermute`` in the JAX package), dequantize.

    Quantizing the whole ring at once equals quantizing per device: the
    quant blocks never straddle two slots (each slot's length is a
    multiple of BLOCK).

    With ``cross`` the ring is this process's segment of a ring over
    several processes: after the rotation slot 0 holds the last local
    slot's ``(q, s)``, which ``cross([q0, s0])`` sends to the process of
    the next stage, returning the ``(q, s)`` the previous stage's process
    sent, which take slot 0's place.  So what crosses the process boundary
    is the int8 payload and its scales, as over the JAX ``ppermute``."""
    q, s = quantize_int8_blocks(y)
    q, s = torch.roll(q, 1, 0), torch.roll(s, 1, 0)
    if cross is not None:
        q[0], s[0] = cross([q[0], s[0]])
    return dequantize_int8_blocks(q, s, out_dtype)


class _StraightThroughHop(torch.autograd.Function):
    """:func:`quantized_ring_hop` forward; the backward treats dequant∘quant
    as identity and rolls the cotangent one slot back (the JAX trainer's
    ``_hop_bwd``, a ``ppermute`` by the inverse ring).  Across processes
    ``back(g0)`` sends slot 0's cotangent to the previous stage's process
    and returns the last slot's, from the next stage's; ``token`` (a leaf
    that requires grad, or None) records the hop under autograd even
    where ``y`` needs no gradient, so that exchange always runs.  It saves
    nothing, so a recompute never needs to rerun the quantizer."""

    @staticmethod
    def forward(ctx, y, out_dtype, cross, back, token):
        ctx.back = back
        return quantized_ring_hop(y, out_dtype, cross)

    @staticmethod
    def backward(ctx, g):
        gy = torch.roll(g, -1, 0)
        if ctx.back is not None:
            gy[-1] = ctx.back(g[0])
        return gy, None, None, None, None


def ste_ring_hop(y: torch.Tensor, out_dtype, cross=None, back=None,
                 token=None) -> torch.Tensor:
    """The int8 ring hop with a straight-through estimator: exactly
    :func:`quantized_ring_hop` forward (one quantizer launch for the whole
    ring; with ``cross``, this process's segment of a ring across
    processes), ``torch.roll(g, -1, 0)`` backward, its last slot from
    ``back`` across processes: the cotangent crosses in the ring's dtype,
    not as int8, as in the JAX trainer (``token``: see
    ``_StraightThroughHop``).  With grad off (inference, a CUDA-graph
    capture) it is the plain hop."""
    return _StraightThroughHop.apply(y, out_dtype, cross, back, token)
