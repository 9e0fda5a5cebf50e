"""Exact softmax attention: the port of ``defer_tpu.ops.flash_attention``.

``softmax(q kᵀ · f32(1/√D)) v`` for ``q [B, H, Tq, D]`` and
``k, v [B, H, Tk, D]`` of any sizes.  ``causal=True`` is bottom-right
aligned: query row i sees key positions <= i + Tk - Tq, so a decode call
(Tq=1 against a long prefix) sees the whole prefix.  A row that sees no key
returns 0 (the denominator is floored at 1e-20).  Forward only: the JAX
package defines no gradient either.

:func:`flash_attention` checks its arguments and calls the custom operator
``torch.ops.defer_tpu_torch.flash_attention(q, k, v, causal)``, which
dispatches on the tensors' device:

* ``cpu`` — :func:`flash_attention_plain`, a plain PyTorch masked softmax
  in float32 (the version the tests hold to the JAX package, and the one
  the CUDA kernel is held to on the card);
* ``meta`` and fake tensors — the operator's fake implementation, which
  gives the output's shape and dtype: graph shape inference
  (``GraphBuilder.add``) runs ops on meta tensors, and ``torch.export``
  traces with fake ones, so neither reaches the kernel loader;
* ``cuda`` — the hand-written Hopper kernel (``ops/flash_attention_cuda.py``,
  ``csrc/flash_attention.cu``), which raises on what it cannot take.
  There is no fallback from the card to the plain version.

The operator is what makes an exported stage program
(``utils/export.py``) carry the kernel: a trace records one
``defer_tpu_torch.flash_attention`` node, not the plain version's ops, and
the loaded program dispatches that node by the device of its inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: floor of the softmax denominator (``flash_attention.py:96`` in the JAX
#: package): a row with no live key divides 0 by it and returns 0
L_FLOOR = 1e-20


def softmax_scale(d: int) -> float:
    """``f32(1/√d)``: the scores are multiplied by it, as the Pallas
    kernel multiplies by its weakly typed Python scale."""
    return float(np.float32(1.0 / math.sqrt(d)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be [B, H, T, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if (k.shape != v.shape or tuple(k.shape[:2]) != (b, h)
            or k.shape[3] != d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def _check_blocks(block_q: int, block_k: int) -> None:
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(blk, int) or isinstance(blk, bool) or blk < 1:
            raise ValueError(f"flash_attention: {name} must be a positive "
                             f"int, got {blk!r}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False) -> torch.Tensor:
    """The reference math in plain PyTorch, all in float32: scores scaled
    by ``f32(1/√D)``, masked, max-subtracted softmax with the denominator
    floored at 1e-20 (rows with no live key give 0).  Output in q's
    dtype."""
    _check(q, k, v)
    t_q, t_k = q.shape[2], k.shape[2]
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * softmax_scale(q.shape[-1])
    if causal:  # bottom-right: row i sees keys j <= i + Tk - Tq
        q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)
        future = q_pos < torch.arange(t_k, device=q.device)
        s = s.masked_fill(future, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)  # rows with no live key
    p = torch.exp(s - m)                     # exp(-inf) = 0 on masked keys
    l = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    return ((p @ vf) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Exact attention ``softmax(q kᵀ/√D) v``: [B,H,Tq,D] x [B,H,Tk,D]
    -> [B,H,Tq,D] in q's dtype (f32 or bf16 in, f32 state).

    ``block_q``/``block_k`` are the JAX signature's tile sizes.  They are
    validated and accepted; the CUDA kernel runs its own fixed tile
    (``csrc/flash_attention.cu``), which changes results only by rounding.

    Forward only, as the JAX package's Pallas kernel: with grad mode on
    and an input that requires grad it raises, on every device, rather
    than let the plain version stand in for the kernel.  Attention models
    train through ``attn_impl="xla"`` blocks
    (``graph.optimize.with_attn_impl``).
    """
    _check_blocks(block_q, block_k)
    _check(q, k, v)
    if q.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"flash_attention: no implementation for device "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (neither has the JAX "
            "package's Pallas kernel): build the attention blocks with "
            "attn_impl=\"xla\" to train, e.g. "
            "graph.optimize.with_attn_impl(graph, \"xla\")")
    return torch.ops.defer_tpu_torch.flash_attention(q, k, v, bool(causal))


@torch.library.custom_op("defer_tpu_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    return flash_attention_plain(q, k, v, causal=causal)


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v, causal):
    from .flash_attention_cuda import flash_attention_cuda
    return flash_attention_cuda(q, k, v, causal=causal)


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)
