"""Ring attention: sequence-parallel exact attention over a mesh axis —
the port of ``defer_tpu.parallel.ring_attention``.

The sequence axis is split over a ``seq`` mesh axis: each rank holds a
Q/K/V shard, and the K/V shards rotate around the ring (``ppermute``)
while an online-softmax accumulator (running max, running denominator,
rescaled value sum) builds the exact attention output.  Each rank's score
block is ``(T/N)²``, not ``T²``: the point of sequence parallelism.  As in
the JAX package the arithmetic is plain tensor code (``torch.einsum``),
not a kernel.

The JAX function is per-device code under ``shard_map``; here
:func:`ring_attention` runs the ranks in turn within each of the ``N``
phases between rotations, and frees each rank's score block before the
next rank's.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .mesh import Mesh, ppermute

SEQ_AXIS = "seq"


def _online_block(q, k, v, m, l, acc, scale, mask=None):
    """One block of streaming-softmax accumulation.

    q: [B,H,Tq,D]; k,v: [B,H,Tk,D]; m,l: [B,H,Tq]; acc: [B,H,Tq,D].
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new = -inf): keep accumulators unchanged
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc_new


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], *,
                   causal: bool = False) -> list[torch.Tensor]:
    """Exact attention with K/V rotating around the ring of ranks.

    ``qs``/``ks``/``vs`` hold the ranks' shards [B, H, Tl, D], rank ``i``
    the positions ``[i*Tl, (i+1)*Tl)``; returns the ranks' output shards.
    ``causal`` masks by the global sequence order."""
    n = len(qs)
    b, h, tl, d = qs[0].shape
    scale = 1.0 / math.sqrt(d)
    perm = [(i, (i + 1) % n) for i in range(n)]
    state = [(torch.full((b, h, tl), -math.inf, dtype=q.dtype,
                         device=q.device),
              torch.zeros((b, h, tl), dtype=q.dtype, device=q.device),
              torch.zeros_like(q)) for q in qs]
    ks, vs = list(ks), list(vs)
    for r in range(n):
        for idx, q in enumerate(qs):
            # ks[idx]/vs[idx] hold the shard that started on rank idx - r
            mask = None
            if causal:
                pos = torch.arange(tl, device=q.device)
                src = (idx - r) % n
                mask = (idx * tl + pos)[:, None] >= (src * tl + pos)[None, :]
            state[idx] = _online_block(q, ks[idx], vs[idx], *state[idx],
                                       scale, mask)
        if r < n - 1:  # the last rotation's result would go unread
            ks, vs = ppermute(ks, perm), ppermute(vs, perm)
    return [acc / l.clamp_min(1e-20)[..., None] for _, l, acc in state]


def full_attention(q, k, v, *, causal: bool = False):
    """Reference single-device attention (for equivalence tests).

    ``causal`` uses bottom-right alignment when Tq != Tk (query row i sees
    key positions <= i + Tk - Tq), matching ``flash_attention``."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        q_pos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        s = s.masked_fill(q_pos < torch.arange(tk, device=q.device)[None, :],
                          -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", s.softmax(dim=-1), v)


def shard_sequence(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """Global [B, H, T, D] -> the ranks' sequence shards, each on its
    rank's device."""
    n = len(devices)
    if x.shape[2] % n:
        raise ValueError(f"sequence length {x.shape[2]} does not split "
                         f"over {n} ranks")
    return [c.to(d) for c, d in zip(x.chunk(n, dim=2), devices)]


def sequence_parallel_attention(q, k, v, mesh: Mesh, *,
                                axis_name: str = SEQ_AXIS,
                                causal: bool = False):
    """Global [B,H,T,D] tensors in, attention out: the sequence dimension
    split over ``mesh[axis_name]`` and K/V rotated around the ring.  The
    output lies on the first rank's device."""
    devices = mesh.axis_devices(axis_name)
    outs = ring_attention(shard_sequence(q, devices),
                          shard_sequence(k, devices),
                          shard_sequence(v, devices), causal=causal)
    return torch.cat([o.to(devices[0]) for o in outs], dim=2)
