"""Ulysses-style sequence parallelism: all_to_all head-scatter attention —
the port of ``defer_tpu.parallel.ulysses``.

The second of the two sequence-parallel schemes (ring attention is the
other, ``ring_attention.py``): two ``all_to_all`` exchanges re-shard the
tensors from sequence-split [B, H, T/N, D] to head-split [B, H/N, T, D],
each rank runs full attention over the whole sequence on its heads, and
one more exchange splits the output back by sequence.  Needs
``num_heads % N == 0`` and a sequence that splits evenly.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mesh import Mesh, all_to_all
from .ring_attention import SEQ_AXIS, full_attention, shard_sequence


def ulysses_attention(qs: Sequence[torch.Tensor],
                      ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], *,
                      causal: bool = False) -> list[torch.Tensor]:
    """Exact attention on the ranks' sequence shards [B, H, T/N, D] via
    head scatter; returns the ranks' output shards [B, H, T/N, D]."""
    n = len(qs)
    h = qs[0].shape[1]
    if h % n:
        raise ValueError(f"num_heads={h} not divisible by mesh size {n}")

    def scatter_heads(xs):
        # [b, h, tl, d] -> [b, h/n, T, d]: head chunk j goes to rank j,
        # the received sequence shards concatenate into the sequence
        return all_to_all(xs, split_axis=1, concat_axis=2)

    outs = [full_attention(q, k, v, causal=causal) for q, k, v in
            zip(scatter_heads(qs), scatter_heads(ks), scatter_heads(vs))]
    # inverse: [b, h/n, T, d] -> [b, h, tl, d]
    return all_to_all(outs, split_axis=2, concat_axis=1)


def sequence_parallel_attention_ulysses(q, k, v, mesh: Mesh, *,
                                        axis_name: str = SEQ_AXIS,
                                        causal: bool = False):
    """Global [B,H,T,D] in, attention out: the sequence split over
    ``mesh[axis_name]`` with all_to_all head exchange.  The output lies on
    the first rank's device."""
    devices = mesh.axis_devices(axis_name)
    outs = ulysses_attention(shard_sequence(q, devices),
                             shard_sequence(k, devices),
                             shard_sequence(v, devices), causal=causal)
    return torch.cat([o.to(devices[0]) for o in outs], dim=2)
