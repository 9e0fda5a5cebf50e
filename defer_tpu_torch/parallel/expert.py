"""Expert parallelism: MoE experts sharded over an ``"expert"`` mesh axis
with capacity-based ``all_to_all`` token dispatch — the port of
``defer_tpu.parallel.expert``.

Switch routing: tokens are split by batch over the expert axis, each rank
owns ``E / ep`` experts, and two ``all_to_all`` exchanges move (token ->
owning expert) and (result -> originating rank).  Equal to the dense
:meth:`MoE.apply` whenever no expert's per-rank token count exceeds its
capacity; an overflow token is dropped and keeps only the residual (its
FFN delta is zero). The arithmetic is plain tensor code, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from ..graph.ir import tree_map
from .mesh import Mesh, all_to_all, visible_cards
from .tensor import rank_params, stack_trees

EXPERT_AXIS = "expert"


def expert_parallel_mesh(ep: int, devices=None) -> Mesh:
    """A one-axis ``("expert",)`` mesh of ``ep`` devices (default: every
    visible card; ``devices=[dev] * ep`` for one card)."""
    devices = list(devices) if devices is not None else visible_cards()
    if len(devices) < ep:
        raise ValueError(f"need {ep} devices, have {len(devices)}")
    return Mesh(devices[:ep], (EXPERT_AXIS,))


def shard_moe_params(op, params: dict[str, Any], ep: int,
                     mesh: Mesh | None = None, axis: str = EXPERT_AXIS):
    """Per-rank expert shards stacked on a leading [ep, ...] axis.

    The gate is replicated (every rank routes identically); fc1/fc2 are
    sliced so rank r owns experts [r*E/ep, (r+1)*E/ep).  With ``mesh``, the
    stack lies on the device of the axis's first rank."""
    e = op.num_experts
    if e % ep:
        raise ValueError(f"num_experts={e} not divisible by ep={ep}")
    el = e // ep

    def rank_shard(r):
        sl = slice(r * el, (r + 1) * el)
        return {
            "gate": params["gate"],
            "fc1": {"w": params["fc1"]["w"][sl], "b": params["fc1"]["b"][sl]},
            "fc2": {"w": params["fc2"]["w"][sl], "b": params["fc2"]["b"][sl]},
        }

    out = stack_trees([rank_shard(r) for r in range(ep)])
    if mesh is not None:
        dev = mesh.axis_devices(axis)[0]
        out = tree_map(lambda a: a.to(dev), out)
    return out


def expert_parallel_apply(op, params: Sequence[dict],
                          xs: Sequence[torch.Tensor], *, ep: int,
                          capacity: int) -> list[torch.Tensor]:
    """One EP MoE layer on the ranks' token shards ``xs`` [b_local, t, d].

    ``params`` holds each rank's expert slice.  Three phases: route and
    pack each rank's capacity buffer, run each rank's local experts on
    what it received, then scatter each rank's results back to its
    tokens; two ``all_to_all`` exchanges between them."""
    b, t, d = xs[0].shape
    n = b * t
    el = op.num_experts // ep
    dtype = xs[0].dtype
    # the local expert index rides the payload in the activation dtype, so
    # it must be exactly representable there: a float is integer-exact up
    # to 2**(mantissa+1) (bf16: 256), beyond which a token would reach the
    # wrong local expert
    exact_max = 2 ** (round(-math.log2(torch.finfo(dtype).eps)) + 1)
    if el > exact_max:
        raise ValueError(
            f"{el} local experts per device cannot ride a {dtype} "
            f"all_to_all payload exactly (max {exact_max}); use wider "
            f"activations or more expert-parallel ranks")

    sends, routes = [], []
    for p, x in zip(params, xs):
        xf = x.reshape(n, d)
        eid, pe = op.route(p, x)
        eidf, pef = eid.reshape(n), pe.reshape(n).to(dtype)
        dest = eidf // el                                   # owning rank
        # slot = this token's arrival index in its dest's capacity buffer
        dmask = F.one_hot(dest, ep)
        pos = (dmask.cumsum(0) * dmask).sum(-1) - 1
        keep = pos < capacity
        slot = torch.where(keep, pos, capacity)             # overflow -> C
        # payload = token features + its local expert index; the gate prob
        # stays local (applied to the returned result)
        payload = torch.cat([xf, (eidf % el).to(dtype)[:, None]], dim=-1)
        buf = xf.new_zeros((ep, capacity + 1, d + 1))
        buf[dest, slot] = payload
        sends.append(buf[:, :capacity])
        routes.append((dest, slot, keep, pef))

    ys = []
    for p, recv in zip(params, all_to_all(sends, 0, 0)):
        xr, lidr = recv[..., :d], recv[..., d].long()       # [ep, C, d]
        # masked dense sweep over my local experts (el is small by design)
        y = torch.zeros_like(xr)
        for e in range(el):
            y = torch.where((lidr == e)[..., None], op.expert_fn(p, xr, e), y)
        ys.append(y)

    outs = []
    for x, back, (dest, slot, keep, pef) in zip(xs, all_to_all(ys, 0, 0),
                                                routes):
        y_tok = back[dest, slot.clamp(0, capacity - 1)]      # [n, d]
        y_tok = y_tok * keep[:, None].to(dtype) * pef[:, None]
        outs.append(x + y_tok.reshape(b, t, d))
    return outs


def expert_parallel_fn(op, mesh: Mesh, axis: str = EXPERT_AXIS,
                       capacity_factor: float = 2.0,
                       tokens_per_device: int | None = None):
    """EP forward: ``fn(stacked_params, x) -> y``.

    ``x`` [B, t, d] is split by batch over the expert axis;
    ``stacked_params`` comes from :func:`shard_moe_params`.  Capacity per
    rank is ``ceil(capacity_factor * tokens_per_device / ep)`` (from the
    call's shapes unless given).  The output lies on the first rank's
    device."""
    devices = mesh.axis_devices(axis)
    ep = len(devices)

    def fn(pstk, x):
        if x.shape[0] % ep:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{ep} ranks")
        xs = [c.to(dv) for c, dv in zip(x.chunk(ep, dim=0), devices)]
        ntok = tokens_per_device or xs[0].shape[0] * xs[0].shape[1]
        cap = max(1, math.ceil(capacity_factor * ntok / ep))
        params = [rank_params(pstk, r, dv) for r, dv in enumerate(devices)]
        outs = expert_parallel_apply(op, params, xs, ep=ep, capacity=cap)
        return torch.cat([o.to(devices[0]) for o in outs], dim=0)

    return fn
