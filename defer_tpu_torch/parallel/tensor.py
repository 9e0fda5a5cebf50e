"""Tensor parallelism: intra-layer (Megatron-style) sharding over a
``"model"`` mesh axis — the port of ``defer_tpu.parallel.tensor``.

Weight matrices are split across the axis's ranks, every rank computes a
partial product and one psum (``parallel.mesh.psum``) reconstitutes the
activation.  The pieces:

  * per-op hooks (``Op.tp_shard`` / ``tp_apply`` / ``tp_unshard``),
    implemented by the matmul-bearing ops (``Dense``,
    ``TransformerBlock``); every other op is replicated;
  * :func:`shard_tp_params` — each rank's shard of a parameter dict,
    stacked on a leading ``[tp, ...]`` axis (as numpy, bit-equal to the
    JAX package's);
  * :func:`tensor_parallel_fn` — the graph's forward on those shards, a
    loop over the ranks in phases between the ops' psums; the input and
    the output are replicated.  Where the model axis crosses
    ``torch.distributed`` processes, each process holds and runs its own
    ranks of the line and the psums all-reduce over the line's processes
    (``parallel.mesh.ModelLine``).

Sharding scheme (the column->row pairing, two psums per transformer
block):

  =============  ==========================  =====================
  parameter      split                       collective
  =============  ==========================  =====================
  Dense.w        rows (input dim)            psum after matmul
  qkv.w / .b     columns, per head group     none (local heads)
  proj.w         rows                        psum before residual
  fc1.w / .b     columns                     none
  fc2.w          rows                        psum before residual
  =============  ==========================  =====================
"""

from __future__ import annotations

from typing import Any

import torch

from ..graph.ir import LayerGraph, tree_map
from .mesh import (MODEL_AXIS, Mesh, ModelLine, _line,
                   mesh_placement, visible_cards)


def tensor_parallel_mesh(tp: int, devices=None) -> Mesh:
    """A one-axis ``("model",)`` mesh of ``tp`` devices (default: every
    visible card; ``devices=[dev] * tp`` for one card)."""
    devices = list(devices) if devices is not None else visible_cards()
    if len(devices) < tp:
        raise ValueError(f"need {tp} devices, have {len(devices)}")
    return Mesh(devices[:tp], (MODEL_AXIS,))


def _line_ranks(mesh: Mesh | None, axis: str, tp: int) -> list[int]:
    """This process's ranks of its line along ``axis`` (every rank where
    the line lies in one process)."""
    if mesh is None or not mesh.axis_crosses_processes(axis):
        return list(range(tp))
    return _line(mesh, axis)[1]


def shard_tp_params(graph: LayerGraph, params: dict[str, Any], tp: int,
                    mesh: Mesh | None = None, axis: str = MODEL_AXIS):
    """Per-rank TP shards of ``params``, stacked on a leading [ranks, ...]
    axis (contiguous copies): every rank's, or, with a ``mesh`` whose
    ``axis`` crosses processes, this process's ranks of its line.  Ops
    without a ``tp_shard`` override are replicated: each rank gets the
    full leaf.  With ``mesh``, the stack lies on the device of this
    process's first rank."""
    ranks = _line_ranks(mesh, axis, tp)
    out: dict[str, Any] = {}
    for name, node in graph.nodes.items():
        p = params.get(name)
        if p is None:
            continue
        out[name] = stack_trees([node.op.tp_shard(p, tp, r)
                                 for r in ranks])
    if mesh is not None:
        dev = (mesh_placement(mesh, "shard_tp_params")[1]
               if mesh.axis_crosses_processes(axis)
               else mesh.axis_devices(axis)[0])
        out = tree_map(lambda a: a.to(dev), out)
    return out


def stack_trees(trees: list) -> Any:
    """Same-structure nested dicts -> one dict whose leaves are the
    leaves stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([torch.as_tensor(t) for t in trees])


def rank_params(stacked: dict[str, Any], rank: int,
                device: torch.device) -> dict[str, Any]:
    """Rank ``rank``'s slice of a stacked shard dict, on ``device``."""
    return tree_map(lambda a: a[rank].to(device), stacked)


def tensor_parallel_fn(graph: LayerGraph, mesh: Mesh,
                       axis: str = MODEL_AXIS):
    """TP forward: ``fn(stacked_params, x) -> y``.

    ``stacked_params`` comes from :func:`shard_tp_params`; ``x`` is
    replicated to every rank's device, rank ``r`` runs on its shard
    ``stacked[r]`` and the output is the first rank's (every rank holds
    the same after the last psum).  Where ``axis`` crosses processes,
    every process of the line calls ``fn`` with the same ``x``: it runs
    its own ranks (the stack :func:`shard_tp_params` gives it) and the
    psums all-reduce over the line's processes."""
    tp = mesh.shape[axis]
    ranks = _line_ranks(mesh, axis, tp)
    if mesh.axis_crosses_processes(axis):
        devices = [mesh_placement(mesh, "tensor_parallel_fn")[1]] * len(
            ranks)
    else:
        devices = mesh.axis_devices(axis)
    line = ModelLine(tp, ranks, mesh, axis)

    def fn(pstk, x):
        params = [rank_params(pstk, i, d) for i, d in enumerate(devices)]
        xs = [x.to(d) for d in devices]
        if tp == 1:
            return graph.apply(params[0], xs[0])
        return graph.apply(params, xs, tp=line)[0]

    return fn
