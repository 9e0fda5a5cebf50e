"""Timing helpers for the planner: a timed window and measured node costs.

The port of ``timed_window`` and ``measured_node_costs`` of
``defer_tpu.utils.profiling``.  Pipeline windows, traces and
``profile_pipeline`` come with ROADMAP item A7 (a node's profiling
window and its ``torch.profiler`` trace are ``obs/profile.py``'s).
"""

from __future__ import annotations

import time

import torch

from ..graph.ir import tree_map
from .config import resolve_device


def timed_window(fn, *, min_iters=8, min_s=3.0, max_iters=512):
    """Warm call, then measure average seconds/iter over a timed window
    (the reference harness's measurement discipline, test/test.py:25-37)."""
    fn()  # warmup
    t0 = time.perf_counter()
    n = 0
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if (n >= min_iters and dt >= min_s) or n >= max_iters:
            return dt / n


def _node_loop(op, p, xs, ts, k: int):
    """``k`` calls of ``op`` on ``xs`` whose first input is perturbed per
    step (``ts[i]``), each output summed into a float32 carry — the
    reference's scan body, unrolled: nothing can be hoisted out of the
    loop, and every call's output is consumed."""
    x0 = xs[0]
    floating = x0.dtype.is_floating_point

    def run():
        c = torch.zeros((), dtype=torch.float32, device=x0.device)
        for i in range(k):
            # int ids alternate +0/+1 (still a valid index set)
            x = x0 + (ts[i] * 1e-7).to(x0.dtype) if floating \
                else x0 + ts[i].to(torch.int32).remainder(2).to(x0.dtype)
            y = op.apply(p, x, *xs[1:])
            c = c + y.to(torch.float32).sum()
        return c
    return run


@torch.inference_mode()
def measured_node_costs(graph, params, *, batch: int = 1,
                        compute_dtype=None, k: int = 32, reps: int = 3,
                        device=None) -> dict[str, float]:
    """Per-node measured seconds for every node of ``graph`` — the
    empirical cost map for latency-balanced partitioning
    (``graph.analysis.auto_cut_points(g, n, costs=...)``) and the
    planner's ``StageCostModel(node_costs=...)``.

    Each node runs on zero inputs at ``batch`` (floating inputs and
    parameters in ``compute_dtype`` when given) ``k`` times per timed
    call, as the reference's ``lax.scan`` does: on the card the ``k``
    calls are one CUDA-graph replay (``runtime/cuda_graph.py``), captured
    after an eager warm-up, so one sync sits under ``k`` calls instead of
    under each — timing one call per sync would put the same launch floor
    under every node and flatten the weights.  The first timed call warms
    up; the cost is the minimum over ``reps`` further calls, divided by
    ``k``, in seconds.  Kernel launch counts stay true under replay
    (``ops/launches.py``): every replay adds the ``k`` calls' launches.

    Standalone per-op timing ignores fusion across ops, so ABSOLUTE
    numbers overstate a stage; partitioning only needs the RELATIVE
    weights.  Runs on the CUDA card by default; ``device="cpu"`` times
    the same loop eagerly on the host.
    """
    from ..runtime.cuda_graph import capture

    dev = resolve_device(device)
    cdt = None
    if compute_dtype is not None:
        cdt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) \
            else compute_dtype
    ts = torch.arange(k, dtype=torch.float32, device=dev)
    costs: dict[str, float] = {}
    for name in graph.topo_order:
        node = graph.nodes[name]
        xs = []
        for i in node.inputs:
            s = graph.out_spec(i)
            dt = cdt if cdt is not None and s.dtype.is_floating_point \
                else s.dtype
            xs.append(torch.zeros((batch,) + tuple(s.shape), dtype=dt,
                                  device=dev))
        p = params.get(name)
        if p is not None:
            p = tree_map(lambda a: a.to(dev, cdt) if cdt is not None
                         and a.is_floating_point() else a.to(dev), p)
        run = _node_loop(node.op, p, xs, ts, k)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                graph_ = capture(run, dev, label="node_costs")
            step = graph_.replay
        else:
            step = run
        step()  # warm
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        costs[name] = best / k
        del step
        if dev.type == "cuda":
            del graph_
    return costs
