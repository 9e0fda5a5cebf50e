"""Timing and profiling helpers: the port of ``defer_tpu.utils.profiling``.

``timed_window`` is the reference harness's measurement discipline;
``amortized_forward_seconds`` times ``k`` forwards in one dispatch (one
CUDA-graph replay on the card); ``pipeline_window_seconds`` is a ring
pipeline's steady-state seconds per chunk with pushes kept in flight;
``measured_node_costs`` is the planner's empirical cost map;
``trace`` records a ``torch.profiler`` Chrome trace and
``profile_pipeline`` a deployment's structured breakdown.  A node's
profiling window and its trace are ``obs/profile.py``'s.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import time
from typing import Any

import numpy as np
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


def _sync(device: torch.device) -> None:
    """Wait for the card (a no-op off CUDA)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def amortized_forward_seconds(apply_fn, params, x0: torch.Tensor, k: int, *,
                              min_iters: int = 3, min_s: float = 2.0,
                              max_iters: int = 64) -> float:
    """Per-forward seconds with ``k`` forwards fused in ONE dispatch.

    One sync per forward would time the host's launches and the sync, not
    the card; the reference fuses the ``k`` forwards into one on-device
    ``lax.scan``.  Here the ``k`` forwards are one CUDA-graph replay on
    the card (``runtime/cuda_graph.py``), each output summed into a
    float32 carry, and an eager loop of the same forwards on the CPU.
    Step ``i`` feeds ``x0 + t[i]``, so every forward stays live:
    ``t = linspace(0, 1e-6, k)`` for floating inputs, and +0/+1
    alternately for integer inputs (token ids stay valid).  ``x0`` is a
    tensor on the device the forwards run on; ``apply_fn(params, x)``
    returns one tensor.
    """
    dev = x0.device
    if x0.dtype.is_floating_point:
        ts = torch.linspace(0, 1e-6, k, device=dev).to(x0.dtype)
    else:
        ts = (torch.arange(k, device=dev) % 2).to(x0.dtype)
    carry = torch.zeros((), dtype=torch.float32, device=dev)

    def run():
        c = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k):
            c = c + apply_fn(params, x0 + ts[i]).to(torch.float32).sum()
        carry.copy_(c)

    if dev.type == "cuda":
        from ..runtime.cuda_graph import capture
        with torch.cuda.device(dev):
            graph = capture(run, dev, label="amortized_forward")
        step = graph.replay
    else:
        step = run

    def once():
        step()
        _sync(dev)

    return timed_window(once, min_iters=min_iters, min_s=min_s,
                        max_iters=max_iters) / k


def pipeline_window_seconds(pipe, inputs, *, inflight: int = 2,
                            min_s: float = 2.5, max_chunks: int = 64):
    """Steady-state seconds per chunk with ``inflight`` chunk dispatches
    kept in flight (no per-chunk sync) and each completed chunk's result
    slab drained to the host.

    ``inputs`` must be a device block from ``pipe.stage_inputs`` — it is
    re-fed every chunk (the reference harness also re-feeds one image,
    test/test.py:20-23).  Warms up with a bubble pass of the same
    resident block (on the card it captures the chunk's graph), so no
    extra chunk-sized buffer is staged.  The deployment's counters are
    cleared before the measured window."""

    def run_window(m):
        pending = collections.deque()
        t0 = time.perf_counter()
        for _ in range(m):
            slab, _mask = pipe.push(inputs, raw=True)
            if slab is not None:
                pending.append(slab)
            while len(pending) > inflight:
                pending.popleft().cpu()
        while pending:
            pending.popleft().cpu()
        return time.perf_counter() - t0

    pipe.reset()
    slab, _ = pipe.push(inputs, n_real=0, raw=True)  # capture pass
    if slab is not None:
        slab.cpu()
    pipe.reset()
    run_window(2)  # post-capture warm pass
    t1 = max(run_window(1), 1e-4)
    m = max(2, min(max_chunks, math.ceil(min_s / t1)))
    # bill only the measured window to the deployment's metrics — the
    # capture/warm/calibration pushes above are harness artifacts that
    # would otherwise dominate bubble_fraction / throughput_per_s
    pipe.metrics.clear_counters()
    return run_window(m) / m


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
        _sync(dev)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        costs[name] = best / k
        del step
        if dev.type == "cuda":
            del graph_
    return costs


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is present) and write its Chrome trace to
    ``log_dir/trace-<pid>-<us>.json`` (open at https://ui.perfetto.dev)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns() // 1000}.json"))


def profile_pipeline(pipe, params: dict[str, Any], *, iters: int = 20,
                     warmup: int = 2) -> dict:
    """Structured breakdown of a pipeline deployment.

    Returns per-stage compute latency, the steady-state step time of one
    chunk (one CUDA-graph replay on the card), the implied stage-imbalance
    factor (max stage / mean stage — the pipeline's efficiency ceiling),
    and transfer-buffer footprint: the JAX package's keys.  The card is
    synchronized before and after the timed push; the CPU path never
    syncs.
    """
    lat = pipe.stage_latencies(params, iters=iters)
    inputs = np.zeros((pipe.chunk, pipe.microbatch) + tuple(
        pipe.in_spec.shape), np.float32)
    pipe.reset()
    for _ in range(warmup):
        pipe.push(inputs, n_real=0)
    _sync(pipe.device)  # don't bill queued warmup work to t0
    t0 = time.perf_counter()
    pipe.push(inputs, n_real=0)
    _sync(pipe.device)
    step_s = (time.perf_counter() - t0) / pipe.chunk
    mean_lat = sum(lat) / len(lat)
    return {
        "num_stages": pipe.num_stages,
        "stage_latency_ms": [round(s * 1e3, 4) for s in lat],
        "stage_imbalance": round(max(lat) / mean_lat, 3) if mean_lat else 0.0,
        "pipeline_step_ms": round(step_s * 1e3, 4),
        "step_overhead_vs_max_stage": round(step_s / max(lat), 3)
        if max(lat) > 0 else 0.0,
        "buffer_bytes_per_hop": pipe.metrics.buffer_bytes_per_hop,
        "steady_state_throughput_per_s": round(
            pipe.microbatch / step_s, 2) if step_s else 0.0,
    }
