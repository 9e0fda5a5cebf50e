"""MPMD relay pipeline — the correctness oracle / debug execution mode.

The port of ``defer_tpu.runtime.mpmd``: one module per stage, run in
sequence on one device, with each microbatch relayed stage to stage.  The
in-flight window (as deep as the pipeline) falls out of PyTorch's
asynchronous CUDA launches, as it falls out of JAX's async dispatch in the
reference.  Same streaming contract as :class:`SpmdPipeline`:
``reset`` / ``push`` / ``flush`` / ``warmup`` / ``run``.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..obs import tracer
from ..partition.stage import StageModule, StageSpec
from ..utils.config import resolve_device
from ..utils.metrics import PipelineMetrics
from .spmd import check_single_card


class MpmdPipeline:
    """Per-stage modules relaying each microbatch, on one device
    (``device=None`` means the CUDA card)."""

    def __init__(self, stages: Sequence[StageSpec], params: dict[str, Any],
                 *, device: str | torch.device | None = None,
                 microbatch: int = 1, compute_dtype=None):
        check_single_card(compute_dtype=compute_dtype)
        self.device = resolve_device(device)
        self.stages = list(stages)
        self.num_stages = n = len(self.stages)
        self.microbatch = microbatch
        self.modules = [StageModule(s, params, self.device)
                        for s in self.stages]
        self.in_spec = self.stages[0].in_spec
        self.out_spec = self.stages[-1].out_spec
        self.metrics = PipelineMetrics(num_stages=n, microbatch=microbatch)
        self.metrics.bind()
        self.reset()

    # ------------------------------------------------------------------
    # streaming interface (mirrors SpmdPipeline)
    # ------------------------------------------------------------------

    def reset(self):
        """Empty the in-flight window."""
        self._inflight: collections.deque = collections.deque()

    @torch.inference_mode()
    def _issue(self, x_np):
        """Issue one microbatch through every stage without blocking;
        returns its output and an event that completes with it (None on
        the CPU, where the work is done on return)."""
        x = torch.as_tensor(np.asarray(x_np)).to(self.device,
                                                 self.in_spec.dtype)
        for module in self.modules:
            x = module(x)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return x, done

    def push(self, xs, n_real: int | None = None):
        """Issue ``xs`` ([C, microbatch, *in_shape]); return microbatches
        that have left the in-flight window (depth = pipeline depth), in
        feed order — the same contract as ``SpmdPipeline.push``."""
        xs = np.asarray(xs)
        c = xs.shape[0]
        if n_real is None:
            n_real = c
        t0 = time.perf_counter()
        emitted, last = [], None
        for j in range(c):
            self._inflight.append((*self._issue(xs[j]), j < n_real))
            while len(self._inflight) > self.num_stages:
                arr, done, real = self._inflight.popleft()
                if real:
                    emitted.append(arr)
                    last = done
                    self.metrics.inferences += self.microbatch
        # wait for what we hand back (the oldest in-flight work) so wall_s
        # measures execution, not just enqueue; newer work stays in flight
        if last is not None:
            last.synchronize()
        self.metrics.steps += c
        self.metrics.chunk_calls += 1
        dt = time.perf_counter() - t0
        self.metrics.wall_s += dt
        self.metrics.push_latency.record(dt)
        tr = tracer()
        if tr.enabled:
            tr.record("mpmd.push", t0, dt, {"chunk": c, "n_real": n_real})
        return emitted

    def flush(self):
        """Drain the in-flight window; returns remaining outputs in order."""
        emitted, last = [], None
        t0 = time.perf_counter()
        while self._inflight:
            arr, done, real = self._inflight.popleft()
            last = done
            if real:
                emitted.append(arr)
                self.metrics.inferences += self.microbatch
        if last is not None:
            last.synchronize()
        self.metrics.wall_s += time.perf_counter() - t0
        return emitted

    def warmup(self):
        """Run every stage once on one bubble microbatch."""
        self.reset()
        bubble = np.zeros((1, self.microbatch) + self.in_spec.shape,
                          np.float32)
        self.push(bubble, n_real=0)
        self.flush()
        self.reset()

    # ------------------------------------------------------------------
    # batch convenience
    # ------------------------------------------------------------------

    def run(self, inputs) -> np.ndarray:
        """[M, microbatch, *in_shape] -> [M, microbatch, *out_shape]."""
        inputs = np.asarray(inputs)
        self.reset()
        outs = self.push(inputs)
        outs.extend(self.flush())
        if len(outs) != inputs.shape[0]:
            raise RuntimeError(
                f"pipeline emitted {len(outs)} of {inputs.shape[0]} inputs")
        return torch.stack(outs).float().cpu().numpy()

    def __call__(self, inputs) -> np.ndarray:
        return self.run(inputs)
