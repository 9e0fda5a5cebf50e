"""Ring pipeline engine on one card: the port of ``defer_tpu.runtime.spmd``.

The JAX engine is one SPMD program over a ``stage`` mesh axis: per step
every device runs its stage on its slot of the activation ring and
``lax.ppermute``s the result to its successor.  On one card the ring is one
``[N, microbatch, buf_elems]`` tensor in ``buffer_dtype``, and a step is:

  1. slot 0 takes the injected input (not quantized);
  2. each stage k runs on slot k; its output is reshaped to
     ``[b, out_sz]``, cast to ``buffer_dtype`` and zero-padded to
     ``buf_elems``;
  3. the ring rotates one slot (stage k's output to slot k+1, the last
     wraps to slot 0).  Under ``wire="int8"`` the whole ring is
     block-quantized in ONE kernel launch before the rotation and
     dequantized after it (``ops.quant.quantized_ring_hop``) — the wrap hop
     too, so the output read at slot 0 is a dequantized value, exactly as
     on the TPU.

Schedule (unchanged): at step t stage 0 starts microbatch t, stage k
computes microbatch t-k, and the output at slot 0 after step t is
microbatch t-N+1.  A chunk of steps is a plain Python loop.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..graph.ir import ShapeSpec, as_dtype
from ..obs import tracer
from ..ops.quant import quantized_ring_hop
from ..partition.stage import StageModule, StageSpec, buffer_footprint
from ..utils.config import resolve_device
from ..utils.metrics import PipelineMetrics


def check_single_card(*, compute_dtype=None, data_parallel: int = 1,
                      tensor_parallel: int = 1,
                      master_weights: bool = False) -> None:
    """Raise for the reference options this port does not support yet."""
    if compute_dtype is not None and as_dtype(compute_dtype) != torch.float32:
        raise NotImplementedError(
            "compute_dtype other than float32 is not ported yet (ROADMAP)")
    if data_parallel != 1 or tensor_parallel != 1:
        raise NotImplementedError(
            "data_parallel / tensor_parallel need a multi-card ring "
            "(ROADMAP queue A15)")
    if master_weights:
        raise NotImplementedError(
            "master_weights belongs to the pipeline trainer (ROADMAP queue "
            "A16)")


class SpmdPipeline:
    """Inference pipeline over a ring of stage slots on one device.

    Usage::

        stages = partition(graph, cut_points)
        pipe = SpmdPipeline(stages, params, device="cuda")
        outputs = pipe.run(inputs)          # [M, B, ...] -> [M, B, ...]

    or streaming: ``reset()`` / ``push(chunk, n_real)`` / ``flush()``.
    ``device=None`` means the CUDA card (an error when CUDA is absent).
    """

    def __init__(
        self,
        stages: Sequence[StageSpec],
        params: dict[str, Any],
        *,
        device: str | torch.device | None = None,
        microbatch: int = 1,
        chunk: int = 16,
        buffer_dtype=torch.float32,
        compute_dtype=None,
        wire: str = "buffer",
        data_parallel: int = 1,
        tensor_parallel: int = 1,
        master_weights: bool = False,
    ):
        check_single_card(compute_dtype=compute_dtype,
                          data_parallel=data_parallel,
                          tensor_parallel=tensor_parallel,
                          master_weights=master_weights)
        if wire not in ("buffer", "int8"):
            raise ValueError(f"wire must be 'buffer' or 'int8', got {wire!r}")
        self.device = resolve_device(device)
        self.stages = list(stages)
        self.num_stages = n = len(self.stages)
        self.microbatch = microbatch
        self.chunk = chunk
        self.buffer_dtype = as_dtype(buffer_dtype)
        self.wire = wire

        self._in_sizes = [s.in_spec.size for s in self.stages]
        self._out_sizes = [s.out_spec.size for s in self.stages]
        self._footprint = buffer_footprint(
            self.stages, microbatch=microbatch,
            itemsize=self.buffer_dtype.itemsize, wire=wire)
        self.buf_elems = self._footprint["buf_elems"]
        self.in_spec: ShapeSpec = self.stages[0].in_spec
        self.out_spec: ShapeSpec = self.stages[-1].out_spec
        if (not self.in_spec.dtype.is_floating_point
                and self.buffer_dtype != torch.float32):
            raise ValueError(
                "integer model inputs (e.g. token ids) require "
                "buffer_dtype=float32: ids above 256 are not exactly "
                f"representable in {self.buffer_dtype}")

        #: stage k's module, holding its own parameters on the device
        self.modules = [StageModule(s, params, self.device)
                        for s in self.stages]

        self.metrics = PipelineMetrics(
            num_stages=n, microbatch=microbatch, buffer_elems=self.buf_elems,
            buffer_bytes_per_hop=self._footprint["bytes_per_hop"])
        self.metrics.bind()
        self._flush_zeros = None  # lazy device-resident bubble block
        self.reset()

    # ------------------------------------------------------------------
    # one pipeline step / one chunk
    # ------------------------------------------------------------------

    def _step(self, a: torch.Tensor) -> torch.Tensor:
        """Run every stage on its slot of ring ``a`` and rotate: the ring
        of the next step (``a`` is not modified)."""
        n, b, buf = a.shape
        y = torch.empty_like(a)
        for k, module in enumerate(self.modules):
            spec = self.stages[k].in_spec
            x = a[k, :, :self._in_sizes[k]].reshape((b,) + spec.shape)
            out_sz = self._out_sizes[k]
            y[k, :, :out_sz] = module(x.to(spec.dtype)).reshape(b, out_sz)
            if out_sz < buf:
                y[k, :, out_sz:] = 0
        if self.wire == "int8":
            return quantized_ring_hop(y, self.buffer_dtype)
        return torch.roll(y, 1, 0)

    @torch.inference_mode()
    def _run_chunk(self, xs: torch.Tensor) -> torch.Tensor:
        """Advance ``xs.shape[0]`` steps; returns ``[C, B, out_sz_last]``:
        what the last stage delivered to slot 0 at each step."""
        out_sz = self._out_sizes[-1]
        outs = torch.empty((xs.shape[0], self.microbatch, out_sz),
                           dtype=self.buffer_dtype, device=self.device)
        a = self._a
        for t in range(xs.shape[0]):
            a[0] = xs[t]  # inject at stage 0 (the dispatcher feeding node 0)
            a = self._step(a)
            outs[t] = a[0, :, :out_sz]
        self._a = a
        return outs

    # ------------------------------------------------------------------
    # streaming interface
    # ------------------------------------------------------------------

    def reset(self):
        """Empty the pipe (all stages hold bubbles)."""
        self._a = torch.zeros((self.num_stages, self.microbatch,
                               self.buf_elems), dtype=self.buffer_dtype,
                              device=self.device)
        self._step_count = 0
        self._fed = 0
        self._real: collections.deque[bool] = collections.deque()
        self._emitted = 0

    def _flatten_inputs(self, xs, staged: bool = False) -> torch.Tensor:
        if (isinstance(xs, torch.Tensor) and xs.device == self.device
                and xs.ndim == 3
                and tuple(xs.shape[1:]) == (self.microbatch, self.buf_elems)
                and xs.dtype == self.buffer_dtype):
            return xs  # already staged via stage_inputs()
        if not isinstance(xs, torch.Tensor):
            xs = torch.from_numpy(np.asarray(xs, np.float32))
        if staged:
            # host block already in transfer-buffer layout; opt-in only, so
            # a mis-shaped input never skips validation by coincidence
            if xs.ndim != 3 or tuple(xs.shape[1:]) != (self.microbatch,
                                                       self.buf_elems):
                raise ValueError(
                    f"staged block must be [C, {self.microbatch}, "
                    f"{self.buf_elems}], got {tuple(xs.shape)}")
            return xs.to(self.device, self.buffer_dtype)
        c = xs.shape[0]
        flat = xs.reshape(c, self.microbatch, -1)
        if flat.shape[-1] != self._in_sizes[0]:
            raise ValueError(
                f"input sample size {flat.shape[-1]} != stage-0 input "
                f"size {self._in_sizes[0]}")
        buf = torch.zeros((c, self.microbatch, self.buf_elems),
                          dtype=self.buffer_dtype, device=self.device)
        buf[..., :flat.shape[-1]] = flat.to(self.device, torch.float32)
        return buf

    def stage_inputs(self, xs) -> torch.Tensor:
        """Pre-stage a [C, microbatch, *in_shape] block on the device;
        ``push`` takes the result as it is."""
        return self._flatten_inputs(xs)

    def push(self, xs, n_real: int | None = None, *,
             staged: bool = False, raw: bool = False):
        """Advance the pipe by ``xs.shape[0]`` steps, feeding ``xs``.

        ``xs``: [C, microbatch, *in_shape] host array or tensor, or a device
        block from ``stage_inputs``.  ``n_real`` marks how many leading
        entries are real inputs (the rest are bubble padding).
        ``staged=True`` declares a block already in transfer-buffer layout
        ``[C, microbatch, buf_elems]``.  Returns the list of completed
        output microbatches (device tensors [microbatch, *out_shape]), in
        feed order.

        ``raw=True`` returns ``(slab, real_mask)`` instead: one device
        tensor ``[n_completed, microbatch, out_size]`` of every microbatch
        that completed this chunk (bubbles included; None when none did)
        plus a bool mask of which entries are real.
        """
        c = xs.shape[0]
        if n_real is None:
            n_real = c
        xs_dev = self._flatten_inputs(xs, staged=staged)
        t0 = time.perf_counter()
        outs = self._run_chunk(xs_dev)
        self.metrics.chunk_calls += 1
        self.metrics.steps += c
        self._real.extend([True] * n_real + [False] * (c - n_real))
        self._fed += c

        ready = self._collect(outs, c, raw=raw)
        dt = time.perf_counter() - t0
        self.metrics.wall_s += dt
        self.metrics.push_latency.record(dt)
        tr = tracer()
        if tr.enabled:
            tr.record("spmd.push", t0, dt, {"chunk": c, "n_real": n_real})
        return ready

    def _collect(self, outs: torch.Tensor, c: int, raw: bool = False):
        """Map step outputs back to microbatch indices and drop bubbles."""
        n = self.num_stages
        out_shape = (self.microbatch,) + self.out_spec.shape
        # steps j in this chunk completing a microbatch m = step+j-(n-1)
        # with 0 <= m < fed form one contiguous local range [j0, j1)
        j0 = max(0, (n - 1) - self._step_count)
        j1 = min(c, self._fed + (n - 1) - self._step_count)
        cnt = max(0, j1 - j0)
        if cnt and self._step_count + j0 - (n - 1) != self._emitted:
            raise RuntimeError("pipeline outputs out of feed order: "
                               f"{(self._step_count, j0, n, self._emitted)}")
        self._step_count += c

        if raw:
            mask = np.array([self._real.popleft() for _ in range(cnt)], bool)
            self._emitted += cnt
            self.metrics.inferences += int(mask.sum()) * self.microbatch
            return (outs[j0:j1] if cnt else None), mask

        emitted = []
        for j in range(j0, j1):
            is_real = self._real.popleft()
            self._emitted += 1
            if is_real:
                self.metrics.inferences += self.microbatch
                emitted.append(outs[j].reshape(out_shape))
        return emitted

    def _bubble_block(self) -> torch.Tensor:
        """Cached device-resident all-bubble [chunk, ...] input block."""
        if self._flush_zeros is None:
            self._flush_zeros = torch.zeros(
                (self.chunk, self.microbatch, self.buf_elems),
                dtype=self.buffer_dtype, device=self.device)
        return self._flush_zeros

    def warmup(self):
        """Run one full bubble chunk, leaving the pipe empty (the probe
        ``Defer.health_check`` uses)."""
        self.reset()
        self.push(self._bubble_block(), n_real=0)
        self.reset()

    def flush(self):
        """Drain the pipe: run bubble chunks until every fed microbatch has
        emerged (the fill/drain of the classic pipeline schedule)."""
        emitted = []
        target = self._fed  # overshoot bubbles beyond this are ignored
        block = self._bubble_block()
        while self._emitted < target:
            emitted.extend(self.push(block, n_real=0))
        return emitted

    # ------------------------------------------------------------------
    # batch convenience
    # ------------------------------------------------------------------

    def run(self, inputs) -> np.ndarray:
        """Feed [M, microbatch, *in_shape]; return [M, microbatch, *out]."""
        inputs = np.asarray(inputs)
        m = inputs.shape[0]
        if inputs.shape[1] != self.microbatch:
            raise ValueError(
                f"inputs microbatch dim {inputs.shape[1]} != {self.microbatch}")
        self.reset()
        outs = []
        for lo in range(0, m, self.chunk):
            hi = min(lo + self.chunk, m)
            block = inputs[lo:hi]
            n_real = hi - lo
            if n_real < self.chunk:
                pad = np.zeros((self.chunk - n_real,) + block.shape[1:],
                               block.dtype)
                block = np.concatenate([block, pad], 0)
            outs.extend(self.push(block, n_real=n_real))
        outs.extend(self.flush())
        if len(outs) != m:
            raise RuntimeError(f"pipeline emitted {len(outs)} of {m} inputs")
        return torch.stack(outs).float().cpu().numpy()

    def __call__(self, inputs) -> np.ndarray:
        return self.run(inputs)

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------

    @property
    def hop_utilization(self) -> list[float]:
        """Fraction of the homogeneous ``buf_elems`` hop buffer each
        stage->successor boundary actually carries (hop k = stage k's
        output; the last entry is the wrap link back to slot 0)."""
        return list(self._footprint["hop_utilization"])
