"""Dispatcher: the user-facing API — the port of ``defer_tpu.runtime.dispatcher``.

``Defer(config).run(graph, params, inputs, cut_points=...)`` partitions
the graph, builds the pipeline engine on the configured device and streams
the inputs through it.  This slice ports ``build``, ``run``, ``stream``
and ``health_check``; the queue service (``run_defer``), the network
endpoint and the decoder APIs are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np

from ..graph.ir import LayerGraph
from ..partition.partitioner import partition
from ..utils.config import DeferConfig, resolve_device
from .mpmd import MpmdPipeline
from .spmd import SpmdPipeline


class Defer:
    """One DEFER deployment on one device.

    The device is ``config.device``; ``None`` means the CUDA card, and the
    constructor raises when CUDA is absent (pass ``device="cpu"`` in the
    config to run on the CPU).
    """

    def __init__(self, config: DeferConfig | None = None):
        self.config = config or DeferConfig()
        self.device = resolve_device(self.config.device)

    def build(self, graph: LayerGraph, params: dict[str, Any],
              cut_points: list[str] | None = None,
              num_stages: int | None = None):
        """Partition + build; returns the pipeline engine."""
        cfg = self.config
        stages = partition(graph, cut_points, num_stages=num_stages)
        if cfg.mode == "mpmd":
            return MpmdPipeline(stages, params, device=self.device,
                                microbatch=cfg.microbatch,
                                compute_dtype=cfg.compute_dtype)
        if cfg.mode != "spmd":
            raise ValueError(f"mode must be 'spmd' or 'mpmd', got "
                             f"{cfg.mode!r}")
        return SpmdPipeline(
            stages, params, device=self.device,
            microbatch=cfg.microbatch, chunk=cfg.chunk,
            buffer_dtype=cfg.buffer_dtype,
            compute_dtype=cfg.compute_dtype,
            wire=cfg.wire,
            data_parallel=cfg.data_parallel,
            tensor_parallel=cfg.tensor_parallel,
            master_weights=cfg.master_weights,
        )

    def health_check(self, graph, params, cut_points=None, num_stages=None):
        """Build-and-run probe of a deployment before serving traffic:
        builds the pipeline and pushes one all-bubble chunk through it.
        Raises nothing: failures come back in the report."""
        report: dict[str, Any] = {"ok": False, "stages": None,
                                  "device": str(self.device), "error": None}
        try:
            pipe = self.build(graph, params, cut_points, num_stages)
            report["stages"] = len(pipe.stages)
            pipe.warmup()
            report["ok"] = True
        except Exception as e:  # noqa: BLE001 — report, don't raise
            report["error"] = e
        return report

    def run(self, graph, params, inputs, cut_points=None, num_stages=None):
        """One-shot batched inference over the pipeline:
        [M, microbatch, *in_shape] -> [M, microbatch, *out_shape] numpy."""
        pipe = self.build(graph, params, cut_points, num_stages)
        return pipe.run(inputs)

    def stream(self, graph, params, inputs: Iterable[np.ndarray],
               cut_points=None, num_stages=None) -> Iterator:
        """Generator streaming: yields one output (a device tensor
        [microbatch, *out_shape]) per input microbatch, in order."""
        pipe = self.build(graph, params, cut_points, num_stages)
        if isinstance(pipe, MpmdPipeline):
            for x in inputs:
                yield from pipe.push(np.asarray(x)[None])
            yield from pipe.flush()
            return
        pipe.reset()
        batch: list[np.ndarray] = []
        for x in inputs:
            batch.append(np.asarray(x))
            if len(batch) == pipe.chunk:
                yield from pipe.push(np.stack(batch))
                batch.clear()
        if batch:
            pad = [np.zeros_like(batch[0])] * (pipe.chunk - len(batch))
            yield from pipe.push(np.stack(batch + pad), n_real=len(batch))
        yield from pipe.flush()
