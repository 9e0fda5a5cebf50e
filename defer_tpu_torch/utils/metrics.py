"""Pipeline metrics: inferences/sec and per-stage latency.

The port's copy of ``defer_tpu.utils.metrics.PipelineMetrics``: the same
fields, the same derived views, and the same :meth:`bind` into the
process-wide registry.  The streaming counters stay plain ints — the hot
path pays attribute increments, never a registry lookup.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref

from ..obs import REGISTRY, LatencyHistogram

#: unique registry prefixes for successive deployments in one process
_PIPE_SEQ = itertools.count()


@dataclasses.dataclass
class PipelineMetrics:
    num_stages: int = 0
    inferences: int = 0
    microbatch: int = 1
    steps: int = 0  # pipeline steps executed (each = one step on every stage)
    wall_s: float = 0.0
    chunk_calls: int = 0
    stage_latency_s: list[float] = dataclasses.field(default_factory=list)
    buffer_elems: int = 0
    buffer_bytes_per_hop: int = 0
    #: per-chunk ``push`` wall time (host dispatch + collect), log-bucketed
    push_latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    #: per-stage latency distributions (filled by ``record_stage_latency``
    #: / ``SpmdPipeline.stage_latencies``)
    stage_hists: list[LatencyHistogram] = dataclasses.field(
        default_factory=list)
    #: CUDA graphs captured (one per chunk length the engine was pushed);
    #: ``reweight`` and ``reset`` never capture again
    captures: int = 0
    #: device memory the captured graphs hold in their private pools
    #: (``torch.cuda.memory_reserved`` across each capture)
    graph_pool_bytes: int = 0
    #: registry prefix once bound (``bind``), e.g. "pipeline3"
    prefix: str | None = None

    def clear_counters(self):
        """Zero the streaming counters (keep stage latencies / geometry) —
        e.g. after a harness's warmup pushes, before a measured window."""
        self.inferences = 0
        self.steps = 0
        self.wall_s = 0.0
        self.chunk_calls = 0
        self.push_latency.clear()

    def bind(self, registry=None, prefix: str | None = None) -> str:
        """Publish this deployment's metrics into ``registry`` (default:
        the process-wide one) under ``prefix`` (default: a fresh
        ``pipeline<N>``).  Counters are exported via weak snapshot-time
        callbacks; the push histogram is registered weakly.  Returns the
        prefix.  Idempotent per instance."""
        if self.prefix is not None:
            return self.prefix
        registry = registry or REGISTRY
        self._registry = registry
        self.prefix = prefix or f"pipeline{next(_PIPE_SEQ)}"
        p = self.prefix
        ref = weakref.ref(self)
        for field in ("num_stages", "microbatch", "inferences", "steps",
                      "wall_s", "chunk_calls", "buffer_bytes_per_hop",
                      "captures"):
            registry.register_callback(
                f"{p}.{field}",
                lambda r=ref, f=field:
                    getattr(r(), f) if r() is not None else None)
        registry.register_callback(
            f"{p}.throughput_per_s",
            lambda r=ref:
                round(r().throughput, 3) if r() is not None else None)
        # per-hop bytes: every hop of the homogeneous ring carries
        # bytes_per_hop per step, derived at snapshot time
        if self.buffer_bytes_per_hop and self.num_stages:
            for k in range(self.num_stages):
                registry.register_callback(
                    f"{p}.hop{k}.bytes",
                    lambda r=ref: r().steps * r().buffer_bytes_per_hop
                    if r() is not None else None)
        registry.register(f"{p}.push_latency_s", self.push_latency,
                          weak=True)
        return p

    def record_stage_latency(self, stage: int, seconds: float) -> None:
        """Feed one per-stage latency sample (grows the histogram list on
        demand and keeps the ``stage_latency_s`` means in sync)."""
        while len(self.stage_hists) <= stage:
            self.stage_hists.append(LatencyHistogram())
            if self.prefix is not None:
                getattr(self, "_registry", REGISTRY).register(
                    f"{self.prefix}.stage{len(self.stage_hists) - 1}"
                    f".latency_s", self.stage_hists[-1], weak=True)
        h = self.stage_hists[stage]
        h.record(seconds)
        while len(self.stage_latency_s) <= stage:
            self.stage_latency_s.append(0.0)
        self.stage_latency_s[stage] = h.mean

    @property
    def throughput(self) -> float:
        return self.inferences / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bubble_fraction(self) -> float:
        """Fraction of pipeline steps spent on fill/drain bubbles."""
        if self.steps == 0:
            return 0.0
        useful_steps = self.inferences / max(self.microbatch, 1)
        return max(0.0, 1.0 - useful_steps / self.steps)

    @property
    def duty_cycle(self) -> list[float]:
        """Per-stage busy fraction at steady state (stage latency /
        slowest stage)."""
        if not self.stage_latency_s:
            return []
        slowest = max(self.stage_latency_s)
        if slowest <= 0:
            return [0.0] * len(self.stage_latency_s)
        return [l / slowest for l in self.stage_latency_s]

    @property
    def pipeline_efficiency(self) -> float:
        """Mean duty cycle — 1.0 means perfectly balanced stages."""
        d = self.duty_cycle
        return sum(d) / len(d) if d else 0.0

    def as_dict(self) -> dict:
        d = {
            "num_stages": self.num_stages,
            "microbatch": self.microbatch,
            "inferences": self.inferences,
            "steps": self.steps,
            "wall_s": round(self.wall_s, 6),
            "throughput_per_s": round(self.throughput, 3),
            "chunk_calls": self.chunk_calls,
            "stage_latency_ms": [round(s * 1e3, 4)
                                 for s in self.stage_latency_s],
            "buffer_bytes_per_hop": self.buffer_bytes_per_hop,
            "bubble_fraction": round(self.bubble_fraction, 4),
            "duty_cycle": [round(d, 4) for d in self.duty_cycle],
            "pipeline_efficiency": round(self.pipeline_efficiency, 4),
        }
        if self.push_latency.count:
            d["push_latency_ms"] = self.push_latency.summary(scale=1e3,
                                                             ndigits=4)
        if any(h.count for h in self.stage_hists):
            d["stage_latency_percentiles_ms"] = [
                h.summary(scale=1e3, ndigits=4) for h in self.stage_hists]
        return d


class StopwatchWindow:
    """Timed-window throughput counter reproducing the reference harness
    semantics (results drained in a window / window seconds,
    test/test.py:25-37)."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.count = 0
        self._t0 = time.perf_counter()

    def tick(self, n: int = 1) -> bool:
        """Record n results; returns False once the window has elapsed."""
        self.count += n
        return (time.perf_counter() - self._t0) < self.window_s

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.count / e if e > 0 else 0.0
