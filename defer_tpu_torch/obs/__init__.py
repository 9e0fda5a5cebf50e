"""Observability for the port: histograms, a metrics registry, a tracer,
and the flight recorder (``obs.events``).

The subset of ``defer_tpu.obs`` that ``PipelineMetrics``, the pipeline
engines, the dispatcher and the stage-node chain use, kept as the port's
own copy (the port imports nothing of the JAX package).
"""

from .histogram import LatencyHistogram
from .registry import REGISTRY, Counter, Gauge, MetricsRegistry
from .trace import (Tracer, enable_tracing, export_chrome_trace,
                    new_span_id, trace_context, tracer)

__all__ = ["LatencyHistogram", "REGISTRY", "Counter", "Gauge",
           "MetricsRegistry", "Tracer", "enable_tracing", "tracer",
           "new_span_id", "trace_context", "export_chrome_trace"]
