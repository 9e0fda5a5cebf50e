"""Observability for the port: histograms, a metrics registry, a tracer,
and the flight recorder (``obs.events``).

The subset of ``defer_tpu.obs`` that ``PipelineMetrics``, the pipeline
engines and the dispatcher use, kept as the port's own copy (the port
imports nothing of the JAX package).
"""

from .histogram import LatencyHistogram
from .registry import REGISTRY, Counter, Gauge, MetricsRegistry
from .trace import Tracer, enable_tracing, tracer

__all__ = ["LatencyHistogram", "REGISTRY", "Counter", "Gauge",
           "MetricsRegistry", "Tracer", "enable_tracing", "tracer"]
