"""Observability for the port: histograms, a metrics registry, a tracer.

The subset of ``defer_tpu.obs`` that ``PipelineMetrics`` and the pipeline
engines use, kept as the port's own copy (the port imports nothing of the
JAX package).
"""

from .histogram import LatencyHistogram
from .registry import REGISTRY, Counter, MetricsRegistry
from .trace import Tracer, enable_tracing, tracer

__all__ = ["LatencyHistogram", "REGISTRY", "Counter", "MetricsRegistry",
           "Tracer", "enable_tracing", "tracer"]
