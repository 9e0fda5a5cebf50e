"""Observability for the port: histograms, a metrics registry, a tracer,
the flight recorder, request attribution, the cluster view and straggler
detector, capacity accounting, push reporting, the black-box journal and
postmortem, and the profiling plane.

The port's copy of ``defer_tpu.obs``, exporting the same names (the port
imports nothing of the JAX package).
"""

from .histogram import LatencyHistogram
from .registry import REGISTRY, Counter, Gauge, MetricsRegistry, get_registry
from .trace import (Tracer, enable_tracing, export_chrome_trace,
                    new_span_id, trace_context, tracer)
from .events import (EVENT_KINDS, FlightRecorder, merge_events,
                     recorder, validate_event)
from .events import emit as emit_event
from .attrib import (DoorAttribution, RequestAttribution,
                     attribute_request, attribute_sampled)
from .cluster import (ClusterView, StragglerDetector, StragglerFlag,
                      align_clock, estimate_clock_offset,
                      expected_stage_ms)
from .capacity import (CapacityModel, DriftAuditor, DriftFlag,
                       achieved_mfu, stage_flops_bytes)
from .report import ObsReporter, start_prom_server
from .journal import (JOURNAL_VERSION, JournalSpiller, JournalWriter,
                      active_journal, read_journal,
                      read_process_journals, start_journal, stop_journal)
from .postmortem import (BUNDLE_VERSION, collect as collect_postmortem,
                         maybe_autopsy)
from .profile import (ENGINE_PHASES, NODE_PHASES, MemoryWatcher,
                      ProfileSession, RecompileWatcher,
                      device_memory_bytes, memory_watcher,
                      recompile_watcher)

__all__ = [
    "LatencyHistogram",
    "MetricsRegistry", "REGISTRY", "get_registry", "Counter", "Gauge",
    "Tracer", "tracer", "enable_tracing", "export_chrome_trace",
    "trace_context", "new_span_id",
    "FlightRecorder", "recorder", "emit_event", "merge_events",
    "validate_event", "EVENT_KINDS",
    "RequestAttribution", "attribute_request", "attribute_sampled",
    "DoorAttribution",
    "ClusterView", "StragglerDetector", "StragglerFlag",
    "estimate_clock_offset", "align_clock", "expected_stage_ms",
    "CapacityModel", "DriftAuditor", "DriftFlag", "achieved_mfu",
    "stage_flops_bytes",
    "ObsReporter", "start_prom_server",
    "JOURNAL_VERSION", "JournalWriter", "JournalSpiller",
    "start_journal", "stop_journal", "active_journal",
    "read_journal", "read_process_journals",
    "BUNDLE_VERSION", "collect_postmortem", "maybe_autopsy",
    "NODE_PHASES", "ENGINE_PHASES", "ProfileSession",
    "RecompileWatcher", "recompile_watcher",
    "MemoryWatcher", "memory_watcher", "device_memory_bytes",
]
