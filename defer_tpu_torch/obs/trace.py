"""Span tracer, exportable as Chrome trace JSON.

The port's copy of the part of ``defer_tpu.obs.trace`` that the pipeline
engines use: one process :class:`Tracer` (:func:`tracer`), disabled by
default, on which an engine records an already-timed interval.  The cost
contract instrumentation sites rely on:

* disabled: ``tracer().enabled`` is one attribute read + branch;
* enabled: recording a span is one dict construction + one deque append
  (O(1), no I/O, no locks on the hot path).

Timestamps are monotonic (``perf_counter``) anchored once to the wall
clock.  Export is the Chrome trace-event format (open the file at
https://ui.perfetto.dev).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .registry import REGISTRY

#: incremented whenever a span is evicted from a full buffer
_DROPPED = REGISTRY.counter("trace.dropped_spans")


class Tracer:
    #: default span-buffer cap: past it the OLDEST span is evicted per
    #: append and ``trace.dropped_spans`` counts the loss
    DEFAULT_MAX_SPANS = 200_000

    def __init__(self, process: str | None = None, enabled: bool = False,
                 max_spans: int | None = None):
        #: the one predicate hot paths check
        self.enabled = enabled
        self.process = process or f"pid{os.getpid()}"
        self.max_spans = (self.DEFAULT_MAX_SPANS if max_spans is None
                          else int(max_spans))
        self._spans: collections.deque[dict] = collections.deque()
        self._wall0_us = time.time_ns() // 1_000
        self._mono0 = time.perf_counter()

    def record(self, name: str, t0: float, dur_s: float,
               args: dict | None = None) -> None:
        """Record an already-timed interval (``t0`` from ``perf_counter``)
        as a span.  The caller checks ``enabled`` first."""
        self._spans.append({
            "name": name,
            "ts_us": self._wall0_us + int((t0 - self._mono0) * 1e6),
            "dur_us": max(int(dur_s * 1e6), 1),
            "tid": threading.get_ident() & 0xFFFF,
            "args": args or {},
        })
        while len(self._spans) > self.max_spans:
            self._spans.popleft()
            _DROPPED.n += 1

    def now_us(self) -> int:
        """This process's current position on the span timeline (the
        anchor ``record`` stamps ``ts_us`` with); events are stamped with
        it, so they interleave with the spans."""
        return self._wall0_us + int(
            (time.perf_counter() - self._mono0) * 1e6)

    @property
    def spans(self) -> list[dict]:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def export_chrome(self, path: str) -> None:
        """Write the spans as Chrome trace-event JSON (complete events)."""
        events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                   "args": {"name": self.process}}]
        events += [{"name": s["name"], "ph": "X", "cat": "defer",
                    "ts": s["ts_us"], "dur": s["dur_us"], "pid": 1,
                    "tid": s["tid"], "args": s["args"]}
                   for s in list(self._spans)]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
            f.write("\n")


#: process singleton
_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enable_tracing(process: str | None = None) -> Tracer:
    """Turn the process tracer on (idempotent); returns it."""
    if process:
        _TRACER.process = process
    _TRACER.enabled = True
    return _TRACER
