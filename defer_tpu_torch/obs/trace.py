"""Span tracer: trace_id/span_id spans exportable as Chrome trace JSON.

The port's copy of ``defer_tpu.obs.trace``.  One :class:`Tracer` per
process (module singleton via :func:`tracer`), disabled by default.  The cost contract instrumentation
sites rely on:

* disabled: ``tracer().enabled`` is one attribute read + branch;
  ``span()`` on a disabled tracer returns a shared no-op context manager.
* enabled: finishing a span is one dict construction + one deque append
  under the GIL (O(1), no I/O, no locks on the hot path).

Spans carry ``trace_id``/``span_id``/``parent_id`` links.  Timestamps are
monotonic (``perf_counter``) anchored once to the wall clock, so spans
from different processes on one machine line up on a shared axis when
stitched: a stage-node chain ships each node's spans back to the
dispatcher in a ``trace_dump`` control frame (``runtime/node.py``) and
they merge here through :meth:`Tracer.ingest`.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``):
open the file at https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid

from .registry import REGISTRY

#: incremented whenever a span is evicted from a full buffer — the
#: visible price of the cap
_DROPPED = REGISTRY.counter("trace.dropped_spans")

#: callbacks invoked with ``delta_us`` whenever the process tracer's wall
#: anchor shifts (clock alignment): other timeline-stamped buffers (the
#: flight recorder's event ring, a journal's anchor) register here so
#: their buffered entries stay coherent with the shifted spans
_ANCHOR_HOOKS: list = []


def register_anchor_hook(fn) -> None:
    """Register ``fn(delta_us)`` to run on every wall-anchor shift of the
    process tracer."""
    _ANCHOR_HOOKS.append(fn)

def _new_id() -> str:
    return uuid.uuid4().hex[:16]


#: public alias: pre-allocate a span id (see ``Tracer.record(span_id=...)``)
new_span_id = _new_id


class _Span:
    """Context manager for one span; created only when tracing is on."""

    __slots__ = ("_tracer", "name", "trace_id", "parent_id", "span_id",
                 "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = _new_id()
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        stack = self._tracer._stack()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        args = self.args
        if exc_type is not None:
            args = dict(args or ())
            args["error"] = exc_type.__name__
        self._tracer._finish(self.name, self.trace_id, self.span_id,
                             self.parent_id, self._t0, t1 - self._t0, args)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path (no allocation)."""

    __slots__ = ()
    span_id = None
    trace_id = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class Tracer:
    #: default span-buffer cap (spans, not bytes).  A long traced stream
    #: must not grow memory without bound: past the cap the OLDEST span
    #: is evicted per append and ``trace.dropped_spans`` counts the loss.
    DEFAULT_MAX_SPANS = 200_000

    def __init__(self, process: str | None = None, enabled: bool = False,
                 max_spans: int | None = None):
        #: the one predicate hot paths check
        self.enabled = enabled
        self.process = process or f"pid{os.getpid()}"
        self._spans: collections.deque[dict] = collections.deque()
        self.max_spans = (self.DEFAULT_MAX_SPANS if max_spans is None
                          else int(max_spans))
        #: spans evicted because the buffer was full (lifetime)
        self.dropped = 0
        #: spans ever removed from the FRONT of the buffer (drained,
        #: cleared, or evicted) — the anchor of the ``spans_since``
        #: cursor contract, so live subscribers can fetch incremental
        #: batches without draining what ``trace_dump`` will collect
        self._base = 0
        self._tls = threading.local()
        self._trace_id: str | None = None
        #: adopted remote parent (cross-process propagation target)
        self._remote_parent: str | None = None
        # wall-clock anchor: ts_us = wall0 + (mono - mono0), so per-process
        # monotonic clocks land on one shared (approximate) absolute axis
        self._wall0_us = time.time_ns() // 1_000
        self._mono0 = time.perf_counter()

    # -- trace identity ----------------------------------------------------

    @property
    def trace_id(self) -> str:
        """Current trace id, starting a trace on first use."""
        if self._trace_id is None:
            self._trace_id = _new_id()
        return self._trace_id

    def start_trace(self, trace_id: str | None = None) -> str:
        """Begin a new trace (fresh id unless given one to join)."""
        self._trace_id = trace_id or _new_id()
        self._remote_parent = None
        return self._trace_id

    def adopt(self, ctx: dict | None) -> None:
        """Join a remote trace: ``ctx`` is an :meth:`inject` dict carried
        over the wire (e.g. in a K_CTRL frame).  Subsequent root spans in
        this process parent under the remote span."""
        if not ctx or "trace_id" not in ctx:
            return
        self._trace_id = ctx["trace_id"]
        self._remote_parent = ctx.get("span_id")
        self.enabled = True

    def inject(self) -> dict:
        """Wire-format trace context: the current span (or remote parent)
        of this thread, under the current trace id."""
        stack = self._stack()
        parent = stack[-1].span_id if stack else self._remote_parent
        ctx = {"trace_id": self.trace_id}
        if parent:
            ctx["span_id"] = parent
        return ctx

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def span(self, name: str, args: dict | None = None):
        """Context manager for a timed span; no-op when disabled."""
        if not self.enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1].span_id if stack else self._remote_parent
        return _Span(self, name, self.trace_id, parent, args)

    def record(self, name: str, t0: float, dur_s: float,
               args: dict | None = None,
               parent_id: str | None = None,
               span_id: str | None = None) -> None:
        """Record an already-timed interval as a span (O(1) append).

        ``t0`` is a ``perf_counter`` timestamp.  The caller checks
        ``enabled`` first — that predicate is the whole disabled cost.
        ``span_id`` lets a caller pre-allocate the id (``new_span_id``) so
        children — possibly in other processes — can parent under a span
        recorded only when the enclosing work finishes."""
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1].span_id if stack else self._remote_parent
        self._finish(name, self.trace_id, span_id or _new_id(), parent_id,
                     t0, dur_s, args)

    def _finish(self, name, trace_id, span_id, parent_id, t0, dur_s, args):
        self._spans.append({
            "name": name,
            "trace": trace_id,
            "span": span_id,
            "parent": parent_id,
            "ts_us": self._wall0_us + int((t0 - self._mono0) * 1e6),
            "dur_us": max(int(dur_s * 1e6), 1),
            "proc": self.process,
            "tid": threading.get_ident() & 0xFFFF,
            "args": args or {},
        })
        if len(self._spans) > self.max_spans:
            self._evict(len(self._spans) - self.max_spans)

    def _evict(self, n: int) -> None:
        """Drop the ``n`` oldest spans (buffer cap): recent spans are the
        ones a live monitor and an end-of-stream dump still want.  A
        concurrent ``drain`` may empty the buffer between the length
        check and the pop — losing the eviction race just means the
        drain already made room."""
        popped = 0
        for _ in range(n):
            try:
                self._spans.popleft()
            except IndexError:
                break
            popped += 1
        self.dropped += popped
        self._base += popped
        _DROPPED.n += popped

    def now_us(self) -> int:
        """This process's current position on the span timeline (the same
        anchor ``_finish`` stamps ``ts_us`` with) — what a clock-offset
        probe compares across processes."""
        return self._wall0_us + int(
            (time.perf_counter() - self._mono0) * 1e6)

    def shift_wall_anchor(self, delta_us: int) -> None:
        """Shift the wall anchor by ``delta_us``: clock alignment after a
        ping-pong offset estimate (``obs.cluster.estimate_clock_offset``).
        Buffered spans shift too, so the whole dump stays on one axis
        whenever the correction lands.  Iterates a snapshot
        (``list(deque)`` is atomic under the GIL): a span appended while
        the anchor shifts may stay unshifted, a one-span error, where
        iterating the live deque could raise in the connection worker
        applying a ``clock_adjust``."""
        delta_us = int(delta_us)
        self._wall0_us += delta_us
        for s in list(self._spans):
            s["ts_us"] += delta_us
        if self is _TRACER:
            # coupled buffers (the flight recorder) follow the PROCESS
            # tracer only: a test-local Tracer must not move the ring
            for fn in _ANCHOR_HOOKS:
                fn(delta_us)

    # -- cross-process stitching -------------------------------------------

    def drain(self) -> list[dict]:
        """Pop all recorded spans (the ship-over-the-wire form).

        Element-wise popleft, not snapshot+clear: a span appended by a
        concurrent hot-path thread mid-drain is either drained or left
        for the next drain — never silently lost between the copy and
        the clear."""
        spans: list[dict] = []
        while True:
            try:
                spans.append(self._spans.popleft())
            except IndexError:
                break
        self._base += len(spans)
        return spans

    def ingest(self, spans: list[dict]) -> None:
        """Merge spans drained from another process's tracer."""
        self._spans.extend(spans)
        if len(self._spans) > self.max_spans:
            self._evict(len(self._spans) - self.max_spans)

    def span_cursor(self) -> int:
        """Monotone count of spans ever finished in this tracer — pass it
        back to :meth:`spans_since` for an incremental batch."""
        return self._base + len(self._spans)

    def spans_since(self, cursor: int, limit: int | None = None
                    ) -> tuple[int, list[dict]]:
        """(new_cursor, spans finished after ``cursor``) WITHOUT draining:
        a live subscriber (obs_push span batches) reads incrementally
        while ``trace_dump`` still collects everything at stream end.
        ``limit`` keeps only the newest N of the batch (push size bound);
        spans evicted or drained before the read are simply gone.

        Reads a snapshot first — ``list(deque)`` is GIL-atomic, whereas
        islice over the live deque would raise if a hot-path thread
        appended mid-iteration (the reporter thread calls this while
        the stream is recording)."""
        base = self._base
        snapshot = list(self._spans)
        start = max(0, cursor - base)
        out = snapshot[start:]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return base + len(snapshot), out

    @property
    def spans(self) -> list[dict]:
        return list(self._spans)

    def clear(self) -> None:
        self.drain()

    # -- export ------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Spans as Chrome trace-event dicts (complete events, ph="X")."""
        pids: dict[str, int] = {}
        events: list[dict] = []
        for s in list(self._spans):  # snapshot: appends may race export
            proc = s.get("proc", "?")
            pid = pids.get(proc)
            if pid is None:
                pid = pids[proc] = len(pids) + 1
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": proc}})
            args = dict(s.get("args") or ())
            args["trace_id"] = s.get("trace")
            args["span_id"] = s.get("span")
            if s.get("parent"):
                args["parent_span_id"] = s["parent"]
            events.append({
                "name": s["name"], "ph": "X", "cat": "defer",
                "ts": s["ts_us"], "dur": s["dur_us"],
                "pid": pid, "tid": s.get("tid", 0), "args": args,
            })
        return events

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)
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


def trace_context() -> dict | None:
    """Wire context of the current trace, or None when tracing is off —
    the one-liner callers put into a K_CTRL frame."""
    return _TRACER.inject() if _TRACER.enabled else None


def export_chrome_trace(path: str) -> None:
    """Write the process tracer's spans as Chrome trace JSON."""
    _TRACER.export_chrome(path)
