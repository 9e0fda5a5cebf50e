"""Node-side push telemetry: the obs reporter thread and the Prometheus
scrape endpoint.

The port's copy of ``defer_tpu.obs.report``; the push frames are the JAX
package's, so a monitor of either package watches a node of either.

A stage node answers ``{"cmd": "obs_subscribe", "interval_ms": 250}`` on
any control connection by starting one :class:`ObsReporter` bound to that
connection: a daemon thread that periodically builds an ``obs_push``
control frame from the node's live state (``StageNode.obs_snapshot``)
and writes it back on the same socket — no new ports, the push plane
rides the existing K_CTRL channel.  The reporter is self-cleaning: the
first failed send (subscriber closed the connection, node tearing down)
ends the thread.

:func:`start_prom_server` is the pull-side alternative: a stdlib
``http.server`` endpoint serving ``MetricsRegistry.exposition()`` for a
Prometheus scraper (``--prom-port`` on the ``node``/``chain`` CLIs).
"""

from __future__ import annotations

import threading

from .events import recorder
from .registry import REGISTRY
from .trace import tracer


class WatermarkSplit:
    """Per-subscriber fan-out of reset-on-read channel watermarks.

    A channel's ``take_watermark()`` is destructive — the peak since the
    LAST read, whoever read it.  With two concurrent subscribers (the
    serve front door's shedding loop and a human ``monitor``) each would
    see only the peaks since ANY subscriber's last push, splitting a
    burst across their reports.  This splitter is the node-side fix
    every underlying take is folded into
    EVERY registered subscriber's running maximum, and a subscriber's
    own take drains only ITS accumulator — each subscriber sees the true
    peak since its own last read.

    Unregistered callers (direct ``obs_snapshot`` calls, tests) still
    get the raw fold — their reads never subtract from a subscriber's
    view.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[int, dict[str, int]] = {}

    def register(self, sid: int) -> None:
        with self._lock:
            self._subs.setdefault(sid, {})

    def unregister(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    def take(self, sid: int | None, key: str, chan) -> int:
        """Fold ``chan``'s watermark into every subscriber's view and
        return subscriber ``sid``'s accumulated peak (raw fold for
        ``sid=None`` / unknown)."""
        if chan is None:
            return 0
        with self._lock:
            hi = int(chan.take_watermark())
            for acc in self._subs.values():
                if hi > acc.get(key, 0):
                    acc[key] = hi
            acc = self._subs.get(sid) if sid is not None else None
            if acc is None:
                return hi
            return acc.pop(key, 0)


class ObsReporter(threading.Thread):
    """Per-subscription push thread (one per ``obs_subscribe``).

    ``source`` supplies the payload: an object with
    ``obs_snapshot(cursor, include_spans, span_limit) -> (dict, cursor)``
    (``StageNode`` implements it).  The span cursor starts at the
    subscription instant, so pushes carry only spans recorded since —
    and never drain the buffer ``trace_dump`` collects at stream end.
    """

    def __init__(self, source, conn, *, interval_s: float = 0.25,
                 spans: bool = True, span_limit: int = 256):
        super().__init__(daemon=True, name="obs-reporter")
        self._source = source
        self._conn = conn
        self.interval_s = max(0.02, float(interval_s))
        self._spans = spans
        self._span_limit = span_limit
        # NOT named _stop: threading.Thread's own machinery calls
        # self._stop() as a METHOD when a dead thread's is_alive() is
        # checked — shadowing it with an Event breaks that call
        self._halt = threading.Event()
        self._cursor = tracer().span_cursor()
        #: flight-recorder cursor: pushes carry only events emitted
        #: since the subscription instant (obs/events.py)
        self._ev_cursor = recorder().cursor()
        #: per-subscriber identity for the source's watermark splitter
        #: (each subscription sees peaks since ITS own last push)
        self.sid = id(self)

    def _snapshot(self):
        """One source snapshot, tolerant of the source's vintage: the
        current contract returns ``(payload, span_cursor,
        event_cursor)``; older sources (tests, external stubs) may
        return two values or reject the newer keywords."""
        try:
            out = self._source.obs_snapshot(
                cursor=self._cursor, include_spans=self._spans,
                span_limit=self._span_limit, subscriber=self.sid,
                event_cursor=self._ev_cursor)
        except TypeError:
            try:
                out = self._source.obs_snapshot(
                    cursor=self._cursor, include_spans=self._spans,
                    span_limit=self._span_limit, subscriber=self.sid)
            except TypeError:
                # source predates per-subscriber watermark splitting
                out = self._source.obs_snapshot(
                    cursor=self._cursor, include_spans=self._spans,
                    span_limit=self._span_limit)
        if len(out) == 3:
            payload, self._cursor, self._ev_cursor = out
        else:
            payload, self._cursor = out
        return payload

    def run(self) -> None:
        from ..transport.framed import send_ctrl
        register = getattr(self._source, "obs_register", None)
        if register is not None:
            register(self.sid)
        seq = 0
        try:
            while not self._halt.is_set():
                payload = self._snapshot()
                try:
                    payload["cmd"] = "obs_push"
                    payload["push_seq"] = seq
                    payload["interval_ms"] = round(
                        self.interval_s * 1e3, 3)
                    payload["t_us"] = tracer().now_us()
                    send_ctrl(self._conn, payload)
                except (OSError, ValueError):
                    return  # subscriber gone / socket closed: self-clean
                seq += 1
                self._halt.wait(self.interval_s)
        finally:
            unregister = getattr(self._source, "obs_unregister", None)
            if unregister is not None:
                unregister(self.sid)

    def stop(self) -> None:
        self._halt.set()


def start_prom_server(port: int, *, host: str = "127.0.0.1",
                      registry=None):
    """Serve ``registry.exposition()`` at ``http://host:port/metrics``
    (any path answers, as scrapers sometimes probe ``/``) on a daemon
    thread.  Returns the ``ThreadingHTTPServer``; its actual bound port
    is ``server.server_address[1]`` (pass ``port=0`` for an ephemeral
    one).  Stdlib only — no prometheus_client dependency."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            body = reg.exposition().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # noqa: ARG002 — silence stderr
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="prom-http").start()
    return srv
