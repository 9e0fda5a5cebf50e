"""Process-wide metrics registry: named counters, gauges and histograms.

The port's copy of ``defer_tpu.obs.registry``.  One registry per process
(module-level :data:`REGISTRY`); instruments are created once by name and
then held by the instrumented code as plain attributes, so the hot path
never goes through the registry dict.  Snapshots are pull-based:
``snapshot()`` returns a JSON-ready dict, ``exposition()`` a
Prometheus-style text page (counters and gauges as they are, histograms as
summaries with p50/p95/p99 quantile lines; the text is the JAX package's,
byte for byte, for the same instruments).

Callbacks let existing stat objects (``PipelineMetrics``'s plain-int
counters) appear in snapshots without paying any registry cost when they
update: the registry calls them at snapshot time only.
"""

from __future__ import annotations

import json
import re
import threading
import weakref
from typing import Callable

from .histogram import LatencyHistogram


class Counter:
    """Monotonic counter.  ``n`` is a plain int — increment it directly
    on hot paths (``c.n += k``); ``inc`` is the readable spelling."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def inc(self, k: int = 1) -> None:
        self.n += k

    @property
    def value(self) -> int:
        return self.n

    def __repr__(self):
        return f"Counter({self.n})"


class Gauge:
    """Last-written value, with additive updates and a high watermark.

    ``set`` is the single-writer spelling; ``inc``/``dec`` the
    multi-writer one (several writers bound to one name compose instead
    of overwriting each other).  A race under the GIL costs one update,
    never a corrupt value.  ``hi`` is the largest value since the last
    :meth:`take_watermark`.
    """

    __slots__ = ("v", "hi")

    def __init__(self):
        self.v = 0.0
        self.hi = 0.0

    def set(self, v: float) -> None:
        self.v = v
        if v > self.hi:
            self.hi = v

    def inc(self, k: float = 1.0) -> None:
        v = self.v + k
        self.v = v
        if v > self.hi:
            self.hi = v

    def dec(self, k: float = 1.0) -> None:
        self.v -= k

    def take_watermark(self) -> float:
        """Max value since the previous call; resets to the current value
        (so each reporting interval sees its own peak)."""
        h = self.hi if self.hi > self.v else self.v
        self.hi = self.v
        return h

    @property
    def value(self) -> float:
        return self.v

    def __repr__(self):
        return f"Gauge({self.v})"


def _prom_name(name: str) -> str:
    """Dotted metric name -> Prometheus-legal name (``[a-zA-Z_:]`` first
    char, ``[a-zA-Z0-9_:]`` after)."""
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not n or n[0].isdigit():
        n = "_" + n
    return n


def _prom_escape(text: str) -> str:
    """Escape a HELP line per the Prometheus text format: backslash and
    newline (HELP text is not quoted, so quotes pass through)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _prom_label_value(text: str) -> str:
    """Escape a label VALUE per the text format: backslash, double quote,
    newline."""
    return (text.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


class MetricsRegistry:
    """Named instruments with get-or-create semantics.

    Creation is locked (threads race to register the same name and must
    get the same object); reads/increments touch the instrument directly.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._callbacks: dict[str, Callable[[], object]] = {}

    def _get_or_create(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> LatencyHistogram:
        return self._get_or_create(name, LatencyHistogram)

    def register(self, name: str, instrument, weak: bool = False) -> None:
        """Attach an externally-owned instrument under ``name``.
        ``weak=True`` holds it by weakref: once its owner is collected the
        entry is pruned at the next snapshot, so transient deployments do
        not grow the registry forever."""
        with self._lock:
            self._metrics[name] = weakref.ref(instrument) if weak \
                else instrument

    def register_callback(self, name: str,
                          fn: Callable[[], object]) -> None:
        """``fn()`` is evaluated at snapshot time; zero steady-state cost."""
        with self._lock:
            self._callbacks[name] = fn

    def unregister(self, prefix: str) -> None:
        """Drop every instrument and callback whose name starts with
        ``prefix``."""
        with self._lock:
            for d in (self._metrics, self._callbacks):
                for k in [k for k in d if k.startswith(prefix)]:
                    del d[k]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._callbacks.clear()

    def _live_metrics(self) -> dict:
        """The instrument dict with weakrefs resolved; dead weak entries
        are pruned in place (their owner was collected)."""
        with self._lock:
            out = {}
            for name, m in list(self._metrics.items()):
                if isinstance(m, weakref.ref):
                    m = m()
                    if m is None:
                        del self._metrics[name]
                        continue
                out[name] = m
            return out

    def snapshot(self) -> dict:
        """JSON-ready view: counters and gauges as numbers, histograms as
        summaries.

        A callback returning ``None`` marks itself expired (its source was
        collected) and is pruned, as are dead weak-registered instruments.
        """
        metrics = self._live_metrics()
        with self._lock:
            callbacks = dict(self._callbacks)
        out: dict = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, LatencyHistogram):
                out[name] = m.summary()
            else:
                out[name] = getattr(m, "value", repr(m))
        expired = []
        for name, fn in sorted(callbacks.items()):
            v = fn()
            if v is None:
                expired.append(name)
            else:
                out[name] = v
        if expired:
            with self._lock:
                for name in expired:
                    self._callbacks.pop(name, None)
        return out

    def exposition(self) -> str:
        """Prometheus text format (histograms as summaries).  Every family
        gets a ``# HELP`` line carrying the original dotted name, escaped;
        names are sanitized to the legal charset (never digit-first), and
        label values are escaped.  The family prefix stays the JAX
        package's (``defer_tpu metric``), so one scrape config reads a
        chain of either package's nodes."""
        metrics = self._live_metrics()
        with self._lock:
            callbacks = dict(self._callbacks)
        lines: list[str] = []

        def family(name: str, kind: str) -> str:
            pn = _prom_name(name)
            lines.append(f"# HELP {pn} defer_tpu metric "
                         f"{_prom_escape(name)}")
            lines.append(f"# TYPE {pn} {kind}")
            return pn

        for name, m in sorted(metrics.items()):
            if isinstance(m, LatencyHistogram):
                pn = family(name, "summary")
                for q in (0.5, 0.95, 0.99):
                    lines.append(
                        f'{pn}{{quantile="{_prom_label_value(str(q))}"}} '
                        f'{m.quantile(q):.9g}')
                lines.append(f"{pn}_sum {m.sum:.9g}")
                lines.append(f"{pn}_count {m.count}")
            elif isinstance(m, Counter):
                pn = family(name, "counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                pn = family(name, "gauge")
                lines.append(f"{pn} {m.value:.9g}")
        for name, fn in sorted(callbacks.items()):
            try:
                v = fn()
            except Exception:  # noqa: BLE001 — a dead callback must not
                continue       # take the scrape page down
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                pn = family(name, "gauge")
                lines.append(f"{pn} {v:.9g}" if isinstance(v, float)
                             else f"{pn} {v}")
        return "\n".join(lines) + "\n"

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=str)
            f.write("\n")


#: the process-wide registry every subsystem instruments into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
