"""Process-wide metrics registry: named counters and histograms.

The port's copy of the part of ``defer_tpu.obs.registry`` that the
pipeline engines use.  One registry per process (module-level
:data:`REGISTRY`); instruments are created once by name and then held by
the instrumented code as plain attributes, so the hot path never goes
through the registry dict.  Snapshots are pull-based: ``snapshot()``
returns a JSON-ready dict.

Callbacks let existing stat objects (``PipelineMetrics``'s plain-int
counters) appear in snapshots without paying any registry cost when they
update: the registry calls them at snapshot time only.
"""

from __future__ import annotations

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

    def snapshot(self) -> dict:
        """JSON-ready view: counters as numbers, histograms as summaries.

        A callback returning ``None`` marks itself expired (its source was
        collected) and is pruned, as are dead weak-registered instruments.
        """
        with self._lock:
            metrics = {}
            for name, m in list(self._metrics.items()):
                if isinstance(m, weakref.ref):
                    m = m()
                    if m is None:
                        del self._metrics[name]
                        continue
                metrics[name] = m
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


#: the process-wide registry every subsystem instruments into
REGISTRY = MetricsRegistry()
