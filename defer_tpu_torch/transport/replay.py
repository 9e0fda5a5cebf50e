"""Bounded retain-until-ack window: the port of ``ReplayBuffer`` from
``defer_tpu.transport.replay``.

The dispatcher's resubmit log stands on it: every microbatch fed to the
pipeline is retained under its feed sequence number until its output is
emitted (the cumulative "ack"), and a watchdog recovery replays
:meth:`ReplayBuffer.unacked`.  The self-healing fan-out of the JAX
package (``ReplayFanOut``) needs the framed network channels and waits
for them (ROADMAP A9/A10).
"""

from __future__ import annotations

import threading
import time

from ..obs import REGISTRY

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    """Bounded window of retained-but-unacked values, keyed by seq.

    One producer calls :meth:`retain` before each send; consumers call
    :meth:`ack` with their cumulative position; a recovery snapshots
    :meth:`unacked`.  ``retain`` blocks while the window is full — the
    retained memory is the backpressure bound, published as a gauge
    (``gauge=`` name, absolute value).
    """

    def __init__(self, capacity: int = 256, *, gauge: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._frames: dict[int, object] = {}
        self._acked = 0            # every seq < _acked is released
        self._err: BaseException | None = None
        self._cv = threading.Condition()
        self._gauge = REGISTRY.gauge(gauge) if gauge else None
        #: lifetime high watermark of retained values
        self.hi = 0

    def retain(self, seq: int, value, timeout: float | None = None) -> None:
        """Hold one value until a cumulative ack releases it; blocks while
        the window is full (an already-acked seq is a no-op)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._err is not None:
                    raise self._err
                if seq < self._acked:
                    return
                if len(self._frames) < self.capacity \
                        or seq in self._frames:
                    self._frames[seq] = value
                    if len(self._frames) > self.hi:
                        self.hi = len(self._frames)
                    if self._gauge is not None:
                        self._gauge.set(len(self._frames))
                    return
                if deadline is not None \
                        and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replay window full ({self.capacity}) for "
                        f"{timeout:.1f}s — no ack from downstream")
                self._cv.wait(0.05)

    def ack(self, upto: int) -> None:
        """Cumulative release: drop every retained seq below ``upto``.
        Stale acks are no-ops."""
        with self._cv:
            if upto <= self._acked:
                return
            self._acked = upto
            for s in [s for s in self._frames if s < upto]:
                del self._frames[s]
            if self._gauge is not None:
                self._gauge.set(len(self._frames))
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Wake a producer parked in :meth:`retain` with ``exc``."""
        with self._cv:
            if self._err is None:
                self._err = exc
            self._cv.notify_all()

    def unacked(self) -> list[tuple[int, object]]:
        """Snapshot of retained (seq, value) pairs in seq order — what a
        recovery replays."""
        with self._cv:
            return sorted(self._frames.items())

    def depth(self) -> int:
        with self._cv:
            return len(self._frames)

    @property
    def acked(self) -> int:
        with self._cv:
            return self._acked
