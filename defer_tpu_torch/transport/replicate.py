"""Ordered fan-out / fan-in for data-parallel stage replicas.

The port of ``defer_tpu.transport.replicate``.  A chain's steady-state
period is its slowest stage; when one indivisible stage dominates, R
data-parallel replicas of it inside the chain cut its service time to
``compute / R``, provided the stream's order survives the parallel
paths.  The two order-preserving halves ride the framed transport's v2
sequence numbers (``K_TENSOR_SEQ``, ``transport/framed.py``), so the
frames are byte-identical to the JAX package's and the two packages'
fans interoperate:

* :class:`FanOutSender` round-robins tensor frames across R
  :class:`~defer_tpu_torch.transport.channel.AsyncSender` channels,
  stamping frame ``i`` with sequence number ``i``.  Strict round-robin
  means a stalled replica blocks the producer on that channel's turn:
  backpressure is kept per path, never routed around (the fan-in would
  starve on the stalled replica's slots anyway).
* :class:`FanInMerge` is a bounded reorder buffer fed by R upstream
  reader threads, releasing frames to one consumer strictly in sequence
  order.  A gap parks the consumer even when later frames are buffered;
  a full buffer parks the readers (except for the frame the consumer
  waits on, which is always admitted), which stops their socket reads,
  so TCP pushes back on the fast replicas.  Duplicate or stale sequence
  numbers raise, unless a ``replay_window`` absorbs a healed fan-out's
  replay overlap (``transport/replay.py``).

The merge ends once all R upstreams have delivered their END frame and
the buffer has drained in order; an END with a sequence gap outstanding
raises (a replica died mid-stream and its slots can never be filled).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Sequence

from ..obs import LatencyHistogram
from .channel import AsyncSender
from .framed import K_CTRL, K_END, K_TENSOR

__all__ = ["FanInMerge", "FanOutSender"]


class FanInMerge:
    """Bounded reorder buffer merging R sequence-stamped upstreams.

    Reader threads (one per upstream connection) call :meth:`put`,
    :meth:`put_ctrl`, :meth:`end` and :meth:`fail`; one consumer calls
    :meth:`get` and receives ``(kind, value)`` tuples shaped like
    ``recv_frame``'s: tensors strictly in sequence order (seq stripped),
    control frames ahead of buffered tensors, then ``(K_END, None)`` once
    every upstream ended and the buffer drained.
    """

    def __init__(self, expected: int, *, capacity: int = 32,
                 replay_window: int = 0):
        if expected < 1:
            raise ValueError(f"expected must be >= 1, got {expected}")
        if capacity < max(expected, 1):
            # fewer slots than upstreams could park every reader with the
            # needed frame still in a socket nobody reads
            raise ValueError(f"capacity {capacity} < expected {expected}")
        if replay_window < 0:
            raise ValueError(f"replay_window must be >= 0, "
                             f"got {replay_window}")
        self.expected = expected
        self.capacity = capacity
        #: failover tolerance: a duplicate or stale seq within this many
        #: positions behind the stream head is dropped silently (a healed
        #: fan-out replayed frames its acks had not yet covered); 0 keeps
        #: the strict contract, where any duplicate raises
        self.replay_window = replay_window
        #: duplicates absorbed inside the replay window
        self.duplicates = 0
        self._buf: dict[int, object] = {}
        self._ctrl: list[dict] = []
        self._next = 0
        self._ends = 0
        self._err: BaseException | None = None
        self._cv = threading.Condition()

    # -- producer side (reader threads) ---------------------------------------

    def put(self, seq: int, value, timeout: float | None = None) -> None:
        """Insert one tensor by sequence number.  Blocks while the buffer
        is full, unless ``seq`` is the one the consumer is parked on (the
        needed frame is always admitted, so a full buffer of later frames
        cannot deadlock the stream).  A duplicate or stale sequence
        number raises ``ValueError``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._err is not None:
                    raise self._err
                if seq < self._next or seq in self._buf:
                    if self.replay_window > 0 \
                            and seq >= self._next - self.replay_window:
                        # failover replay overlap: already merged or
                        # buffered; absorb it
                        self.duplicates += 1
                        return
                    raise ValueError(
                        f"duplicate/stale sequence {seq} "
                        f"(next expected {self._next})")
                if seq == self._next or len(self._buf) < self.capacity:
                    self._buf[seq] = value
                    self._cv.notify_all()
                    return
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"reorder buffer full ({self.capacity}) for "
                        f"{timeout:.1f}s waiting on seq {self._next}")
                self._cv.wait(0.05)

    def put_ctrl(self, msg: dict) -> None:
        """Queue a control frame, delivered ahead of buffered tensors (the
        control plane rides ahead of data, as on a single path)."""
        with self._cv:
            self._ctrl.append(msg)
            self._cv.notify_all()

    def end(self) -> None:
        """One upstream delivered its END frame."""
        with self._cv:
            self._ends += 1
            if self._ends > self.expected:
                self._err = ConnectionError(
                    f"{self._ends} END frames from {self.expected} "
                    f"upstreams")
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        """An upstream reader died: raise ``exc`` in everyone parked here,
        the consumer and the other readers alike."""
        with self._cv:
            if self._err is None:
                self._err = exc
            self._cv.notify_all()

    # -- consumer side ---------------------------------------------------------

    def _pop_locked(self):
        """One ready item under the lock, or None."""
        if self._ctrl:
            return K_CTRL, self._ctrl.pop(0)
        if self._next in self._buf:
            value = self._buf.pop(self._next)
            self._next += 1
            self._cv.notify_all()  # wake readers parked on a full buffer
            return K_TENSOR, value
        if self._err is not None:
            raise self._err
        if self._ends >= self.expected:
            if self._buf:
                raise ConnectionError(
                    f"all {self.expected} upstreams ended with sequence "
                    f"gap: waiting on {self._next}, "
                    f"{sorted(self._buf)[:4]}... still buffered")
            return K_END, None
        return None

    def get(self, timeout: float | None = None) -> tuple:
        """Next in-order ``(kind, value)``; ``TimeoutError`` past
        ``timeout`` (None waits forever); re-raises a reader's failure."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                got = self._pop_locked()
                if got is not None:
                    return got
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no in-order frame within {timeout:.1f}s "
                        f"(waiting on seq {self._next}, "
                        f"{len(self._buf)} out-of-order buffered)")
                self._cv.wait(0.05)

    def get_nowait(self) -> tuple:
        """Non-blocking :meth:`get`: ``queue.Empty`` when the next
        in-sequence frame has not arrived, even with later frames buffered
        (the consumer's cue to drain its compute window)."""
        with self._cv:
            got = self._pop_locked()
        if got is None:
            raise queue.Empty
        return got

    def qsize(self) -> int:
        with self._cv:
            return len(self._buf)

    @property
    def next_seq(self) -> int:
        """The cumulative merge position: every seq below it has been
        released in order, which is what a ``replay_ack`` carries."""
        with self._cv:
            return self._next


class FanOutSender:
    """Round-robin tensor distribution across R replica channels.

    The :class:`AsyncSender` surface (``send``, ``send_ctrl``,
    ``send_end``, ``close``, ``flush``) over R of them: tensor ``i`` goes
    to channel ``i % R`` stamped with sequence number ``i``; control and
    END frames go to every channel (each replica needs the trace context,
    and the fan-in counts R ENDs).  ``send`` ignores a caller's seq and
    stamps its own: a fan-out begins a fresh sequence segment.
    """

    def __init__(self, socks: Sequence, *, depth: int = 8,
                 codec: str = "raw", gauge: str | None = None, span=None,
                 hist: str | None = None):
        if not socks:
            raise ValueError("FanOutSender needs at least one socket")
        self._chans = [AsyncSender(s, depth=depth, codec=codec,
                                   gauge=gauge, span=span, hist=hist)
                       for s in socks]
        self._n = 0
        self.depth = depth

    @property
    def width(self) -> int:
        return len(self._chans)

    @property
    def sample_every(self) -> int:
        return self._chans[0].sample_every

    @sample_every.setter
    def sample_every(self, n: int) -> None:
        for ch in self._chans:
            ch.sample_every = n

    def take_watermark(self) -> int:
        """Peak occupancy across the replica channels since the last
        call."""
        return max(ch.take_watermark() for ch in self._chans)

    @property
    def hi(self) -> int:
        """The channels' watermark peek, without a reset (what a
        ``stats`` reply reads)."""
        return max(ch.hi for ch in self._chans)

    @property
    def enc(self) -> LatencyHistogram:
        """The channels' encode histograms, merged."""
        h = LatencyHistogram()
        for ch in self._chans:
            h.merge(ch.enc)
        return h

    def send(self, arr, *, seq: int | None = None) -> None:
        self._chans[self._n % len(self._chans)].send(arr, seq=self._n)
        self._n += 1

    def send_ctrl(self, msg: dict) -> None:
        for ch in self._chans:
            ch.send_ctrl(msg)

    def send_end(self) -> None:
        for ch in self._chans:
            ch.send_end()

    def close(self, timeout: float | None = None) -> None:
        """END every channel, then join them all; the first failure is
        raised after every channel had its close attempt."""
        first: BaseException | None = None
        for ch in self._chans:
            try:
                ch.close(timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first is None:
                    first = e
        if first is not None:
            raise first

    def flush(self, timeout: float | None = None) -> None:
        for ch in self._chans:
            ch.flush(timeout=timeout)

    def qsize(self) -> int:
        return sum(ch.qsize() for ch in self._chans)
