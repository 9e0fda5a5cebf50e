"""Async double-buffered transport channels: overlap rx, compute, and tx.

The port of ``defer_tpu.transport.channel``, on the port's framed
transport and observability.

A serial stage loop pays rx + decode + compute + encode + tx per tensor,
so per-hop latency is the *sum* of the phases.  The paper's pipeline claim
(+53% ResNet50 throughput at 8 nodes) needs every node to process
microbatch *j* while receiving *j+1* and relaying *j-1* — per-hop cost is
then the *max* of the phases.  This module supplies the two halves of that
overlap for any framed socket:

* :class:`AsyncReceiver` — a daemon thread that reads *and decodes* frames
  into a bounded queue.  A full queue parks the thread in ``put``, which
  stops its reads; TCP flow control then pushes back on the upstream
  sender, so backpressure is preserved end to end with at most
  ``depth`` decoded frames of slack.
* :class:`AsyncSender` — a bounded queue drained by a daemon thread that
  *encodes and sends*.  A full queue blocks the producer (``send``), so a
  slow wire stalls the compute loop after ``depth`` frames, never later.

Both sides surface worker-thread failures on the caller's thread: the
receiver's ``get`` re-raises the exact exception that killed the rx
thread; the sender's next ``send``/``flush`` raises :class:`ChannelError`
chained to the tx thread's failure (and the dead thread drains the queue
so a producer parked in ``send`` always wakes).

Telemetry: pass ``gauge="node.rx_queue_depth"`` to publish the queue's
occupancy as a registry gauge (ADDITIVE ``inc``/``dec`` updates, so
several channels sharing a name report their total; ``take_watermark``
returns the per-interval peak), ``hist="node.rx_s"`` to record per-frame
recv+decode / encode+send seconds, and ``span=<name or callable>`` to
record a ``<name>.rx`` / ``<name>.tx`` span per frame when the process
tracer is enabled — the Perfetto view of rx/compute/tx actually
overlapping.  Setting ``sample_every = N`` switches per-frame spans to
1-in-N waterfall sampling keyed on the wire sequence number, adding
``.rx_wait`` / ``.tx_wait`` queue-time spans for the sampled frames
(docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

from ..obs import REGISTRY, LatencyHistogram, tracer
from .framed import (K_END, K_TENSOR, K_TENSOR_SEQ, recv_frame, send_ctrl,
                     send_end, send_frame)

#: rx-queue sentinel: the thread died, ``err`` holds why
_ERR = object()
#: tx-queue item kinds
_TENSOR, _CTRL, _END, _FLUSH, _TENSOR_SEQ = 0, 1, 2, 3, 4


class ChannelError(ConnectionError):
    """A channel worker thread died; the original failure is ``__cause__``."""


def _resolve_label(span) -> Callable[[], str] | None:
    if span is None:
        return None
    return span if callable(span) else (lambda: span)


def _sampled(sample_every: int, seq: int | None) -> bool:
    """Waterfall sampling predicate: ``sample_every <= 0`` keeps the
    pre-sampling behavior (every frame records its span); ``N >= 1``
    records only frames whose WIRE sequence number is a multiple of N —
    the same 1-in-N frames in every process of the chain, so the sampled
    frame's full rx-wait/infer/tx-wait path stitches into one waterfall
    (docs/OBSERVABILITY.md).  Frames without a wire seq are not sampled.
    """
    if sample_every <= 0:
        return True
    return seq is not None and seq % sample_every == 0


class AsyncReceiver:
    """Daemon rx thread: recv + decode into a bounded in-order queue.

    The thread exits after delivering a ``K_END`` frame (the stream is
    over) or on error.  ``get`` never hangs past its timeout and re-raises
    the rx thread's failure once the queue is drained.
    """

    #: waterfall sampling period for per-frame spans (0 = every frame);
    #: set by the owner when the trace context carries ``sample_every``
    sample_every: int = 0

    def __init__(self, sock, *, depth: int = 8, gauge: str | None = None,
                 span=None, hist: str | None = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._sock = sock
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._gauge = REGISTRY.gauge(gauge) if gauge else None
        self._span = _resolve_label(span)
        #: registry histogram of recv+decode seconds per tensor frame
        #: (always-on; the live bottleneck estimate reads it)
        self._hist = REGISTRY.histogram(hist) if hist else None
        #: per-CHANNEL decode seconds (codec work only, no blocking recv
        #: wait) — the live bottleneck estimate's per-node attribution
        #: even when several in-process nodes share the registry
        self.dec = LatencyHistogram()
        #: high watermark of queue occupancy since take_watermark()
        self.hi = 0
        self.err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="channel-rx")
        self._thread.start()

    def bind_gauge(self, name: str) -> None:
        """Start publishing queue occupancy under ``name`` — for callers
        that only later learn this connection is worth monitoring (a node
        binds its gauge once a connection becomes THE data stream, so
        short-lived control connections never clobber the reading).
        Gauge updates are ADDITIVE (``inc``/``dec``) so several channels
        sharing one name report their total; binding syncs the current
        occupancy in (±1 transient if the rx thread races the bind)."""
        g = REGISTRY.gauge(name)
        g.inc(self._q.qsize())
        self._gauge = g

    def bind_hist(self, name: str) -> None:
        """Start recording per-frame recv+decode seconds under ``name``
        (bound with the gauge once a connection proves to be the data
        stream)."""
        self._hist = REGISTRY.histogram(name)

    def take_watermark(self) -> int:
        """Max queue occupancy since the previous call (the per-interval
        depth watermark an obs_push reports)."""
        h = max(self.hi, self._q.qsize())
        self.hi = self._q.qsize()
        return h

    def release_gauge(self) -> None:
        """Return this channel's remaining contribution to its shared
        ADDITIVE gauge and unbind: a stream abandoned mid-flight leaves
        queued frames nobody will ever dequeue, and without this the
        gauge would carry the dead stream's depth forever (the old
        absolute-set updates self-corrected; additive ones must
        reconcile).  ±1 transient if the rx thread races the unbind."""
        g, self._gauge = self._gauge, None
        if g is not None:
            g.dec(self._q.qsize())

    def _run(self):
        n = 0
        try:
            while True:
                t0 = time.perf_counter()
                kind, value = recv_frame(self._sock,
                                         on_decode=self.dec.record)
                dt = time.perf_counter() - t0
                if kind in (K_TENSOR, K_TENSOR_SEQ):
                    if self._hist is not None:
                        self._hist.record(dt)
                    tr = tracer()
                    if tr.enabled and self._span is not None:
                        seq = value[0] if kind == K_TENSOR_SEQ else None
                        if _sampled(self.sample_every, seq):
                            tr.record(f"{self._span()}.rx", t0, dt,
                                      {"seq": n if seq is None else seq})
                n += 1
                self._q.put((kind, value, time.perf_counter()))
                if self._gauge is not None:
                    self._gauge.inc()
                q = self._q.qsize()
                if q > self.hi:
                    self.hi = q
                if kind == K_END:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in get()
            self.err = e
            try:
                self._q.put_nowait(_ERR)
            except queue.Full:
                pass  # get() checks err once the queue drains

    def get(self, timeout: float | None = None) -> tuple:
        """Next (kind, value) in arrival order; re-raises the rx thread's
        failure, raises TimeoutError past ``timeout`` (None = forever)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self.err is not None and self._q.empty():
                    raise self.err
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no frame within {timeout:.1f}s")
                continue
            return self._unwrap(item)

    def get_nowait(self) -> tuple:
        """Non-blocking :meth:`get`; raises ``queue.Empty`` when no frame
        is ready (the consumer's cue to spend the idle time elsewhere,
        e.g. draining its compute window)."""
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            if self.err is not None:
                raise self.err from None
            raise
        return self._unwrap(item)

    def _unwrap(self, item) -> tuple:
        if item is _ERR:
            raise self.err
        if self._gauge is not None:
            self._gauge.dec()
        kind, value, t_enq = item
        if self._span is not None and self.sample_every > 0:
            # waterfall sampling: how long the sampled frame waited in
            # the rx queue before the compute loop took it
            tr = tracer()
            seq = value[0] if kind == K_TENSOR_SEQ else None
            if tr.enabled and _sampled(self.sample_every, seq):
                now = time.perf_counter()
                tr.record(f"{self._span()}.rx_wait", t_enq, now - t_enq,
                          {"seq": seq})
        return kind, value

    def qsize(self) -> int:
        return self._q.qsize()


class AsyncSender:
    """Bounded tx queue drained by a daemon encode+send thread.

    ``send``/``send_ctrl``/``send_end`` enqueue in call order; a full
    queue blocks the caller (bounded in-flight depth).  After the tx
    thread dies, every subsequent call raises :class:`ChannelError` and
    the queue is drained so a parked producer always wakes.
    """

    #: waterfall sampling period for per-frame spans (0 = every frame)
    sample_every: int = 0

    def __init__(self, sock, *, depth: int = 8, codec: str = "raw",
                 gauge: str | None = None, span=None,
                 hist: str | None = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._sock = sock
        self.codec = codec
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._gauge = REGISTRY.gauge(gauge) if gauge else None
        self._span = _resolve_label(span)
        #: registry histogram of encode+send seconds per tensor frame
        self._hist = REGISTRY.histogram(hist) if hist else None
        #: per-CHANNEL encode seconds (codec work only) — see
        #: ``AsyncReceiver.dec``
        self.enc = LatencyHistogram()
        #: high watermark of queue occupancy since take_watermark()
        self.hi = 0
        self.err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="channel-tx")
        self._thread.start()

    def take_watermark(self) -> int:
        """Max queue occupancy since the previous call."""
        h = max(self.hi, self._q.qsize())
        self.hi = self._q.qsize()
        return h

    # -- producer side -----------------------------------------------------

    def send(self, arr, *, seq: int | None = None) -> None:
        """Enqueue one tensor frame (encode + send happen on the tx
        thread, under this sender's codec).  ``seq`` stamps the frame
        with a stream sequence number (``K_TENSOR_SEQ``) so a downstream
        fan-in can restore order across parallel replica paths."""
        if seq is None:
            self._put((_TENSOR, arr))
        else:
            self._put((_TENSOR_SEQ, (seq, arr)))

    def send_ctrl(self, msg: dict) -> None:
        self._put((_CTRL, msg))

    def send_end(self) -> None:
        """Enqueue the END frame; the tx thread exits after sending it."""
        self._put((_END, None))

    def close(self, timeout: float | None = None) -> None:
        """Send END (after everything already queued) and wait for the tx
        thread to put it on the wire and exit — the caller may close the
        socket afterwards without racing a buffered frame."""
        self.send_end()
        self._thread.join(timeout)
        if self.err is not None:
            raise ChannelError("transport tx thread died") from self.err
        if self._thread.is_alive():
            raise TimeoutError(f"tx queue did not drain in {timeout:.1f}s")

    def flush(self, timeout: float | None = None) -> None:
        """Block until everything enqueued so far is on the wire (or raise
        the tx thread's failure / TimeoutError)."""
        ev = threading.Event()
        self._put((_FLUSH, ev))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ev.wait(0.05):
            if self.err is not None:
                raise ChannelError("transport tx thread died") from self.err
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"tx queue did not drain in {timeout:.1f}s")
        if self.err is not None:
            raise ChannelError("transport tx thread died") from self.err

    def _put(self, item) -> None:
        while True:
            if self.err is not None:
                raise ChannelError("transport tx thread died") from self.err
            try:
                self._q.put(item + (time.perf_counter(),), timeout=0.05)
            except queue.Full:
                continue
            if self._gauge is not None:
                self._gauge.inc()
            q = self._q.qsize()
            if q > self.hi:
                self.hi = q
            return

    def qsize(self) -> int:
        return self._q.qsize()

    # -- tx thread ----------------------------------------------------------

    def _run(self):
        n = 0
        try:
            while True:
                kind, v, t_enq = self._q.get()
                if self._gauge is not None:
                    self._gauge.dec()
                if kind == _FLUSH:
                    v.set()
                    continue
                t0 = time.perf_counter()
                if kind == _TENSOR:
                    send_frame(self._sock, v, codec=self.codec,
                               on_encode=self.enc.record)
                elif kind == _TENSOR_SEQ:
                    send_frame(self._sock, v[1], codec=self.codec,
                               seq=v[0], on_encode=self.enc.record)
                elif kind == _CTRL:
                    send_ctrl(self._sock, v)
                else:
                    send_end(self._sock)
                if kind in (_TENSOR, _TENSOR_SEQ):
                    dt = time.perf_counter() - t0
                    if self._hist is not None:
                        self._hist.record(dt)
                    tr = tracer()
                    if tr.enabled and self._span is not None:
                        seq = v[0] if kind == _TENSOR_SEQ else None
                        if _sampled(self.sample_every, seq):
                            label = self._span()
                            if self.sample_every > 0:
                                # waterfall sampling: queue wait before
                                # the frame reached the wire
                                tr.record(f"{label}.tx_wait", t_enq,
                                          t0 - t_enq, {"seq": seq})
                            tr.record(f"{label}.tx", t0, dt,
                                      {"seq": n if seq is None else seq})
                n += 1
                if kind == _END:
                    # release any flush marker enqueued after the END so
                    # a racing flush() can never hang on a dead thread
                    while True:
                        try:
                            k2, v2, _ = self._q.get_nowait()
                        except queue.Empty:
                            return
                        if self._gauge is not None:
                            self._gauge.dec()
                        if k2 == _FLUSH:
                            v2.set()
        except BaseException as e:  # noqa: BLE001 — surfaced in _put/flush
            self.err = e
            # wake any parked producer and release pending flush waiters;
            # items still queued are dropped (the wire is dead anyway)
            while True:
                try:
                    kind, v, _ = self._q.get_nowait()
                except queue.Empty:
                    return
                if self._gauge is not None:
                    self._gauge.dec()
                if kind == _FLUSH:
                    v.set()  # flush re-checks err after the event fires
