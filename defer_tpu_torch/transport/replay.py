"""Seq-replay substrate: the bounded retain-until-ack window and the
self-healing fan-out.  The port of ``defer_tpu.transport.replay``.

* :class:`ReplayBuffer` — a bounded window of sent-but-unacked values,
  keyed by seq.  ``retain`` blocks while the window is full (the retained
  memory is the backpressure bound), a cumulative ``ack(upto)`` releases
  everything below it, and ``unacked`` snapshots what a recovery must
  replay.  The dispatcher's resubmit log stands on it too: every
  microbatch fed to the pipeline is retained under its feed sequence
  number until its output is emitted, and a watchdog recovery replays
  :meth:`ReplayBuffer.unacked`.
* :class:`ReplayFanOut` — the :class:`~.replicate.FanOutSender` surface
  with an ack reader per channel and a heal path: when a replica channel
  dies (a send fails, or its ack socket reaches EOF), the channel redials
  the same address with :func:`~.framed.connect_retry` (the respawned
  replica binds its old port), resends the stream preamble
  (``stream_begin``/``trace``), replays the channel's unacked window in
  order, and resumes, emitting one ``failover`` event with the measured
  recovery time.  Replayed frames the downstream fan-in already merged
  are dropped inside its replay window (``FanInMerge(replay_window=)``),
  so a replay overlap never corrupts or reorders the stream.

The acks ride the reverse direction of the fan path's data sockets, which
works because fan paths never negotiate a transport tier (no shm doorbell
or probe reply shares those sockets):

* the fan-in's merge loop sends cumulative ``{"cmd": "replay_ack",
  "seq": N}`` control frames upstream on every fan-in connection (every
  frame below N has been merged in order);
* each replica relays the ack one hop further upstream on its own
  inbound connection;
* the fan-out's ack readers release the replay window, and a
  ``{"cmd": "replay_done"}`` from a replica that completed its stream
  marks that channel's later EOF as shutdown, not death.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Sequence

from ..obs import REGISTRY, LatencyHistogram
from ..obs.events import emit as emit_event
from .channel import AsyncSender, ChannelError
from .framed import K_CTRL, K_END, connect_retry, recv_frame

__all__ = ["ReplayBuffer", "ReplayFanOut", "ACK_EVERY"]

#: fan-in ack cadence: one cumulative replay_ack per ACK_EVERY merged
#: frames (plus one at stream end).  Small enough that the retained window
#: stays shallow, large enough that acks never crowd the reverse path.
ACK_EVERY = 8


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


class ReplayFanOut:
    """Round-robin replica fan-out that survives a replica's death.

    The :class:`~.replicate.FanOutSender` surface (``send``,
    ``send_ctrl``, ``send_end``, ``close``, ``flush``, ``qsize`` and the
    telemetry properties) over R :class:`AsyncSender` channels, with three
    additions:

    * every tensor frame is retained in one shared :class:`ReplayBuffer`
      until the downstream fan-in's cumulative ``replay_ack`` releases it
      (an ack reader per channel, on the data socket's reverse
      direction);
    * a dead channel (a send failure, or its ack reader's EOF without a
      ``replay_done``) heals: redial the same address, resend the
      recorded stream preamble, replay the channel's unacked frames in
      order, resume.  Channel assignment stays ``seq % R`` throughout, so
      a replayed frame lands on the path whose fan-in slots it;
    * the recovery is timed and emitted as one ``failover`` event.

    A replay can overlap frames the fan-in already merged (acks lag by up
    to ``ACK_EVERY``); the fan-in's merge drops those inside its replay
    window.  A duplicate-tolerant downstream and a replay-until-acked
    upstream are the whole failover contract.
    """

    def __init__(self, socks: Sequence, addrs: Sequence[tuple[str, int]],
                 *, depth: int = 8, codec: str = "raw",
                 gauge: str | None = None, span=None,
                 hist: str | None = None, window: int = 256,
                 redial_timeout_s: float = 30.0,
                 replay_gauge: str | None = "node.replay_depth"):
        if not socks:
            raise ValueError("ReplayFanOut needs at least one socket")
        if len(socks) != len(addrs):
            raise ValueError(f"{len(socks)} sockets but {len(addrs)} "
                             f"addresses")
        self._socks = list(socks)
        self._addrs = [tuple(a) for a in addrs]
        self.depth = depth
        self._codec = codec
        self._gauge_name = gauge
        self._span = span
        self._hist_name = hist
        self.redial_timeout_s = redial_timeout_s
        self._buf = ReplayBuffer(window, gauge=replay_gauge)
        self._chans = [self._new_chan(s) for s in self._socks]
        self._n = 0
        self._cv = threading.Condition()
        self._healing = [False] * len(self._chans)
        self._chan_err: list[BaseException | None] = \
            [None] * len(self._chans)
        #: END queued on the current channel object of slot i
        self._end_sent = [False] * len(self._chans)
        self._end_queued = False
        #: the channel completed its stream (replay_done received): a
        #: later EOF there is shutdown, not death
        self._done = [False] * len(self._chans)
        self._closing = False
        #: heals performed (what a node's stats report)
        self.failovers = 0
        #: preamble control frames a healed channel resends before its
        #: replay (stream_begin, trace), the latest of each command
        self._preamble: list[dict] = []
        for i, s in enumerate(self._socks):
            self._start_ack_reader(i, s, self._chans[i])

    def _new_chan(self, sock) -> AsyncSender:
        return AsyncSender(sock, depth=self.depth, codec=self._codec,
                           gauge=self._gauge_name, span=self._span,
                           hist=self._hist_name)

    def _start_ack_reader(self, i: int, sock, chan) -> None:
        # each reader is bound to the channel generation it was started
        # for: after a heal swaps the slot, a stale reader must never act
        # on the replacement (see _ack_loop's heal call)
        threading.Thread(target=self._ack_loop, args=(i, sock, chan),
                         daemon=True, name=f"replay-ack-{i}").start()

    # -- the FanOutSender telemetry surface ------------------------------------

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
        return max(ch.take_watermark() for ch in self._chans)

    @property
    def hi(self) -> int:
        return max(ch.hi for ch in self._chans)

    @property
    def enc(self) -> LatencyHistogram:
        h = LatencyHistogram()
        for ch in self._chans:
            h.merge(ch.enc)
        return h

    def qsize(self) -> int:
        return sum(ch.qsize() for ch in self._chans)

    def replay_depth(self) -> int:
        """Frames retained for replay right now."""
        return self._buf.depth()

    # -- the ack plane -----------------------------------------------------------

    def _ack_loop(self, i: int, sock, chan) -> None:
        """Read the channel's reverse direction: cumulative replay_acks
        release the window, replay_done marks a clean end, EOF without
        one heals the channel."""
        try:
            while True:
                try:
                    kind, value = recv_frame(sock)
                except TimeoutError:
                    # an idle reverse path is no death: the first ack
                    # flows only once the fan-in merges frames, and the
                    # fan sockets may carry a recv timeout.  Death shows
                    # as EOF, a reset or garbage
                    if self._closing or self._done[i]:
                        return
                    continue
                if kind == K_CTRL and isinstance(value, dict):
                    cmd = value.get("cmd")
                    if cmd == "replay_ack":
                        self._buf.ack(int(value.get("seq", 0)))
                    elif cmd == "replay_done":
                        self._done[i] = True
                elif kind == K_END:
                    break
        except (OSError, ConnectionError, ValueError):
            pass
        try:
            if self._closing or self._done[i]:
                return
            try:
                # heal THIS reader's channel generation, never the slot's
                # current occupant: a send-path heal may already have
                # swapped in a live replacement, and _heal's identity
                # check then makes this call a no-op
                self._heal(i, chan)
            except BaseException:  # noqa: BLE001 — kept in _chan_err,
                pass               # raised on the next send
        finally:
            # the reader owns its socket's close: _heal only shuts the
            # socket down (waking this recv with EOF), because closing an
            # fd another thread is blocked in recv(2) on lets the next
            # connect reuse the number and the stale reader steal its
            # bytes
            try:
                sock.close()
            except OSError:
                pass

    # -- heal --------------------------------------------------------------------

    def _heal(self, i: int, dead) -> None:
        """Replace channel ``i``: shut the dead socket down, redial the
        same address, resend the preamble, replay the channel's unacked
        frames in order, swap in, time and emit.  One healer per (slot,
        dead channel); concurrent detectors wait for its outcome."""
        with self._cv:
            while self._healing[i]:
                self._cv.wait(0.05)
            if self._chans[i] is not dead:
                # someone else already healed this very death
                if self._chan_err[i] is not None:
                    raise ChannelError(
                        f"replica channel {i} unrecoverable") \
                        from self._chan_err[i]
                return
            if self._closing:
                raise ChannelError(
                    f"replica channel {i} died during teardown")
            self._healing[i] = True
            ended = self._end_queued
        t0 = time.perf_counter()
        host, port = self._addrs[i]
        deadline = time.monotonic() + self.redial_timeout_s
        try:
            try:
                # shutdown, not close: the slot's ack reader may be
                # blocked in recv(2) on this fd, and closes it itself
                self._socks[i].shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            attempt = 0
            while True:
                # connect, preamble and replay are one retryable attempt:
                # a redial can land in the dying process's listen backlog,
                # which accepts and then resets mid-replay; only a later
                # dial reaches the respawned replica
                budget = deadline - time.monotonic()
                if budget <= 0:
                    raise ChannelError(
                        f"replica channel {i} ({host}:{port}): no "
                        f"successful replay within "
                        f"{self.redial_timeout_s:.1f}s")
                sock = connect_retry(host, port, timeout_s=budget)
                ch = self._new_chan(sock)
                ch.sample_every = dead.sample_every
                with self._cv:
                    preamble = list(self._preamble)
                try:
                    for msg in preamble:
                        ch.send_ctrl(msg)
                    replayed = 0
                    for s, arr in self._buf.unacked():
                        if s % len(self._chans) == i:
                            ch.send(arr, seq=s)
                            replayed += 1
                    if ended:
                        # the old channel's END died with it: the healed
                        # stream still has to end
                        ch.send_end()
                    break
                except (ChannelError, OSError, ConnectionError,
                        TimeoutError) as e:
                    attempt += 1
                    emit_event("redial", addr=f"{host}:{port}",
                               attempt=attempt, delay_ms=0.0,
                               error=type(e).__name__)
                    try:
                        sock.close()
                    except OSError:
                        pass
            with self._cv:
                self._socks[i] = sock
                self._chans[i] = ch
                self._chan_err[i] = None
                self._end_sent[i] = ended
                self._healing[i] = False
                self.failovers += 1
                self._cv.notify_all()
            recovery_ms = (time.perf_counter() - t0) * 1e3
            emit_event("failover",
                       hop=(self._span() if callable(self._span)
                            else self._span),
                       chan=i, addr=f"{host}:{port}", replayed=replayed,
                       recovery_ms=round(recovery_ms, 3))
            REGISTRY.counter("transport.failovers").n += 1
            self._start_ack_reader(i, sock, ch)
        except BaseException as e:  # noqa: BLE001 — raised to the sender
            with self._cv:
                self._chan_err[i] = e
                self._healing[i] = False
                self._cv.notify_all()
            self._buf.fail(e if isinstance(e, ChannelError) else
                           ChannelError(f"replica channel {i} "
                                        f"({host}:{port}) could not be "
                                        f"healed: {e!r}"))
            raise

    def _current_chan(self, i: int) -> AsyncSender:
        """The live channel of slot ``i``, after any heal in flight;
        raises the slot's terminal error if healing failed."""
        with self._cv:
            while self._healing[i]:
                self._cv.wait(0.05)
            if self._chan_err[i] is not None:
                raise ChannelError(
                    f"replica channel {i} unrecoverable") \
                    from self._chan_err[i]
            return self._chans[i]

    # -- the sender surface ------------------------------------------------------

    def send(self, arr, *, seq: int | None = None) -> None:
        """Retain, then round-robin as FanOutSender does (tensor ``i`` to
        channel ``i % R`` stamped ``seq=i``; a caller's seq is ignored).
        A send that meets a dead channel heals it and retries; the retry
        can duplicate a frame the heal already replayed, which the
        downstream merge drops inside its replay window."""
        s = self._n
        self._n += 1
        self._buf.retain(s, arr)
        i = s % len(self._chans)
        while True:
            ch = self._current_chan(i)
            try:
                ch.send(arr, seq=s)
                return
            except ChannelError:
                self._heal(i, ch)

    def send_ctrl(self, msg: dict) -> None:
        """Send a control frame on every channel; the stream preamble
        (``stream_begin``, ``trace``) is recorded, so a healed channel
        resends it ahead of its replay."""
        if isinstance(msg, dict) and msg.get("cmd") in ("stream_begin",
                                                        "trace"):
            with self._cv:
                self._preamble = [m for m in self._preamble
                                  if m.get("cmd") != msg.get("cmd")]
                self._preamble.append(dict(msg))
        for i in range(len(self._chans)):
            while True:
                ch = self._current_chan(i)
                try:
                    ch.send_ctrl(msg)
                    break
                except ChannelError:
                    self._heal(i, ch)

    def send_end(self) -> None:
        self._end_queued = True
        for i in range(len(self._chans)):
            while True:
                ch = self._current_chan(i)
                with self._cv:
                    if self._end_sent[i]:
                        break  # a heal already ended this channel
                try:
                    ch.send_end()
                    with self._cv:
                        self._end_sent[i] = True
                    break
                except ChannelError:
                    self._heal(i, ch)

    def flush(self, timeout: float | None = None) -> None:
        for i in range(len(self._chans)):
            self._current_chan(i).flush(timeout=timeout)

    @staticmethod
    def _join_chan(ch, timeout: float | None) -> None:
        """Wait for a channel whose END is queued to drain and exit
        (``AsyncSender.close`` without a second END)."""
        ch._thread.join(timeout)
        if ch.err is not None:
            raise ChannelError("transport tx thread died") from ch.err
        if ch._thread.is_alive():
            raise TimeoutError(
                f"tx queue did not drain in {timeout:.1f}s")

    def close(self, timeout: float | None = None) -> None:
        """END every channel and join them, healing a channel that dies
        with unacked frames still owed (its replay and END complete the
        stream on the respawned replica); the first terminal failure is
        raised after every channel had its close attempt."""
        self._end_queued = True
        first: BaseException | None = None
        for i in range(len(self._chans)):
            attempts = 0
            while True:
                try:
                    ch = self._current_chan(i)
                except ChannelError as e:
                    first = first or e
                    break
                with self._cv:
                    ended = self._end_sent[i]
                try:
                    if not ended:
                        ch.send_end()
                        with self._cv:
                            self._end_sent[i] = True
                    self._join_chan(ch, timeout)
                    break
                except ChannelError:
                    attempts += 1
                    if attempts > 3:
                        first = first or ChannelError(
                            f"replica channel {i} kept dying during "
                            f"close")
                        break
                    try:
                        self._heal(i, ch)
                    except BaseException as e:  # noqa: BLE001
                        first = first or e
                        break
                except TimeoutError as e:
                    first = first or e
                    break
        self._closing = True
        if first is not None:
            raise first
