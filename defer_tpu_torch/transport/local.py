"""Colocated transport tier: zero-serialization in-process channels.

The port of ``defer_tpu.transport.local``.  Every hop of the stage-node
chain pays a TCP round trip plus a host encode/decode, even when both
endpoints live in the same process (stages colocated as ``--co-stage``
serve threads, or a chain of nodes on threads of one program).  This
module is the colocated rule for the chain transport:

* :class:`LocalPipe` — a bounded in-memory frame stream.  Tensor frames
  carry the live host object (a numpy array, or a ``torch.bfloat16``
  tensor, as the node's host sync makes them) by reference: no codec, no
  framing, no socket, no copy.  The queue is bounded, so the tcp path's
  backpressure holds: a slow consumer parks the producer after ``depth``
  frames, as a full ``AsyncSender`` queue does.  Sequence stamping
  (``send(arr, seq=)``) is kept.
* **Negotiation** — the sender dials TCP as always, then offers the fast
  path with a ``tier_probe`` control frame carrying its pid, protocol
  version and a token it registered in this process's offer registry.
  The receiver grants only when the pid matches, the version matches and
  the token resolves in its registry — the lookup is the proof that both
  ends share one process (a remote peer's token never resolves here; a
  JAX package peer's token lives in that package's registry, so the two
  packages never splice a pipe).  A refused offer degrades the hop to
  plain tcp on the same socket and counts ``transport.tier_fallback``.

The ``device`` tier has no transport object: adjacent stages that share a
device are fused into one exported stage program before the chain starts
(``partition.fuse_stages``), so the hop ceases to exist.

:class:`LocalSender` has the :class:`~.channel.AsyncSender` surface
(``send`` / ``send_ctrl`` / ``send_end`` / ``close`` / ``flush`` /
``enc`` / watermarks) and :class:`LocalReceiver` the
:class:`~.channel.AsyncReceiver` one (``get`` / ``get_nowait`` /
``bind_gauge`` / ``bind_hist`` / ``release_gauge`` / ``dec``), so the
nodes and the dispatcher swap them in without caring which tier won.
Their ``enc``/``dec`` histograms stay empty: a colocated hop does no
codec work.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import uuid

from ..obs import REGISTRY, LatencyHistogram
from ..obs.events import emit as emit_event
from .channel import ChannelError
from .framed import (K_CTRL, K_END, K_TENSOR, K_TENSOR_SEQ,
                     PROTOCOL_VERSION, recv_expect, send_ctrl)

__all__ = ["LocalPipe", "LocalReceiver", "LocalSender", "answer_probe",
           "grant_local", "offer_local", "record_fallback"]

#: hops that wanted a colocated tier but degraded to tcp (a failed
#: handshake: wrong pid, version mismatch, unknown token, refused peer)
_FALLBACK = REGISTRY.counter("transport.tier_fallback")

#: tensor frames handed through local pipes (wire frame counters keep
#: meaning "bytes that crossed a socket")
_LOCAL_FRAMES = REGISTRY.counter("transport.local_frames")

#: token -> LocalPipe: offers awaiting a grant.  Process-local on purpose:
#: a probe from another process never resolves its token here, which is
#: the colocation proof the handshake needs.
_OFFERS: dict[str, "LocalPipe"] = {}
_OFFERS_LOCK = threading.Lock()


def record_fallback(hop: str | None = None) -> None:
    """Count one degraded hop: the process-wide
    ``transport.tier_fallback`` counter, plus a labeled
    ``transport.tier_fallback.<hop>`` twin when the offering side named
    its hop (``stage1``, ``chain``), and a ``tier_fallback`` event."""
    _FALLBACK.n += 1
    if hop:
        REGISTRY.counter(f"transport.tier_fallback.{hop}").n += 1
    emit_event("tier_fallback", hop=hop)


class LocalPipe:
    """One bounded in-memory frame stream (sender end + receiver end).

    Items are ``(kind, value)`` tuples shaped as ``recv_frame`` returns
    them — ``(K_TENSOR, arr)``, ``(K_TENSOR_SEQ, (seq, arr))``,
    ``(K_CTRL, dict)``, ``(K_END, None)`` — so a consumer cannot tell a
    frame off a socket from one off a pipe.
    """

    #: end classes, so the device-resident ici tier inherits the pipe's
    #: backpressure, ordered ctrl, cascading END and peer-death poisoning
    sender_cls: type["LocalSender"]
    receiver_cls: type["LocalReceiver"]

    def __init__(self, depth: int = 8):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        #: the sender enqueued its END (clean shutdown)
        self._ended = False
        #: the sender abandoned the stream without an END (peer death: the
        #: pipe's cut TCP connection)
        self._sender_gone = False
        #: the receiver will never consume again (its stream loop exited)
        self._receiver_gone = False
        #: the gauge the receiver bound, and the enqueue/dequeue counts
        #: kept under ``_glock``: the gauge follows the counts, never
        #: ``qsize()``, so a bind racing a put counts the item once
        self._gauge = None
        self._glock = threading.Lock()
        self._enq = 0
        self._deq = 0
        self.sender = self.sender_cls(self)
        self.receiver = self.receiver_cls(self)


class LocalSender:
    """Producer end of a :class:`LocalPipe` (the AsyncSender surface)."""

    #: waterfall sampling period, kept for the surface; a local hop
    #: records no per-frame tx span (it has no tx phase)
    sample_every: int = 0
    codec = "local"   #: nominal; no codec runs on a local hop

    def __init__(self, pipe: LocalPipe):
        self._pipe = pipe
        self._q = pipe._q
        self.depth = pipe.depth
        #: per-channel encode histogram: stays empty (no codec work)
        self.enc = LatencyHistogram()
        self.hi = 0
        self.err: BaseException | None = None

    def send(self, arr, *, seq: int | None = None) -> None:
        if seq is None:
            self._put((K_TENSOR, arr))
        else:
            self._put((K_TENSOR_SEQ, (seq, arr)))
        _LOCAL_FRAMES.n += 1

    def send_ctrl(self, msg: dict) -> None:
        self._put((K_CTRL, dict(msg)))

    def send_end(self) -> None:
        self._put((K_END, None))
        self._pipe._ended = True

    def close(self, timeout: float | None = None) -> None:
        """END the stream.  Once enqueued the frame is delivered (the
        consumer holds the same queue), so there is no tx thread to join;
        ``timeout`` bounds only the wait for a slot against a peer that is
        alive but not consuming, so a dead chain fails instead of
        hanging."""
        self._put((K_END, None), timeout=timeout)
        self._pipe._ended = True

    def flush(self, timeout: float | None = None) -> None:
        """No-op: ``send`` hands the frame over synchronously."""
        if self.err is not None:
            raise ChannelError("local channel peer gone") from self.err

    def detach(self) -> None:
        """Abandon the stream (the owner's teardown).  Without a prior END
        this marks the sender dead, so a consumer parked in ``get`` fails
        as on a cut TCP connection; after a clean END it is a no-op."""
        if not self._pipe._ended:
            self._pipe._sender_gone = True

    def _put(self, item, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._pipe._receiver_gone:
                self.err = ConnectionError(
                    "local channel receiver abandoned the stream")
                raise ChannelError("local channel receiver gone") \
                    from self.err
            try:
                self._q.put(item, timeout=0.05)
            except queue.Full:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"local channel full for {timeout:.1f}s "
                        f"(peer stopped consuming)")
                continue  # bounded queue: backpressure
            with self._pipe._glock:
                self._pipe._enq += 1
                if self._pipe._gauge is not None:
                    self._pipe._gauge.inc()
            q = self._q.qsize()
            if q > self.hi:
                self.hi = q
            return

    def take_watermark(self) -> int:
        h = max(self.hi, self._q.qsize())
        self.hi = self._q.qsize()
        return h

    def qsize(self) -> int:
        return self._q.qsize()


class LocalReceiver:
    """Consumer end of a :class:`LocalPipe` (the AsyncReceiver surface)."""

    sample_every: int = 0

    def __init__(self, pipe: LocalPipe):
        self._pipe = pipe
        self._q = pipe._q
        self.depth = pipe.depth
        #: per-channel decode histogram: stays empty (no codec work)
        self.dec = LatencyHistogram()
        self.hi = 0
        self.err: BaseException | None = None

    def bind_gauge(self, name: str) -> None:
        g = REGISTRY.gauge(name)
        with self._pipe._glock:
            # the backlog is the enqueues already counted under the lock;
            # a put not yet counted sees the gauge and counts itself
            g.inc(self._pipe._enq - self._pipe._deq)
            self._pipe._gauge = g

    def bind_hist(self, name: str) -> None:
        """Kept for the surface; a local hop has no recv+decode phase, so
        nothing is recorded under ``name``."""

    def release_gauge(self) -> None:
        """Reconcile the shared gauge and mark this end gone, so a producer
        parked in ``send`` wakes with :class:`ChannelError` instead of
        blocking against a dead stream."""
        self._pipe._receiver_gone = True
        with self._pipe._glock:
            g, self._pipe._gauge = self._pipe._gauge, None
            if g is not None:
                g.dec(self._pipe._enq - self._pipe._deq)

    def get(self, timeout: float | None = None) -> tuple:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._pipe._sender_gone and self._q.empty():
                    self.err = ConnectionError(
                        "local channel peer closed mid-stream")
                    raise self.err
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"no frame within {timeout:.1f}s")
                continue
            return self._got(item)

    def get_nowait(self) -> tuple:
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            if self._pipe._sender_gone:
                self.err = ConnectionError(
                    "local channel peer closed mid-stream")
                raise self.err from None
            raise
        return self._got(item)

    def _got(self, item) -> tuple:
        with self._pipe._glock:
            self._pipe._deq += 1
            if self._pipe._gauge is not None:
                self._pipe._gauge.dec()
        q = self._q.qsize()
        if q > self.hi:
            self.hi = q
        return item

    def take_watermark(self) -> int:
        h = max(self.hi, self._q.qsize())
        self.hi = self._q.qsize()
        return h

    def qsize(self) -> int:
        return self._q.qsize()


LocalPipe.sender_cls = LocalSender
LocalPipe.receiver_cls = LocalReceiver


# ---------------------------------------------------------------------------
# negotiation
# ---------------------------------------------------------------------------

def _register(pipe: LocalPipe) -> str:
    token = uuid.uuid4().hex
    with _OFFERS_LOCK:
        _OFFERS[token] = pipe
    return token


def _claim(token) -> LocalPipe | None:
    with _OFFERS_LOCK:
        return _OFFERS.pop(token, None)


def offer_local(sock, *, depth: int = 8, hop: str | None = None,
                fallback: bool = True) -> tuple[str, LocalPipe | None]:
    """Offer the colocated fast path on a freshly dialed data socket.

    Sends the ``tier_probe`` and waits for the ``tier_reply`` (the probe
    is the first frame on the connection, so the reply cannot interleave
    with data).  Returns ``("local", pipe)`` when granted — the caller
    sends every further frame through ``pipe.sender`` and keeps the socket
    only as the connection's lifetime anchor — or ``("tcp", None)`` after
    a refusal, counting one fallback (see :func:`record_fallback`) unless
    ``fallback=False``: the tier ladder passes that when it will offer the
    next rung on the same socket, so one degraded hop counts once.
    """
    pipe = LocalPipe(depth=depth)
    token = _register(pipe)
    try:
        send_ctrl(sock, {"cmd": "tier_probe", "want": "local",
                         "pid": os.getpid(), "proto": PROTOCOL_VERSION,
                         "token": token})
        reply = recv_expect(sock, K_CTRL)
    finally:
        _claim(token)  # a granted probe was already claimed by the peer
    if isinstance(reply, dict) and reply.get("cmd") == "tier_reply" \
            and reply.get("tier") == "local":
        return "local", pipe
    if fallback:
        record_fallback(hop)
    return "tcp", None


def grant_local(msg) -> LocalPipe | None:
    """Validate one ``tier_probe``; return the offered pipe when the
    colocation claim holds, else None (the caller replies tcp).

    Checks, in order: the probe wants ``local``; the wire protocol version
    matches; the peer's pid is this process's; and the token resolves in
    this process's offer registry — the proof both ends share one address
    space (a forged pid alone is never enough)."""
    if not isinstance(msg, dict) or msg.get("want") != "local":
        return None
    try:
        if int(msg.get("proto", -1)) != PROTOCOL_VERSION:
            return None
        if int(msg.get("pid", -1)) != os.getpid():
            return None
    except (TypeError, ValueError):
        return None
    return _claim(msg.get("token"))


def answer_probe(conn, msg, *, accept: bool = True) -> LocalPipe | None:
    """Receiver side of the local handshake: validate ``msg`` (when
    ``accept``), send the ``tier_reply`` on ``conn`` and return the granted
    :class:`LocalPipe` or None.  A probe is always answered: an unanswered
    probe would park the offering peer in its reply wait.  Loops that
    refuse every tier (the serial loop, a stream's teardown) call it with
    ``accept=False``; the granting loops use
    :func:`~.shm.answer_tier_probe`, which answers every rung."""
    pipe = grant_local(msg) if accept else None
    send_ctrl(conn, {"cmd": "tier_reply",
                     "tier": "local" if pipe is not None else "tcp"})
    return pipe
