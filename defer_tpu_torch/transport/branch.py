"""Per-seq broadcast fan-out and all-paths join for branched stage graphs.

The port of ``defer_tpu.transport.branch``.  Replication
(``transport/replicate.py``) splits a stream across R identical replicas:
frame ``i`` goes to one replica and the fan-in restores round-robin
order.  A branched stage graph needs the other fan: every branch computes
on every frame (an inception block's branches all read the block input; a
branched MoE's experts all read the token batch), and the join needs all
P branch outputs of sequence ``s`` before it can run the graph's merge
op.  The frames are the framed transport's v2 sequence-stamped frames
(``K_TENSOR_SEQ``), byte-identical to the JAX package's, so the two
packages' forks, branches and joins interoperate.  The two halves:

* :class:`BroadcastSender` sends each tensor frame to all P branch
  channels, stamped with one shared sequence number.  Each channel's
  ``stream_begin`` control frame carries its path label, so the join can
  attribute every connection (a direct fork->join channel standing in for
  an empty residual branch included) to its merge-input slot.
  Backpressure holds per path: one stalled branch fills its bounded
  channel queue and parks the producer.

* :class:`BranchJoin` is a bounded reorder buffer keyed on ``(path,
  seq)``: reader threads (one per inbound branch connection) deposit each
  path's frame for ``s``; the consumer parks until all P paths delivered
  ``s``, then receives ``(seq, [x_path0, ..., x_pathP-1])`` strictly in
  sequence order — the argument list of the join stage's program.  The
  discipline is FanInMerge's: a full buffer parks readers except for a
  deposit that completes the consumer's next needed seq or lands in an
  open slot (liveness), duplicate or stale ``(path, seq)`` deposits
  raise, and an END needs all P paths ended with no incomplete seq
  buffered: a branch that died mid-stream fails the stream, never
  completes it short.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Sequence

from ..obs import LatencyHistogram
from .channel import AsyncSender
from .framed import K_CTRL, K_END, K_TENSOR_SEQ

__all__ = ["BranchJoin", "BroadcastSender"]


class BranchJoin:
    """Bounded ``(path, seq)`` reorder buffer merging P branch paths.

    Reader threads call :meth:`attach` (once per path) then :meth:`put`
    / :meth:`put_ctrl` / :meth:`end` / :meth:`fail`; one consumer calls
    :meth:`get` and receives ``(kind, value)`` tuples: control frames
    first, then ``(K_TENSOR_SEQ, (seq, [parts...]))`` strictly in
    sequence order with ``parts`` in path order, then ``(K_END, None)``
    once every path ended and the buffer drained.
    """

    def __init__(self, paths: int, *, capacity: int = 32):
        if paths < 2:
            raise ValueError(f"paths must be >= 2, got {paths}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.paths = paths
        self.capacity = capacity          # distinct buffered seqs
        self._slots: dict[int, list] = {}  # seq -> [part per path]
        self._have: dict[int, int] = {}    # seq -> parts present
        self._ctrl: list[dict] = []
        self._next = 0
        self._attached: set[int] = set()
        self._ended: set[int] = set()
        self._err: BaseException | None = None
        self._cv = threading.Condition()

    # -- producer side (one reader thread per branch connection) ------------

    def _check_path(self, path: int) -> None:
        if not 0 <= path < self.paths:
            raise ValueError(f"path {path} out of range 0..{self.paths - 1}")

    def attach(self, path: int) -> None:
        """Claim ``path`` for one upstream connection; a second
        connection claiming the same path raises (two branches cannot
        share a merge-input slot)."""
        with self._cv:
            self._check_path(path)
            if path in self._attached:
                raise ConnectionError(
                    f"two upstreams claimed join path {path}")
            self._attached.add(path)

    def put(self, path: int, seq: int, value,
            timeout: float | None = None) -> None:
        """Deposit path ``path``'s frame for sequence ``seq``.  Blocks
        while ``capacity`` distinct seqs are buffered UNLESS the deposit
        lands in an existing slot or opens the consumer's next needed
        seq (liveness: the frame everyone is waiting on is always
        admitted).  Duplicate ``(path, seq)`` or stale ``seq`` raise."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._check_path(path)
            while True:
                if self._err is not None:
                    raise self._err
                if seq < self._next:
                    raise ValueError(
                        f"stale sequence {seq} on path {path} "
                        f"(next expected {self._next})")
                slot = self._slots.get(seq)
                if slot is not None and slot[path] is not None:
                    raise ValueError(
                        f"duplicate frame for (path {path}, seq {seq})")
                if slot is not None or seq == self._next \
                        or len(self._slots) < self.capacity:
                    if slot is None:
                        slot = self._slots[seq] = [None] * self.paths
                        self._have[seq] = 0
                    slot[path] = value
                    self._have[seq] += 1
                    self._cv.notify_all()
                    return
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"join buffer full ({self.capacity} seqs) for "
                        f"{timeout:.1f}s waiting on seq {self._next}")
                self._cv.wait(0.05)

    def put_ctrl(self, msg: dict) -> None:
        """Queue a control frame — delivered ahead of buffered tensors
        (control rides ahead of data, the single-path convention)."""
        with self._cv:
            self._ctrl.append(msg)
            self._cv.notify_all()

    def end(self, path: int) -> None:
        """Path ``path`` delivered its END frame (exactly once)."""
        with self._cv:
            self._check_path(path)
            if path in self._ended:
                self._err = ConnectionError(
                    f"two END frames on join path {path}")
            self._ended.add(path)
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        """A branch reader died: surface ``exc`` to everyone parked."""
        with self._cv:
            if self._err is None:
                self._err = exc
            self._cv.notify_all()

    # -- consumer side -------------------------------------------------------

    def _pop_locked(self):
        if self._ctrl:
            return K_CTRL, self._ctrl.pop(0)
        if self._have.get(self._next, 0) == self.paths:
            seq = self._next
            parts = self._slots.pop(seq)
            del self._have[seq]
            self._next += 1
            self._cv.notify_all()  # wake readers parked on a full buffer
            return K_TENSOR_SEQ, (seq, parts)
        if self._err is not None:
            raise self._err
        if len(self._ended) >= self.paths:
            if self._slots:
                missing = {
                    s: [p for p, v in enumerate(self._slots[s])
                        if v is None]
                    for s in sorted(self._slots)[:4]}
                raise ConnectionError(
                    f"all {self.paths} branch paths ended with the join "
                    f"incomplete: waiting on seq {self._next}, missing "
                    f"(seq -> paths) {missing}")
            return K_END, None
        return None

    def get(self, timeout: float | None = None) -> tuple:
        """Next in-order item (see class docstring); TimeoutError past
        ``timeout`` (None = wait forever), re-raises reader failures."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                got = self._pop_locked()
                if got is not None:
                    return got
                if deadline is not None and time.monotonic() > deadline:
                    have = self._have.get(self._next, 0)
                    raise TimeoutError(
                        f"no complete join frame within {timeout:.1f}s "
                        f"(seq {self._next} has {have}/{self.paths} "
                        f"paths, {len(self._slots)} seqs buffered)")
                self._cv.wait(0.05)

    def get_nowait(self) -> tuple:
        """Non-blocking :meth:`get`; raises ``queue.Empty`` while the
        next seq is incomplete (the consumer's cue to drain its compute
        window)."""
        with self._cv:
            got = self._pop_locked()
        if got is None:
            raise queue.Empty
        return got

    def qsize(self) -> int:
        with self._cv:
            return len(self._slots)


class BroadcastSender:
    """Every frame to every branch: the fork side of a stage graph.

    Presents the :class:`AsyncSender` surface over P of them, like
    :class:`~defer_tpu_torch.transport.replicate.FanOutSender` — but where the
    replica fan round-robins, a broadcast DUPLICATES: tensor ``i`` goes
    to ALL channels stamped with sequence ``i`` (a caller-supplied seq
    is ignored — the fork begins a fresh sequence segment), and each
    channel is announced with ``{"cmd": "stream_begin", "path": p}`` so
    the join end of the region can map connections to merge-input slots.
    Control and END frames broadcast as well (each branch needs the
    trace context; the join counts one END per path).
    """

    def __init__(self, socks: Sequence, *, depth: int = 8,
                 codec: str = "raw", gauge: str | None = None, span=None,
                 hist: str | None = None,
                 paths: Sequence[int] | None = None):
        if len(socks) < 2:
            raise ValueError("BroadcastSender needs >= 2 channels "
                             "(a single path is a plain unicast hop)")
        self._chans = [AsyncSender(s, depth=depth, codec=codec,
                                   gauge=gauge, span=span, hist=hist)
                       for s in socks]
        self.paths = list(paths) if paths is not None \
            else list(range(len(socks)))
        if len(self.paths) != len(self._chans):
            raise ValueError(f"{len(self._chans)} channels but "
                             f"{len(self.paths)} path labels")
        self._n = 0
        self.depth = depth
        for p, ch in zip(self.paths, self._chans):
            ch.send_ctrl({"cmd": "stream_begin", "path": int(p)})

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

    def send(self, arr, *, seq: int | None = None) -> None:
        # every channel's encode thread reads the same (read-only) array
        # concurrently; the shared stamp is what lets the join pair the P
        # copies back up
        for ch in self._chans:
            ch.send(arr, seq=self._n)
        self._n += 1

    def send_ctrl(self, msg: dict) -> None:
        for ch in self._chans:
            ch.send_ctrl(msg)

    def send_end(self) -> None:
        for ch in self._chans:
            ch.send_end()

    def close(self, timeout: float | None = None) -> None:
        """END every channel, then join them all; the first failure is
        raised after every channel got its close attempt."""
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
