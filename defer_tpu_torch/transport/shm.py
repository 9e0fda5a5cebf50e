"""Shared-memory transport tier: same-host cross-process hops.

The port of ``defer_tpu.transport.shm``.  The ``local`` tier only engages
when both ends of a hop share one process; a chain of node processes on
one host would otherwise push every activation through loopback TCP with
a codec pass.  This rung sits between ``local`` and ``tcp``: activations
ride a ``multiprocessing.shared_memory`` ring of slots, and the TCP socket
the hop dialed anyway becomes a doorbell carrying per-frame slot
descriptors, control frames and END — so seq stamping, in-order K_CTRL and
the cascading END keep the wire protocol's meaning while the payload never
touches a socket.

* :class:`ShmRing` — one shared segment of ``slots`` fixed-capacity slots,
  created by the sender.  A tensor is written once into the next free slot
  and announced with a ``shm_frame`` doorbell naming the slot, dtype,
  shape and optional seq; the receiver copies the slot out into an array
  it owns, then acks.  A CUDA tensor is copied straight from the card into
  the slot (one device-to-host copy, the node's ``host_sync``).  A frame
  fatter than a slot grows the ring: the sender drains its outstanding
  slots, swaps in a bigger segment and announces it with a ``shm_grow``
  doorbell, which the ordered socket delivers before any frame that uses
  it.
* **Backpressure** — the receiver returns one ack byte per consumed frame
  on the doorbell socket (slots are used and freed in FIFO order, so a
  count is enough), and a full ring parks the producer as a full
  ``AsyncSender`` queue does.  Peer death poisons both ends: socket EOF
  fails the receiver's frame source with ``ConnectionError``, and the
  sender's ack reader marks the channel dead so a parked producer wakes
  with :class:`~.channel.ChannelError`.
* **Negotiation** — the sender creates the segment, then offers
  ``{"cmd": "tier_probe", "want": "shm", seg, boot_id, proto}``.  The
  grantor accepts only when the protocol version matches, the boot id
  matches, and it can open the offered segment — the open is the
  same-host proof.  A refused offer degrades the hop to tcp on the same
  socket and counts ``transport.tier_fallback`` (and its per-hop twin).

The probe, the doorbells, the segment names and the ack byte are the JAX
package's, so a JAX node and a port node on one host negotiate shm in
either direction.  bfloat16 frames are announced as ``"bfloat16"`` (the
JAX package's name for them) and arrive as ``torch.bfloat16`` tensors.

Segment lifecycle: segments are named ``defer_shm_<pid>_<rand>``.  The
creating process unlinks on close or detach and again at exit; the
receiver unlinks on its teardown too (mapped frames stay readable after
an unlink), so whichever end survives a crash reaps the name.  When both
ends die (kill -9), :func:`sweep_orphan_segments` — run by ``run_chain``
and the dispatcher's deploy — unlinks every ``defer_shm_`` segment whose
creator pid is gone.  A ring reserves its pages when it is created
(``posix_fallocate``), so a ``/dev/shm`` too small for it fails there
with ``OSError`` instead of a bus error at the first write.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
import time
import uuid
from multiprocessing import shared_memory

import numpy as np
import torch

from ..obs import REGISTRY, LatencyHistogram
from .channel import ChannelError
from .framed import (BF16, K_CTRL, K_TENSOR, K_TENSOR_SEQ,
                     PROTOCOL_VERSION, recv_expect, send_ctrl, send_end,
                     wire_dtype)
from .local import record_fallback

__all__ = ["ShmReceiver", "ShmRing", "ShmSender", "answer_tier_probe",
           "grant_shm", "offer_shm", "offer_tier_ladder",
           "sweep_orphan_segments"]

#: tensor frames handed through shm rings (wire frame counters keep
#: meaning "bytes that crossed a socket", which shm payloads never do)
_SHM_FRAMES = REGISTRY.counter("transport.shm_frames")

#: segment name prefix ``defer_shm_<creator pid>_<rand>``: the pid lets
#: the orphan sweep attribute (and reap) a dead chain's segments
SEG_PREFIX = "defer_shm_"

#: default slot capacity; a fatter first frame grows the ring
DEFAULT_SLOT_BYTES = 1 << 20

#: rings created by this process and not yet unlinked (atexit backstop)
_LIVE_RINGS: "set[ShmRing]" = set()
_LIVE_LOCK = threading.Lock()


def _boot_id() -> str:
    """This host's boot id: the cheap same-host witness the probe carries
    (opening the segment is the real proof)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return f"host:{socket.gethostname()}"


def _untrack(seg: shared_memory.SharedMemory) -> None:
    """Detach ``seg`` from multiprocessing's resource tracker, which would
    otherwise unlink a segment another process created when this one
    exits: this module owns the unlinks (explicit, atexit, the sweep)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:  # noqa: BLE001 — tracking is best-effort anyway
        pass


def _unlink_name(name: str) -> None:
    """Remove a segment name without the resource tracker (idempotent)."""
    try:
        import _posixshmem
        _posixshmem.shm_unlink("/" + name)
    except ImportError:
        try:
            os.unlink(os.path.join("/dev/shm", name))
        except OSError:
            pass
    except OSError:
        pass


def _open_segment(name: str) -> shared_memory.SharedMemory | None:
    """Map an existing segment by name, untracked; None if it does not
    resolve on this host (the grantor's refusal path)."""
    try:
        seg = shared_memory.SharedMemory(name=name)
    except (OSError, ValueError):
        return None
    _untrack(seg)
    return seg


def _close_segment(seg: shared_memory.SharedMemory) -> None:
    try:
        seg.close()
    except (OSError, BufferError):
        pass


@atexit.register
def _unlink_live_rings() -> None:
    with _LIVE_LOCK:
        rings = list(_LIVE_RINGS)
    for r in rings:
        r.unlink()


def _frame_dtype(x) -> tuple[str, np.dtype]:
    """(wire dtype string, numpy dtype of the slot's bytes) of a frame."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return BF16, np.dtype(np.int16)
        dt = torch.empty(0, dtype=x.dtype).numpy().dtype
        return wire_dtype(dt), dt
    dt = np.asarray(x).dtype
    return wire_dtype(dt), dt


class ShmRing:
    """Sender-owned shared segment of ``slots`` fixed-capacity slots.

    Slots are claimed in FIFO order by the sender and freed in the same
    order by the receiver's acks, so the free-slot accounting is a
    counting semaphore; no per-slot state crosses the processes beyond the
    doorbell descriptor.
    """

    def __init__(self, *, slots: int = 8,
                 slot_bytes: int = DEFAULT_SLOT_BYTES):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        # 64-byte slots keep every view's offset aligned for any dtype
        self.slot_bytes = max(64, (int(slot_bytes) + 63) & ~63)
        self.slots = slots
        self.name = f"{SEG_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:12]}"
        size = self.slots * self.slot_bytes
        self._seg = shared_memory.SharedMemory(name=self.name, create=True,
                                               size=size)
        _untrack(self._seg)
        self._unlinked = False
        try:
            # reserve the pages now: on a full /dev/shm this raises, where
            # a sparse segment would kill the process at its first write
            os.posix_fallocate(self._seg._fd, 0, size)
        except AttributeError:
            pass  # no posix_fallocate on this platform
        except OSError as e:
            self.unlink()
            _close_segment(self._seg)
            raise OSError(e.errno, f"cannot reserve a {size}-byte shared "
                                   f"memory ring ({self.slots} x "
                                   f"{self.slot_bytes} bytes) in /dev/shm: "
                                   f"{e.strerror}") from e
        with _LIVE_LOCK:
            _LIVE_RINGS.add(self)

    def view(self, slot: int, dtype: np.dtype, shape) -> np.ndarray:
        """A writable numpy view of ``slot``'s first bytes as ``dtype``."""
        count = int(np.prod(shape, dtype=np.int64))
        return np.frombuffer(self._seg.buf, dtype=dtype, count=count,
                             offset=slot * self.slot_bytes).reshape(shape)

    def unlink(self) -> None:
        """Remove the segment name (idempotent; mappings stay valid).  Both
        ends call this on teardown, so whoever survives a crash reaps the
        name."""
        if self._unlinked:
            return
        self._unlinked = True
        with _LIVE_LOCK:
            _LIVE_RINGS.discard(self)
        _unlink_name(self.name)  # the other end may have got there first

    def close(self) -> None:
        _close_segment(self._seg)


class ShmSender:
    """Producer end of a shm hop (the AsyncSender surface).

    ``send`` claims the next free slot (parking while the ring is full),
    copies the tensor in and sends the doorbell descriptor; control frames
    and END ride the doorbell socket directly, so their order against
    tensors is the socket's.  A stage node splits ``send`` into
    :meth:`claim`, :meth:`slot_tensor` and :meth:`commit` so that its
    device-to-host copy lands in the slot directly.
    """

    #: kept for the surface; a shm hop records no per-frame tx span
    sample_every: int = 0
    codec = "shm"   #: nominal; no codec runs on a shm hop

    def __init__(self, sock, ring: ShmRing):
        self._sock = sock
        try:
            # the dialed socket inherits connect_retry's timeout; the ack
            # loop's recv must not time out on an idle but healthy hop
            sock.settimeout(None)
        except OSError:
            pass
        self._ring = ring
        self.depth = ring.slots
        #: per-channel encode histogram: stays empty (no codec work)
        self.enc = LatencyHistogram()
        self.hi = 0
        self.err: BaseException | None = None
        self._ended = False
        self._free = threading.Semaphore(ring.slots)
        self._head = 0          # next slot index (FIFO ring order)
        self._inflight = 0      # frames announced, not yet acked
        self._ilock = threading.Lock()
        #: serializes doorbell writes (a trace ctrl from the control path
        #: may race the stream thread's descriptors)
        self._wlock = threading.Lock()
        self._acks = threading.Thread(target=self._ack_loop, daemon=True,
                                      name="shm-ack-rx")
        self._acks.start()

    def _ack_loop(self):
        """Count ack bytes off the doorbell; EOF or an error marks the
        channel dead, so a producer parked on a full ring wakes with
        :class:`ChannelError`."""
        try:
            while True:
                data = self._sock.recv(4096)
                if not data:
                    raise ConnectionError(
                        "shm doorbell peer closed (receiver gone)")
                with self._ilock:
                    self._inflight -= len(data)
                for _ in range(len(data)):
                    self._free.release()
        except BaseException as e:  # noqa: BLE001 — surfaced in send()
            self.err = e

    def _drain(self, timeout: float | None = None) -> None:
        """Park until every announced frame has been acked."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.err is not None:
                raise ChannelError("shm channel receiver gone") \
                    from self.err
            with self._ilock:
                if self._inflight == 0:
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"shm ring did not drain in {timeout:.1f}s")
            time.sleep(0.002)

    def _grow(self, nbytes: int) -> None:
        """Swap in a segment with bigger slots: drain the ring (the
        receiver keeps no reference into it), then announce the new name
        on the ordered doorbell ahead of every frame that needs it."""
        self._drain()
        size = 1 << max(6, (int(nbytes) - 1).bit_length())
        new = ShmRing(slots=self._ring.slots, slot_bytes=size)
        with self._wlock:
            send_ctrl(self._sock, {"cmd": "shm_grow", "seg": new.name,
                                   "slots": new.slots,
                                   "slot_bytes": new.slot_bytes})
        old, self._ring = self._ring, new
        self.depth = new.slots
        old.unlink()
        old.close()

    # -- producer side -------------------------------------------------------

    def claim(self, nbytes: int, timeout: float | None = None) -> int:
        """Reserve the next slot for a frame of ``nbytes`` (growing the
        ring first when it is fatter than a slot); parks while the ring is
        full.  Returns the slot index."""
        if nbytes > self._ring.slot_bytes:
            self._grow(nbytes)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.err is not None:
                raise ChannelError("shm channel receiver gone") \
                    from self.err
            if self._free.acquire(timeout=0.05):
                slot = self._head % self._ring.slots
                self._head += 1
                return slot
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"shm ring full for {timeout:.1f}s "
                    f"(peer stopped consuming)")

    def slot_tensor(self, slot: int, like: torch.Tensor) -> torch.Tensor:
        """A contiguous CPU tensor over ``slot`` with ``like``'s dtype and
        shape: ``slot_tensor(...).copy_(y)`` writes a frame in place, from
        the card or the host.  Drop it before :meth:`commit`."""
        _, dt = _frame_dtype(like)
        t = torch.from_numpy(self._ring.view(slot, dt, tuple(like.shape)))
        return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 else t

    def commit(self, slot: int, like, *, seq: int | None = None) -> None:
        """Announce the frame written into ``slot`` (dtype and shape of
        ``like``) on the doorbell."""
        wdt, dt = _frame_dtype(like)
        shape = list(like.shape)
        msg = {"cmd": "shm_frame", "slot": slot,
               "nbytes": int(np.prod(shape, dtype=np.int64)) * dt.itemsize,
               "dtype": wdt, "shape": shape}
        if seq is not None:
            msg["seq"] = int(seq)
        with self._ilock:
            self._inflight += 1
            if self._inflight > self.hi:
                self.hi = self._inflight
        with self._wlock:
            send_ctrl(self._sock, msg)
        _SHM_FRAMES.n += 1

    def send(self, arr, *, seq: int | None = None) -> None:
        if isinstance(arr, torch.Tensor):
            slot = self.claim(arr.numel() * arr.element_size())
            self.slot_tensor(slot, arr).copy_(arr)
        else:
            arr = np.asarray(arr)
            slot = self.claim(arr.nbytes)
            np.copyto(self._ring.view(slot, arr.dtype, arr.shape), arr)
        self.commit(slot, arr, seq=seq)

    def send_ctrl(self, msg: dict) -> None:
        if self.err is not None:
            raise ChannelError("shm channel receiver gone") from self.err
        with self._wlock:
            send_ctrl(self._sock, dict(msg))

    def send_end(self) -> None:
        with self._wlock:
            send_end(self._sock)
        self._ended = True

    def close(self, timeout: float | None = None) -> None:
        """Drain the ring, send END, release the segment.  Draining first
        means the receiver acks its last frame before the END, so no ack is
        in flight when the owner closes the socket.  ``timeout`` bounds the
        wait against a stalled but live peer; the segment name is released
        whether or not the drain succeeds."""
        try:
            self._drain(timeout)
            self.send_end()
        finally:
            self._ring.unlink()
            self._ring.close()

    def flush(self, timeout: float | None = None) -> None:
        """Every frame ``send`` accepted is written and announced already;
        only surface a dead peer."""
        if self.err is not None:
            raise ChannelError("shm channel receiver gone") from self.err

    def detach(self) -> None:
        """Abandon the stream (the owner's teardown without an END):
        release the segment; the socket's close fails the receiver as a
        cut TCP connection would."""
        if not self._ended:
            self.err = self.err or ConnectionError(
                "shm channel abandoned by sender")
        self._ring.unlink()
        self._ring.close()

    def take_watermark(self) -> int:
        with self._ilock:
            h = max(self.hi, self._inflight)
            self.hi = self._inflight
        return h

    def qsize(self) -> int:
        with self._ilock:
            return self._inflight


class ShmReceiver:
    """Consumer end of a shm hop (the AsyncReceiver surface).

    Wraps the hop's socket frame source (the
    :class:`~.channel.AsyncReceiver` whose rx thread owns the socket
    reads): a ``shm_frame`` descriptor becomes the slot's contents copied
    into an array this end owns — the copy comes before the ack byte that
    frees the slot — and every other frame passes through, so ctrl order
    and the cascading END are the wire path's.
    """

    sample_every: int = 0

    def __init__(self, sock, inner, seg: shared_memory.SharedMemory, *,
                 slot_bytes: int, slots: int):
        self._sock = sock
        self._inner = inner
        self._seg = seg
        self.slot_bytes = int(slot_bytes)
        self.depth = int(slots)
        #: per-channel decode histogram: stays empty (no codec work)
        self.dec = LatencyHistogram()
        self.hi = 0
        self.err: BaseException | None = None
        self._closed = False

    def get(self, timeout: float | None = None) -> tuple:
        while True:
            try:
                kind, value = self._inner.get(timeout)
            except (ConnectionError, OSError):
                self._teardown()
                raise
            item = self._translate(kind, value)
            if item is not None:
                return item

    def get_nowait(self) -> tuple:
        while True:
            try:
                kind, value = self._inner.get_nowait()
            except (ConnectionError, OSError):
                self._teardown()
                raise
            item = self._translate(kind, value)
            if item is not None:
                return item

    def _read_slot(self, msg: dict):
        """The announced frame, copied out of its slot: a numpy array, or a
        ``torch.bfloat16`` tensor for a bfloat16 frame."""
        bf16 = msg["dtype"] == BF16
        dt = np.dtype(np.int16) if bf16 else np.dtype(msg["dtype"])
        shape = tuple(msg["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(self._seg.buf, dtype=dt, count=count,
                            offset=int(msg["slot"]) * self.slot_bytes
                            ).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr

    def _translate(self, kind, value):
        """shm doorbells -> tensors; ``shm_grow`` swaps the mapping and
        yields nothing; every other frame passes through."""
        if kind != K_CTRL or not isinstance(value, dict):
            return kind, value
        cmd = value.get("cmd")
        if cmd == "shm_frame":
            arr = self._read_slot(value)
            try:
                self._sock.sendall(b"\x01")  # the slot recycles, FIFO
            except OSError as e:
                self.err = e  # sender gone: surfaced on its next send
            seq = value.get("seq")
            if seq is not None:
                return K_TENSOR_SEQ, (int(seq), arr)
            return K_TENSOR, arr
        if cmd == "shm_grow":
            old, old_name = self._seg, self._seg.name
            seg = _open_segment(value["seg"])
            if seg is None:
                raise ConnectionError(
                    f"shm_grow named a segment this host cannot open: "
                    f"{value['seg']!r}")
            self._seg = seg
            self.slot_bytes = int(value["slot_bytes"])
            self.depth = int(value["slots"])
            _unlink_name(old_name)  # the sender unlinks it too; harmless
            _close_segment(old)
            return None
        return kind, value

    def _teardown(self) -> None:
        """Stream over (clean or poisoned): reap the segment name (the
        sender may be dead), drop the mapping, and shut the doorbell down —
        a plain close would not wake a peer blocked in ``recv``, so a
        producer parked on a full ring would never learn this end is
        gone."""
        if self._closed:
            return
        self._closed = True
        _unlink_name(self._seg.name)
        _close_segment(self._seg)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # peer already gone / socket already closed

    def bind_gauge(self, name: str) -> None:
        self._inner.bind_gauge(name)

    def bind_hist(self, name: str) -> None:
        """Kept for the surface; a shm hop has no recv+decode phase, so
        nothing is recorded under ``name``."""

    def release_gauge(self) -> None:
        """Stream over: reconcile the inner channel's gauge and release
        this end's mapping and segment name."""
        self._inner.release_gauge()
        self._teardown()

    def take_watermark(self) -> int:
        return self._inner.take_watermark()

    def qsize(self) -> int:
        return self._inner.qsize()


# ---------------------------------------------------------------------------
# negotiation
# ---------------------------------------------------------------------------

def offer_shm(sock, *, depth: int = 8,
              slot_bytes: int = DEFAULT_SLOT_BYTES,
              hop: str | None = None,
              fallback: bool = True) -> tuple[str, ShmSender | None]:
    """Offer the shared-memory tier on a freshly dialed data socket.

    Creates the ring, sends the ``tier_probe`` (the first frame on the
    connection) and waits for the ``tier_reply``.  Granted: ``("shm",
    sender)``, the socket staying open as the doorbell.  Refused: the ring
    is unlinked, one fallback is counted when ``fallback`` (labeled per
    ``hop``), and the hop degrades to the wire path on the same socket:
    ``("tcp", None)``.  A ring that cannot be created raises."""
    ring = ShmRing(slots=depth, slot_bytes=slot_bytes)
    try:
        send_ctrl(sock, {"cmd": "tier_probe", "want": "shm",
                         "proto": PROTOCOL_VERSION, "boot_id": _boot_id(),
                         "pid": os.getpid(), "seg": ring.name,
                         "slots": ring.slots,
                         "slot_bytes": ring.slot_bytes})
        reply = recv_expect(sock, K_CTRL)
    except BaseException:
        ring.unlink()
        ring.close()
        raise
    if isinstance(reply, dict) and reply.get("cmd") == "tier_reply" \
            and reply.get("tier") == "shm":
        return "shm", ShmSender(sock, ring)
    ring.unlink()
    ring.close()
    if fallback:
        record_fallback(hop)
    return "tcp", None


def offer_tier_ladder(sock, *, tier: str, depth: int = 8,
                      hop: str | None = None, device=None):
    """Walk the sender's tier ladder on a freshly dialed data socket: ici
    (same process and same devices, tensors stay on the card) over local
    (same process, host arrays by reference) over shm (same host,
    shared-memory ring) over tcp, one probe per rung on the same socket.
    ``tier="auto"`` offers every rung; ``"ici"``/``"local"``/``"shm"`` pin
    that rung's offer alone.  ``device`` is the ``torch.device`` the
    offering side's outputs live on (the ici probe's identity).

    Returns ``(tier_out, tx_or_None, fell_back)``: a granted rung's sender,
    or ``("tcp", None, True)`` when every offer was refused, with one
    fallback counted for the whole ladder (an upper rung's refusal is not
    a fallback while a lower rung is left to try)."""
    from .ici import offer_ici
    from .local import offer_local
    tx = None
    tier_out = "tcp"
    if tier in ("auto", "ici"):
        tier_out, tx = offer_ici(sock, depth=depth, hop=hop, device=device,
                                 fallback=(tier == "ici"))
        if tx is not None or tier == "ici":
            return tier_out, tx, tx is None
    if tier in ("auto", "local"):
        tier_out, pipe = offer_local(sock, depth=depth, hop=hop,
                                     fallback=(tier == "local"))
        if pipe is not None:
            tx = pipe.sender
        if tx is not None or tier == "local":
            return tier_out, tx, tx is None
    tier_out, tx = offer_shm(sock, depth=depth, hop=hop)
    return tier_out, tx, tx is None


def grant_shm(msg) -> shared_memory.SharedMemory | None:
    """Validate one shm ``tier_probe``; return the opened segment when the
    same-host claim holds, else None (the caller replies tcp).

    Checks, in order: the probe wants ``shm``; the protocol version
    matches; the boot id is this host's; the name carries the segment
    prefix; and the segment opens here — the proof both ends share one
    shared-memory namespace."""
    if not isinstance(msg, dict) or msg.get("want") != "shm":
        return None
    try:
        if int(msg.get("proto", -1)) != PROTOCOL_VERSION:
            return None
    except (TypeError, ValueError):
        return None
    if msg.get("boot_id") != _boot_id():
        return None
    if not isinstance(msg.get("seg"), str) \
            or not msg["seg"].startswith(SEG_PREFIX):
        return None
    return _open_segment(msg["seg"])


def answer_tier_probe(conn, msg, *, accept: bool = True, inner=None,
                      depth: int = 8, device=None):
    """Receiver side of every colocated tier: validate ``msg`` (when
    ``accept``), send the ``tier_reply`` on ``conn`` and return ``(tier,
    receiver_or_None)`` — ``("ici", IciReceiver)``, ``("local",
    LocalReceiver)``, ``("shm", ShmReceiver)`` or ``("tcp", None)``.
    ``inner`` is the hop's live socket frame source (needed to grant shm:
    the doorbell rides it); ``device`` is this side's ``torch.device``,
    which an ici grant must share the platform of and echoes in its reply
    so the sender knows where frames must land.  Every granting loop
    answers through here, so a probe is always answered."""
    from .local import grant_local
    want = msg.get("want") if isinstance(msg, dict) else None
    if accept and want == "ici":
        from .ici import device_reply, grant_ici
        pipe = grant_ici(msg, device=device)
        if pipe is not None:
            send_ctrl(conn, {"cmd": "tier_reply", "tier": "ici",
                             "device": device_reply(device)})
            return "ici", pipe.receiver
    elif accept and want == "local":
        pipe = grant_local(msg)
        if pipe is not None:
            send_ctrl(conn, {"cmd": "tier_reply", "tier": "local"})
            return "local", pipe.receiver
    elif accept and want == "shm" and inner is not None:
        seg = grant_shm(msg)
        if seg is not None:
            # the proof's own mapping goes to the receiver (re-opening by
            # name would race the sender's unlinks)
            rx = ShmReceiver(conn, inner, seg,
                             slot_bytes=int(msg.get("slot_bytes",
                                                    DEFAULT_SLOT_BYTES)),
                             slots=int(msg.get("slots", depth)))
            send_ctrl(conn, {"cmd": "tier_reply", "tier": "shm"})
            return "shm", rx
    send_ctrl(conn, {"cmd": "tier_reply", "tier": "tcp"})
    return "tcp", None


# ---------------------------------------------------------------------------
# orphan sweep
# ---------------------------------------------------------------------------

def sweep_orphan_segments(shm_dir: str = "/dev/shm") -> list[str]:
    """Unlink every ``defer_shm_<pid>_*`` segment whose creator pid is dead
    — the backstop for chains whose both hop ends were killed (an end that
    survives reaps its own segments).  Returns the reaped names; a no-op
    on hosts without a ``/dev/shm``-style directory."""
    reaped: list[str] = []
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return reaped
    for name in names:
        if not name.startswith(SEG_PREFIX):
            continue
        pid_s, _, _ = name[len(SEG_PREFIX):].partition("_")
        try:
            pid = int(pid_s)
        except ValueError:
            continue
        if pid == os.getpid():
            continue  # this process's rings reap themselves
        try:
            os.kill(pid, 0)
            continue  # creator alive: the segment is (or may be) live
        except ProcessLookupError:
            pass
        except OSError:
            continue  # e.g. EPERM: alive under another uid — leave it
        try:
            os.unlink(os.path.join(shm_dir, name))
            reaped.append(name)
        except OSError:
            pass
    return reaped
