"""Device-resident transport tier: live CUDA tensors handed across stages.

The port of ``defer_tpu.transport.ici``, where frames carry live
``jax.Array``s; here they carry live ``torch.Tensor``s.  Every other tier
round-trips the host on each hop: the producing stage copies its output to
the host (``local`` hands that copy by reference, ``shm`` through a ring),
and the consuming stage's program uploads it again.  This rung removes the
pair:

* :class:`IciPipe` — a bounded in-process frame stream (the
  :class:`~.local.LocalPipe` machinery: seq stamping, in-order K_CTRL,
  cascading K_END, bounded backpressure, peer death poisoning both ends)
  whose tensor frames are the producer's output tensors themselves.  No
  copy to the host, no codec, no socket payload: the consuming stage's
  program reads the tensor where it lies, and the only host copy left in
  a chain of ici hops is at its result edge.
* **Stream order.**  A tensor is handed over with a CUDA event recorded on
  the producer's current stream after the program that wrote it.  The
  receiver makes its own current stream wait on that event before the
  consuming program is queued, and when its stream is not the producer's
  it records the tensor on its stream (``record_stream``), so the caching
  allocator does not hand the block to the producer again while the
  consumer may still read it.  Nothing on the hop waits on the host: no
  ``torch.cuda.synchronize()``, no ``.cpu()``.
* **Cross-device hops** — when the receiver's stage runs on another card,
  :meth:`IciSender.send` moves the tensor with one
  ``tensor.to(device, non_blocking=True)`` (device to device, never via
  the host), ordered after the producer's event, and counts it in
  ``d2d``/``device_pairs`` and ``transport.ici_d2d``.  A same-device hop
  passes the tensor by reference.
* **Negotiation** — the probe carries ``{"cmd": "tier_probe", "want":
  "ici", backend, platform, device_ids, pid, proto, token}``, where the
  mesh identity comes from torch (backend ``"torch"``, platform ``cuda``
  or ``cpu``, the device indices).  The grantor accepts only when the
  protocol version and the pid match, the backend is torch (a JAX array
  and a torch tensor are not interchangeable), every offered device index
  resolves here on the grantor's platform, and the token resolves in this
  process's offer registry.  The ``tier_reply`` carries the receiver's
  device index so the sender knows where frames must land.  A refused
  offer degrades the hop down the ladder (``shm.offer_tier_ladder``).

Stage programs are functional: they never write to their input, so a
tensor handed over stays as the producer left it while the consumer reads
it.  Node programs run eagerly (a ``torch.export`` program, not a
CUDA-graph replay), so a handed-over output is a fresh allocation that no
later call overwrites; a node whose program is replayed from a CUDA-graph
pool must copy its output before handing it over here.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import NamedTuple

import torch

from ..obs import REGISTRY
from .framed import (K_CTRL, K_TENSOR, K_TENSOR_SEQ, PROTOCOL_VERSION,
                     recv_expect, send_ctrl)
from .local import LocalPipe, LocalReceiver, LocalSender, record_fallback

__all__ = ["IciPipe", "IciReceiver", "IciSender", "device_reply",
           "grant_ici", "offer_ici"]

#: tensor frames handed device-resident through ici pipes (ici hops touch
#: neither the wire counters nor the local/shm ones)
_ICI_FRAMES = REGISTRY.counter("transport.ici_frames")

#: cross-device moves performed by ici senders
_ICI_D2D = REGISTRY.counter("transport.ici_d2d")

#: token -> IciPipe: offers awaiting a grant.  Process-local: a live
#: tensor can only be handed within one address space, so an unresolvable
#: token refuses the offer.
_OFFERS: dict[str, "IciPipe"] = {}
_OFFERS_LOCK = threading.Lock()

#: the backend an ici probe of this package names
BACKEND = "torch"


class _Handoff(NamedTuple):
    """A tensor in an ici pipe, with the event its producer recorded after
    writing it and the stream it recorded on (None off the card)."""

    tensor: object
    event: object
    stream: object


def _device_index(device: torch.device) -> int:
    return 0 if device.index is None else device.index


def _record(tensor) -> tuple:
    """(event, stream): an event recorded on ``tensor``'s device's current
    stream, or (None, None) for a tensor that is not on a CUDA card."""
    dev = getattr(tensor, "device", None)
    if dev is None or dev.type != "cuda":
        return None, None
    stream = torch.cuda.current_stream(dev)
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev, stream


def _to_device(tensor, dest: torch.device, event):
    """``tensor`` moved to ``dest`` on ``dest``'s current stream, after
    ``event``: one device-to-device copy."""
    stream = torch.cuda.current_stream(dest)
    if event is not None:
        stream.wait_event(event)
    with torch.cuda.stream(stream):
        return tensor.to(dest, non_blocking=True)


class IciSender(LocalSender):
    """Producer end of an ici hop (the AsyncSender surface).

    ``send`` keeps the tensor on the card: a same-device hop hands it over
    by reference with its producer's event; a hop whose receiver runs on
    another card pays one device-to-device move, counted in ``d2d`` and
    ``device_pairs``.  Host frames (numpy inputs at the dispatcher's feed
    edge) pass by reference, and the receiving program uploads them as it
    would off any other tier.  Everything else is the LocalSender
    contract.
    """

    codec = "ici"   #: nominal; no codec and no host byte touch an ici hop

    def __init__(self, pipe: "IciPipe"):
        super().__init__(pipe)
        #: the receiver's ``torch.device`` (from the tier_reply), or None
        self.dest_device: torch.device | None = None
        #: cross-device moves this sender performed
        self.d2d = 0
        #: distinct (src index, dst index) pairs of those moves
        self.device_pairs: set[tuple[int, int]] = set()

    def send(self, arr, *, seq: int | None = None) -> None:
        item = arr
        if isinstance(arr, torch.Tensor):
            event, stream = _record(arr)
            dest = self.dest_device
            src = arr.device
            if dest is not None and src.type == "cuda" \
                    and dest.type == "cuda" and src != dest:
                arr = _to_device(arr, dest, event)
                event, stream = _record(arr)
                self.d2d += 1
                _ICI_D2D.n += 1
                self.device_pairs.add((_device_index(src),
                                       _device_index(dest)))
            item = _Handoff(arr, event, stream)
        if seq is None:
            self._put((K_TENSOR, item))
        else:
            self._put((K_TENSOR_SEQ, (seq, item)))
        _ICI_FRAMES.n += 1


def _adopt(item):
    """The consumer's half of the handoff: order its current stream after
    the producer's event, and keep the block alive for its stream."""
    if not isinstance(item, _Handoff):
        return item
    tensor, event, stream = item
    if event is not None:
        mine = torch.cuda.current_stream(tensor.device)
        mine.wait_event(event)
        if mine != stream:
            tensor.record_stream(mine)
    return tensor


class IciReceiver(LocalReceiver):
    """Consumer end of an ici hop (the AsyncReceiver surface): tensor
    frames come out as the producer's tensors, with this thread's stream
    ordered after their producer's work."""

    def _got(self, item) -> tuple:
        kind, value = super()._got(item)
        if kind == K_TENSOR:
            return kind, _adopt(value)
        if kind == K_TENSOR_SEQ:
            return kind, (value[0], _adopt(value[1]))
        return kind, value


class IciPipe(LocalPipe):
    """One bounded in-process stream of device-resident frames."""

    sender_cls = IciSender
    receiver_cls = IciReceiver


# ---------------------------------------------------------------------------
# negotiation
# ---------------------------------------------------------------------------

def _register(pipe: IciPipe) -> str:
    token = uuid.uuid4().hex
    with _OFFERS_LOCK:
        _OFFERS[token] = pipe
    return token


def _claim(token) -> IciPipe | None:
    with _OFFERS_LOCK:
        return _OFFERS.pop(token, None)


def _mesh_ident(device: torch.device | None = None) -> dict:
    """This side's half of the same-mesh proof: the backend, the platform
    and the device indices its outputs live on."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {"backend": BACKEND, "platform": dev.type,
            "device_ids": [_device_index(dev)]}


def _resolves(platform, index) -> bool:
    """Whether ``platform`` device ``index`` exists in this process."""
    if not isinstance(index, int) or isinstance(index, bool) or index < 0:
        return False
    if platform == "cpu":
        return index == 0
    if platform == "cuda":
        return torch.cuda.is_available() \
            and index < torch.cuda.device_count()
    return False


def device_reply(device: torch.device | None):
    """The device index an ici ``tier_reply`` carries for ``device``."""
    return None if device is None else _device_index(device)


def offer_ici(sock, *, depth: int = 8, hop: str | None = None,
              device: torch.device | None = None, fallback: bool = True
              ) -> tuple[str, IciSender | None]:
    """Offer the device-resident tier on a freshly dialed data socket.

    Sends the ``tier_probe`` (the first frame on the connection) with this
    side's identity — ``device`` is where its outputs live — and waits for
    the ``tier_reply``.  Granted: ``("ici", sender)`` with the sender's
    ``dest_device`` set from the reply, the socket staying open as the
    hop's lifetime anchor.  Refused (another process, another platform, a
    JAX peer, a tcp-pinned peer): ``("tcp", None)``, counting one fallback
    when ``fallback`` — the ladder passes ``False`` when it offers the
    next rung on the same socket."""
    ident = _mesh_ident(device)
    pipe = IciPipe(depth=depth)
    token = _register(pipe)
    try:
        send_ctrl(sock, {"cmd": "tier_probe", "want": "ici",
                         "pid": os.getpid(), "proto": PROTOCOL_VERSION,
                         "token": token, **ident})
        reply = recv_expect(sock, K_CTRL)
    finally:
        _claim(token)  # a granted probe was already claimed by the peer
    if isinstance(reply, dict) and reply.get("cmd") == "tier_reply" \
            and reply.get("tier") == "ici":
        sender: IciSender = pipe.sender
        idx = reply.get("device")
        if idx is not None:
            sender.dest_device = torch.device(ident["platform"], int(idx)) \
                if ident["platform"] == "cuda" else torch.device("cpu")
        return "ici", sender
    if fallback:
        record_fallback(hop)
    return "tcp", None


def grant_ici(msg, *, device: torch.device | None = None) -> IciPipe | None:
    """Validate one ici ``tier_probe``; return the offered pipe when the
    same-process and same-mesh claims both hold, else None (the caller
    replies tcp or the next rung).

    Checks, in order: the probe wants ``ici``; the protocol version
    matches; the peer's pid is this process's; the backend is torch; the
    platform is the grantor's own (``device``'s type, when given); every
    offered device index resolves here; and the token resolves in this
    process's offer registry."""
    if not isinstance(msg, dict) or msg.get("want") != "ici":
        return None
    try:
        if int(msg.get("proto", -1)) != PROTOCOL_VERSION:
            return None
        if int(msg.get("pid", -1)) != os.getpid():
            return None
    except (TypeError, ValueError):
        return None
    if msg.get("backend") != BACKEND:
        return None
    platform = msg.get("platform")
    if device is not None and torch.device(device).type != platform:
        return None
    ids = msg.get("device_ids")
    if not isinstance(ids, (list, tuple)) or not ids:
        return None
    if not all(_resolves(platform, i) for i in ids):
        return None
    return _claim(msg.get("token"))
