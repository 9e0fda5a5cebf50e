"""Framed stream transport for the host edge: the port of
``defer_tpu.transport.framed``.

The reference's entire distributed backend is a hand-rolled framed TCP
protocol: 8-byte big-endian length prefix, fixed-size chunking,
non-blocking sockets parked on select() (reference
src/node_state.py:43-101).  Here the stages share one card, and this module
serves the edge the card does not cover: a remote client streaming
inference inputs to (and results from) the pipeline host
(``Defer.serve_endpoint``).

The wire format is the JAX package's, byte for byte (protocol v2, the same
frame kinds, header, codec names and dtype strings), so a client of either
package talks to an endpoint of the other.  Design differences from the
reference, on purpose:
  * Blocking sockets + memoryview scatter/gather writes instead of
    non-blocking + select-spin: simpler, same throughput, no EAGAIN loops.
  * One connection carries typed frames (header with kind/shape/dtype/codec)
    instead of three fixed single-purpose ports (5000/5001/5002,
    reference src/node.py:17).
  * Codec is negotiated per frame (raw / lzb / blockfloat+lzb), not
    hardwired, and encode/decode are symmetric (the reference's decode
    sides are asymmetric — SURVEY.md §3.5).

bfloat16: numpy has no bfloat16 without ``ml_dtypes``, which the port does
not need.  A ``torch.bfloat16`` tensor is sent as its 16-bit pattern under
the dtype string ``"bfloat16"`` (the float codecs encode its float32
values, as the JAX package does), and a ``"bfloat16"`` frame decodes to a
``torch.bfloat16`` tensor through an int16 view.  Every other tensor frame
decodes to a numpy array.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from ..codec import BlockFloatCodec, Codec, LosslessCodec, PipelineCodec, RawCodec
from ..obs import REGISTRY


def _env_int(name: str) -> int:
    v = os.environ.get(name, "")
    return int(v) if v else 0


#: default kernel socket buffer sizes for data sockets (bytes; 0 = leave
#: the kernel default).  Overridable per process via environment or the
#: ``--sock-buf`` CLI flag; big cross-host hops with high bandwidth-delay
#: product want these raised well past the Linux default.
SOCK_SNDBUF = _env_int("DEFER_SOCK_SNDBUF")
SOCK_RCVBUF = _env_int("DEFER_SOCK_RCVBUF")


def default_sock_buf(max_frame_bytes: int, *, floor: int = 1 << 16,
                     ceil: int = 1 << 23) -> int:
    """SO_SNDBUF/SO_RCVBUF sized to a chain's fattest boundary frame.

    Two frames of headroom (one draining into the kernel while the next
    encodes), clamped to [64 KiB, 8 MiB]: below the floor small-tensor
    chains would lose to syscall churn, above the ceiling a 100 MB
    activation should flow-control rather than buffer whole in the
    kernel.  Callers derive ``max_frame_bytes`` from the partition's
    boundary specs (``graph.analysis.max_activation_bytes``) instead of
    guessing a flat constant.
    """
    return max(floor, min(ceil, 2 * int(max_frame_bytes)))


def configure_socket(sock: socket.socket, *, nodelay: bool = True,
                     sndbuf: int | None = None,
                     rcvbuf: int | None = None) -> socket.socket:
    """Tune a data socket: TCP_NODELAY plus optional SO_SNDBUF/SO_RCVBUF.

    Every frame here is a complete message the peer is waiting on —
    small K_CTRL/K_ACK/K_END frames under Nagle + delayed ACK add up to
    ~40 ms stalls per handshake on localhost chains, so NODELAY is the
    default on every data socket.  Non-TCP sockets (AF_UNIX socketpairs
    in tests) are left untouched, and objects that are not sockets (test
    doubles, in-memory channels) are returned as they are.
    """
    if not isinstance(sock, socket.socket):
        return sock  # not a socket (test double / in-memory channel)
    if sndbuf is None:
        sndbuf = SOCK_SNDBUF
    if rcvbuf is None:
        rcvbuf = SOCK_RCVBUF
    try:
        if nodelay:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not TCP (e.g. AF_UNIX)
    try:
        if sndbuf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
        if rcvbuf:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    except OSError:
        pass
    return sock


def connect_retry(host: str, port: int, timeout_s: float = 30.0,
                  *, base_delay_s: float = 0.05,
                  max_delay_s: float = 1.0) -> socket.socket:
    """Connect to a peer that may still be booting: exponential backoff
    with full jitter (50 ms envelope doubling to 1 s) capped by the
    ``timeout_s`` deadline, returning a :func:`configure_socket`-tuned
    connection.  The one retry policy for every control/data dial in
    the chain (stage nodes, dispatcher, monitor subscriptions, failover
    re-dials).  Jitter matters on the failover path: R replica channels
    re-dialing a respawned process on a fixed cadence would arrive in
    lockstep bursts.  Every failed attempt emits a ``redial`` flight-
    recorder event, so ``monitor --events`` attributes exactly how a
    failover re-dial converged (docs/ROBUSTNESS.md)."""
    import random

    deadline = time.monotonic() + timeout_s
    envelope = base_delay_s
    attempt = 0
    while True:
        try:
            # per-attempt connect timeout is bounded by the remaining
            # deadline, so the LAST attempt cannot overshoot the cap
            budget = max(0.001, min(timeout_s,
                                    deadline - time.monotonic()))
            return configure_socket(
                socket.create_connection((host, port), timeout=budget))
        except OSError as e:
            attempt += 1
            now = time.monotonic()
            if now >= deadline:
                raise
            # full jitter: uniform over the exponential envelope,
            # clipped to what the deadline still allows
            delay = min(random.uniform(0.0, envelope), deadline - now)
            from ..obs.events import emit as _emit
            _emit("redial", addr=f"{host}:{port}", attempt=attempt,
                  delay_ms=round(delay * 1e3, 3),
                  error=type(e).__name__)
            time.sleep(delay)
            envelope = min(envelope * 2, max_delay_s)

#: frame kinds
K_TENSOR = 1
K_BYTES = 2
K_END = 3
K_CTRL = 4   # JSON control message (deploy/reweight handshake)
K_ACK = 5    # the reference's 1-byte \x06 ACK (src/node.py:42), framed
K_TENSOR_SEQ = 6  # v2: K_TENSOR + a u64 sequence number after the header

#: wire protocol version.  v2 adds K_TENSOR_SEQ: a tensor frame carrying
#: a monotonically increasing stream sequence number (u64, big-endian,
#: between the fixed header and the codec name) so frames that travel
#: parallel paths — data-parallel stage replicas — can be merged back
#: into strict stream order at the fan-in (docs/TRANSPORT.md).  v1
#: receivers reject kind 6 loudly; every other frame kind is unchanged.
PROTOCOL_VERSION = 2

_CODECS: dict[str, Codec] = {}
#: creation lock: ``TensorClient.infer_stream`` decodes on a receiver
#: thread while the sender encodes — both may fault the same codec in.
#: Reads stay lock-free (dict get under the GIL); only misses lock.
_CODECS_LOCK = threading.Lock()

# wire telemetry: per-hop frame/byte counters plus codec encode/decode
# latency histograms, all in the process registry.  Plain attribute
# increments on the hot path; a snapshot is only paid when exported.
_TX_FRAMES = REGISTRY.counter("transport.tx_frames")
_TX_BYTES = REGISTRY.counter("transport.tx_bytes")
_RX_FRAMES = REGISTRY.counter("transport.rx_frames")
_RX_BYTES = REGISTRY.counter("transport.rx_bytes")
_ENC_HIST = REGISTRY.histogram("codec.encode_s")
_DEC_HIST = REGISTRY.histogram("codec.decode_s")


class _SleepCodec(Codec):
    """Test/bench-only wrapper: a real codec plus a fixed per-side delay.

    ``sleep<ms>+<codec>`` models per-hop phases a CPU-bound localhost
    chain cannot express (accelerator compute, NIC serialization): the
    sleep occupies wall time without occupying the CPU, which is exactly
    the resource profile the rx/compute/tx overlap is built for.  The
    wire payload is byte-identical to the wrapped codec's, and so is the
    frame's codec field: it carries the whole ``sleep...`` name, as the
    JAX package's does.  Never pick it for deployments.

    ``esleep<ms>+<codec>`` / ``dsleep<ms>+<codec>`` delay only the
    encode / only the decode side, so a bench can place the modeled time
    on one chosen process of a chain.
    """

    name = "sleep"

    def __init__(self, delay_s: float, inner: Codec, *,
                 enc: bool = True, dec: bool = True):
        self._delay_s = delay_s
        self.inner = inner
        self._enc = enc
        self._dec = dec

    def encode(self, arr):
        if self._enc:
            time.sleep(self._delay_s)
        return self.inner.encode(arr)

    def decode(self, data, shape, dtype):
        if self._dec:
            time.sleep(self._delay_s)
        return self.inner.decode(data, shape, dtype)


def _make_codec(name: str) -> Codec:
    if name == "raw":
        return RawCodec()
    if name == "lzb":
        return LosslessCodec()
    if name.startswith("bf"):
        return PipelineCodec(bits=int(name[2:]))
    if name.startswith("sleep"):
        head, _, inner = name.partition("+")
        return _SleepCodec(float(head[5:]) / 1e3, _make_codec(inner or "raw"))
    if name.startswith("esleep") or name.startswith("dsleep"):
        head, _, inner = name.partition("+")
        return _SleepCodec(float(head[6:]) / 1e3, _make_codec(inner or "raw"),
                           enc=name[0] == "e", dec=name[0] == "d")
    raise ValueError(f"unknown codec {name!r}")


def _is_float_codec(codec: Codec) -> bool:
    """Whether ``codec`` (or the codec a sleep wrapper holds) encodes float
    values rather than bytes."""
    while isinstance(codec, _SleepCodec):
        codec = codec.inner
    return isinstance(codec, (BlockFloatCodec, PipelineCodec))


def _codec(name: str) -> Codec:
    c = _CODECS.get(name)
    if c is not None:
        return c
    with _CODECS_LOCK:
        c = _CODECS.get(name)
        if c is None:
            c = _CODECS[name] = _make_codec(name)
    return c


# header: kind u8 | codec len u8 | dtype len u8 | ndim u8 | payload len u64
_HDR = struct.Struct(">BBBBQ")
MAX_FRAME = 1 << 34  # 16 GiB sanity bound


def wire_dtype(dtype) -> str:
    """The dtype string a frame (or shm doorbell descriptor) ships:
    numpy's ``.str`` for builtin dtypes, the registered NAME (e.g.
    ``bfloat16``) for extension dtypes whose ``.str`` is an opaque void
    alias (``<V2``) that would decode as raw bytes on the far end."""
    s = dtype.str
    if np.dtype(s) != dtype:
        return dtype.name
    return s


#: the dtype string of a bfloat16 frame (the JAX package's ``wire_dtype``
#: of an ``ml_dtypes`` bfloat16 array)
BF16 = "bfloat16"


def dtype_from_wire(s: str):
    """Inverse of :func:`wire_dtype`: a numpy dtype, or ``torch.bfloat16``
    for a ``"bfloat16"`` string (the bf16 rule above; no ``ml_dtypes``)."""
    if s == BF16:
        return torch.bfloat16
    return np.dtype(s)


def _as_sendable(x, codec: Codec) -> tuple[np.ndarray, str]:
    """(array the codec encodes, dtype string) of a frame's value.  A
    ``torch.bfloat16`` tensor travels as its bit pattern (int16) for the
    byte codecs and as its float32 values for the float codecs."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            if _is_float_codec(codec):
                return t.float().numpy(), BF16
            return t.contiguous().view(torch.int16).numpy(), BF16
        x = t.numpy()
    arr = np.asarray(x)
    return arr, wire_dtype(arr.dtype)


def _decode_value(codec: Codec | None, buf, dtype: str, shape):
    """One tensor frame's payload -> its value (``codec`` None = raw,
    zero-copy over ``buf``): a numpy array, or a ``torch.bfloat16`` tensor
    for a bfloat16 frame."""
    if dtype != BF16:
        dt = np.dtype(dtype)
        if codec is None:
            return np.frombuffer(buf, dtype=dt).reshape(shape)
        return codec.decode(memoryview(buf), shape, dt)
    if _is_float_codec(codec):
        vals = codec.decode(memoryview(buf), shape, np.float32)
        return torch.from_numpy(vals).to(torch.bfloat16)  # round to nearest
    if codec is None:
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
    else:
        bits = codec.decode(memoryview(buf), shape, np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _sendv(sock: socket.socket, *parts) -> None:
    """Scatter-gather sendall (``sendmsg``/writev): the frame goes out as
    one syscall per kernel-buffer fill with NO concatenation copy of the
    payload — the old ``hdr + cname + meta + payload`` built a second
    multi-megabyte buffer per activation frame."""
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:  # platform without sendmsg: one copy, one sendall
        sock.sendall(b"".join(bytes(p) for p in parts))
        return
    views = [memoryview(p).cast("B") for p in parts if len(p)]
    while views:
        n = sendmsg(views)
        while views and n >= len(views[0]):
            n -= len(views[0])
            del views[0]
        if n:
            views[0] = views[0][n:]


def send_frame(sock: socket.socket, arr_or_bytes, *, codec: str = "raw",
               seq: int | None = None, on_encode=None):
    """Send one typed frame (tensor or raw bytes).  A tensor is a numpy
    array or a torch tensor (copied to the host).

    ``seq`` (tensor frames only) stamps the frame with a u64 stream
    sequence number (kind ``K_TENSOR_SEQ``, protocol v2) so a fan-in
    downstream of data-parallel replicas can restore stream order.
    ``on_encode(dt_s)`` is called with the encode seconds of a tensor
    frame — per-CHANNEL cost attribution (the process-wide
    ``codec.encode_s`` histogram records regardless)."""
    if isinstance(arr_or_bytes, (bytes, bytearray, memoryview)):
        kind, payload = K_BYTES, arr_or_bytes  # scatter-gather: no copy
        meta = b""
        cname = b"raw"
        ndim = 0
    else:
        c = _codec(codec)
        arr, wdt = _as_sendable(arr_or_bytes, c)
        kind = K_TENSOR if seq is None else K_TENSOR_SEQ
        t0 = time.perf_counter()
        if codec == "raw":
            # zero-copy: the payload is a view of the array's own buffer
            # (ascontiguousarray is a no-op for the usual contiguous case)
            try:
                payload = memoryview(np.ascontiguousarray(arr)).cast("B")
            except (TypeError, ValueError):  # 0-d / exotic dtypes
                payload = c.encode(arr)
        else:
            payload = c.encode(arr)
        dt = time.perf_counter() - t0
        _ENC_HIST.record(dt)
        if on_encode is not None:
            on_encode(dt)
        cname = codec.encode()
        dt = wdt.encode()
        meta = dt + b"".join(struct.pack(">Q", s) for s in arr.shape)
        ndim = arr.ndim
    dt_len = len(meta) - 8 * ndim if kind != K_BYTES else 0
    plen = payload.nbytes if isinstance(payload, memoryview) else len(payload)
    hdr = _HDR.pack(kind, len(cname), dt_len, ndim, plen)
    # v2: the sequence number rides between the fixed header and the
    # codec name, so every later field keeps its v1 offset relative to it
    pre = struct.pack(">Q", seq) if kind == K_TENSOR_SEQ else b""
    _sendv(sock, hdr + pre + cname + meta, payload)
    _TX_FRAMES.n += 1
    _TX_BYTES.n += _HDR.size + len(pre) + len(cname) + len(meta) + plen


def send_end(sock: socket.socket):
    sock.sendall(_HDR.pack(K_END, 0, 0, 0, 0))


def send_ctrl(sock: socket.socket, msg: dict):
    """Send one JSON control frame (the control-plane channel: deploy,
    reweight — reference src/dispatcher.py:58-63's arch+topology send)."""
    import json as _json
    payload = _json.dumps(msg).encode()
    sock.sendall(_HDR.pack(K_CTRL, 0, 0, 0, len(payload)) + payload)


def send_ack(sock: socket.socket):
    sock.sendall(_HDR.pack(K_ACK, 0, 0, 0, 0))


def recv_expect(sock: socket.socket, kind: int) -> Any:
    """Receive one frame and demand its kind — loud handshake errors."""
    got, value = recv_frame(sock)
    if got != kind:
        raise ConnectionError(f"expected frame kind {kind}, got {got} "
                              f"({value if got == K_CTRL else ''})")
    return value


def _recv_into(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into a fresh buffer — returned as the
    bytearray itself, NOT a ``bytes(buf)`` copy: tensor payloads go
    straight to ``np.frombuffer``/codec decode over this buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return buf


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    return bytes(_recv_into(sock, n))


def recv_frame(sock: socket.socket, *, on_decode=None) -> tuple[int, Any]:
    """Receive one frame -> (kind, payload).  Tensor frames are decoded to
    ndarrays (``torch.bfloat16`` tensors for bfloat16 frames); K_END returns (K_END, None); K_TENSOR_SEQ (protocol v2)
    returns (K_TENSOR_SEQ, (seq, ndarray)).  ``on_decode(dt_s)`` is
    called with the decode seconds of a tensor frame — per-CHANNEL cost
    attribution, excluding the blocking recv wait (the process-wide
    ``codec.decode_s`` histogram records regardless)."""
    kind, clen, dlen, ndim, plen = _HDR.unpack(_recv_into(sock, _HDR.size))
    _RX_FRAMES.n += 1
    _RX_BYTES.n += _HDR.size + clen + dlen + 8 * ndim + plen
    if kind == K_END:
        return K_END, None
    if kind == K_ACK:
        return K_ACK, None
    if plen > MAX_FRAME:
        raise ValueError(f"frame of {plen} bytes exceeds bound")
    if kind == K_CTRL:
        import json as _json
        return K_CTRL, _json.loads(_recv_into(sock, plen).decode())
    seq = None
    if kind == K_TENSOR_SEQ:
        seq = struct.unpack(">Q", _recv_into(sock, 8))[0]
        _RX_BYTES.n += 8
    cname = _recv_into(sock, clen).decode()
    if kind == K_BYTES:
        return K_BYTES, _recv_exact(sock, plen)
    dt = _recv_into(sock, dlen).decode()
    shape = tuple(struct.unpack(">Q", _recv_into(sock, 8))[0]
                  for _ in range(ndim))
    buf = _recv_into(sock, plen)
    t0 = time.perf_counter()
    # raw is zero-copy: the returned value is a view over the rx buffer
    # (freshly allocated per frame, so it is exclusively owned)
    value = _decode_value(None if cname == "raw" else _codec(cname), buf,
                          dt, shape)
    dt_dec = time.perf_counter() - t0
    _DEC_HIST.record(dt_dec)
    if on_decode is not None:
        on_decode(dt_dec)
    if seq is not None:
        return K_TENSOR_SEQ, (seq, value)
    return K_TENSOR, value


class TensorServer:
    """Accepts one client streaming tensor frames; hands them to a callback
    and streams result frames back.  This is the host front door of a
    pipeline deployment — the role of the dispatcher's paired data socket +
    result server (reference src/dispatcher.py:85-105), on one connection.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()

    def serve_once(self, handler, *, codec: str = "raw"):
        """Accept one client; for each tensor frame, reply with
        handler(array) as a tensor frame.  Returns after the client's END
        frame (echoed back)."""
        conn, _ = self._srv.accept()
        configure_socket(conn)
        try:
            while True:
                kind, value = recv_frame(conn)
                if kind == K_END:
                    send_end(conn)
                    return
                send_frame(conn, handler(value), codec=codec)
        finally:
            conn.close()

    def close(self):
        self._srv.close()


class TensorClient:
    """Client side: request/reply ``infer`` or full-duplex ``infer_stream``.

    ``timeout_s`` bounds how long ``infer_stream`` waits for the endpoint
    to drain after the last input (per-call override available); the old
    hardcoded 600 s default is kept for compatibility."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 600.0):
        self._sock = configure_socket(socket.create_connection((host, port)))
        self.timeout_s = timeout_s

    def infer(self, arr: np.ndarray, *, codec: str = "raw") -> np.ndarray:
        send_frame(self._sock, arr, codec=codec)
        kind, value = recv_frame(self._sock)
        if kind != K_TENSOR:
            raise ConnectionError("expected tensor reply")
        return value

    def infer_stream(self, arrays, *, codec: str = "raw",
                     timeout_s: float | None = None) -> list:
        """Pipelined streaming against a ``Defer.serve_endpoint``: sends
        every input without waiting (keeping the remote pipeline full),
        collects in-order replies concurrently, ends the stream, and
        returns all results.  One call = the reference harness's whole
        send-loop + result-server pair (reference test/test.py:39-51).

        ``timeout_s`` bounds the post-END drain wait (default: the
        client's ``timeout_s``)."""
        if timeout_s is None:
            timeout_s = self.timeout_s

        results: list[np.ndarray] = []
        err: list[BaseException] = []

        def rx():
            try:
                while True:
                    kind, value = recv_frame(self._sock)
                    if kind == K_END:
                        return
                    results.append(value)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                err.append(e)

        t = threading.Thread(target=rx, daemon=True)
        t.start()
        try:
            for a in arrays:
                if err:
                    break  # endpoint died: fail fast instead of pumping
                    # sends into a full socket buffer (sendall can block
                    # forever against a peer that stopped draining)
                send_frame(self._sock, a, codec=codec)
            if not err:
                send_end(self._sock)
        except OSError:
            # the send side broke: prefer the rx thread's root cause
            t.join(timeout=5.0)
            if not err:
                raise
        t.join(timeout=timeout_s)
        if err:
            raise err[0]
        if t.is_alive():
            raise TimeoutError(
                f"endpoint did not drain within {timeout_s:.0f}s")
        return results

    def close(self):
        try:
            send_end(self._sock)
            recv_frame(self._sock)
        except (OSError, ConnectionError):
            pass  # stream already ended / peer gone
        finally:
            self._sock.close()
