"""Serve-protocol client and the open-loop load generator.

The port's copy of ``defer_tpu.serve.client``, on the port's
``transport/framed.py``; its frames are byte-identical to the JAX
package's, so either package's client talks to either package's door.
:class:`ServeClient` speaks the front door's framed protocol: hello ->
samples -> END, with results and shed notices collected on a background
reader keyed by the client's own sample numbers.  :class:`LoadGenerator`
drives one client from a deterministic arrival trace
(:mod:`~defer_tpu_torch.serve.arrivals`) OPEN-LOOP: samples go out at
their scheduled instants whether or not earlier ones completed, so
measured p99 includes real queueing delay — the number closed-loop
benchmarking structurally cannot see.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from ..transport.framed import (K_CTRL, K_END, K_TENSOR_SEQ,
                                connect_retry, recv_frame, send_ctrl,
                                send_end, send_frame)


class ServeClient:
    """One tenant stream against a :class:`ServeFrontDoor`."""

    def __init__(self, host: str, port: int, tenant: str = "default", *,
                 weight: float = 1.0, priority: int = 0,
                 deadline_ms: float | None = None,
                 timeout_s: float = 120.0, **extra_hello):
        self._sock = connect_retry(host, port, timeout_s)
        self.tenant = tenant
        self.timeout_s = timeout_s
        send_ctrl(self._sock, {"cmd": "hello", "tenant": tenant,
                               "weight": weight, "priority": priority,
                               "deadline_ms": deadline_ms, **extra_hello})
        kind, msg = recv_frame(self._sock)
        if kind != K_CTRL or msg.get("cmd") != "welcome":
            raise ConnectionError(f"expected welcome, got {kind}/{msg}")
        self.welcome = msg
        #: seq -> ("ok", ndarray, t_recv) | ("shed", msg, t_recv)
        self.results: dict[int, tuple] = {}
        self.sent_at: dict[int, float] = {}
        self._seq = 0
        self._done = threading.Event()
        self._err: list[BaseException] = []
        self._lock = threading.Lock()
        self._rx = threading.Thread(target=self._reader, daemon=True,
                                    name="serve-client-rx")
        self._rx.start()

    def _reader(self) -> None:
        try:
            while True:
                kind, value = recv_frame(self._sock)
                now = time.monotonic()
                if kind == K_END:
                    self._done.set()
                    return
                if kind == K_TENSOR_SEQ:
                    seq, arr = value
                    with self._lock:
                        self.results[int(seq)] = ("ok", arr, now)
                elif kind == K_CTRL and isinstance(value, dict) \
                        and value.get("cmd") == "shed":
                    with self._lock:
                        self.results[int(value["seq"])] = \
                            ("shed", value, now)
                else:
                    raise ConnectionError(
                        f"unexpected reply frame {kind!r}")
        except BaseException as e:  # noqa: BLE001 — surfaced in finish()
            self._err.append(e)
            self._done.set()

    def submit(self, sample: np.ndarray) -> int:
        """Send one sample (tensor mode) / prompt (decode mode);
        returns its sequence number."""
        seq = self._seq
        self._seq += 1
        self.sent_at[seq] = time.monotonic()
        send_frame(self._sock, np.asarray(sample))
        return seq

    def finish(self, *, close: bool = True) -> dict[int, tuple]:
        """END the stream, wait for every admitted sample to resolve,
        return ``{seq: outcome}``."""
        send_end(self._sock)
        if not self._done.wait(self.timeout_s):
            raise TimeoutError(
                f"front door did not drain within {self.timeout_s:.0f}s")
        if self._err:
            raise self._err[0]
        if close:
            self._sock.close()
        return dict(self.results)

    def abort(self) -> None:
        """Cut the connection without an END (the disconnect tests).
        The shutdown sends the FIN now: a bare ``close`` would leave the
        connection open while this client's reader thread is still
        blocked in ``recv`` on the socket, and the door would not see the
        client leave."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def stream(self, samples) -> list:
        """Submit everything, finish, and return outcomes in send order."""
        seqs = [self.submit(s) for s in samples]
        results = self.finish()
        return [results.get(q) for q in seqs]


def fetch_stats(host: str, port: int, *, timeout_s: float = 30.0) -> dict:
    """One observer stats round-trip against a front door."""
    sock = connect_retry(host, port, timeout_s)
    try:
        send_ctrl(sock, {"cmd": "stats"})
        kind, msg = recv_frame(sock)
        if kind != K_CTRL or msg.get("cmd") != "stats_reply":
            raise ConnectionError(f"expected stats_reply, got {kind}")
        send_end(sock)
        return msg
    finally:
        sock.close()


def fetch_events(host: str, port: int, *, cursor: int = 0,
                 limit: int = 512, timeout_s: float = 30.0) -> dict:
    """One flight-recorder round-trip against a front door: the door
    process's events since ``cursor`` (``{"events", "cursor",
    "dropped"}`` — pass the returned cursor back for the next
    incremental batch).  The serving twin of a stage node's
    ``{"cmd": "events_since"}`` control query."""
    sock = connect_retry(host, port, timeout_s)
    try:
        send_ctrl(sock, {"cmd": "events_since", "cursor": int(cursor),
                         "limit": int(limit)})
        kind, msg = recv_frame(sock)
        if kind != K_CTRL or msg.get("cmd") != "events_reply":
            raise ConnectionError(f"expected events_reply, got {kind}")
        send_end(sock)
        return msg
    finally:
        sock.close()


def _quantile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))
    return ys[i]


class LoadGenerator:
    """Open-loop playback of an arrival trace through one client.

    ``samples`` may be shorter than the trace (cycled).  The sender
    honors the schedule even when the service lags — arrivals are not
    gated on completions — so the summary's p99 is the latency a real
    user at that arrival instant would have seen (admitted requests
    only; sheds are counted separately, with their own rate)."""

    def __init__(self, client: ServeClient, samples, offsets_s):
        self.client = client
        self.samples = list(samples)
        self.offsets = list(offsets_s)

    def run(self) -> dict:
        c = self.client
        t0 = time.monotonic()
        seqs = []
        for i, off in enumerate(self.offsets):
            lag = t0 + off - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            seqs.append(c.submit(self.samples[i % len(self.samples)]))
        results = c.finish()
        wall = time.monotonic() - t0
        lat_ok, shed = [], 0
        for q in seqs:
            out = results.get(q)
            if out is None:
                continue
            if out[0] == "ok":
                lat_ok.append(out[2] - c.sent_at[q])
            else:
                shed += 1
        return {
            "tenant": c.tenant,
            "offered": len(seqs),
            "completed": len(lat_ok),
            "shed": shed,
            "shed_rate": round(shed / max(1, len(seqs)), 4),
            "wall_s": round(wall, 4),
            "throughput_per_s": round(len(lat_ok) / max(wall, 1e-9), 3),
            "latency_p50_ms": round(_quantile(lat_ok, 0.50) * 1e3, 3),
            "latency_p95_ms": round(_quantile(lat_ok, 0.95) * 1e3, 3),
            "latency_p99_ms": round(_quantile(lat_ok, 0.99) * 1e3, 3),
            "latency_max_ms": round(max(lat_ok, default=0.0) * 1e3, 3),
        }
