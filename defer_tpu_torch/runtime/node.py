"""Standalone stage-node processes: the linear process chain.

The port of the linear part of ``defer_tpu.runtime.node``.  Reference
parity: the reference's compute node is a separate process on another
machine that receives its partition, then serves the chain forever —
recv activation, predict, relay to its successor (reference
src/node.py:80-108, boot at src/node.py:110-127).  The last node relays
back to the dispatcher (reference src/dispatcher.py:51-55).

The port keeps the JAX package's design:

* The partition arrives as an exported program plus weights
  (``utils/export.py``: a ``torch.export`` artifact, loaded with no model
  code and placed on the node's device; attention runs the hand kernel
  through the ``defer_tpu_torch::flash_attention`` operator).
* One typed framed connection per hop (``transport/framed.py``, frames
  byte-identical to the JAX package's, so JAX and port nodes chain
  together); the hop codec (raw / lzb / blockfloat) is symmetric.
* Readiness is connect-with-retry, and shutdown is an in-band END frame
  that cascades down the chain.

A node's program runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA and no explicit CPU it raises.  The
dispatch is asynchronous on the card: a CUDA event recorded after the
program marks the frame, the overlapped loop keeps up to ``inflight``
frames un-synced, and the DEVICE phase waits on the event before the
HOST_SYNC phase copies the output to the host.

What this module leaves out raises ``NotImplementedError`` naming the
ROADMAP item that brings it: replicas, fan-in and failover (A10b),
branches and joins (A10c), the colocated transport tiers (A10d), clock
alignment, live telemetry pushes and profiling sessions (A12).
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..obs import REGISTRY, LatencyHistogram, new_span_id, tracer
from ..obs.events import emit as emit_event
from ..obs.events import recorder
from ..transport.channel import AsyncReceiver, AsyncSender, _sampled
from ..transport.framed import (K_ACK, K_BYTES, K_CTRL, K_END, K_TENSOR,
                                K_TENSOR_SEQ, configure_socket,
                                connect_retry, recv_expect, recv_frame,
                                send_ack, send_ctrl, send_end, send_frame)
from ..transport.local import answer_probe
from ..utils.config import resolve_device

#: serve()-loop sentinel a ``shutdown`` control command enqueues: a
#: persistent node returns its accumulated stream total NOW
_SHUTDOWN = object()

#: the transport tiers the JAX package negotiates, and the ones the port
#: has; the rest raise (ROADMAP A10d)
_TIERS = ("tcp", "auto", "local", "shm", "ici")
_PORT_TIERS = ("tcp", "auto")


def _not_ported(item: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP item {item}); the port runs "
        f"the linear chain")


def _check_tier(tier: str, who: str) -> str:
    if tier not in _TIERS:
        raise ValueError(f"{who}: tier must be tcp|auto|local|shm|ici, "
                         f"got {tier!r}")
    if tier not in _PORT_TIERS:
        raise _not_ported("A10d", f"the {tier!r} transport tier")
    return tier


def _parse_hostport(s: str, default_host: str = "127.0.0.1"
                    ) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or default_host), int(port)


def _parse_hop(s: str) -> tuple[str, int]:
    """``host:port`` -> (host, port).  A comma list names replicas of the
    downstream stage, which the port does not run yet."""
    hops = [p for p in s.split(",") if p]
    if len(hops) != 1:
        raise _not_ported("A10b", "a replicated downstream stage (fan-out)")
    return _parse_hostport(hops[0])


def _kernel_launches() -> dict[str, int]:
    """Each hand kernel's launches in this process."""
    from ..ops.launches import counted_kernels
    return {k.name: k.launches for k in counted_kernels()}


class StageNode:
    """One compute node of a process chain: recv -> stage program -> relay.

    ``python -m defer_tpu_torch node --listen :5000`` boots an EMPTY node
    that receives its stage artifact in-band over the control handshake,
    as the reference node gets its model over the wire
    (src/node.py:20-55).  ``artifact`` (a path) pre-loads one instead, with
    ``next_hop`` naming the successor.

    ``device`` is where the stage program runs: the CUDA card by default;
    ``"cpu"`` only when asked.  ``tier`` is the outbound transport-tier
    policy: ``"tcp"``, or ``"auto"``, which walks the rungs the port has —
    tcp alone, so it sends no probe.  ``tier_accept`` would grant inbound
    colocated-tier offers; the port answers every offer with tcp.
    """

    def __init__(self, artifact: str | None, listen: str,
                 next_hop: str | None, *, codec: str = "raw",
                 overlap: bool = True, rx_depth: int = 8,
                 tx_depth: int = 8, inflight: int = 2,
                 infer_delay_s: float = 0.0, tier: str = "tcp",
                 tier_accept: bool = False, device=None,
                 persist: bool = False):
        self.tier = _check_tier(tier, "StageNode")
        if tier_accept:
            raise _not_ported("A10d", "granting a colocated transport tier")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the CUDA context, made before the bind is announced: chain
            # processes boot theirs in parallel, not at their deploy turn
            torch.empty(0, device=self.device)
        from ..utils.export import load_stage_program
        host, port = _parse_hostport(listen, "0.0.0.0")
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self.prog = None
        if artifact is not None:
            self.prog = load_stage_program(artifact, device=self.device)
        self.next_hop = _parse_hop(next_hop) if next_hop else None
        self.codec = codec
        self.overlap = overlap
        self.rx_depth = rx_depth
        self.tx_depth = tx_depth
        self.inflight = max(1, inflight)
        self.infer_delay_s = max(0.0, float(infer_delay_s))
        self.persist = bool(persist)
        self.tier_out: str | None = None
        self.tier_in: str | None = None
        self.processed = 0    # tensors relayed, lifetime
        self.reweights = 0    # weights-only re-pushes accepted
        #: analytic stage FLOPs a deploy may carry (the JAX dispatcher
        #: ships them); reported, not yet divided into an MFU (A12)
        self.stage_flops: float | None = None
        #: waterfall sampling period carried by the trace context (0 =
        #: every frame records spans, N >= 1 = only wire-seq multiples)
        self.trace_sample_every = 0
        #: trace-context K_CTRL received from upstream, held until this
        #: node opens its downstream connection so the context cascades
        #: hop by hop through the whole chain
        self._pending_trace: dict | None = None
        self._done_q: queue.Queue | None = None
        #: live data-path channels (set once a connection proves to be
        #: the stream)
        self._live_rx = None
        self._live_tx = None
        #: per-NODE histograms (the registry's ``node.*_s`` twins are
        #: process-wide, shared by in-process thread chains): the infer
        #: interval and its four phases — dispatch (the program call
        #: returning), queue (residency in the un-synced window), device
        #: (the CUDA event's wait), host_sync (the copy to the host)
        self.infer_hist = LatencyHistogram()
        self.disp_hist = LatencyHistogram()
        self.queue_hist = LatencyHistogram()
        self.dev_hist = LatencyHistogram()
        self.host_sync_hist = LatencyHistogram()

    @property
    def manifest(self):
        return None if self.prog is None else self.prog.manifest

    def _span_label(self) -> str:
        m = self.manifest
        return (f"stage{m['index']}" if m is not None
                else f"node{self.address[1]}")

    # -- the four phases of a frame ------------------------------------------

    def _phase(self, hist, name: str, t0: float, t_end: float, seq) -> None:
        dt = t_end - t0
        REGISTRY.histogram(f"node.{name}_s").record(dt)
        hist.record(dt)
        tr = tracer()
        if tr.enabled and _sampled(self.trace_sample_every, seq):
            tr.record(f"{self._span_label()}.{name}", t0, dt,
                      {} if seq is None else {"seq": seq})

    def _dispatch(self, x, seq=None):
        """Run the stage program and time the DISPATCH phase: the call
        returning (on the card the kernels are queued, not done).
        Returns ``(t0, t_end, (y, event))``: ``t0`` anchors the frame's
        ``infer`` interval, ``t_end`` seeds the QUEUE phase, and the CUDA
        event (None on the CPU) marks the end of this frame's work."""
        t0 = time.perf_counter()
        y = self.prog(x)
        ev = None
        if y.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(y.device))
        t_end = time.perf_counter()
        self._phase(self.disp_hist, "dispatch", t0, t_end, seq)
        return t0, t_end, (y, ev)

    def _queue_wait(self, t_end, seq=None):
        """The frame's residency in the un-synced window (dispatch
        returned -> its drain turn), as the QUEUE phase.  Returns the
        phase's end, the next phase's start."""
        t_now = time.perf_counter()
        self._phase(self.queue_hist, "queue", t_end, t_now, seq)
        return t_now

    def _device_wait(self, ev, seq=None, t0=None):
        """Wait for the frame's CUDA event as the DEVICE phase (device
        compute plus whatever queued ahead of it).  No-op on the CPU,
        where the program ran synchronously.  Returns the phase's end."""
        if t0 is None:
            t0 = time.perf_counter()
        if ev is None:
            return t0
        ev.synchronize()
        t_end = time.perf_counter()
        self._phase(self.dev_hist, "device", t0, t_end, seq)
        return t_end

    def _host_sync(self, y, seq=None, t0=None):
        """Sync the frame (:meth:`_device_wait`), then copy the output to
        the host as the HOST_SYNC phase: a numpy array, or a bfloat16
        tensor (numpy has no bfloat16; the framed transport sends it
        as such).  Returns ``(out, t_end)``; the loops close the ``infer``
        interval at ``t_end`` so the four phases tile it."""
        y, ev = y
        t0 = self._device_wait(ev, seq=seq, t0=t0)
        out = y.cpu()
        if out.dtype != torch.bfloat16:
            out = out.numpy()
        t_end = time.perf_counter()
        self._phase(self.host_sync_hist, "host_sync", t0, t_end, seq)
        return out, t_end

    def _infer_done(self, t0, t_done, seq, label_seq) -> None:
        dt = t_done - t0
        REGISTRY.histogram("node.infer_s").record(dt)
        self.infer_hist.record(dt)
        tr = tracer()
        if tr.enabled and _sampled(self.trace_sample_every, seq):
            tr.record(f"{self._span_label()}.infer", t0, dt,
                      {"seq": label_seq if seq is None else seq,
                       "stage": self.manifest["index"]})

    def _check_frame(self, value) -> None:
        m = self.manifest
        want = tuple(m["in_shape"])
        if tuple(value.shape[1:]) != want:
            raise ValueError(
                f"stage {m['index']} expects sample shape {want}, got "
                f"{tuple(value.shape[1:])}")
        if value.shape[0] != m["batch"]:
            raise ValueError(
                f"stage {m['index']} was exported at batch {m['batch']}, "
                f"got a frame of {value.shape[0]}")

    def _make_tx(self, connect_timeout_s: float):
        """Open the downstream connection: ``(AsyncSender, socket)`` over
        tcp (``tier="auto"`` finds no other rung in the port), with the
        pending trace context cascaded ahead of the first tensor."""
        if self.next_hop is None:
            raise ValueError("no next hop configured")
        sock = connect_retry(*self.next_hop, timeout_s=connect_timeout_s)
        self.tier_out = "tcp"
        tx = AsyncSender(sock, depth=self.tx_depth, codec=self.codec,
                         gauge="node.tx_queue_depth",
                         span=self._span_label, hist="node.tx_s")
        tx.sample_every = self.trace_sample_every
        self._live_tx = tx
        if self._pending_trace is not None:
            tx.send_ctrl(self._pending_trace)
        return tx, sock

    # -- control plane --------------------------------------------------------

    def _deploy(self, msg: dict, blob: bytes) -> None:
        """Apply a ``deploy`` message: refuse the fan roles the port does
        not run, then load the artifact onto this node's device."""
        if int(msg.get("fan_in") or 1) > 1:
            raise _not_ported("A10b", "a fan-in node (replicated upstream stage)")
        if msg.get("replica") is not None:
            raise _not_ported("A10b", "a stage replica")
        if msg.get("fan") not in (None, "rr"):
            raise _not_ported("A10c", f"fan={msg['fan']!r} (a branch fork)")
        if msg.get("branch") is not None:
            raise _not_ported("A10c", "a branch-path node")
        if msg.get("join"):
            raise _not_ported("A10c", "a branch join")
        tier = msg.get("tier")
        if tier:
            _check_tier(tier, "deploy")
        if msg.get("tier_accept"):
            raise _not_ported("A10d", "granting a colocated transport tier")
        nxt = _parse_hop(msg["next"]) if msg.get("next") else None
        if msg.get("device") is not None:
            self.device = resolve_device(msg["device"])
        from ..utils.export import load_stage_program
        self.prog = load_stage_program(blob, device=self.device)
        if nxt is not None:
            self.next_hop = nxt
        if msg.get("codec"):
            self.codec = msg["codec"]
        if tier:
            self.tier = tier
        if msg.get("infer_delay_ms") is not None:
            self.infer_delay_s = max(0.0,
                                     float(msg["infer_delay_ms"]) / 1e3)
        if msg.get("flops") is not None:
            self.stage_flops = float(msg["flops"])

    def _handle_ctrl(self, conn, msg: dict, recv=None) -> bool:
        """One control command; True if the connection should keep
        serving.

        ``recv`` supplies the follow-up frame of multi-frame commands
        (deploy/reweight blobs); the overlapped loop passes its rx-queue
        getter because the channel's rx thread owns all socket reads.

        deploy:   {"cmd": "deploy", "next": "host:port", "codec": ...}
                  followed by a K_BYTES artifact blob -> load, ACK (the
                  in-band analogue of the reference's weights+arch sockets
                  and \\x06 ACK, src/dispatcher.py:44-65).
        reweight: {"cmd": "reweight"} followed by a K_BYTES npz blob ->
                  swap the loaded program's weights, ACK.
        trace:    adopt the dispatcher's trace context and cascade it
                  downstream when the data connection opens (no ACK).
        trace_dump: reply with (and drain) this process's spans.
        events_since: reply with the flight recorder's events since a
                  cursor.
        stats:    reply with what this node is and has done.
        quiesce:  reply once this node's data plane is drained.
        shutdown: ACK; a persistent node leaves its serve loop.
        """
        def _expect(kind):
            if recv is None:
                return recv_expect(conn, kind)
            got, value = recv()
            if got != kind:
                raise ConnectionError(
                    f"expected frame kind {kind}, got {got}")
            return value

        cmd = msg.get("cmd")
        if cmd == "deploy":
            self._deploy(msg, _expect(K_BYTES))
            send_ack(conn)
            return True
        if cmd == "reweight":
            if self.prog is None:
                raise ValueError("reweight before deploy")
            self.prog.reweight(_expect(K_BYTES))
            self.reweights += 1
            send_ack(conn)
            return True
        if cmd == "trace":
            tr = tracer()
            tr.adopt(msg)
            m = self.manifest
            tr.process = (f"stage{m['index']}" if m is not None
                          else f"node:{self.address[1]}")
            self._pending_trace = dict(msg)
            # waterfall sampling rides the trace context: every process
            # of the chain samples the SAME 1-in-N wire sequences
            self.trace_sample_every = int(msg.get("sample_every", 0) or 0)
            for ch in (self._live_rx, self._live_tx):
                if ch is not None:
                    ch.sample_every = self.trace_sample_every
            return True
        if cmd == "events_since":
            rec = recorder()
            cursor, evs = rec.events_since(int(msg.get("cursor", 0)),
                                           limit=int(msg.get("limit", 512)))
            send_ctrl(conn, {"cmd": "events_reply", "events": evs,
                             "cursor": cursor, "dropped": rec.dropped})
            return True
        if cmd == "trace_dump":
            tr = tracer()
            send_ctrl(conn, {"spans": tr.drain()})
            # the trace is over once collected: stop recording so a node
            # that later serves untraced streams doesn't accumulate spans
            tr.enabled = False
            tr._remote_parent = None
            self._pending_trace = None
            return True
        if cmd == "stats":
            send_ctrl(conn, self._stats(msg))
            return True
        if cmd == "quiesce":
            at = msg.get("at_seq")
            processed = self._quiesce(None if at is None else int(at),
                                      float(msg.get("timeout_s", 30.0)))
            emit_event("quiesce", hop=self._span_label(),
                       processed=processed)
            send_ctrl(conn, {"cmd": "quiesced", "processed": processed})
            return True
        if cmd == "shutdown":
            # a persistent node exits its serve loop; a one-shot node
            # ACKs harmlessly (its serve returns at stream end anyway)
            send_ack(conn)
            if self._done_q is not None:
                self._done_q.put(_SHUTDOWN)
            return True
        if cmd in ("clock_probe", "clock_adjust", "obs_subscribe",
                   "profile_start", "profile_stop"):
            raise _not_ported("A12", f"the {cmd!r} command")
        raise ValueError(f"unknown control command {msg!r}")

    def _stats(self, msg: dict) -> dict:
        """The ``stats`` reply: every key of the JAX node's, the fan,
        branch, ici and failover ones at their linear-chain values, plus
        ``kernel_launches`` (each hand kernel's launches in this
        process — how a multi-process chain shows its stages ran them)."""
        m = self.manifest
        reg = REGISTRY
        rx, tx = self._live_rx, self._live_tx
        rec = recorder()
        _, evs = rec.events_since(int(msg.get("event_cursor", 0)),
                                  limit=int(msg.get("event_limit", 256)))
        mem = (torch.cuda.memory_allocated(self.device)
               if self.device.type == "cuda" else None)
        return {
            "stage": None if m is None else m["index"],
            "name": None if m is None else m["name"],
            "replica": None,
            "branch": None,
            "join": 0,
            "fan_in": 1,
            "processed": self.processed,
            "reweights": self.reweights,
            "codec": self.codec,
            "tier": self.tier_out or "tcp",
            "tier_in": self.tier_in,
            "tier_fallbacks": 0,
            "device": str(self.device),
            "ici_d2d": 0,
            "ici_device_pairs": [],
            "next": (None if self.next_hop is None
                     else f"{self.next_hop[0]}:{self.next_hop[1]}"),
            "tx_frames": reg.counter("transport.tx_frames").value,
            "tx_bytes": reg.counter("transport.tx_bytes").value,
            "rx_frames": reg.counter("transport.rx_frames").value,
            "rx_bytes": reg.counter("transport.rx_bytes").value,
            "infer_latency_s": self.infer_hist.summary(),
            "host_sync_s": self.host_sync_hist.summary(),
            "dispatch_s": self.disp_hist.summary(),
            "queue_s": self.queue_hist.summary(),
            "device_s": self.dev_hist.summary(),
            # no program is compiled at run time (the exported graph runs
            # as it is); memory is the caching allocator's live bytes
            "recompiles": 0,
            "mem_bytes": mem,
            "profiling": False,
            "rx_s": reg.histogram("node.rx_s").summary(),
            "tx_s": reg.histogram("node.tx_s").summary(),
            "encode_latency_s": (tx.enc.summary() if tx is not None else
                                 reg.histogram("codec.encode_s").summary()),
            "decode_latency_s": (rx.dec.summary() if rx is not None else
                                 reg.histogram("codec.decode_s").summary()),
            "overlap": self.overlap,
            "rx_queue_depth": reg.gauge("node.rx_queue_depth").value,
            "tx_queue_depth": reg.gauge("node.tx_queue_depth").value,
            "rx_depth": self.rx_depth,
            "tx_depth": self.tx_depth,
            "rx_watermark": self._chan_hi(rx),
            "tx_watermark": self._chan_hi(tx),
            "inflight": reg.gauge("node.inflight").value,
            "flops": self.stage_flops,
            # MFU against the card's peak comes with obs/capacity.py (A12)
            "mfu": None,
            "achieved_flops_s": None,
            "failovers": 0,
            "replay_depth": 0,
            "merge_duplicates": 0,
            "events": {"dropped": rec.dropped, "events": evs},
            "kernel_launches": _kernel_launches(),
        }

    @staticmethod
    def _chan_hi(chan) -> int:
        """Peek a channel's occupancy watermark without resetting it."""
        if chan is None:
            return 0
        return max(int(chan.hi), chan.qsize())

    def _quiesce(self, at_seq: int | None, timeout_s: float) -> int:
        """Block until this node's data plane is drained and stable:
        ``processed`` past ``at_seq`` (when given) and unchanged across
        consecutive samples, no dispatch in flight, live queues empty.
        Returns the stable processed count; TimeoutError if the node
        never settles."""
        deadline = time.monotonic() + timeout_s
        inflight_g = REGISTRY.gauge("node.inflight")
        last = -1
        while True:
            p = self.processed
            rx, tx = self._live_rx, self._live_tx
            if ((at_seq is None or p >= at_seq) and p == last
                    and inflight_g.value == 0
                    and (rx is None or rx.qsize() == 0)
                    and (tx is None or tx.qsize() == 0)):
                return p
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"quiesce: node did not stabilize within "
                    f"{timeout_s:.1f}s (processed {p}, at_seq {at_seq})")
            last = p
            time.sleep(0.05)

    # -- serving ----------------------------------------------------------------

    def serve(self, *, connect_timeout_s: float = 30.0) -> int:
        """Serve control/data connections until a data stream completes.

        Connections are handled concurrently (a thread per connection):
        control connections (deploy / reweight / stats ..., each ending
        with the peer's END) may arrive before or during the upstream data
        stream, which is relayed through the stage program until its END
        frame.  Returns the number of tensors the completed data stream
        processed (a ``persist`` node: the total over its segments, once a
        ``shutdown`` command arrives).  The END is forwarded downstream
        before closing, so shutdown cascades through the chain to the
        dispatcher's result server.
        """
        done: queue.Queue = queue.Queue()
        self._done_q = done

        def worker(conn):
            try:
                configure_socket(conn)
                n = self._serve_conn(conn, connect_timeout_s)
                if n is not None:
                    done.put(n)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                done.put(e)
            finally:
                conn.close()

        total = 0
        self._srv.settimeout(0.25)
        try:
            while True:
                try:
                    conn, _ = self._srv.accept()
                except TimeoutError:
                    conn = None
                if conn is not None:
                    threading.Thread(target=worker, args=(conn,),
                                     daemon=True).start()
                try:
                    r = done.get_nowait()
                except queue.Empty:
                    continue
                if r is _SHUTDOWN:
                    return total
                if isinstance(r, BaseException):
                    raise r
                if not self.persist:
                    return r
                total += r
        finally:
            self._srv.close()

    def _serve_conn(self, conn, connect_timeout_s: float) -> int | None:
        """One connection: None if it was control-only, else its tensor
        count.  ``overlap=True`` runs the three-phase overlapped loop,
        ``overlap=False`` the strictly serial baseline."""
        if self.overlap:
            return self._serve_conn_overlapped(conn, connect_timeout_s)
        return self._serve_conn_serial(conn, connect_timeout_s)

    def _serve_conn_overlapped(self, conn,
                               connect_timeout_s: float) -> int | None:
        """Three-phase overlap: rx thread -> compute loop -> tx thread.

        An :class:`AsyncReceiver` decodes upstream frames into a bounded
        queue while this thread computes, and an :class:`AsyncSender`
        encodes and sends relayed tensors from a bounded queue, so the rx
        of frame j+1, the compute of j and the tx of j-1 run at once.  The
        compute loop keeps up to ``inflight`` programs un-synced on the
        card: the copy to the host of output j-1 overlaps the device
        compute of j.  Bounded queues keep end-to-end backpressure.

        Sequence-stamped frames (``K_TENSOR_SEQ``) relay their sequence
        number onto the output frame unchanged.
        """
        tx = out_sock = None
        n = 0                   # tensors relayed downstream
        seq = 0                 # tensors received
        streamed = False
        stream_marked = False   # upstream announced this conn as data path
        inflight_g = REGISTRY.gauge("node.inflight")
        #: issued-but-unsynced stage outputs, oldest first
        pending: collections.deque = collections.deque()
        # no gauge yet: most connections are short-lived control round
        # trips; the gauge is bound once this connection is the stream
        rx = AsyncReceiver(conn, depth=self.rx_depth,
                           span=self._span_label)

        def drain_one():
            nonlocal n, streamed
            t0, t_end, s, y, relay_seq = pending.popleft()
            inflight_g.dec()
            tq = self._queue_wait(t_end, seq=relay_seq)
            y, t_done = self._host_sync(y, seq=relay_seq, t0=tq)
            self._infer_done(t0, t_done, relay_seq, s)
            self.processed += 1  # before the send: a stats query can
            #   race the relay of the final tensor otherwise
            tx.send(y, seq=relay_seq)
            n += 1
            streamed = True

        try:
            while True:
                if pending:
                    # compute-ahead only while input is immediately
                    # available: an idle upstream means the window must
                    # drain NOW, or the stream's tail stalls in the node
                    try:
                        kind, value = rx.get_nowait()
                    except queue.Empty:
                        drain_one()
                        continue
                else:
                    kind, value = rx.get()
                if kind == K_END:
                    while pending:
                        drain_one()
                    if streamed or stream_marked:
                        if tx is None:
                            # marked data path with zero frames: still
                            # propagate the stream so the END cascades
                            tx, out_sock = self._make_tx(connect_timeout_s)
                            tx.send_ctrl({"cmd": "stream_begin"})
                        # END + join: every relayed frame is on the wire
                        # before the finally block closes the socket
                        tx.close(timeout=connect_timeout_s)
                        emit_event("stream_end", hop=self._span_label(),
                                   n=n)
                        return n
                    return None  # control connection closing
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        stream_marked = True
                        continue
                    if cmd == "tier_probe":
                        answer_probe(conn, value)
                        self.tier_in = "tcp"
                        continue
                    if cmd == "req_meta":
                        # serve-front-door request metadata: cascade
                        # downstream now — a meta may only move EARLIER
                        # relative to its own frame, never later, and
                        # the result hop joins meta to frame by seq
                        stream_marked = True
                        if tx is None:
                            tx, out_sock = self._make_tx(connect_timeout_s)
                        tx.send_ctrl(value)
                        continue
                    if cmd == "trace":
                        # relay order: everything received before this
                        # ctrl frame must reach downstream ahead of it
                        while pending:
                            drain_one()
                    self._handle_ctrl(conn, value, recv=rx.get)
                    if cmd == "trace" and tx is not None:
                        # downstream already connected (a second traced
                        # stream on a live chain): cascade the new
                        # context now, not just at connection open
                        tx.send_ctrl(self._pending_trace)
                    continue
                if kind == K_TENSOR_SEQ:
                    relay_seq, value = value
                elif kind == K_TENSOR:
                    relay_seq = None
                else:
                    raise ValueError(f"unexpected frame kind {kind}")
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if tx is None:
                    tx, out_sock = self._make_tx(connect_timeout_s)
                if self._live_rx is not rx:
                    # first tensor on this channel: bind the live
                    # telemetry to the channel the stream rides
                    rx.bind_gauge("node.rx_queue_depth")
                    rx.bind_hist("node.rx_s")
                    rx.sample_every = self.trace_sample_every
                    self._live_rx = rx
                    emit_event("stream_begin", hop=self._span_label())
                self._check_frame(value)
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(value, seq=relay_seq)
                pending.append((t0, t_end, seq, y, relay_seq))
                seq += 1
                inflight_g.inc()
                while len(pending) >= self.inflight:
                    drain_one()
        except Exception as e:  # noqa: BLE001 — see below
            if streamed:
                raise  # upstream died / corrupted mid-stream: loud
            # a connection that never became the data stream must not be
            # able to kill a serving node: port scanners and malformed
            # control peers are logged and dropped.  The remote side still
            # fails loudly — its recv gets a cut connection, no ACK/END.
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None
        finally:
            # reconcile the ADDITIVE gauges: an abandoned stream's queued
            # frames / un-synced dispatches are never consumed
            if self._live_rx is rx:
                self._live_rx = None
            rx.release_gauge()
            if pending:
                inflight_g.dec(len(pending))
            if out_sock is not None:
                out_sock.close()

    def _serve_conn_serial(self, conn,
                           connect_timeout_s: float) -> int | None:
        """The serial loop: per tensor, rx + decode, compute with an
        immediate host sync, encode + tx — phases pay their sum.  Kept as
        the baseline the overlap is measured against."""
        out = None
        n = 0
        streamed = False
        stream_marked = False

        def open_out():
            if self.next_hop is None:
                raise ValueError("no next hop configured")
            sock = connect_retry(*self.next_hop,
                                 timeout_s=connect_timeout_s)
            self.tier_out = "tcp"
            if self._pending_trace is not None:
                send_ctrl(sock, self._pending_trace)
            return sock

        try:
            while True:
                kind, value = recv_frame(conn)
                if kind == K_END:
                    if streamed or stream_marked:
                        if out is None:
                            out = open_out()
                            send_ctrl(out, {"cmd": "stream_begin"})
                        send_end(out)
                        return n
                    return None  # control connection closing
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        stream_marked = True
                        continue
                    if cmd == "tier_probe":
                        answer_probe(conn, value)
                        self.tier_in = "tcp"
                        continue
                    if cmd == "req_meta":
                        stream_marked = True
                        if out is None:
                            out = open_out()
                        send_ctrl(out, value)
                        continue
                    self._handle_ctrl(conn, value)
                    if cmd == "trace" and out is not None:
                        send_ctrl(out, self._pending_trace)
                    continue
                if kind == K_TENSOR_SEQ:
                    relay_seq, value = value
                elif kind == K_TENSOR:
                    relay_seq = None
                else:
                    raise ValueError(f"unexpected frame kind {kind}")
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if out is None:
                    out = open_out()
                self._check_frame(value)
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(value, seq=relay_seq)
                tq = self._queue_wait(t_end, seq=relay_seq)
                y, t_done = self._host_sync(y, seq=relay_seq, t0=tq)
                self._infer_done(t0, t_done, relay_seq, n)
                self.processed += 1
                send_frame(out, y, codec=self.codec, seq=relay_seq)
                n += 1
                streamed = True
        except Exception as e:  # noqa: BLE001 — see the overlapped loop
            if streamed:
                raise
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None
        finally:
            if out is not None:
                out.close()


class ChainDispatcher:
    """Drives a linear chain of stage nodes from one controller.

    Opens the result server (the reference dispatcher's own port 5000
    role, src/dispatcher.py:95-105), streams inputs to node 0, and returns
    results in order, with a bounded in-flight window so the chain stays
    full without unbounded buffering.
    """

    #: the one timeout default; also covers partially constructed
    #: instances
    timeout_s: float = 180.0

    def __init__(self, first_hop: str, *, listen: str = "127.0.0.1:0",
                 codec: str = "raw", window: int = 64,
                 timeout_s: float | None = None,
                 tx_depth: int = 8, rx_depth: int = 8,
                 result_fan_in: int = 1,
                 trace_sample_every: int = 0, tier: str = "tcp"):
        if timeout_s is not None:
            self.timeout_s = timeout_s
        self.tier = _check_tier(tier, "ChainDispatcher")
        if result_fan_in != 1:
            raise _not_ported("A10b", "a replicated last stage (result fan-in)")
        self.first_hop = _parse_hop(first_hop)
        host, port = _parse_hostport(listen)
        self._res_srv = socket.create_server((host, port))
        # a dead chain fails, not hangs
        self._res_srv.settimeout(self.timeout_s)
        self.result_address = self._res_srv.getsockname()
        self.codec = codec
        self.window = window
        self.tx_depth = tx_depth
        self.rx_depth = rx_depth
        self.trace_sample_every = max(0, int(trace_sample_every))
        self.tier_out: str | None = None
        self.tier_in: str | None = None
        #: wire sequence counter, continuous across stream() calls (a warm
        #: stream and a timed stream must not reuse seq numbers — sampled
        #: spans are keyed by them)
        self._stream_seq = 0
        self._send_sock: socket.socket | None = None
        self._res_conn: socket.socket | None = None
        self._tx_chan: AsyncSender | None = None
        self._rx_chan: AsyncReceiver | None = None

    def _ensure_connected(self) -> None:
        if self._send_sock is None:
            # generous: every node of a spawned chain imports torch first
            self._send_sock = connect_retry(*self.first_hop,
                                            timeout_s=self.timeout_s)
        if self._tx_chan is None:
            # encode + send happen on the channel's tx thread, so the feed
            # loop and the wire overlap (and the END in close() rides the
            # same ordered queue)
            self.tier_out = "tcp"
            self._tx_chan = AsyncSender(self._send_sock,
                                        depth=self.tx_depth,
                                        codec=self.codec,
                                        gauge="chain.tx_queue_depth",
                                        span="chain", hist="chain.tx_s")
            self._tx_chan.sample_every = self.trace_sample_every
        # the result connection is accepted lazily in _recv_tensor: the
        # last node only dials back once its first tensor arrives, so
        # accepting before sending anything would deadlock the chain

    def stream(self, inputs) -> list:
        """Send every input through the chain; return outputs in order.

        Full duplex: a sender thread keeps the chain fed (up to ``window``
        in flight, released as results land) while this thread drains
        results, so a slow stage applies backpressure through the window.
        Encoding happens on the tx channel's thread and result decoding on
        the rx channel's.  Per-``get`` timeouts keep a dead chain failing
        rather than hanging.

        With tracing enabled the call injects its trace context as a
        K_CTRL frame ahead of the first tensor; every stage adopts it,
        cascades it downstream and parents its spans under this stream's
        root span — collect them afterwards with :meth:`collect_trace`.
        """
        self._ensure_connected()
        tr = tracer()
        root_span = None
        t_start = time.perf_counter()
        if tr.enabled:
            # pre-allocate the root span id so remote stages can parent
            # under a span recorded only when the stream completes
            root_span = new_span_id()
            self._tx_chan.send_ctrl(
                {"cmd": "trace", "trace_id": tr.trace_id,
                 "span_id": root_span,
                 "sample_every": self.trace_sample_every})
        # waterfall sampling needs a wire sequence number on every frame
        stamp_seq = tr.enabled and self.trace_sample_every > 0
        outs: list = []
        window = threading.Semaphore(self.window)
        sent = [0]
        tx_done = threading.Event()
        rx_failed = threading.Event()
        err: list[BaseException] = []

        def tx():
            try:
                for x in inputs:
                    if rx_failed.is_set():
                        return
                    if not window.acquire(timeout=self.timeout_s):
                        raise TimeoutError(
                            f"chain accepted no result for "
                            f"{self.timeout_s:.0f}s with {self.window} in "
                            f"flight — a stage is stuck")
                    if rx_failed.is_set():
                        return  # woken by the error path, not a result
                    self._tx_chan.send(
                        x if isinstance(x, torch.Tensor) else np.asarray(x),
                        seq=(self._stream_seq + sent[0]) if stamp_seq
                        else None)
                    sent[0] += 1
            except BaseException as e:  # noqa: BLE001 — surfaced below
                err.append(e)
            finally:
                self._stream_seq += sent[0]
                tx_done.set()

        t = threading.Thread(target=tx, daemon=True, name="chain-tx")
        t.start()
        try:
            while True:
                if err:
                    raise err[0]
                if len(outs) < sent[0]:
                    # something is in flight: recv (bounded by the result
                    # channel's timeout).  Never recv otherwise — nothing
                    # would arrive and the wait would run its full timeout
                    outs.append(self._recv_tensor())
                    window.release()
                    continue
                if tx_done.is_set():
                    break  # everything sent has been received
                tx_done.wait(0.01)  # sender still working; let it run
        except BaseException:
            rx_failed.set()
            # a sender parked in window.acquire must wake to see the flag;
            # then give it a bounded moment so no trailing frame interleaves
            # with the caller's teardown (close() writes END on this socket)
            window.release(self.window)
            t.join(timeout=5.0)
            raise
        t.join(timeout=self.timeout_s)  # no trailing writes after return
        if err:
            raise err[0]
        if root_span is not None:
            tr.record("chain.stream", t_start,
                      time.perf_counter() - t_start,
                      {"sent": sent[0], "received": len(outs)},
                      span_id=root_span)
        return outs

    def _control(self, addr: str, msg: dict, blob: bytes | None = None,
                 reply: int = K_ACK):
        """One control round trip on a fresh connection to ``addr``: the
        message, an optional K_BYTES blob, the expected reply, END."""
        s = connect_retry(*_parse_hostport(addr), timeout_s=self.timeout_s)
        try:
            send_ctrl(s, msg)
            if blob is not None:
                send_frame(s, blob)
            out = recv_expect(s, reply)
            send_end(s)
            return out
        finally:
            s.close()

    @staticmethod
    def _linear(node_addrs: Sequence, n: int) -> list[str]:
        addrs = list(node_addrs)
        if len(addrs) != n:
            raise ValueError(f"{n} stages but {len(addrs)} nodes")
        if any(not isinstance(a, str) for a in addrs):
            raise _not_ported("A10b", "stage replicas (a list of addresses)")
        return addrs

    def deploy(self, stages, params, node_addrs: Sequence[str], *,
               batch: int = 1, result_hop: str | None = None,
               codecs: Sequence[str] | None = None,
               tiers: Sequence[str] | None = None) -> None:
        """Ship each stage's artifact to its node over the control
        channel.

        Serial, in chain order, each ACKed before the next — the in-band
        model distribution of the reference dispatcher
        (src/dispatcher.py:44-65: weights, arch JSON, next-node IP, \\x06
        ACK) collapsed to one control connection per node carrying a
        self-contained ``torch.export`` program and its weights.  Nodes may
        boot with no files at all.  ``result_hop`` overrides the address
        the last node relays results to (default: this dispatcher's result
        server).  ``codecs`` (per stage) sets each stage's OUTBOUND hop
        codec; ``tiers`` (per stage, ``tcp``/``auto``) its outbound
        transport-tier policy.
        """
        from ..utils.export import export_stage_bytes
        addrs = self._linear(node_addrs, len(stages))
        result_hop = result_hop or \
            f"{self.result_address[0]}:{self.result_address[1]}"
        for i, (stage, addr) in enumerate(zip(stages, addrs)):
            msg = {"cmd": "deploy",
                   "next": addrs[i + 1] if i + 1 < len(addrs)
                   else result_hop,
                   "codec": codecs[i] if codecs else self.codec}
            if tiers:
                msg["tier"] = _check_tier(tiers[i], "deploy")
            self._control(addr, msg,
                          export_stage_bytes(stage, params, batch=batch))

    def reweight(self, stages, params, node_addrs: Sequence[str]) -> None:
        """Weights-only re-push: install fresh weights on every node's
        loaded stage program — redeploy without restarting any process or
        resending the program."""
        from ..utils.export import stage_weight_leaves, weights_blob
        addrs = self._linear(node_addrs, len(stages))
        for stage, addr in zip(stages, addrs):
            self._control(addr, {"cmd": "reweight"}, weights_blob(
                stage_weight_leaves(stage, params)))

    def stats(self, node_addrs: Sequence[str]) -> list[dict]:
        """Every node's ``stats`` reply (works mid-stream: nodes serve a
        thread per connection)."""
        return [self._control(a, {"cmd": "stats"}, reply=K_CTRL)
                for a in node_addrs]

    def _ensure_result_chan(self) -> None:
        """Accept the last node's dial-back and wrap it in the result
        :class:`AsyncReceiver` (idempotent)."""
        if self._res_conn is None:
            self._res_conn, _ = self._res_srv.accept()
            configure_socket(self._res_conn)
        if self._rx_chan is None:
            self._res_conn.settimeout(None)
            self._rx_chan = AsyncReceiver(self._res_conn,
                                          depth=self.rx_depth,
                                          gauge="chain.rx_queue_depth",
                                          span="chain", hist="chain.rx_s")
            self._rx_chan.sample_every = self.trace_sample_every

    def _result_item(self, *, timeout_s: float | None = None
                     ) -> tuple[int, Any]:
        """One frame off the result hop with the handshakes handled: a
        tier probe is answered (tcp), trace / stream_begin markers — which
        the dispatcher itself originated — are skipped; everything else is
        returned."""
        self._ensure_result_chan()
        t = self.timeout_s if timeout_s is None else timeout_s
        while True:
            kind, y = self._rx_chan.get(timeout=t)
            if kind == K_CTRL and isinstance(y, dict):
                cmd = y.get("cmd")
                if cmd == "tier_probe":
                    answer_probe(self._res_conn, y)
                    self.tier_in = "tcp"
                    continue
                if cmd in ("trace", "stream_begin"):
                    continue
            return kind, y

    # -- serve front door: request-scoped duplex stream ----------------------

    def begin_trace(self, *, sample_every: int | None = None
                    ) -> str | None:
        """Inject the current trace context into the chain ahead of any
        request-scoped frame — the serving-path twin of what
        :meth:`stream` does per call.  Returns the pre-allocated root span
        id stage spans parent under, or None when tracing is off."""
        tr = tracer()
        if not tr.enabled:
            return None
        if sample_every is not None:
            self.trace_sample_every = max(0, int(sample_every))
        self._ensure_connected()
        self._tx_chan.sample_every = self.trace_sample_every
        if self._rx_chan is not None:
            self._rx_chan.sample_every = self.trace_sample_every
        root_span = new_span_id()
        self._tx_chan.send_ctrl(
            {"cmd": "trace", "trace_id": tr.trace_id,
             "span_id": root_span,
             "sample_every": self.trace_sample_every})
        return root_span

    def send_request_frame(self, arr, *, seq: int,
                           meta: dict | None = None) -> None:
        """One request-scoped frame into the chain: stamped with ``seq``
        (``K_TENSOR_SEQ`` — every stage relays the stamp unchanged, so the
        result hop identifies the frame it answers), optionally preceded
        by a ``req_meta`` K_CTRL frame carrying its tenant/request
        composition, which stage nodes cascade downstream ahead of (never
        behind) the frame it describes."""
        self._ensure_connected()
        if meta is not None:
            msg = {"cmd": "req_meta", "seq": int(seq)}
            msg.update(meta)
            self._tx_chan.send_ctrl(msg)
        self._tx_chan.send(
            arr if isinstance(arr, torch.Tensor) else np.asarray(arr),
            seq=int(seq))

    def recv_result(self, *, timeout_s: float | None = None):
        """Next item off the result hop for a request-scoped stream:
        ``("meta", msg)`` for a cascaded ``req_meta`` frame, ``("tensor",
        (seq, arr))`` for a result (``seq`` None on unstamped frames),
        ``("end", None)`` when the chain drained."""
        kind, y = self._result_item(timeout_s=timeout_s)
        if kind == K_CTRL and isinstance(y, dict) \
                and y.get("cmd") == "req_meta":
            return "meta", y
        if kind == K_TENSOR_SEQ:
            return "tensor", (y[0], y[1])
        if kind == K_TENSOR:
            return "tensor", (None, y)
        if kind == K_END:
            return "end", None
        raise ConnectionError(
            f"unexpected frame kind {kind!r} on the result hop")

    def _recv_tensor(self):
        """One in-order result frame; a loud protocol check (an early END
        from a node that died mid-stream must raise, not mis-drain)."""
        kind, y = self._result_item()
        if kind == K_TENSOR_SEQ:
            # waterfall sampling stamps every frame end to end; strip it
            return y[1]
        if kind != K_TENSOR:
            raise ConnectionError(
                f"chain returned frame kind {kind!r} while results were "
                f"still in flight (a stage node died and cascaded END?)")
        return y

    def collect_trace(self, node_addrs: Sequence[str]) -> int:
        """Fetch and merge every node's recorded spans into this process's
        tracer (a ``trace_dump`` round trip per node), so one export holds
        the stitched dispatcher -> stage0 -> ... -> stageN-1 trace.
        Returns the number of spans ingested.  Call while the nodes are
        still alive — after ``stream`` returns, before ``close``."""
        tr = tracer()
        total = 0
        for addr in node_addrs:
            spans = self._control(addr, {"cmd": "trace_dump"},
                                  reply=K_CTRL).get("spans", [])
            tr.ingest(spans)
            total += len(spans)
        return total

    def quiesce(self, node_addrs: Sequence[str], *,
                at_seq: int | None = None,
                timeout_s: float | None = None) -> list[int]:
        """Drain every node to a stable sequence point: per node, a
        ``quiesce`` round trip that returns once the node's queues are
        empty, its in-flight window has drained and its processed count
        has stopped moving (optionally past ``at_seq``).  Returns each
        node's processed count."""
        t = self.timeout_s if timeout_s is None else timeout_s
        out: list[int] = []
        for addr in node_addrs:
            msg: dict = {"cmd": "quiesce", "timeout_s": t}
            if at_seq is not None:
                msg["at_seq"] = int(at_seq)
            reply = self._control(addr, msg, reply=K_CTRL)
            if not isinstance(reply, dict) \
                    or reply.get("cmd") != "quiesced":
                raise ConnectionError(
                    f"node {addr} answered quiesce with {reply!r}")
            out.append(int(reply.get("processed", 0)))
        return out

    def shutdown_nodes(self, node_addrs: Sequence[str]) -> None:
        """Ask persistent nodes (``persist=True``) to leave their serve
        loop after the current segment."""
        for addr in node_addrs:
            self._control(addr, {"cmd": "shutdown"})

    def end_stream(self) -> None:
        """Drain the current stream segment (best effort) and drop every
        data-plane connection, but KEEP the result server listening, so a
        follow-up :meth:`stream` opens a fresh segment against nodes that
        persisted across it.  The wire sequence counter is not reset.

        The END handshake is wrapped so a chain that already died
        mid-stream cannot mask the original failure with a secondary
        BrokenPipe/EOF from the teardown itself."""
        try:
            if self._send_sock is not None:
                # the END rides the ordered tx queue behind any trailing
                # frames; close() joins the tx thread so it is on the
                # wire before we wait for the cascaded echo
                self._tx_chan.close(timeout=min(10.0, self.timeout_s))
                if self._res_conn is None:
                    # nothing was ever received: still accept the last
                    # node's dial-back so its cascaded END completes
                    try:
                        self._res_srv.settimeout(min(10.0, self.timeout_s))
                        self._res_conn, _ = self._res_srv.accept()
                        self._res_conn.settimeout(self.timeout_s)
                    except OSError:
                        pass
                if self._res_conn is not None:
                    # drain leftover in-flight frames until the END
                    # cascades through
                    while True:
                        if self._rx_chan is not None:
                            kind, v = self._rx_chan.get(
                                timeout=self.timeout_s)
                        else:
                            kind, v = recv_frame(self._res_conn)
                        if kind == K_CTRL and isinstance(v, dict) \
                                and v.get("cmd") == "tier_probe":
                            answer_probe(self._res_conn, v)
                        if kind == K_END:
                            break
        except (OSError, ConnectionError, ValueError, TimeoutError):
            pass  # teardown after failure: keep the root cause
        finally:
            if self._rx_chan is not None:
                # reconcile the additive chain.rx_queue_depth gauge
                self._rx_chan.release_gauge()
            if self._send_sock is not None:
                self._send_sock.close()
            if self._res_conn is not None:
                self._res_conn.close()
            # reset to pre-connect state: the next stream() segment
            # redials the (possibly re-deployed) chain from scratch
            self._send_sock = None
            self._tx_chan = None
            self._rx_chan = None
            self._res_conn = None
            try:
                self._res_srv.settimeout(self.timeout_s)
            except OSError:
                pass  # already closed (end_stream after close)

    def close(self) -> None:
        """End the current segment (:meth:`end_stream`) and close the
        result server — the dispatcher is done for good."""
        try:
            self.end_stream()
        finally:
            self._res_srv.close()


# ---------------------------------------------------------------------------
# run_chain: spawn one OS process per stage, deploy, stream, tear down
# ---------------------------------------------------------------------------

def _free_ports(n: int) -> list[int]:
    """Probe n free localhost ports.  Inherently racy (probe-then-close,
    then the children bind): ``run_chain`` detects children that died with
    a bind failure and retries the whole spawn on fresh ports."""
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


#: substrings that identify a child that lost the ``_free_ports`` race
_BIND_RACE_MARKS = ("Address already in use", "EADDRINUSE",
                    "address is already in use")


class _BindRace(RuntimeError):
    """A chain child lost the ``_free_ports`` probe race (its port was
    taken before it bound) — the spawn should retry."""


def _log_tail(lf, limit: int = 2000) -> str:
    try:
        lf.flush()
        lf.seek(0)
        return lf.read()[-limit:]
    except (OSError, ValueError):
        return "<log unavailable>"


def _kill_procs(procs, *, grace_s: float = 5.0) -> None:
    """Terminate every child now (SIGTERM, a short grace, then SIGKILL):
    a node that died mid-deploy or mid-stream must not leave its siblings
    running."""
    for pr in procs:
        if pr.poll() is None:
            try:
                pr.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace_s
    for pr in procs:
        try:
            pr.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pr.kill()
    for pr in procs:
        try:
            pr.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass


def _await_binds(procs, labels, logs, addrs, *,
                 timeout_s: float = 90.0) -> None:
    """Block until every child reports its bind (the ``listening on``
    line ``cmd_node`` prints once ``StageNode`` has bound), or diagnose
    the one that died trying: a bind-race death raises :class:`_BindRace`
    (retryable), anything else a ``RuntimeError`` carrying that node's
    log tail.  The log line, not a connect probe, is the signal: a stolen
    port still accepts connections — from whoever stole it."""
    deadline = time.monotonic() + timeout_s
    for i, addr in enumerate(addrs):
        while True:
            rc = procs[i].poll()
            tail = _log_tail(logs[i], limit=8000)
            if f"listening on {addr}," in tail:
                break
            if rc is not None:
                if any(m in tail for m in _BIND_RACE_MARKS):
                    raise _BindRace(f"node {labels[i]} lost the port bind "
                                    f"race")
                raise RuntimeError(f"chain node {labels[i]} exited rc={rc} "
                                   f"during boot: {tail[-2000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"chain node {labels[i]} did not bind {addr} within "
                    f"{timeout_s:.0f}s: {tail[-2000:]}")
            time.sleep(0.1)


#: seconds a spawned node may take to exit once END has cascaded
_EXIT_TIMEOUT_S = 60.0


class NodeProcs(NamedTuple):
    """The children :func:`spawn_nodes` yields, once each has bound."""

    procs: list       # subprocess.Popen, one per node
    addrs: list       # each node's listen address, "host:port"
    result: str       # a free port for the dispatcher's result channel
    logs: list        # each node's log file (its stdout and stderr)


@contextlib.contextmanager
def spawn_nodes(n: int, *, log_dir: str, device: str = "cuda",
                argv_for=None, env: dict[str, str] | None = None,
                on_spawn=None, spawn_retries: int = 3):
    """Spawn ``n`` ``python -m defer_tpu_torch node`` processes on fresh
    localhost ports and yield a :class:`NodeProcs` once every child has
    bound — the one spawn path of the port's process chains
    (:func:`run_chain` runs its nodes through it).

    Every child runs on ``device`` (its argv carries ``--device``),
    imports this package from where the parent did, takes ``env`` over
    the parent's environment and logs to ``log_dir/node_<k>.log``.
    ``argv_for(k, addrs, result)`` gives node k's further arguments (by
    default none: the node boots empty and awaits an in-band deploy).  On
    the card the parent first builds every hand kernel
    (``ops/_build.py``), so the children load the built libraries instead
    of each starting its own ``nvcc``.  ``on_spawn(procs)`` is called
    with each spawn's ``subprocess.Popen`` list.

    Children that exit with an address-in-use bind failure at boot (the
    ``_free_ports`` race) are killed and the spawn retries on fresh
    ports, up to ``spawn_retries`` spawns; any other death at boot raises
    with that node's log tail.  Leaving the block normally waits up to
    ``_EXIT_TIMEOUT_S`` for every child to exit (the body cascaded END)
    and raises if one did not exit 0.  Leaving it on an error terminates
    every child first and names the dead nodes' log tails; when every
    dead node lost the bind race it raises :class:`_BindRace`, which
    :func:`run_chain` retries.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build
        from ..ops.launches import counted_kernels
        _build.build([k.source for k in counted_kernels()])
    child_env = dict(os.environ)
    # the children import this package from where the parent did
    root = str(Path(__file__).resolve().parents[2])
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    child_env.update(env or {})
    labels = [f"stage{k}" for k in range(n)]

    last_exc: BaseException | None = None
    for attempt in range(max(1, spawn_retries)):
        procs, logs = [], []
        ports = _free_ports(n + 1)  # one listen port per node + the result
        addrs = [f"127.0.0.1:{p}" for p in ports[:n]]
        result = f"127.0.0.1:{ports[-1]}"
        try:
            for k in range(n):
                # log to files, not PIPEs: an undrained pipe fills and
                # deadlocks a chatty child mid-chain
                lf = open(os.path.join(log_dir, f"node_{k}.log"), "w+")
                logs.append(lf)
                argv = [sys.executable, "-m", "defer_tpu_torch", "node",
                        "--listen", addrs[k], "--device", str(dev)]
                if argv_for is not None:
                    argv += argv_for(k, addrs, result)
                procs.append(subprocess.Popen(
                    argv, env=child_env, stdout=lf,
                    stderr=subprocess.STDOUT))
            if on_spawn is not None:
                on_spawn(procs)
            _await_binds(procs, labels, logs, addrs)
            break
        except BaseException as e:
            _kill_procs(procs)
            for lf in logs:
                lf.close()
            if not isinstance(e, _BindRace):
                raise
            last_exc = e
            print(f"spawn_nodes: bind race on attempt {attempt + 1} ({e}); "
                  f"retrying on fresh ports", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"node spawn lost the port race {spawn_retries} "
                           f"times: {last_exc}") from last_exc

    try:
        yield NodeProcs(procs, addrs, result, logs)
        for pr in procs:
            try:
                pr.wait(timeout=_EXIT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait(timeout=_EXIT_TIMEOUT_S)
        for i, pr in enumerate(procs):
            if pr.returncode != 0:
                raise RuntimeError(f"chain node {labels[i]} exited "
                                   f"rc={pr.returncode}: "
                                   f"{_log_tail(logs[i])}")
    except BaseException as e:
        # diagnose: which children died, and why — each dead node's log
        # tail instead of the dispatcher's bare timeout
        _kill_procs(procs)
        dead = [(labels[i], pr.returncode, _log_tail(logs[i]))
                for i, pr in enumerate(procs)
                if pr.returncode not in (0, None)]
        races = [d for d in dead
                 if any(m in d[2] for m in _BIND_RACE_MARKS)]
        if races and len(races) == len(dead):
            raise _BindRace(
                f"{[d[0] for d in races]} lost the port bind race") from e
        if dead and not isinstance(e, RuntimeError):
            detail = "; ".join(f"node {lbl} rc={rc}: ...{tail[-800:]}"
                               for lbl, rc, tail in dead)
            raise RuntimeError(f"chain failed ({type(e).__name__}: {e}); "
                               f"dead nodes: {detail}") from e
        raise
    finally:
        for lf in logs:
            lf.close()


def run_chain(stages: Sequence, params: dict[str, Any], inputs,
              *, batch: int = 1, codec: str = "raw",
              artifact_dir: str | None = None,
              env: dict[str, str] | None = None,
              in_band: bool = False, overlap: bool = True,
              rx_depth: int | None = None, tx_depth: int | None = None,
              inflight: int | None = None,
              replicas: dict[int, int] | None = None,
              hop_codecs: Sequence[str] | None = None,
              hop_tiers: Sequence[str] | None = None,
              tier: str = "auto",
              devices: int | None = None,
              device_map: dict[int, int] | None = None,
              stage_delays: Sequence[float] | None = None,
              stats_out: list | None = None,
              spawn_retries: int = 3,
              on_spawn=None,
              trace_sample_every: int = 0,
              plan=None,
              failover: bool = False,
              journal_dir: str | None = None,
              device: str = "cuda") -> list:
    """Export, spawn one OS process per stage, deploy, stream, tear down.

    The one-call analogue of the reference's whole deployment procedure
    (start N ``node.py`` processes, run the dispatcher,
    src/dispatcher.py:44-65 + test/test.py).  Every node runs its program
    on ``device`` (``"cuda"``, the default, or ``"cpu"``); the nodes are
    spawned by :func:`spawn_nodes`, which builds the hand kernels first on
    the card.

    ``in_band=True`` boots every node empty and ships each stage artifact
    over its control connection with an ACK handshake; ``in_band=False``
    exports the artifacts to ``artifact_dir`` (a temporary directory by
    default) and passes paths on the command line.  ``hop_codecs`` (one
    per stage) sets each stage's OUTBOUND hop codec (default ``codec``;
    the dispatcher -> stage 0 hop always uses ``codec``).
    ``stage_delays`` (seconds per stage) adds bench-only simulated device
    time per frame.  ``stats_out`` (a list) receives every node's
    ``stats`` reply, queried before teardown.  ``trace_sample_every=N``
    switches per-frame spans to 1-in-N sampling when tracing is on; the
    nodes' spans are collected into this process's tracer.  ``env``
    overrides entries of the children's environment.

    Children that exit with an address-in-use bind failure (the
    ``_free_ports`` race), at boot or later, and a dispatcher that loses
    the race for its result port, are retried on fresh ports, up to
    ``spawn_retries`` attempts; any other child death surfaces that
    node's log tail.  On any failure every child is terminated before the
    error propagates.  ``on_spawn(procs)`` is called with each spawn's
    ``subprocess.Popen`` list.

    Not ported yet, and raising ``NotImplementedError``: ``replicas`` and
    ``failover`` (A10b), ``tier`` and ``hop_tiers`` other than tcp/auto,
    ``devices`` and ``device_map`` (A10d), ``plan`` and ``journal_dir``
    (A12).
    """
    if replicas and any(int(r) > 1 for r in replicas.values()):
        raise _not_ported("A10b", "stage replicas")
    if failover:
        raise _not_ported("A10b", "failover")
    if devices is not None or device_map:
        raise _not_ported("A10d", "devices/device_map (stages pinned to devices)")
    if plan is not None:
        raise _not_ported("A12", "the live plan observation (plan=)")
    if journal_dir is not None:
        raise _not_ported("A12", "the flight-recorder journal (journal_dir=)")
    n = len(stages)
    _check_tier(tier, "run_chain")
    if hop_tiers is not None:
        if len(hop_tiers) != n - 1:
            raise ValueError(f"hop_tiers must have one entry per "
                             f"inter-stage hop ({n - 1}), got "
                             f"{len(hop_tiers)}")
        for t in hop_tiers:
            if t == "device":
                raise _not_ported("A10d", "the 'device' hop tier (stage fusion)")
            _check_tier(t, "run_chain hop_tiers")
    if hop_codecs is not None and len(hop_codecs) != n:
        raise ValueError(f"hop_codecs must have one entry per stage ({n}), "
                         f"got {len(hop_codecs)}")
    codec_of = list(hop_codecs) if hop_codecs is not None else [codec] * n
    if stage_delays is not None and len(stage_delays) != n:
        raise ValueError(f"stage_delays must have one entry per stage "
                         f"({n}), got {len(stage_delays)}")
    delay_of = ([float(d) for d in stage_delays]
                if stage_delays is not None else [0.0] * n)
    if in_band and any(delay_of):
        raise ValueError("stage_delays ride the node's argv: pass "
                         "in_band=False with them")
    dev = resolve_device(device)
    tuning = [] if overlap else ["--no-overlap"]
    for flag, v in (("--rx-depth", rx_depth), ("--tx-depth", tx_depth),
                    ("--inflight", inflight)):
        if v is not None:
            tuning += [flag, str(v)]

    tmp = None
    if artifact_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="defer_chain_")
        artifact_dir = tmp.name
    try:
        paths = None
        if not in_band:
            from ..utils.export import export_pipeline
            paths = export_pipeline(stages, params, artifact_dir,
                                    batch=batch)

        def argv_for(k: int, addrs, result) -> list[str]:
            if in_band:
                return tuning
            argv = ["--artifact", paths[k],
                    "--next", addrs[k + 1] if k + 1 < n else result,
                    "--codec", codec_of[k]]
            if delay_of[k]:
                argv += ["--infer-delay-ms", str(delay_of[k] * 1e3)]
            return argv + tuning

        last_exc: BaseException | None = None
        for attempt in range(max(1, spawn_retries)):
            try:
                with spawn_nodes(n, log_dir=artifact_dir, device=str(dev),
                                 argv_for=argv_for, env=env,
                                 on_spawn=on_spawn,
                                 spawn_retries=spawn_retries) as nodes:
                    return _drive_chain(
                        nodes, stages, params, inputs, batch=batch,
                        codec=codec, codec_of=codec_of, in_band=in_band,
                        rx_depth=rx_depth, tx_depth=tx_depth,
                        stats_out=stats_out,
                        trace_sample_every=trace_sample_every)
            except _BindRace as e:
                last_exc = e
                print(f"run_chain: bind race on attempt {attempt + 1} "
                      f"({e}); retrying on fresh ports", file=sys.stderr,
                      flush=True)
        raise RuntimeError(f"chain spawn lost the port race "
                           f"{spawn_retries} times: {last_exc}") from last_exc
    finally:
        if tmp is not None:
            tmp.cleanup()


def _drive_chain(nodes: NodeProcs, stages, params, inputs, *, batch, codec,
                 codec_of, in_band, rx_depth, tx_depth, stats_out,
                 trace_sample_every):
    """Deploy (in-band), stream and close one spawned chain (see
    :func:`run_chain`); raises :class:`_BindRace` when the dispatcher's
    result-port bind lost the ``_free_ports`` race."""
    try:
        disp = ChainDispatcher(nodes.addrs[0], listen=nodes.result,
                               codec=codec, tx_depth=tx_depth or 8,
                               rx_depth=rx_depth or 8,
                               trace_sample_every=trace_sample_every)
    except OSError as e:
        if any(m in str(e) for m in _BIND_RACE_MARKS):
            # as retryable as a child's
            raise _BindRace(f"dispatcher lost the result-port bind race "
                            f"({e})") from e
        raise
    failed = True
    try:
        if in_band:
            disp.deploy(stages, params, nodes.addrs, batch=batch,
                        codecs=codec_of)
        outs = disp.stream(inputs)
        if stats_out is not None:
            # queried while the nodes still serve (they exit once close()
            # cascades END)
            stats_out.extend(disp.stats(nodes.addrs))
        if tracer().enabled:
            try:
                disp.collect_trace(nodes.addrs)
            except (OSError, ConnectionError) as e:
                print(f"run_chain: trace collection failed: {e!r}",
                      file=sys.stderr)
        failed = False
    finally:
        if failed:
            # kill the children FIRST so the dispatcher's drain hits dead
            # sockets (fast) instead of waiting out its timeouts
            _kill_procs(nodes.procs)
        disp.close()
    return outs
