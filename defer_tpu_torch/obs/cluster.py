"""Dispatcher-side live observability: cluster aggregation, clock
alignment, and straggler detection over the chain's push telemetry.

The port's copy of ``defer_tpu.obs.cluster``: the same rows, flags and
verdicts from the same pushes, so a view of either package watches the
nodes of either.

The chain's nodes push ``{"cmd": "obs_push"}`` control frames (a
subscription started by ``{"cmd": "obs_subscribe"}`` on any control
connection — ``runtime/node.py``, ``obs/report.py``); this module is the
receiving half:

* :func:`estimate_clock_offset` — NTP's simplest form over a ctrl
  socket: N ping-pong rounds, keep the offset from the minimum-RTT
  sample.  The dispatcher then ships a ``clock_adjust`` back so the
  node's :attr:`Tracer._wall0_us` anchor lands on the dispatcher's
  timeline and every process's spans share one coherent Perfetto axis.
* :class:`ClusterView` — merges pushes into a rolling per-stage /
  per-replica model (throughput, latency percentiles, queue depths and
  watermarks, bytes/s) with a bounded per-node history; identifies the
  live bottleneck stage by the BACKPRESSURE EDGE (queue-watermark
  saturation stops at the bottleneck: every stage upstream of it has a
  saturated tx queue, the bottleneck's own tx is drained) falling back
  to per-stage service-time estimates.
* :class:`StragglerDetector` — compares the live model against the
  active plan's per-stage expectations (``stage_effective_ms``) and
  flags sustained deviation, sustained backpressure, or a stalled
  stage; :meth:`StragglerDetector.suggest` feeds the view's rows into
  the existing :func:`defer_tpu_torch.plan.replan.replan` machinery to emit a
  :class:`~defer_tpu_torch.plan.replan.ReplanResult` while the stream is
  still in flight.

Transport imports are deferred inside functions: ``transport.framed``
itself imports ``defer_tpu_torch.obs``, and this module must stay importable
from ``obs/__init__``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from .events import emit as emit_event
from .events import merge_events, recorder
from .trace import Tracer, tracer

#: a queue watermark at >= this fraction of its depth counts as saturated
SATURATION_FRAC = 0.9

#: default window (in pushes) for the rolling service estimates — ~2 s
#: at the default 250 ms report interval.  Shared with the capacity
#: plane's drift auditor (obs/capacity.py imports it from here).
SERVICE_WINDOW = 8


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

def estimate_clock_offset(sock, *, rounds: int = 8,
                          local: Tracer | None = None) -> dict:
    """Estimate the peer tracer's timeline offset over a ctrl socket.

    N ``clock_probe`` ping-pong rounds; per round the peer's reported
    ``now_us`` is compared against the local midpoint estimate
    ``t0 + rtt/2``.  The round with the minimum RTT bounds the error
    tightest (the probe least delayed by queueing), so its offset is the
    estimate — NTP's simplest form.  Returns ``{"offset_us", "rtt_us",
    "rounds"}`` where ``offset_us`` is (peer timeline − local timeline):
    ship ``-offset_us`` back in a ``clock_adjust`` to align the peer.
    """
    from ..transport.framed import K_CTRL, recv_frame, send_ctrl

    tr = local or tracer()
    best_rtt = None
    best_off = 0.0
    for i in range(max(1, rounds)):
        t0 = tr.now_us()
        send_ctrl(sock, {"cmd": "clock_probe", "echo": i})
        while True:
            kind, msg = recv_frame(sock)
            if kind == K_CTRL and isinstance(msg, dict) \
                    and msg.get("cmd") == "clock_probe_reply" \
                    and msg.get("echo") == i:
                break
        t1 = tr.now_us()
        rtt = t1 - t0
        off = float(msg["t_us"]) - (t0 + rtt / 2.0)
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_off = rtt, off
    return {"offset_us": best_off, "rtt_us": best_rtt,
            "rounds": max(1, rounds)}


def align_clock(sock, *, rounds: int = 8,
                local: Tracer | None = None) -> dict:
    """Estimate the peer's offset and ship the correcting
    ``clock_adjust`` (ACKed), so the peer's future AND buffered spans
    land on the local timeline.  Returns the estimate dict."""
    from ..transport.framed import K_ACK, recv_expect, send_ctrl

    est = estimate_clock_offset(sock, rounds=rounds, local=local)
    send_ctrl(sock, {"cmd": "clock_adjust",
                     "offset_us": -int(round(est["offset_us"]))})
    recv_expect(sock, K_ACK)
    return est


def expected_stage_ms(plan) -> list[float]:
    """Per-stage expected service milliseconds from a solved plan: the
    replica-divided ``stage_effective_ms`` when the plan is replicated,
    else the plain ``stage_cost_ms`` (max of compute and hop comm)."""
    doc = plan.to_json() if hasattr(plan, "to_json") else dict(plan)
    return list(doc.get("stage_effective_ms") or doc["stage_cost_ms"])


# ---------------------------------------------------------------------------
# cluster view
# ---------------------------------------------------------------------------

def _p50_ms(summ) -> float:
    if not isinstance(summ, dict) or not summ.get("count"):
        return 0.0
    return float(summ.get("p50", summ.get("mean", 0.0))) * 1e3


def _service_ms(push: dict) -> float:
    """One push's per-replica service-time estimate: the slowest of the
    three phases that each own a thread in the overlapped node loop
    (decode on rx, stage infer, encode on tx) — whichever is largest
    bounds that replica's steady-state rate."""
    lat = push.get("latency") or {}
    return max(_p50_ms(lat.get("infer_s")),
               _p50_ms(lat.get("decode_s")),
               _p50_ms(lat.get("encode_s")))


def _win_mean_ms(history, phase: str) -> float | None:
    """Delta-mean (ms) of one latency phase over a push window: the
    exact ``sum``/``count`` fields of the first and last push in the
    window subtract cleanly (percentiles do not), so the estimate
    reflects ONLY the frames of the current window — a regime shift
    shows up within a few pushes instead of being averaged into the
    lifetime fold.  ``None`` when the phase gained no samples."""
    first = (history[0][1].get("latency") or {}).get(phase) or {}
    last = (history[-1][1].get("latency") or {}).get(phase) or {}
    n = int(last.get("count", 0)) - int(first.get("count", 0))
    if n <= 0:
        return None
    return (float(last.get("sum", 0.0))
            - float(first.get("sum", 0.0))) / n * 1e3


class _Node:
    """Rolling per-node state: identity + a bounded push history."""

    __slots__ = ("ident", "addr", "history", "err", "events_dropped")

    def __init__(self, ident: dict, addr: str | None, history: int):
        self.ident = ident
        self.addr = addr
        self.history: collections.deque = collections.deque(maxlen=history)
        self.err: BaseException | None = None
        self.events_dropped = 0


class ClusterView:
    """Rolling per-stage / per-replica model of a live chain.

    Feed it either by :meth:`connect` (dial each node, clock-align,
    subscribe, one reader thread per node) or by calling :meth:`ingest`
    with ``obs_push`` payloads directly (tests, embedded dispatchers).
    """

    def __init__(self, *, history: int = 240, span_buffer: int = 4096,
                 event_buffer: int = 4096):
        self._lock = threading.Lock()
        self._nodes: dict = {}
        self._history = history
        self._spans: collections.deque = collections.deque(
            maxlen=span_buffer)
        #: cluster-merged flight-recorder events, arrival order
        #: (obs/events.py rides the obs_push frames here)
        self._events: collections.deque = collections.deque(
            maxlen=event_buffer)
        #: sum of every node's reported ring evictions (a nonzero total
        #: means the merged log has gaps — surfaced by monitor --events)
        self.events_dropped = 0
        self._socks: list = []
        self._threads: list[threading.Thread] = []
        self._closed = threading.Event()
        #: per-addr clock-offset estimates from :meth:`connect`
        self.clock_offsets: dict[str, dict] = {}

    # -- feeding -----------------------------------------------------------

    @staticmethod
    def _key(ident: dict, addr: str | None):
        stage = ident.get("stage")
        if stage is None:
            return ("addr", addr or ident.get("port"))
        return (int(stage), ident.get("replica"))

    def ingest(self, push: dict, addr: str | None = None) -> None:
        """Merge one ``obs_push`` payload into the rolling model."""
        ident = push.get("node") or {}
        key = self._key(ident, addr)
        with self._lock:
            node = self._nodes.get(key)
            if node is None:
                node = self._nodes[key] = _Node(ident, addr, self._history)
            node.ident = ident
            node.history.append((time.monotonic(), push))
            spans = (push.get("trace") or {}).get("spans") or ()
            self._spans.extend(spans)
            ev_doc = push.get("events") or {}
            self._events.extend(ev_doc.get("events") or ())
            dropped = ev_doc.get("dropped")
            if dropped is not None:
                # per-node lifetime counts: keep the max seen per node
                node.events_dropped = int(dropped)
                self.events_dropped = sum(
                    getattr(nd, "events_dropped", 0)
                    for nd in self._nodes.values())

    def connect(self, addrs, *, interval_ms: float = 250.0,
                spans: bool = False, span_limit: int = 256,
                align_clocks: bool = False, probe_clocks: bool = True,
                timeout_s: float = 30.0,
                clock_rounds: int = 8,
                reconnect: bool = False) -> "ClusterView":
        """Dial every node address, subscribe to its push stream, and
        consume pushes on one daemon reader thread per node until
        :meth:`close`.  A node that dies mid-watch marks its rows dead
        instead of killing the view.

        ``reconnect=True`` makes each reader SURVIVE node restarts: the
        failover supervisor respawns a killed replica on its old port,
        so the reader redials that address with the transport's jittered
        ``connect_retry`` backoff, re-subscribes, and resumes — the
        follow-mode monitor keeps tailing across the kill instead of
        going silent.  Resumed streams dedup naturally: a respawned
        process's events carry a fresh ``proc`` identity and a fresh
        subscription's cursor starts at its current ring position, and
        the consumer-side ``merge_events`` collapses any overlap on the
        ``(proc, seq)`` key.

        Clocks: ``probe_clocks`` (default) ESTIMATES each node's offset
        (filling :attr:`clock_offsets`) without touching its tracer —
        watching must be passive, and a monitor that re-anchored nodes
        to ITS OWN timeline would undo the dispatcher's earlier
        alignment and re-skew the final trace export.  Pass
        ``align_clocks=True`` only when this process IS the trace
        collector (e.g. ``ChainDispatcher.watch`` from the dispatcher,
        or ``monitor --align``)."""
        from ..transport.framed import send_ctrl

        self._sub = {"interval_ms": interval_ms, "spans": bool(spans),
                     "span_limit": int(span_limit)}
        self._reconnect = bool(reconnect)
        self._redial_timeout_s = float(timeout_s)
        for addr in addrs:
            host, _, port = str(addr).rpartition(":")
            sock = self._dial(host or "127.0.0.1", int(port), timeout_s)
            if align_clocks:
                self.clock_offsets[str(addr)] = align_clock(
                    sock, rounds=clock_rounds)
            elif probe_clocks:
                self.clock_offsets[str(addr)] = estimate_clock_offset(
                    sock, rounds=clock_rounds)
            send_ctrl(sock, {"cmd": "obs_subscribe",
                             "interval_ms": interval_ms,
                             "spans": bool(spans),
                             "span_limit": int(span_limit)})
            self._socks.append(sock)
            t = threading.Thread(target=self._reader,
                                 args=(sock, str(addr)),
                                 daemon=True, name="cluster-view-rx")
            t.start()
            self._threads.append(t)
        return self

    @staticmethod
    def _dial(host: str, port: int, timeout_s: float):
        from ..transport.framed import connect_retry
        return connect_retry(host, port, timeout_s)

    def _reader(self, sock, addr: str) -> None:
        from ..transport.framed import K_CTRL, K_END, recv_frame, send_ctrl
        while True:
            try:
                while not self._closed.is_set():
                    kind, msg = recv_frame(sock)
                    if kind == K_END:
                        return
                    if kind == K_CTRL and isinstance(msg, dict) \
                            and msg.get("cmd") == "obs_push":
                        self.ingest(msg, addr)
                return
            except (OSError, ConnectionError, ValueError) as e:
                with self._lock:
                    for node in self._nodes.values():
                        if node.addr == addr:
                            node.err = e
                if self._closed.is_set():
                    return
                # a node dying mid-watch is itself a flight-recorder
                # fact: it lands in THIS process's ring and therefore in
                # the merged log (the dead node can no longer push)
                self._events.append(emit_event(
                    "node_dead", addr=addr, error=repr(e)))
                if not getattr(self, "_reconnect", False):
                    return
                # survive the restart: the failover supervisor respawns
                # a killed replica on its OLD port, so redial the same
                # address with the transport's jittered backoff and
                # re-subscribe (a fresh subscription's event cursor
                # starts at the new ring's position; merge_events dedups
                # any overlap on (proc, seq))
                host, _, port = addr.rpartition(":")
                try:
                    sock = self._dial(host or "127.0.0.1", int(port),
                                      getattr(self, "_redial_timeout_s",
                                              30.0))
                    send_ctrl(sock, {"cmd": "obs_subscribe",
                                     **self._sub})
                except (OSError, ConnectionError):
                    return   # node stayed dead past the dial deadline
                if self._closed.is_set():
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                self._socks.append(sock)
                with self._lock:
                    for node in self._nodes.values():
                        if node.addr == addr:
                            node.err = None

    def close(self) -> None:
        """Unsubscribe (best-effort END) and drop every connection."""
        from ..transport.framed import send_end
        self._closed.set()
        for s in self._socks:
            try:
                send_end(s)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)

    # -- the rolling model -------------------------------------------------

    def _rate(self, node: _Node, field, window: int = 5) -> float:
        """Delta-rate of a cumulative counter over the last few pushes."""
        h = list(node.history)[-window:]
        if len(h) < 2:
            return 0.0
        (t0, p0), (t1, p1) = h[0], h[-1]
        dt = t1 - t0
        if dt <= 0:
            return 0.0
        return (field(p1) - field(p0)) / dt

    def rows(self) -> list[dict]:
        """Per-replica live rows, stage order (dispatcher-addressed rows
        last).  Rates are deltas over the last few pushes; percentiles
        come from the node's cumulative histograms."""
        out = []
        with self._lock:
            nodes = list(self._nodes.items())
        now = time.monotonic()
        for key, node in nodes:
            if not node.history:
                continue
            t_last, last = node.history[-1]
            q = last.get("queues") or {}
            lat = last.get("latency") or {}
            cnt = last.get("counters") or {}
            # watermarks are per-interval peaks: report the max over the
            # last few pushes so a burst is visible past one interval
            recent = [p for _, p in list(node.history)[-5:]]

            def peak(field: str) -> float:
                return max(((p.get("queues") or {}).get(field, 0)
                            for p in recent), default=0)
            row = {
                "stage": node.ident.get("stage"),
                "replica": node.ident.get("replica"),
                # branched stage graphs: the branch
                # path this vertex rides, and the join width when this
                # vertex merges P paths — what the monitor's BR column
                # renders so a bottleneck highlight names the branch
                "branch": node.ident.get("branch"),
                "join": node.ident.get("join"),
                "name": node.ident.get("name"),
                # negotiated OUTBOUND transport tier of the node's hop
                # (tcp / local / shm / auto-until-negotiated) —
                # distinguishes wire-bound rows from colocated
                # fast-path ones — plus the hop's degraded-offer count
                # (a tcp row with fallbacks is a hop that WANTED a
                # colocated tier; the monitor marks it "tcp!")
                "tier": node.ident.get("tier"),
                "tier_fallbacks": node.ident.get("tier_fallbacks", 0),
                "addr": node.addr,
                "pushes": len(node.history),
                "age_s": round(now - t_last, 3),
                "alive": node.err is None,
                "processed": last.get("processed", 0),
                "throughput_per_s": round(self._rate(
                    node, lambda p: p.get("processed", 0)), 3),
                "rx_bytes_per_s": round(self._rate(
                    node, lambda p: (p.get("counters") or {})
                    .get("rx_bytes", 0)), 1),
                "tx_bytes_per_s": round(self._rate(
                    node, lambda p: (p.get("counters") or {})
                    .get("tx_bytes", 0)), 1),
                "infer_ms": {k: round(float(
                    (lat.get("infer_s") or {}).get(k, 0.0)) * 1e3, 4)
                    for k in ("p50", "p95", "p99")},
                # host-sync distribution (the copy to the host
                # around the compute loop): an ici hop's row shows
                # count == 0 — the observable proof the device-resident
                # path skipped the host round-trip entirely
                "host_sync_ms": {
                    "p50": round(float((lat.get("host_sync_s") or {})
                                       .get("p50", 0.0)) * 1e3, 4),
                    "count": int((lat.get("host_sync_s") or {})
                                 .get("count", 0))},
                # the infer X-ray (obs/profile.py): dispatch = the program
                # call returning (host-side cost), device =
                # the CUDA event's wait — the monitor's DISP/DEV columns;
                # count 0 (rendered "-") from a pre-profiling node
                "dispatch_ms": {
                    "p50": round(float((lat.get("dispatch_s") or {})
                                       .get("p50", 0.0)) * 1e3, 4),
                    "count": int((lat.get("dispatch_s") or {})
                                 .get("count", 0))},
                "device_ms": {
                    "p50": round(float((lat.get("device_s") or {})
                                       .get("p50", 0.0)) * 1e3, 4),
                    "count": int((lat.get("device_s") or {})
                                 .get("count", 0))},
                "queue_ms": {
                    "p50": round(float((lat.get("queue_s") or {})
                                       .get("p50", 0.0)) * 1e3, 4),
                    "count": int((lat.get("queue_s") or {})
                                 .get("count", 0))},
                # compile/memory telemetry: None from old-vintage or
                # CPU processes (rendered "-", never a fake 0)
                "mem_bytes": last.get("mem_bytes"),
                "recompiles": last.get("recompiles"),
                "service_ms": round(_service_ms(last), 4),
                # window-bounded rolling service (delta-means over the
                # last few pushes) — the current-regime estimate the
                # drift auditor and suggest() score against
                "service_win_ms": round(
                    self._windowed_service_ms(node, SERVICE_WINDOW), 4),
                # capacity accounting shipped by the node itself
                # (deploy message carries the stage's analytic FLOPs;
                # the node owns its chip generation).  mfu is None —
                # rendered "-" — when the peak is unknown.
                "flops": (last.get("capacity") or {}).get("flops"),
                "mfu": (last.get("capacity") or {}).get("mfu"),
                "achieved_flops_s": (last.get("capacity") or {})
                .get("achieved_flops_s"),
                "rx_q": q.get("rx", 0), "tx_q": q.get("tx", 0),
                "rx_hi": peak("rx_hi"), "tx_hi": peak("tx_hi"),
                "rx_depth": q.get("rx_depth", 0),
                "tx_depth": q.get("tx_depth", 0),
                "inflight": q.get("inflight", 0),
                "tx_frames": cnt.get("tx_frames", 0),
                "rx_frames": cnt.get("rx_frames", 0),
                "spans_dropped": (last.get("trace") or {})
                .get("dropped", 0),
            }
            out.append(row)
        out.sort(key=lambda r: ((0, r["stage"], r["replica"] or 0)
                                if r["stage"] is not None
                                else (1, 0, 0)))
        return out

    def stats_rows(self) -> list[dict]:
        """The latest push per node reshaped like a
        ``ChainDispatcher.stats`` reply row — directly consumable by
        :func:`defer_tpu_torch.plan.replan.measured_stage_seconds` / replan."""
        out = []
        with self._lock:
            nodes = list(self._nodes.values())
        for node in nodes:
            if not node.history:
                continue
            _, last = node.history[-1]
            lat = last.get("latency") or {}
            out.append({
                "stage": node.ident.get("stage"),
                "name": node.ident.get("name"),
                "replica": node.ident.get("replica"),
                "fan_in": node.ident.get("fan_in", 1),
                "processed": last.get("processed", 0),
                "infer_latency_s": lat.get("infer_s") or {"count": 0},
            })
        return out

    def spans(self) -> list[dict]:
        """Recent pushed span samples (bounded buffer)."""
        with self._lock:
            return list(self._spans)

    def events(self, *, include_local: bool = True) -> list[dict]:
        """The cluster-merged flight-recorder log: every watched node's
        pushed events (plus, by default, this process's own ring — a
        dispatcher/front door colocated with the monitor) ordered by
        the clock-aligned timestamp with per-process seq as the tie
        break (:func:`~defer_tpu_torch.obs.events.merge_events`)."""
        with self._lock:
            batch = list(self._events)
        if include_local:
            # the view's node_dead markers are already copies of local
            # ring entries — dedup on (proc, seq)
            seen = {(e.get("proc"), e.get("seq")) for e in batch}
            batch += [e for e in recorder().snapshot()
                      if (e.get("proc"), e.get("seq")) not in seen]
        return merge_events(batch)

    def take_events(self) -> list[dict]:
        """Drain the NODE-pushed events accumulated since the last call
        (arrival order) — the monitor's incremental read; merge with
        :func:`merge_events` per batch when rendering."""
        out = []
        with self._lock:
            while self._events:
                out.append(self._events.popleft())
        return out

    # -- bottleneck identification ----------------------------------------

    def _stage_map(self) -> dict[int, list[dict]]:
        stages: dict[int, list[dict]] = {}
        for r in self.rows():
            if r["stage"] is not None:
                stages.setdefault(int(r["stage"]), []).append(r)
        return stages

    @staticmethod
    def _saturated(row: dict, side: str) -> bool:
        depth = row.get(f"{side}_depth") or 0
        return depth > 0 and row.get(f"{side}_hi", 0) \
            >= SATURATION_FRAC * depth

    @staticmethod
    def _eff_ms(reps: list[dict]) -> float:
        """Replica-divided effective service of one stage's rows: the
        mean replica service time over the replica count — THE formula
        shared by bottleneck() and stage_effective_ms()."""
        return (sum(r["service_ms"] for r in reps) / len(reps)
                / max(1, len(reps)))

    def bottleneck(self) -> int | None:
        """The live bottleneck stage id, or None when there is no data
        OR no conclusive signal (service estimates within noise of each
        other and no queue saturated).

        Primary signal — per-stage service time: each stage's rate is
        bounded by the slowest of its three phase threads (inbound
        decode, infer, outbound encode — per-channel/per-node p50s, so
        blocking waits never pollute the estimate), divided by its
        replica count.  A clear winner (>= 1.5x the runner-up) is the
        bottleneck.  When timing is flat — e.g. a wire-bound hop whose
        cost is invisible to any CPU histogram — fall back to the
        backpressure edge: saturation propagates upstream of the
        bottleneck (full tx watermarks) while everything downstream
        starves, so the bottleneck is the most-downstream stage whose
        own rx queue watermark is saturated or whose predecessor's tx
        watermark is."""
        stages = self._stage_map()
        if not stages:
            return None
        order = sorted(stages)
        eff = {k: self._eff_ms(reps) for k, reps in stages.items()}
        top = max(eff, key=lambda k: eff[k])
        if eff[top] > 0:
            runner_up = max((v for k, v in eff.items() if k != top),
                            default=0.0)
            if len(order) == 1 or eff[top] >= 1.5 * runner_up:
                return top
        candidates = []
        for i, k in enumerate(order):
            own_rx = any(self._saturated(r, "rx") for r in stages[k])
            up_tx = i > 0 and any(self._saturated(r, "tx")
                                  for r in stages[order[i - 1]])
            if own_rx or up_tx:
                candidates.append(k)
        if candidates:
            return max(candidates)
        # neither signal is conclusive (service times within noise of
        # each other, no queue saturated): say so rather than flip
        # between near-equal stages refresh to refresh
        return None

    def _windowed_service_ms(self, node: _Node, window: int) -> float:
        """One node's window-bounded service estimate: the max of the
        three phase delta-means (see :func:`_win_mean_ms`) over the last
        ``window`` pushes.  Falls back to the lifetime p50 estimate
        when the window holds fewer than two pushes or no phase gained
        samples (an idle chain keeps its last honest figure instead of
        reading as infinitely fast)."""
        h = list(node.history)[-max(2, int(window)):]
        if not h:
            return 0.0
        if len(h) < 2:
            return _service_ms(h[-1][1])
        vals = [v for v in (_win_mean_ms(h, ph) for ph in
                            ("infer_s", "decode_s", "encode_s"))
                if v is not None]
        if not vals:
            return _service_ms(h[-1][1])
        return max(vals)

    def stage_service_ms(self, *, window: int | None = None
                         ) -> dict[int, float]:
        """Live UNDIVIDED per-stage service estimate (ms): the mean
        replica service time — what one replica costs per frame, the
        unit :func:`defer_tpu_torch.plan.replan.measured_stage_seconds`
        expects (the solver divides by R itself).

        ``window`` bounds the estimate to the last N pushes (rolling
        delta-means) instead of the lifetime histogram fold — the form
        calibration and drift scoring use, so a long-running chain's
        current regime is scored rather than its cold-start average."""
        if window is None:
            return {k: sum(r["service_ms"] for r in reps) / len(reps)
                    for k, reps in self._stage_map().items()}
        with self._lock:
            nodes = list(self._nodes.values())
        acc: dict[int, list[float]] = {}
        for node in nodes:
            stage = node.ident.get("stage")
            if stage is None or not node.history:
                continue
            acc.setdefault(int(stage), []).append(
                self._windowed_service_ms(node, window))
        return {k: sum(vs) / len(vs) for k, vs in acc.items()}

    def stage_effective_ms(self) -> dict[int, float]:
        """Live per-stage effective service estimate (ms): the mean
        replica service time divided by the replica count — the number
        the planner's ``stage_effective_ms`` predicts."""
        return {k: self._eff_ms(reps)
                for k, reps in self._stage_map().items()}


# ---------------------------------------------------------------------------
# straggler / stall detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerFlag:
    stage: int
    reason: str            #: "slow" | "backpressure" | "stalled"
    measured_ms: float
    expected_ms: float
    ratio: float
    intervals: int         #: consecutive reporting intervals sustained

    def to_json(self) -> dict:
        return {"stage": self.stage, "reason": self.reason,
                "measured_ms": round(self.measured_ms, 4),
                "expected_ms": round(self.expected_ms, 4),
                "ratio": round(self.ratio, 4),
                "intervals": self.intervals}


class StragglerDetector:
    """Flags stages whose live behavior deviates from the active plan.

    ``expected_stage_ms`` is the plan's prediction (see
    :func:`expected_stage_ms`); a stage is flagged when, for the last
    ``sustain`` pushes (reporting intervals):

    * ``slow`` — its live service estimate exceeded ``factor`` × the
      plan's figure every interval;
    * ``backpressure`` — the backpressure edge pointed at it every
      interval (queue-watermark saturation, see
      :meth:`ClusterView.bottleneck`);
    * ``stalled`` — it processed nothing while some other stage did
      (a dead replica / wedged stage).

    The detector is evaluated on demand against the view's history, so
    one :meth:`observe` call at any time answers "sustained over the
    last k intervals?" without needing to be polled on a schedule.
    """

    def __init__(self, expected_ms=None, *,
                 factor: float = 1.5, sustain: int = 2):
        self.expected_ms = list(expected_ms) if expected_ms else None
        self.factor = factor
        self.sustain = max(1, sustain)
        #: (stage, reason) pairs already emitted into the flight
        #: recorder — a sustained flag is ONE event, not one per poll
        self._emitted: set[tuple[int, str]] = set()

    def _stage_history(self, view: ClusterView) -> dict[int, list[list]]:
        """stage -> per-replica push histories (newest last)."""
        out: dict[int, list[list]] = {}
        with view._lock:
            nodes = list(view._nodes.values())
        for node in nodes:
            stage = node.ident.get("stage")
            if stage is None:
                continue
            out.setdefault(int(stage), []).append(
                [p for _, p in node.history])
        return out

    def observe(self, view: ClusterView) -> list[StragglerFlag]:
        hist = self._stage_history(view)
        if not hist:
            return []
        order = sorted(hist)
        flags: dict[int, StragglerFlag] = {}
        k_sust = self.sustain

        def service_at(k: int, i_back: int) -> float:
            """Mean replica-divided service estimate i_back pushes ago."""
            reps = hist[k]
            vals = [_service_ms(h[-1 - i_back]) for h in reps
                    if len(h) > i_back]
            if not vals:
                return 0.0
            return sum(vals) / len(vals) / max(1, len(reps))

        def sat_at(k: int, i_back: int, side: str) -> bool:
            for h in hist[k]:
                if len(h) > i_back:
                    q = h[-1 - i_back].get("queues") or {}
                    depth = q.get(f"{side}_depth") or 0
                    if depth > 0 and q.get(f"{side}_hi", 0) \
                            >= SATURATION_FRAC * depth:
                        return True
            return False

        def processed_delta(k: int, n: int) -> int:
            d = 0
            for h in hist[k]:
                if len(h) > n:
                    d += (h[-1].get("processed", 0)
                          - h[-1 - n].get("processed", 0))
            return d

        enough = all(any(len(h) > k_sust for h in hist[k]) for k in order)
        for i, k in enumerate(order):
            # slow: sustained deviation from the plan's expectation
            if self.expected_ms is not None and k < len(self.expected_ms):
                exp = self.expected_ms[k]
                vals = [service_at(k, b) for b in range(k_sust)]
                if exp > 0 and vals and all(v > self.factor * exp
                                            for v in vals):
                    flags[k] = StragglerFlag(
                        stage=k, reason="slow", measured_ms=vals[0],
                        expected_ms=exp, ratio=vals[0] / exp,
                        intervals=k_sust)
            # backpressure: the saturation edge pointed at k every
            # interval (own rx saturated, or predecessor tx saturated,
            # while k's own tx stayed drained)
            if k not in flags:
                held = all(
                    (sat_at(k, b, "rx")
                     or (i > 0 and sat_at(order[i - 1], b, "tx")))
                    and not sat_at(k, b, "tx")
                    for b in range(k_sust))
                if held and any(len(h) > k_sust for h in hist[k]):
                    exp = (self.expected_ms[k]
                           if self.expected_ms is not None
                           and k < len(self.expected_ms) else 0.0)
                    meas = service_at(k, 0)
                    flags[k] = StragglerFlag(
                        stage=k, reason="backpressure", measured_ms=meas,
                        expected_ms=exp,
                        ratio=meas / exp if exp > 0 else 0.0,
                        intervals=k_sust)
            # stalled: no progress for k_sust intervals while an
            # UPSTREAM stage kept producing — work is flowing toward k
            # and k consumes none of it (a wedged/dead stage).  An
            # upstream-only condition on purpose: at a healthy stream's
            # tail the early stages finish first while later stages
            # drain, which must not read as a stall.
            if k not in flags and enough \
                    and processed_delta(k, k_sust) == 0 \
                    and any(processed_delta(j, k_sust) > 0
                            for j in order if j < k):
                flags[k] = StragglerFlag(
                    stage=k, reason="stalled", measured_ms=0.0,
                    expected_ms=0.0, ratio=0.0, intervals=k_sust)
        out = [flags[k] for k in sorted(flags)]
        live = set()
        for f in out:
            key = (f.stage, f.reason)
            live.add(key)
            if key not in self._emitted:
                self._emitted.add(key)
                emit_event("straggler", **f.to_json())
        # a flag that clears re-arms its event for the next episode
        self._emitted &= live
        return out

    def suggest(self, view: ClusterView, graph, plan, cost=None):
        """Feed the live measurements into the replanner: returns the
        :class:`~defer_tpu_torch.plan.replan.ReplanResult` for the measured
        stage costs — the mid-stream "move the cuts / move the replicas"
        suggestion the monitor surfaces.  Uses the full per-stage
        SERVICE estimate (max of decode/infer/encode), so a straggler
        whose pain is a hop codec — invisible to infer-only latency —
        still drives the correction.  With no ``cost`` the model is
        reconstructed from the plan itself
        (:func:`~defer_tpu_torch.plan.replan.cost_model_from_plan`), so the
        corrections are measured-vs-plan, not measured-vs-analytic."""
        from ..plan.replan import cost_model_from_plan, replan
        if cost is None:
            cost = cost_model_from_plan(graph, plan)
        # drop stages with no samples yet (a wedged-from-boot stage has
        # 0.0 service): a zero would scale that stage's cost to nothing
        # and the re-solve would pile work onto the dead stage.
        # Window-bounded on purpose: the suggestion must correct toward
        # the CURRENT regime, not the lifetime average with cold-start
        # samples folded in forever
        measured = {
            k: v / 1e3
            for k, v in view.stage_service_ms(
                window=SERVICE_WINDOW).items() if v > 0}
        result = replan(graph, plan, measured, cost)
        emit_event("replan", moved=bool(result.moved),
                   corrections={str(k): round(float(v), 4)
                                for k, v in result.corrections.items()})
        return result
