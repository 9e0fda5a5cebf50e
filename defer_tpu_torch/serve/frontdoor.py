"""The serving front door: many concurrent client streams multiplexed
onto one deployed chain (or one continuous-batching decode engine).

The port of ``defer_tpu.serve.frontdoor``: the same hello, welcome, shed,
stats and events protocol, in frames byte-identical to the JAX package's,
so either package's client talks to either package's door.

Topology::

    clients --hello/samples--> [admission: WFQ + SLO shed]
                                    |
                              [batch former]         (tensor mode)
                                    |  W-row frames + req_meta K_CTRL
                              ChainDispatcher -> stage0 -> ... -> stageN
                                    |                             |
                              [demux on the result hop] <---------+
                                    |  per-row, keyed by the cascaded
                                    v  req_meta composition
                               owning client (K_TENSOR_SEQ, seq =
                               the client's own sample number)

Decode mode replaces the chain with a
:class:`~defer_tpu_torch.serve.engine.ContinuousBatchEngine`: each
admitted unit is a whole generation request whose KV state rides the
engine's pipeline stages, joining/leaving the batch between decode steps.
Every CUDA call of decode mode runs on the engine's thread; the door's
reader threads only parse frames and admit.

Client wire protocol (framed, ``transport/framed.py``): one K_CTRL
``hello`` (tenant identity + fairness/SLO knobs), then one K_TENSOR per
sample (tensor mode: one ``in_shape`` sample; decode mode: one 1-D
prompt), then K_END.  Replies: per-sample ``K_TENSOR_SEQ`` stamped with
the CLIENT's own sample number (results may complete out of submission
order; the stamp is the join key), or a ``shed`` K_CTRL carrying the
admission prediction and a retry hint; K_END echoes after the client's
END once every admitted sample resolved.  A connection whose first
frame is ``{"cmd": "stats"}`` is an observer, not a tenant: it gets the
per-tenant serving stats reply.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Sequence

import numpy as np

from ..obs import REGISTRY, tracer
from ..obs.attrib import DoorAttribution
from ..obs.events import emit as emit_event
from ..obs.events import recorder
from ..transport.channel import _sampled
from ..transport.framed import (K_CTRL, K_END, K_TENSOR, configure_socket,
                                recv_frame, send_ctrl, send_end, send_frame)
from .admission import AdmissionController, TenantConfig
from .batcher import BatchFormer
from .engine import ContinuousBatchEngine, DecodeRequest, EngineLoop


class _Client:
    """One accepted tenant connection."""

    __slots__ = ("conn", "tenant", "wlock", "state", "alive", "draining",
                 "outstanding", "decode_kw", "requests")

    def __init__(self, conn, tenant: str):
        self.conn = conn
        self.tenant = tenant
        self.wlock = threading.Lock()   # serializes reply writes
        self.state = threading.Lock()   # guards the fields below
        self.alive = True
        self.draining = False
        self.outstanding = 0            # admitted, result not yet sent
        self.decode_kw: dict = {}
        #: live decode requests (for cancellation on disconnect)
        self.requests: list = []


class _Unit:
    """One admitted sample (tensor mode)."""

    __slots__ = ("client", "seq", "rid", "sample", "queued_at",
                 "queued_pc", "popped_at", "submitted_at", "demuxed_at",
                 "sampled_seq", "settled")

    def __init__(self, client: _Client, seq: int, rid: int,
                 sample: np.ndarray):
        self.client = client
        self.seq = seq          #: the client's own sample number
        self.rid = rid          #: door-global request id (demux key)
        self.sample = sample
        #: admission-slot settlement token (guarded by client.state):
        #: delivery and the backend-lost shed sweep can both reach a
        #: unit — whichever flips this settles the slot, the other
        #: backs off
        self.settled = False
        self.queued_at = time.monotonic()
        #: the same instant on the tracer/attribution clock
        #: (perf_counter) — plus the downstream waypoints the batch
        #: former / backend stamp: popped from the admission queue,
        #: frame submitted into the chain, frame back off the demux.
        #: Together they tile the unit's timeline for the always-on
        #: door attribution buckets (obs/attrib.py)
        self.queued_pc = time.perf_counter()
        self.popped_at: float | None = None
        self.submitted_at: float | None = None
        self.demuxed_at: float | None = None
        #: frame wire seq when this request was trace-sampled (the
        #: join key to the chain's stageK spans), else None
        self.sampled_seq: int | None = None


class ChainBackend:
    """Tensor-mode backend: formed microbatches ride one deployed chain.

    ``dispatcher`` is duck-typed: a connected chain dispatcher (the JAX
    package's ``ChainDispatcher`` until the port has its own stage
    processes) with ``begin_trace``, ``send_request_frame``,
    ``recv_result`` and ``close``, whose stage programs run at frame
    batch ``width``.  Every formed
    frame is exactly ``width`` rows (queued units + zero padding),
    preceded by its ``req_meta`` composition frame; the demux thread
    attributes result rows by the metadata that CASCADED THROUGH THE
    CHAIN, not by local bookkeeping — a chain that reorders or drops a
    metadata frame fails loudly instead of mixing tenants' bytes.
    ``window`` bounds frames in flight inside the chain; everything
    beyond it waits in the admission queue where shed predictions can
    see it.
    """

    def __init__(self, dispatcher, width: int, in_shape: Sequence[int], *,
                 window: int = 8, trace_sample_every: int = 0):
        self.disp = dispatcher
        self.width = int(width)
        self.in_shape = tuple(in_shape)
        #: request-scoped waterfall sampling: with tracing enabled,
        #: 1-in-N FRAMES — and therefore whole requests, every unit of a
        #: sampled frame — record spans end to end, keyed on the frame's
        #: wire seq that already rides the chain; 0 = every frame
        self.trace_sample_every = max(0, int(trace_sample_every))
        self._window = threading.Semaphore(max(1, window))
        self._next_seq = 0
        self._pending: dict[int, dict[int, _Unit]] = {}
        self._metas: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._last_done = 0.0
        #: True when, at the LAST completion, another frame was already
        #: in flight — only then is the next completion gap evidence of
        #: service rate rather than of an idle lull (an idle gap folded
        #: into the EWMA would shed deadline tenants forever after a
        #: traffic pause: no admissions -> no completions -> no decay)
        self._prev_busy = False
        self._frames = REGISTRY.counter("serve.frames")
        self._samples = REGISTRY.counter("serve.samples")
        self.on_deliver = None       # set by the door
        self.on_service = None       # set by the door
        self._halt = threading.Event()
        self._rx: threading.Thread | None = None
        self.error: BaseException | None = None

    def start(self) -> None:
        # trace composition happens BEFORE the demux reader exists:
        # begin_trace cascades the trace context (and the shared
        # sample_every) down the chain ahead of any request frame, so
        # every stage samples the SAME 1-in-N wire seqs the door does
        if tracer().enabled:
            self.disp.begin_trace(sample_every=self.trace_sample_every)
        self._rx = threading.Thread(target=self._demux, daemon=True,
                                    name="serve-chain-demux")
        self._rx.start()

    def submit(self, entries: list[tuple[str, _Unit]]) -> None:
        """Ship one formed microbatch (<= width units)."""
        live = [u for _, u in entries
                if u.client.alive or u.client.draining]
        # a unit whose client died while queued is dropped here — its
        # admission slot must still be released
        for _, u in entries:
            if u not in live and self.on_deliver is not None:
                self.on_deliver(u, None)
        if not live:
            return
        frame = np.zeros((self.width,) + self.in_shape, np.float32)
        slots = []
        for row, u in enumerate(live):
            frame[row] = u.sample
            slots.append([u.client.tenant, u.rid, u.seq, row])
        self._window.acquire()
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._pending[seq] = {u.rid: u for u in live}
        now = time.perf_counter()
        tr = tracer()
        if tr.enabled and _sampled(self.trace_sample_every, seq):
            # a sampled FRAME samples every request riding it: the
            # admission-wait and gather spans land on the same timeline
            # (and under the same trace) as the chain's stageK spans
            first_pop = min((u.popped_at for u in live
                             if u.popped_at is not None), default=now)
            tr.record("serve.gather", first_pop,
                      max(now - first_pop, 0.0),
                      {"seq": seq, "n": len(live)})
            for u in live:
                u.sampled_seq = seq
                pop = u.popped_at if u.popped_at is not None else now
                tr.record("serve.admission_wait", u.queued_pc,
                          max(pop - u.queued_pc, 0.0),
                          {"rid": u.rid, "tenant": u.client.tenant,
                           "seq": seq})
        for u in live:
            u.submitted_at = now
        self.disp.send_request_frame(
            frame, seq=seq, meta={"slots": slots, "t": time.monotonic()})
        self._frames.n += 1
        self._samples.n += len(live)

    def _demux(self) -> None:
        try:
            while not self._halt.is_set():
                try:
                    kind, value = self.disp.recv_result(timeout_s=1.0)
                except TimeoutError:
                    continue
                if kind == "meta":
                    self._metas[int(value["seq"])] = value
                    continue
                if kind == "end":
                    return
                seq, arr = value
                if seq is None:
                    raise ConnectionError(
                        "result frame arrived unstamped; the chain must "
                        "relay request-scoped sequence numbers")
                meta = self._metas.pop(seq, None)
                if meta is None:
                    raise ConnectionError(
                        f"result frame seq={seq} arrived without its "
                        f"req_meta — the chain dropped or reordered "
                        f"request metadata")
                with self._lock:
                    units = self._pending.pop(seq)
                    still_busy = bool(self._pending)
                now = time.monotonic()
                # live per-unit service estimate from the completion
                # RATE (amortized chain throughput), not end-to-end
                # latency: the pipeline overlaps frames, so the gap
                # between completions is what bounds capacity.  Only
                # back-to-back gaps count (_prev_busy): a gap spanning
                # an idle lull measures the lull, not the service.
                gap = now - self._last_done if self._last_done else None
                self._last_done = now
                n_live = len(meta["slots"])
                if self.on_service is not None and gap is not None \
                        and n_live and self._prev_busy:
                    self.on_service(max(1e-6, gap) / n_live, n_live)
                self._prev_busy = still_busy
                arr = np.asarray(arr)
                now_pc = time.perf_counter()
                for tenant, rid, cseq, row in meta["slots"]:
                    unit = units.pop(rid, None)
                    if unit is None:
                        raise ConnectionError(
                            f"req_meta names unknown request {rid} "
                            f"(tenant {tenant}, frame {seq})")
                    if unit.seq != cseq or unit.client.tenant != tenant:
                        raise ConnectionError(
                            f"req_meta/unit mismatch on frame {seq}: "
                            f"{tenant}/{rid}/{cseq}")
                    unit.demuxed_at = now_pc
                    if self.on_deliver is not None:
                        self.on_deliver(unit, arr[row])
                self._window.release()
        except BaseException as e:  # noqa: BLE001 — surfaced by the door
            if not self._halt.is_set():
                self.error = e

    def halt_demux(self) -> None:
        """Stop the demux reader and wait it out — the backend-lost
        settlement sweep must not race a late delivery for the same
        admission slot."""
        self._halt.set()
        if self._rx is not None:
            self._rx.join(timeout=10.0)

    def drain_pending(self) -> list[_Unit]:
        """Pop every in-flight unit (submitted into the chain, result
        never demuxed) and release their window slots.  Call with the
        demux halted; the units' admission slots are the caller's to
        settle."""
        with self._lock:
            frames = list(self._pending.values())
            self._pending.clear()
            self._metas.clear()
        units = [u for frame in frames for u in frame.values()]
        for _ in frames:
            self._window.release()
        return units

    def close(self) -> None:
        # stop the demux reader BEFORE the dispatcher's drain: both read
        # the result channel, and a demux thread still racing would eat
        # the cascaded K_END and leave close() waiting out its timeout
        self.halt_demux()
        try:
            self.disp.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


class ServeFrontDoor:
    """The multi-tenant admission server.

    Tensor mode: pass a :class:`ChainBackend`.  Decode mode: pass a
    :class:`~defer_tpu_torch.serve.engine.ContinuousBatchEngine` as
    ``engine``.  ``tenants`` pre-configures known tenants; unknown
    tenants are auto-configured from their hello (weight/priority/
    deadline knobs are client-supplied then — a real deployment would
    pin them server-side).
    """

    def __init__(self, *, listen: str = "127.0.0.1:0",
                 backend: ChainBackend | None = None,
                 engine: ContinuousBatchEngine | None = None,
                 tenants: Sequence[TenantConfig] = (),
                 seed_service_s: float = 0.0,
                 decode_defaults: dict | None = None,
                 gather_s: float = 0.0):
        if (backend is None) == (engine is None):
            raise ValueError("pass exactly one of backend= / engine=")
        host, _, port = listen.rpartition(":")
        self._srv = socket.create_server((host or "127.0.0.1", int(port)))
        self.address = self._srv.getsockname()
        self.mode = "decode" if engine is not None else "tensor"
        self.admission = AdmissionController(seed_service_s=seed_service_s)
        for cfg in tenants:
            self.admission.configure(cfg)
        self.backend = backend
        self.engine = engine
        self.width = engine.width if engine is not None else backend.width
        self.former = BatchFormer(self.admission.queue, self.width,
                                  gather_s=gather_s)
        self.decode_defaults = dict(decode_defaults or {})
        #: always-on per-tenant latency-attribution buckets (admission /
        #: gather / chain / result edge); rides the stats reply
        self.attrib = DoorAttribution()
        self._clients: list[_Client] = []
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._threads: list[threading.Thread] = []
        self._next_rid = 0
        self._engine_loop: EngineLoop | None = None
        self.error: BaseException | None = None
        #: set once the chain backend died and its in-flight units were
        #: shed/settled — the door then sheds new samples at ingest
        #: (reason "backend_lost") instead of queueing into a dead chain
        self._backend_dead = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeFrontDoor":
        if self.backend is not None:
            self.backend.on_deliver = self._deliver
            self.backend.on_service = \
                lambda s, n: self.admission.observe_service(s)
            self.backend.start()
            t = threading.Thread(target=self._form_loop, daemon=True,
                                 name="serve-batch-former")
            t.start()
            self._threads.append(t)
        else:
            # decode: per-unit service = per-token step time x a typical
            # generation length, so shed predictions price whole requests
            typ = float(self.decode_defaults.get("max_new_tokens", 16))

            def on_service(per_tok_s, _n):
                self.admission.observe_service(per_tok_s * typ)

            self._engine_loop = EngineLoop(self.engine, self.former,
                                           on_service=on_service)
            self._engine_loop.start()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="serve-accept")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._halt.set()
        try:
            self._srv.close()
        except OSError:
            pass
        if self._engine_loop is not None:
            self._engine_loop.stop()
            self._engine_loop.join(timeout=10.0)
        if self.backend is not None:
            self.backend.close()
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            self._finish_client(c, send_eos=False)

    def healthcheck(self) -> None:
        """Raise the first UNHANDLED backend/loop error (tests poll
        this).  A chain-backend death the form loop already settled
        (every affected tenant shed with ``retry_after_ms``, slots
        released — :meth:`_backend_lost`) is degraded-but-honest
        service, not a health failure: the door keeps answering, and
        ``stats()['pressure']['backend_lost']`` carries the state."""
        for src in (self, self._engine_loop):
            err = getattr(src, "error", None)
            if err is not None:
                raise err
        if self.backend is not None and self.backend.error is not None \
                and not self._backend_dead:
            raise self.backend.error

    # -- tenant connections ------------------------------------------------

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.25)
        while not self._halt.is_set():
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            configure_socket(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="serve-client")
            t.start()

    def _serve_conn(self, conn) -> None:
        """One connection: observer (stats) or tenant stream."""
        client: _Client | None = None
        try:
            kind, value = recv_frame(conn)
            if kind != K_CTRL or not isinstance(value, dict):
                raise ConnectionError("first frame must be a hello/stats "
                                      "control frame")
            if value.get("cmd") in ("stats", "events_since"):
                # observer connection: stats / flight-recorder queries
                # per request until END
                while True:
                    if value.get("cmd") == "events_since":
                        rec = recorder()
                        cursor, evs = rec.events_since(
                            int(value.get("cursor", 0)),
                            limit=int(value.get("limit", 512)))
                        send_ctrl(conn, {"cmd": "events_reply",
                                         "events": evs,
                                         "cursor": cursor,
                                         "dropped": rec.dropped})
                    else:
                        send_ctrl(conn, {"cmd": "stats_reply",
                                         **self.stats()})
                    kind, value = recv_frame(conn)
                    if kind == K_END:
                        return
                    if kind != K_CTRL or value.get("cmd") not in \
                            ("stats", "events_since"):
                        raise ConnectionError(
                            "observer connections speak stats/"
                            "events_since/END only")
            if value.get("cmd") != "hello":
                raise ConnectionError(f"expected hello, got {value!r}")
            client = self._handle_hello(conn, value)
            self._reader(client)
        except Exception as e:  # noqa: BLE001 — connection-fatal
            if client is not None:
                self._disconnect(client, e)
            else:
                conn.close()

    def _handle_hello(self, conn, msg: dict) -> _Client:
        tenant = str(msg.get("tenant") or "default")
        try:
            cfg = self.admission.tenant(tenant)
        except KeyError:
            cfg = TenantConfig(
                name=tenant,
                weight=float(msg.get("weight", 1.0)),
                priority=int(msg.get("priority", 0)),
                deadline_ms=msg.get("deadline_ms"),
                max_queued=int(msg.get("max_queued", 4096)))
            self.admission.configure(cfg)
        client = _Client(conn, tenant)
        if self.mode == "decode":
            kw = dict(self.decode_defaults)
            for k in ("max_new_tokens", "temperature", "seed"):
                if msg.get(k) is not None:
                    kw[k] = msg[k]
            kw.setdefault("max_new_tokens", 16)
            client.decode_kw = kw
        emit_event("client_open", tenant=tenant, mode=self.mode)
        with self._lock:
            self._clients.append(client)
        send_ctrl(conn, {"cmd": "welcome", "mode": self.mode,
                         "width": self.width, "tenant": tenant,
                         "deadline_ms": cfg.deadline_ms})
        return client

    def _reader(self, client: _Client) -> None:
        """The per-client ingest loop: admit or shed each sample."""
        seq = 0
        while True:
            kind, value = recv_frame(client.conn)
            if kind == K_END:
                with client.state:
                    client.draining = True
                self._maybe_drained(client)
                return
            if kind == K_CTRL and isinstance(value, dict) \
                    and value.get("cmd") == "stats":
                with client.wlock:
                    send_ctrl(client.conn,
                              {"cmd": "stats_reply", **self.stats()})
                continue
            if kind != K_TENSOR:
                raise ConnectionError(
                    f"unexpected frame kind {kind!r} on a tenant stream")
            with self._lock:
                rid = self._next_rid
                self._next_rid += 1
            if self.mode == "decode":
                unit: Any = self._make_decode_request(client, seq, rid,
                                                      value)
            else:
                if self._backend_dead:
                    # the chain is gone: shed at ingest with the same
                    # retry contract the settlement sweep used — never
                    # admit into a queue nothing drains
                    with client.wlock:
                        send_ctrl(client.conn, {
                            "cmd": "shed", "seq": seq, "admitted": False,
                            "predicted_ms": 0.0, "reason": "backend_lost",
                            "retry_after_ms": round(max(
                                0.05, self.admission.service_estimate_s())
                                * 1e3, 3)})
                    seq += 1
                    continue
                sample = np.asarray(value, np.float32)
                if sample.shape != self.backend.in_shape:
                    sample = sample.reshape(self.backend.in_shape)
                unit = _Unit(client, seq, rid, sample)
            # ownership/outstanding BEFORE admit: admit() publishes the
            # unit to the scheduler, and a fast engine could complete it
            # before a post-admit append — the delivery path settles
            # only units it finds owned
            with client.state:
                client.outstanding += 1
                if self.mode == "decode":
                    client.requests.append(unit)
            decision = self.admission.admit(client.tenant, unit)
            if not decision.admitted:
                with client.state:
                    client.outstanding -= 1
                    if self.mode == "decode" \
                            and unit in client.requests:
                        client.requests.remove(unit)
                with client.wlock:
                    send_ctrl(client.conn,
                              {"cmd": "shed", "seq": seq,
                               **decision.to_json()})
            seq += 1

    def _make_decode_request(self, client: _Client, seq: int, rid: int,
                             value) -> DecodeRequest:
        prompt = np.asarray(value).reshape(-1).astype(np.int32)
        kw = client.decode_kw
        max_new = int(kw.get("max_new_tokens", 16))
        if prompt.size + max_new > self.engine.max_len:
            # reject on the CLIENT's connection, not inside the engine
            # loop — one oversized request must not kill the service
            raise ConnectionError(
                f"prompt {prompt.size} + {max_new} new tokens exceeds "
                f"the engine's max_len={self.engine.max_len}")
        req = DecodeRequest(
            prompt=prompt,
            max_new_tokens=max_new,
            tenant=client.tenant, request_id=rid,
            seed=int(kw.get("seed", 0)),
            temperature=float(kw.get("temperature", 0.0)))
        req.queued_at = time.monotonic()
        req.queued_pc = time.perf_counter()  # attribution clock twin
        req.popped_at = None

        def on_done(tokens, _c=client, _s=seq, _r=req):
            self._deliver_decode(_c, _s, _r, tokens)

        req.on_done = on_done
        return req

    # -- delivery ----------------------------------------------------------

    def _deliver(self, unit: _Unit, row: np.ndarray | None) -> None:
        """Tensor-mode result: route one row back to its owner (row is
        None when the unit was dropped with its dead client)."""
        client = unit.client
        with client.state:
            # settle exactly once: the backend-lost sweep and a late
            # delivery can both reach a unit — the settled flag is the
            # ownership token (the decode path's client.requests twin)
            if unit.settled:
                return
            unit.settled = True
            client.outstanding -= 1
            alive = client.alive
        self.admission.complete(client.tenant, queued_at=unit.queued_at)
        if row is not None and alive:
            try:
                with client.wlock:
                    send_frame(client.conn, np.asarray(row),
                               seq=unit.seq)
            except OSError as e:
                self._disconnect(client, e)
                return
            done = time.perf_counter()
            # always-on attribution + SLO scoring: the four stamped
            # waypoints tile this unit's timeline exactly
            self.admission.record_slo(client.tenant,
                                      done - unit.queued_pc)
            self.attrib.record(
                client.tenant, queued=unit.queued_pc,
                popped=unit.popped_at if unit.popped_at is not None
                else unit.queued_pc,
                submitted=unit.submitted_at
                if unit.submitted_at is not None else unit.queued_pc,
                demuxed=unit.demuxed_at
                if unit.demuxed_at is not None else done,
                delivered=done)
            tr = tracer()
            if tr.enabled and unit.sampled_seq is not None:
                # the sampled request's result edge + root span close
                # the trace: demux receipt -> client bytes written,
                # then admitted -> delivered as the e2e envelope every
                # child bucket telescopes inside
                t_dx = unit.demuxed_at if unit.demuxed_at is not None \
                    else done
                tr.record("serve.deliver", t_dx, max(done - t_dx, 0.0),
                          {"rid": unit.rid, "tenant": client.tenant,
                           "seq": unit.sampled_seq})
                tr.record("serve.request", unit.queued_pc,
                          max(done - unit.queued_pc, 0.0),
                          {"rid": unit.rid, "tenant": client.tenant,
                           "seq": unit.sampled_seq,
                           "client_seq": unit.seq})
        self._maybe_drained(client)

    def _deliver_decode(self, client: _Client, seq: int,
                        req: DecodeRequest, tokens) -> None:
        # settle exactly once: membership in client.requests is the
        # ownership token — a disconnect racing the engine's on_done
        # (both threads can reach here for the same request) must not
        # double-count admission.complete / the tenant counters
        with client.state:
            owned = req in client.requests
            if owned:
                client.requests.remove(req)
                client.outstanding -= 1
            alive = client.alive
        if not owned:
            return  # _disconnect already settled this request
        self.admission.complete(client.tenant, queued_at=req.queued_at)
        if tokens is not None and alive:
            try:
                with client.wlock:
                    send_frame(client.conn,
                               np.asarray(tokens, np.int64), seq=seq)
            except OSError as e:
                self._disconnect(client, e)
                return
            done = time.perf_counter()
            queued_pc = getattr(req, "queued_pc", done)
            popped = getattr(req, "popped_at", None)
            if popped is None:
                popped = done
            # decode buckets: admission = queue wait, chain = the
            # engine's whole-request residency (its pipeline stages are
            # in-process; no per-stage frame path to decompose)
            self.admission.record_slo(client.tenant, done - queued_pc)
            self.attrib.record(client.tenant, queued=queued_pc,
                               popped=popped, submitted=popped,
                               demuxed=done, delivered=done)
        self._maybe_drained(client)

    def _maybe_drained(self, client: _Client) -> None:
        with client.state:
            done = (client.draining and client.outstanding == 0
                    and client.alive)
        if done:
            self._finish_client(client, send_eos=True)

    def _finish_client(self, client: _Client, *, send_eos: bool) -> None:
        with client.state:
            if not client.alive:
                return
            client.alive = False
        emit_event("client_close", tenant=client.tenant,
                   clean=bool(send_eos))
        try:
            if send_eos:
                with client.wlock:
                    send_end(client.conn)
        except OSError:
            pass
        client.conn.close()
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)

    def _disconnect(self, client: _Client, err: BaseException) -> None:
        """A client died mid-stream: cancel its in-flight decode
        requests (their KV slots free at the next step boundary),
        leave everyone else untouched."""
        del err
        self._finish_client(client, send_eos=False)
        if self.mode == "decode":
            with client.state:
                live = list(client.requests)
                client.requests.clear()
            for req in live:
                req.on_done = None  # the client is gone
                req.cancelled = True  # still-queued: never join
                if self._engine_loop is not None:
                    self._engine_loop.request_cancel(req)
                self.admission.complete(client.tenant,
                                        queued_at=req.queued_at)
        # queued-but-unsubmitted tensor units drain through
        # ChainBackend.submit's dead-client drop

    # -- the tensor-mode forming loop --------------------------------------

    def _form_loop(self) -> None:
        try:
            while not self._halt.is_set():
                entries = self.former.form(timeout=0.25)
                err = self.backend.error
                if err is None and entries:
                    try:
                        self.backend.submit(entries)
                        entries = []
                    except BaseException as e:  # noqa: BLE001
                        # a dead chain surfaces as a send failure here
                        # before the demux notices EOF; either way the
                        # settlement sweep below owns the cleanup
                        err = e
                if err is not None:
                    if not self._halt.is_set():
                        self._backend_lost(err, entries)
                    return
                self.healthcheck()
        except BaseException as e:  # noqa: BLE001
            if not self._halt.is_set():
                self.error = e

    def _backend_lost(self, err: BaseException,
                      entries: list[tuple[str, _Unit]]) -> None:
        """The chain backend died mid-request: settle EVERY affected
        admission slot exactly once and shed the owning tenants with a
        ``retry_after_ms`` hint, instead of failing the healthcheck and
        leaving in-flight clients hanging.

        Affected units live in three mutually exclusive places —
        formed-but-unsubmitted (``entries``), submitted into the dead
        chain (the backend's pending frames), and still queued in
        admission; the per-unit ``settled`` token makes the sweep safe
        against any delivery that raced the demux shutdown."""
        # stop late deliveries FIRST: settlement must not race the demux
        self.backend.halt_demux()
        self._backend_dead = True
        units = [u for _, u in entries]
        units += self.backend.drain_pending()
        while True:
            nxt = self.admission.queue.pop(timeout=0.0)
            if nxt is None:
                break
            units.append(nxt[1])
        # one honest retry hint for the whole incident: the time to
        # redeploy a chain dwarfs per-unit service, so hint the larger
        retry_s = max(0.05, self.admission.service_estimate_s()
                      * max(1, len(units)))
        shed = 0
        for u in units:
            if self._shed_unit(u, retry_s):
                shed += 1
        emit_event("backend_lost", error=type(err).__name__, shed=shed)

    def _shed_unit(self, unit: _Unit, retry_s: float) -> bool:
        """Settle one in-flight unit as shed (backend lost): release its
        admission slot, tell its client to retry.  Returns False when a
        racing delivery already settled it."""
        client = unit.client
        with client.state:
            if unit.settled:
                return False
            unit.settled = True
            client.outstanding -= 1
            alive = client.alive
        self.admission.complete(client.tenant, queued_at=unit.queued_at)
        REGISTRY.counter(f"serve.tenant.{client.tenant}.shed").n += 1
        REGISTRY.counter("serve.shed").n += 1
        if alive:
            try:
                with client.wlock:
                    send_ctrl(client.conn, {
                        "cmd": "shed", "seq": unit.seq, "admitted": False,
                        "predicted_ms": 0.0, "reason": "backend_lost",
                        "retry_after_ms": round(retry_s * 1e3, 3)})
            except OSError as e:
                self._disconnect(client, e)
                return True
        self._maybe_drained(client)
        return True

    # -- observability -----------------------------------------------------

    def pressure(self) -> dict:
        """Admission-pressure snapshot: ``drain_eta_ms`` is how long the
        current backlog takes at the live service estimate — a bursty
        arrival trace shows up here as backlog long before it shows up
        in any per-stage latency histogram."""
        queued = self.admission.queue.qsize()
        inflight = self.admission.inflight
        unit_s = self.admission.service_estimate_s()
        return {
            "queued": queued,
            "inflight": inflight,
            # frames of work outstanding at the deployed width
            "backlog_frames": -(-inflight // max(1, self.width)),
            "drain_eta_ms": round(inflight * unit_s * 1e3, 3),
            "service_estimate_ms": round(unit_s * 1e3, 4),
            "width": self.width,
            "backend_lost": self._backend_dead,
        }

    def stats(self) -> dict:
        doc = {"mode": self.mode, "width": self.width,
               "pressure": self.pressure(),
               "frames": REGISTRY.counter("serve.frames").value,
               "samples": REGISTRY.counter("serve.samples").value,
               # per-tenant latency-attribution buckets (ms summaries)
               # + the flight recorder's loss counter, so a monitor can
               # see both what the p99 is made of and whether the event
               # log under it is complete
               "attribution": self.attrib.summary(),
               "events_dropped": recorder().dropped,
               **self.admission.stats()}
        if self.engine is not None:
            doc["decode"] = {
                "active": self.engine.active(),
                "free_slots": self.engine.free_slots(),
                "steps": self.engine.steps,
                "tokens": REGISTRY.counter(
                    "serve.decode.tokens").value,
                "step_s": REGISTRY.histogram(
                    "serve.decode.step_s").summary(),
                "captures": self.engine.captures,
                "graph_pool_bytes": self.engine.graph_pool_bytes,
            }
        return doc
