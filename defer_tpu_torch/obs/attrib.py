"""Per-request latency attribution: fold a served request's spans into
named budget buckets that sum to its measured end-to-end latency.

The port's copy of ``defer_tpu.obs.attrib``.  The serving plane stamps
every request with door-side spans (``serve.admission_wait`` /
``serve.gather`` / ``serve.deliver`` / ``serve.request`` —
``serve/frontdoor.py``); a request that rides a chain of stage processes
also carries that chain's per-stage spans (``stageK.infer``,
``stageK.host_sync``) under the frame's wire seq.
:func:`attribute_request` telescopes those spans into buckets —

* ``admission`` — admitted -> popped by the batch former (queue wait),
* ``gather`` — popped -> frame submitted (batch forming window),
* ``transport.hopK`` — stage K-1's compute end -> stage K's compute
  start (labeled with the hop's negotiated tier when known),
* ``stageK`` — stage K's issue-to-materialize compute, host sync
  excluded,
* ``host_sync`` — the summed host materializations,
* ``transport.result`` — last compute end -> demux receipt (the result
  hop),
* ``result_edge`` — demux -> the client's bytes written.

Because the buckets tile the request's own timeline, their sum equals
the measured wall up to cross-process clock skew — the residual is
reported, and :meth:`RequestAttribution.ok` is the "sums to within
tolerance" predicate.

:class:`DoorAttribution` is the always-on, trace-free sibling: the
front door feeds it its timestamps per delivered unit and it keeps
per-tenant bucket histograms (admission / gather / chain / result
edge) — the ``attribution`` block of the serve stats reply.
"""

from __future__ import annotations

import re
import threading

from .histogram import LatencyHistogram

#: ``stage7.infer`` / ``stage7.host_sync`` (serving rides linear
#: chains, so no replica/branch infixes appear on the request path)
_STAGE_RE = re.compile(r"^stage(\d+)\.(infer|host_sync)$")


class RequestAttribution:
    """One request's folded budget buckets."""

    __slots__ = ("rid", "tenant", "seq", "wall_ms", "buckets", "tiers",
                 "stages")

    def __init__(self, rid: int, tenant: str, seq: int, wall_ms: float,
                 buckets: dict[str, float], tiers: dict[str, str],
                 stages: list[int]):
        self.rid = rid
        self.tenant = tenant
        self.seq = seq
        self.wall_ms = wall_ms
        #: ordered bucket name -> milliseconds
        self.buckets = buckets
        #: transport bucket -> negotiated tier label (when known)
        self.tiers = tiers
        self.stages = stages

    @property
    def sum_ms(self) -> float:
        return sum(self.buckets.values())

    @property
    def residual_ms(self) -> float:
        """Measured wall minus the bucket sum (clock skew + untracked
        gaps); the tolerance check is against its magnitude."""
        return self.wall_ms - self.sum_ms

    def ok(self, tol: float = 0.10) -> bool:
        """True when the buckets sum to within ``tol`` (fractional) of
        the measured end-to-end latency — the acceptance bar."""
        if self.wall_ms <= 0:
            return False
        return abs(self.residual_ms) <= tol * self.wall_ms

    def to_json(self) -> dict:
        return {"rid": self.rid, "tenant": self.tenant, "seq": self.seq,
                "wall_ms": round(self.wall_ms, 4),
                "sum_ms": round(self.sum_ms, 4),
                "residual_ms": round(self.residual_ms, 4),
                "buckets_ms": {k: round(v, 4)
                               for k, v in self.buckets.items()},
                "tiers": dict(self.tiers)}


def _index_request_spans(spans):
    """(by_rid, by_seq) lookup tables for the serve/stage span names
    attribution reads."""
    door: dict[int, dict[str, dict]] = {}
    gather: dict[int, dict] = {}
    stage: dict[int, dict[int, dict[str, dict]]] = {}
    for s in spans:
        name = s.get("name", "")
        args = s.get("args") or {}
        if name in ("serve.request", "serve.admission_wait",
                    "serve.deliver"):
            rid = args.get("rid")
            if rid is not None:
                door.setdefault(int(rid), {})[name] = s
            continue
        if name == "serve.gather":
            seq = args.get("seq")
            if seq is not None:
                gather[int(seq)] = s
            continue
        m = _STAGE_RE.match(name)
        if m is not None:
            seq = args.get("seq")
            if seq is not None:
                stage.setdefault(int(seq), {}) \
                    .setdefault(int(m.group(1)), {})[m.group(2)] = s
    return door, gather, stage


def attribute_request(spans, rid: int, *,
                      hop_tiers=None) -> RequestAttribution | None:
    """Fold one request's spans into budget buckets (None when the
    request was not sampled or its root span is missing).

    ``spans`` is any span list on one timeline (the process tracer's
    ``spans``).
    ``hop_tiers`` (optional, one entry per chain hop starting at the
    dispatcher->stage0 edge) labels the transport buckets with their
    negotiated tier."""
    return _attribute_indexed(_index_request_spans(spans), rid,
                              hop_tiers=hop_tiers)


def _attribute_indexed(index, rid: int, *,
                       hop_tiers=None) -> RequestAttribution | None:
    door, gather, stage = index
    mine = door.get(int(rid))
    if not mine or "serve.request" not in mine:
        return None
    root = mine["serve.request"]
    args = root.get("args") or {}
    seq = args.get("seq")
    if seq is None:
        return None
    seq = int(seq)
    t0 = root["ts_us"]
    end = t0 + root["dur_us"]
    buckets: dict[str, float] = {}
    tiers: dict[str, str] = {}

    def put(name: str, us: float) -> None:
        # clock skew can push a cross-process boundary slightly
        # negative; clamp — the residual check still sees the error
        buckets[name] = max(0.0, us) / 1e3

    adm = mine.get("serve.admission_wait")
    adm_end = adm["ts_us"] + adm["dur_us"] if adm is not None else t0
    put("admission", adm_end - t0)
    g = gather.get(seq)
    g_end = g["ts_us"] + g["dur_us"] if g is not None else adm_end
    put("gather", g_end - adm_end)
    prev_end = g_end
    stages = sorted(stage.get(seq, ()))
    host_sync_us = 0.0
    for hop, k in enumerate(stages):
        infer = stage[seq][k].get("infer")
        if infer is None:
            continue
        tier = None
        if hop_tiers is not None and hop < len(hop_tiers):
            tier = hop_tiers[hop]
        put(f"transport.hop{hop}", infer["ts_us"] - prev_end)
        if tier:
            tiers[f"transport.hop{hop}"] = str(tier)
        hs = stage[seq][k].get("host_sync")
        hs_us = hs["dur_us"] if hs is not None else 0
        host_sync_us += hs_us
        put(f"stage{k}", infer["dur_us"] - hs_us)
        prev_end = infer["ts_us"] + infer["dur_us"]
    put("host_sync", host_sync_us)
    dl = mine.get("serve.deliver")
    if dl is not None:
        put("transport.result", dl["ts_us"] - prev_end)
        if hop_tiers is not None and len(hop_tiers) > len(stages):
            tiers["transport.result"] = str(hop_tiers[len(stages)])
        put("result_edge", (dl["ts_us"] + dl["dur_us"]) - dl["ts_us"])
    else:
        put("transport.result", end - prev_end)
        put("result_edge", 0.0)
    return RequestAttribution(
        rid=int(rid), tenant=str(args.get("tenant", "?")), seq=seq,
        wall_ms=root["dur_us"] / 1e3, buckets=buckets, tiers=tiers,
        stages=stages)


def attribute_sampled(spans, *, hop_tiers=None) -> list[RequestAttribution]:
    """Attribution for EVERY sampled request found in ``spans``
    (one per ``serve.request`` root span), wall-latency ascending —
    index into it for the p50/p99 requests.  The span list is indexed
    ONCE, shared by every request's fold."""
    index = _index_request_spans(spans)
    out = []
    for rid in index[0]:
        rep = _attribute_indexed(index, rid, hop_tiers=hop_tiers)
        if rep is not None:
            out.append(rep)
    out.sort(key=lambda r: r.wall_ms)
    return out


#: the door-side (trace-free) bucket names, in timeline order
DOOR_BUCKETS = ("admission", "gather", "chain", "result_edge")


class DoorAttribution:
    """Always-on per-tenant bucket histograms at the front door.

    Four timestamps per delivered unit tile its timeline exactly:
    admitted -> popped (``admission``), popped -> submitted
    (``gather``), submitted -> demux receipt (``chain`` — everything
    inside the deployed chain), demux -> client bytes written
    (``result_edge``).  No tracing required; the stats reply carries
    it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, dict[str, LatencyHistogram]] = {}

    def _hists(self, tenant: str) -> dict[str, LatencyHistogram]:
        with self._lock:
            h = self._tenants.get(tenant)
            if h is None:
                h = self._tenants[tenant] = {
                    k: LatencyHistogram()
                    for k in DOOR_BUCKETS + ("e2e",)}
            return h

    def record(self, tenant: str, *, queued: float, popped: float,
               submitted: float, demuxed: float, delivered: float
               ) -> None:
        """Fold one unit's timestamps (``perf_counter`` seconds) in.
        Out-of-order stamps clamp to zero-width buckets."""
        h = self._hists(tenant)
        popped = max(queued, popped)
        submitted = max(popped, submitted)
        demuxed = max(submitted, demuxed)
        delivered = max(demuxed, delivered)
        h["admission"].record(popped - queued)
        h["gather"].record(submitted - popped)
        h["chain"].record(demuxed - submitted)
        h["result_edge"].record(delivered - demuxed)
        h["e2e"].record(delivered - queued)

    def summary(self) -> dict:
        """Per-tenant bucket summaries in milliseconds (JSON-ready):
        ``{tenant: {bucket: {count, p50, p99, ...}}}``."""
        with self._lock:
            tenants = {t: dict(h) for t, h in self._tenants.items()}
        return {t: {k: hist.summary(scale=1e3)
                    for k, hist in h.items()}
                for t, h in sorted(tenants.items())}
