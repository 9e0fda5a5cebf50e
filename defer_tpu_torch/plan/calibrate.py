"""Online calibration: fit the planner's constants from live telemetry.

The port of ``defer_tpu.plan.calibrate``.  The artifact's schema string
is the reference's, so a calibration file crosses between the packages.

The cost model prices hops with guessed constants — codec throughputs
from :data:`~defer_tpu_torch.plan.cost.DEFAULT_CODECS`, memory/host-sync
bandwidths from order-of-magnitude defaults — while the runtime measures
the real thing on every frame: per-channel encode/decode histograms,
per-stage ``host_sync`` histograms, per-frame send times, byte counters.
This module closes that loop:

1. :func:`hop_telemetry_from_stats` reshapes a ``ChainDispatcher.stats``
   reply into per-hop telemetry records —
   stage ``k``'s outbound hop pairs stage ``k``'s encode/host-sync/send
   histograms with stage ``k+1``'s decode histogram (decode is measured
   at the RECEIVER).
2. :func:`fit_constants` turns those records into a versioned
   :class:`CalibratedConstants` artifact: per-codec encode/decode
   throughputs, ``host_sync_bw_s``, ``ici_bw_s``, wire ``link_bw_s``
   (all bytes/seconds regressions over the summaries' exact
   ``sum``/``count`` fields), plus a memcpy micro-bench for the
   ``local``/``shm`` memory-bandwidth term.  Degenerate inputs —
   zero-byte hops, histograms with fewer than ``min_samples`` samples —
   are rejected LOUDLY (:class:`CalibrationError`), never silently
   fitted: a bandwidth regressed from one sample is a lie with a
   version number.
3. :meth:`CalibratedConstants.apply` overlays the fitted constants on
   any :class:`~defer_tpu_torch.plan.cost.StageCostModel`; the artifact also
   round-trips through plan JSON (``describe()`` carries the constants,
   ``cost_model_from_plan`` restores them), so a replan seeded from a
   calibrated plan keeps scoring with measured numbers.

:func:`predict_stage_service_s` is the audit half: the per-stage service
prediction ALIGNED with what the runtime measures — stage ``k`` =
``max(compute_k, decode(hop k-1), encode(hop k))`` with CODEC-ONLY
enc/dec parts, because the live service estimate
(``obs/cluster.py`` ``_service_ms``, the JAX package's formula) is the
max of the infer / per-channel decode / per-channel encode p50s, none of
which include the host-sync round-trip (measured separately).

Why a codec the model has never seen still calibrates: the fit keys
fitted specs by the DEPLOYED codec name (``dsleep10+raw`` included).  A
default-constants model prices an unknown name via the ``raw`` fallback
— exactly the failure mode that makes uncalibrated predictions wrong on
any chain whose codecs do real work.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import numpy as np

from ..graph.ir import LayerGraph
from .cost import (DEFAULT_CODECS, TIER_CODECS, CodecSpec, StageCostModel)

#: artifact schema identifier; bump on incompatible layout changes
SCHEMA = "defer_tpu.calibration.v1"

#: a histogram with fewer samples than this cannot anchor a bandwidth
#: fit (one compile-warm outlier would BE the estimate)
DEFAULT_MIN_SAMPLES = 8


class CalibrationError(ValueError):
    """A fit was asked to regress from degenerate telemetry (zero-byte
    hop, under-sampled histogram).  Loud on purpose: a silently-skipped
    hop would leave a default constant masquerading as calibrated."""


# ---------------------------------------------------------------------------
# telemetry records
# ---------------------------------------------------------------------------

def _summ(row, key) -> dict:
    s = row.get(key)
    return s if isinstance(s, dict) else {"count": 0}


def _delta(now: dict, base: dict | None) -> dict:
    """Window-bound a cumulative summary: subtract an earlier snapshot's
    exact ``count``/``sum`` so the fit reflects the CURRENT regime, not
    the lifetime average (cold-start/compile samples included forever).
    Percentiles cannot be subtracted; the fit only consumes
    count/sum, which can."""
    if not base or not base.get("count"):
        return dict(now)
    n = int(now.get("count", 0)) - int(base.get("count", 0))
    if n <= 0:
        return {"count": 0}
    return {"count": n,
            "sum": float(now.get("sum", 0.0)) - float(base.get("sum", 0.0))}


def hop_telemetry_from_stats(graph: LayerGraph, cuts: list[str],
                             stats: list[dict], *, batch: int = 1,
                             baseline: list[dict] | None = None
                             ) -> list[dict]:
    """Per-hop telemetry records from a ``ChainDispatcher.stats`` reply.

    Hop ``k`` (stage ``k`` -> ``k+1``) joins stage ``k``'s outbound-side
    histograms (``encode_latency_s``, ``host_sync_s``, ``tx_s``) with
    stage ``k+1``'s ``decode_latency_s`` — decode runs at the receiver.
    Raw boundary bytes come from the graph (``out_spec(cut)`` at
    ``batch``), NOT from the tx byte counters, which are process-wide
    registry totals (per-stage only in multi-process runs).

    Replicated stages contribute one merged record per hop (replica
    summaries pooled by count/sum).  ``baseline`` is an earlier stats
    reply from the same chain: when given, every summary is
    window-bounded by delta (see :func:`_delta`) so calibration scores
    the current regime.
    """
    def pool(rows, key, base_rows):
        out = {"count": 0, "sum": 0.0}
        for r in rows:
            b = None
            if base_rows:
                b = next((_summ(br, key) for br in base_rows
                          if br.get("replica") == r.get("replica")), None)
            s = _delta(_summ(r, key), b)
            if s.get("count"):
                out["count"] += int(s["count"])
                out["sum"] += float(s.get("sum", 0.0))
        return out if out["count"] else {"count": 0}

    by_stage: dict[int, list[dict]] = {}
    for row in stats:
        if isinstance(row, dict) and row.get("stage") is not None:
            by_stage.setdefault(int(row["stage"]), []).append(row)
    base_by_stage: dict[int, list[dict]] = {}
    for row in baseline or ():
        if isinstance(row, dict) and row.get("stage") is not None:
            base_by_stage.setdefault(int(row["stage"]), []).append(row)

    hops = []
    for k, cut in enumerate(cuts):
        tx_rows = by_stage.get(k) or []
        rx_rows = by_stage.get(k + 1) or []
        if not tx_rows:
            continue
        spec = graph.out_spec(cut)
        raw = int(spec.size) * spec.dtype.itemsize * max(1, int(batch))
        tb, rb = base_by_stage.get(k), base_by_stage.get(k + 1)
        hops.append({
            "cut": cut,
            "stage": k,
            "raw_bytes": raw,
            "codec": tx_rows[0].get("codec"),
            "tier": tx_rows[0].get("tier") or "tcp",
            "enc_s": pool(tx_rows, "encode_latency_s", tb),
            "dec_s": pool(rx_rows, "decode_latency_s", rb),
            "host_sync_s": pool(tx_rows, "host_sync_s", tb),
            "tx_s": pool(tx_rows, "tx_s", tb),
        })
    return hops


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibratedConstants:
    """A versioned bundle of measured planner constants.

    Every field carries a ``provenance`` entry —
    ``{"method": "measured"|"bench"|"prior", "samples": n, "bytes": b}``
    — so a consumer can tell a regression over 10k frames from a default
    that merely survived the fit untouched."""

    schema: str = SCHEMA
    gen: str = "unknown"
    created_unix: float = 0.0
    local_bw_s: float | None = None
    host_sync_bw_s: float | None = None
    ici_bw_s: float | None = None
    link_bw_s: float | None = None
    codecs: dict[str, CodecSpec] = dataclasses.field(default_factory=dict)
    provenance: dict[str, dict] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "schema": self.schema, "gen": self.gen,
            "created_unix": round(self.created_unix, 3),
            "local_bw_s": self.local_bw_s,
            "host_sync_bw_s": self.host_sync_bw_s,
            "ici_bw_s": self.ici_bw_s,
            "link_bw_s": self.link_bw_s,
            "codecs": {n: dataclasses.asdict(c)
                       for n, c in sorted(self.codecs.items())},
            "provenance": {k: dict(v)
                           for k, v in sorted(self.provenance.items())},
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CalibratedConstants":
        schema = doc.get("schema")
        if schema != SCHEMA:
            raise CalibrationError(
                f"unknown calibration schema {schema!r} (expected {SCHEMA})")
        codecs = {n: CodecSpec(**c)
                  for n, c in (doc.get("codecs") or {}).items()}
        return cls(schema=SCHEMA, gen=doc.get("gen", "unknown"),
                   created_unix=float(doc.get("created_unix", 0.0)),
                   local_bw_s=doc.get("local_bw_s"),
                   host_sync_bw_s=doc.get("host_sync_bw_s"),
                   ici_bw_s=doc.get("ici_bw_s"),
                   link_bw_s=doc.get("link_bw_s"),
                   codecs=codecs,
                   provenance=dict(doc.get("provenance") or {}))

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CalibratedConstants":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(json.load(f))

    def apply(self, cost: StageCostModel) -> StageCostModel:
        """A shallow copy of ``cost`` with every fitted constant
        overlaid (unfitted fields keep the model's own values); fitted
        codec specs MERGE over the model's table, so deployed codec
        names the analytic table never heard of become priceable."""
        other = copy.copy(cost)
        if self.local_bw_s:
            other.local_bw_s = float(self.local_bw_s)
        if self.host_sync_bw_s:
            other.host_sync_bw_s = float(self.host_sync_bw_s)
        if self.ici_bw_s:
            other.ici_bw_s = float(self.ici_bw_s)
        if self.link_bw_s:
            other.link_bw_s = float(self.link_bw_s)
        if self.codecs:
            other.codecs = {**cost.codecs, **self.codecs}
        return other


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def measure_memory_bw(*, nbytes: int = 1 << 24, reps: int = 3) -> float:
    """Host memory bandwidth (bytes/s) from a memcpy micro-bench — the
    constant behind the ``local`` tier's wire term and half the ``shm``
    ring's write-in/read-out pair.  Min over ``reps`` timed copies after
    a warm round, same protocol as the codec micro-bench."""
    src = np.ones(max(nbytes, 1 << 16), dtype=np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warm (page faults / first touch)
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return src.nbytes / max(best, 1e-9)


def _bw_fit(pairs) -> tuple[float | None, int, int]:
    """Aggregate bandwidth over (raw_bytes, summary) pairs:
    ``sum(bytes_i * count_i) / sum(seconds_i)`` — the count-weighted
    regression through the origin the exact sum/count fields support.
    Returns (bw or None, samples, bytes)."""
    num = den = 0.0
    samples = 0
    for raw, summ in pairs:
        n = int(summ.get("count", 0))
        s = float(summ.get("sum", 0.0))
        if n <= 0 or s <= 0:
            continue
        num += raw * n
        den += s
        samples += n
    if den <= 0 or samples == 0:
        return None, 0, 0
    return num / den, samples, int(num)


def _check_hop(hop: dict, min_samples: int) -> None:
    raw = int(hop.get("raw_bytes", 0))
    if raw <= 0:
        raise CalibrationError(
            f"zero-byte hop at cut {hop.get('cut')!r}: a bandwidth "
            f"cannot be regressed from 0 bytes")
    for key in ("enc_s", "dec_s", "host_sync_s", "tx_s"):
        summ = hop.get(key)
        if not isinstance(summ, dict):
            continue
        n = int(summ.get("count", 0))
        # count == 0 is legitimate absence (an ici hop records no
        # host_sync — that is the tier working); 0 < n < min_samples is
        # an under-sampled histogram and must not anchor a fit
        if 0 < n < min_samples:
            raise CalibrationError(
                f"hop at cut {hop.get('cut')!r}: {key} has only {n} "
                f"sample(s) (< {min_samples}); run longer or lower "
                f"min_samples explicitly")


def fit_constants(hops: list[dict], *,
                  min_samples: int = DEFAULT_MIN_SAMPLES,
                  gen: str = "unknown",
                  prior: StageCostModel | None = None,
                  bench_memory: bool = True) -> CalibratedConstants:
    """Fit :class:`CalibratedConstants` from per-hop telemetry records.

    Each record (see :func:`hop_telemetry_from_stats`) carries
    ``raw_bytes`` (the boundary tensor's bytes), the deployed ``codec``
    and ``tier``, and cumulative summaries ``enc_s`` / ``dec_s`` /
    ``host_sync_s`` / ``tx_s`` (``{"count", "sum"}`` at least).  Fits:

    * per-codec ``encode_bytes_per_s`` / ``decode_bytes_per_s`` — keyed
      by the DEPLOYED codec name, count-weighted over every hop that
      rode that codec; ratio/lossy carried from ``prior``'s table (or
      :data:`DEFAULT_CODECS`) when the name is known, else 1.0 /
      name-prefix heuristic (wire-byte ratios need per-channel byte
      counters, which the registry only attributes per-process);
    * ``host_sync_bw_s`` — one-pass bandwidth from the ``host_sync``
      histograms (the node loop's timed copy of its output to the host; the
      model's 2x term then prices the symmetric H2D re-upload at the
      same rate — docs/PLANNER.md spells out the protocol);
    * ``ici_bw_s`` — from device-resident hops' per-frame send times
      (``tx_s`` on ``tier == "ici"`` hops: the d2d put is the send);
    * ``link_bw_s`` — from wire hops' send-minus-encode residual
      (``tx_s`` prices encode+send; subtract the encode sum);
    * ``local_bw_s`` — a memcpy micro-bench on THIS host
      (``bench_memory=False`` keeps the prior — e.g. when fitting on a
      machine that will not run the chain).

    A constant with no usable telemetry keeps the ``prior``'s value with
    ``{"method": "prior"}`` provenance.  Degenerate records raise
    :class:`CalibrationError` (see :func:`_check_hop`).
    """
    if not hops:
        raise CalibrationError("no hop telemetry records to fit from")
    min_samples = max(2, int(min_samples))
    for hop in hops:
        _check_hop(hop, min_samples)

    prior_codecs = dict(prior.codecs) if prior is not None \
        else dict(DEFAULT_CODECS)
    out = CalibratedConstants(gen=gen, created_unix=time.time())
    prov = out.provenance

    # -- per-codec throughputs (wire hops only) -----------------------------
    enc_pairs: dict[str, list] = {}
    dec_pairs: dict[str, list] = {}
    for hop in hops:
        codec = hop.get("codec")
        if not codec or codec in TIER_CODECS \
                or (hop.get("tier") or "tcp") != "tcp":
            continue
        enc_pairs.setdefault(codec, []).append(
            (hop["raw_bytes"], hop.get("enc_s") or {}))
        dec_pairs.setdefault(codec, []).append(
            (hop["raw_bytes"], hop.get("dec_s") or {}))
    for codec in sorted(set(enc_pairs) | set(dec_pairs)):
        enc_bw, enc_n, enc_b = _bw_fit(enc_pairs.get(codec, ()))
        dec_bw, dec_n, dec_b = _bw_fit(dec_pairs.get(codec, ()))
        base = prior_codecs.get(codec)
        if enc_bw is None and dec_bw is None:
            continue  # hop deployed the codec but no frames moved yet
        out.codecs[codec] = CodecSpec(
            name=codec,
            ratio=base.ratio if base else 1.0,
            encode_bytes_per_s=enc_bw if enc_bw is not None
            else (base.encode_bytes_per_s if base else 8e9),
            decode_bytes_per_s=dec_bw if dec_bw is not None
            else (base.decode_bytes_per_s if base else 8e9),
            lossy=base.lossy if base else codec.startswith("bf"))
        prov[f"codec.{codec}"] = {
            "method": "measured", "samples": enc_n + dec_n,
            "bytes": enc_b + dec_b}

    # -- host_sync bandwidth ------------------------------------------------
    hs_bw, hs_n, hs_b = _bw_fit(
        (h["raw_bytes"], h.get("host_sync_s") or {}) for h in hops)
    if hs_bw is not None:
        out.host_sync_bw_s = hs_bw
        prov["host_sync_bw_s"] = {"method": "measured",
                                  "samples": hs_n, "bytes": hs_b}
    elif prior is not None:
        out.host_sync_bw_s = prior.host_sync_bw_s
        prov["host_sync_bw_s"] = {"method": "prior", "samples": 0,
                                  "bytes": 0}

    # -- ici bandwidth ------------------------------------------------------
    ici_bw, ici_n, ici_b = _bw_fit(
        (h["raw_bytes"], h.get("tx_s") or {})
        for h in hops if (h.get("tier") or "tcp") == "ici")
    if ici_bw is not None:
        out.ici_bw_s = ici_bw
        prov["ici_bw_s"] = {"method": "measured", "samples": ici_n,
                            "bytes": ici_b}
    elif prior is not None:
        out.ici_bw_s = prior.ici_bw_s
        prov["ici_bw_s"] = {"method": "prior", "samples": 0, "bytes": 0}

    # -- wire bandwidth -----------------------------------------------------
    # tx_s prices encode+send per frame; the send residual over the wire
    # bytes is the link estimate.  The tx_s histogram is process-wide
    # (registry), so this is trustworthy in multi-process runs and a
    # same-rate approximation in-process; negative residuals (encode
    # dominated) yield no fit rather than a wild one.
    num = den = 0.0
    link_n = 0
    for h in hops:
        if (h.get("tier") or "tcp") != "tcp":
            continue
        tx, enc = h.get("tx_s") or {}, h.get("enc_s") or {}
        n = min(int(tx.get("count", 0)), int(enc.get("count", 0)))
        if n <= 0:
            continue
        send_sum = float(tx.get("sum", 0.0)) \
            - float(enc.get("sum", 0.0)) * (int(tx.get("count", 0)) / max(
                1, int(enc.get("count", 0))))
        if send_sum <= 0:
            continue
        spec = out.codecs.get(h.get("codec")) \
            or prior_codecs.get(h.get("codec"))
        ratio = spec.ratio if spec else 1.0
        num += (h["raw_bytes"] / max(ratio, 1e-9)) * n
        den += send_sum
        link_n += n
    if den > 0 and link_n:
        out.link_bw_s = num / den
        prov["link_bw_s"] = {"method": "measured", "samples": link_n,
                             "bytes": int(num)}
    elif prior is not None:
        out.link_bw_s = prior.link_bw_s
        prov["link_bw_s"] = {"method": "prior", "samples": 0, "bytes": 0}

    # -- local / shm memory bandwidth ---------------------------------------
    if bench_memory:
        out.local_bw_s = measure_memory_bw()
        prov["local_bw_s"] = {"method": "bench", "samples": 1,
                              "bytes": 1 << 24}
    elif prior is not None:
        out.local_bw_s = prior.local_bw_s
        prov["local_bw_s"] = {"method": "prior", "samples": 0, "bytes": 0}
    return out


def fit_from_stats(graph: LayerGraph, cuts: list[str], stats: list[dict],
                   *, batch: int = 1, gen: str = "unknown",
                   prior: StageCostModel | None = None,
                   baseline: list[dict] | None = None,
                   min_samples: int = DEFAULT_MIN_SAMPLES,
                   bench_memory: bool = True) -> CalibratedConstants:
    """One-call convenience: stats reply -> telemetry records -> fit."""
    hops = hop_telemetry_from_stats(graph, cuts, stats, batch=batch,
                                    baseline=baseline)
    return fit_constants(hops, min_samples=min_samples, gen=gen,
                         prior=prior, bench_memory=bench_memory)


# ---------------------------------------------------------------------------
# measurement-aligned prediction (the audit half)
# ---------------------------------------------------------------------------

def codec_only_parts(cost: StageCostModel, cut: str, codec: str
                     ) -> tuple[float, float]:
    """(encode, decode) seconds of ``codec`` at ``cut`` EXCLUDING the
    host-sync halves — aligned with the per-channel encode/decode
    histograms, which time exactly the codec work.  Tier pseudo-codecs
    do no codec work on either side.  An unknown codec name falls back
    to the ``raw`` spec — the documented failure mode of an
    uncalibrated model pricing a deployed codec it has no row for."""
    if codec in TIER_CODECS:
        return 0.0, 0.0
    spec = cost.codecs.get(codec) or cost.codecs.get("raw") \
        or next(iter(cost.codecs.values()))
    enc, _, dec = spec.comm_parts(cost.cut_bytes(cut), cost.link_bw_s)
    return enc, dec


def predict_stage_service_s(graph: LayerGraph, cuts: list[str],
                            hop_codecs: list[str],
                            cost: StageCostModel) -> list[float]:
    """Per-stage predicted SERVICE seconds, aligned with the live
    estimate: stage ``k`` is rate-bound by the slowest of its three
    overlapped phase threads — inbound decode of hop ``k-1``, infer,
    outbound encode of hop ``k`` — so the prediction is their max, with
    codec-only enc/dec parts (see :func:`codec_only_parts`).

    This deliberately differs from ``Plan.stage_cost_s``, which charges
    hop ``k``'s WHOLE comm (encode+wire+decode+host_sync) to stage
    ``k``: an audit must attribute work to the process that measures
    it, or a decode-heavy codec shows up as drift on the wrong stage."""
    if len(hop_codecs) != len(cuts):
        raise ValueError(f"{len(cuts)} cuts but {len(hop_codecs)} "
                         f"hop codecs")
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    bounds = [0] + [pos[c] + 1 for c in cuts] + [len(order)]
    out = []
    for k in range(len(bounds) - 1):
        names = order[bounds[k]:bounds[k + 1]]
        service = cost.compute_seconds(names)
        if k > 0:
            _, dec = codec_only_parts(cost, cuts[k - 1], hop_codecs[k - 1])
            service = max(service, dec)
        if k < len(cuts):
            enc, _ = codec_only_parts(cost, cuts[k], hop_codecs[k])
            service = max(service, enc)
        out.append(service)
    return out
