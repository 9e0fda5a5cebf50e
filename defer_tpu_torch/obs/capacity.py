"""Capacity accounting: live MFU / roofline utilization and the
prediction-drift auditor.

The port's copy of ``defer_tpu.obs.capacity``.  Peaks come from the
port's ``utils/hw.py`` (the H100 SXM's data-sheet row, ``"h100"``, 989e12
FLOP/s).  The policy is the JAX package's: one peak per generation,
whatever the dtype, so an f32 stage's MFU is against the bf16 peak.

The analytic halves already exist — ``graph/analysis.py`` counts FLOPs,
``utils/hw.py`` publishes per-generation peaks, ``plan/cost.py`` prices
the roofline — and the runtime measures per-stage infer histograms on
every frame.  This module joins them:

* :func:`stage_flops_bytes` / :class:`CapacityModel` — per-stage
  analytic FLOPs and HBM bytes for a deployed partition, and the
  derived live metrics: **MFU** (achieved FLOP/s over the chip peak)
  and **roofline utilization** (the model's best-case stage seconds
  over the measured seconds).  The ``hw.peak_flops`` contract carries
  through: an unknown chip generation has NO peak, so MFU is ``None``
  (rendered ``-``), never a number fabricated against a guessed peak.
* :class:`DriftAuditor` — scores the deployed plan's per-stage service
  predictions (:func:`~defer_tpu_torch.plan.calibrate.predict_stage_service_s`)
  against the live window-bounded measurements every monitor interval;
  sustained relative error past the threshold emits ONE ``model_drift``
  flight-recorder event per episode (the same sustain/re-arm discipline
  as ``StragglerDetector``), so a cost model going stale is a recorded
  fact with numbers attached, not a vibe.

Node-side MFU (the ``stats`` / ``obs_push`` fields) uses
:func:`achieved_mfu` with the per-stage FLOPs the dispatcher ships in
the deploy message — the node knows its own chip generation; the
monitor-side :class:`CapacityModel` recomputes the same figure for
views that only have plan JSON.
"""

from __future__ import annotations

import dataclasses

from ..utils import hw
from .cluster import SERVICE_WINDOW
from .events import emit as emit_event


def stage_flops_bytes(graph, node_names, *, batch: int = 1
                      ) -> tuple[float, float]:
    """(flops, hbm bytes moved) of one stage's nodes at ``batch`` — the
    same per-node accounting as the cost model's roofline
    (``StageCostModel.node_seconds``): every node reads its inputs and
    writes its output through HBM."""
    from ..graph.analysis import node_flops
    batch = max(1, int(batch))
    flops = moved = 0.0
    for name in node_names:
        node = graph.nodes[name]
        flops += node_flops(graph, name)
        moved += sum(graph.out_spec(i).size * graph.out_spec(i).dtype.itemsize
                     for i in node.inputs)
        moved += node.out_spec.size * node.out_spec.dtype.itemsize
    return flops * batch, moved * batch


def achieved_mfu(flops: float, seconds: float,
                 peak_flops_s: float) -> float | None:
    """MFU of one stage interval: achieved FLOP/s over the chip peak.
    ``None`` when there is no honest denominator (unknown peak) or no
    measurement — callers render it as ``-``, never as 0.0 (a real 0%
    and "we cannot know" must stay distinguishable)."""
    if peak_flops_s <= 0 or seconds <= 0 or flops <= 0:
        return None
    return flops / (seconds * peak_flops_s)


def stages_from_cuts(graph, cuts) -> list[list[str]]:
    """Topo-order node names per stage for a ``cuts`` partition."""
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    bounds = [0] + [pos[c] + 1 for c in cuts] + [len(order)]
    return [order[bounds[k]:bounds[k + 1]]
            for k in range(len(bounds) - 1)]


class CapacityModel:
    """Analytic per-stage capacity of a deployed partition, joined with
    measurements on demand.

    ``gen`` anchors the peaks; ``peak_flops_s`` / ``hbm_bw_s`` override
    them explicitly (e.g. from a plan's ``cost_model`` dict).  Unknown
    generation and no override = no peak = MFU/roofline ``None``.
    """

    def __init__(self, graph, cuts, *, batch: int = 1,
                 gen: str | None = None,
                 peak_flops_s: float | None = None,
                 hbm_bw_s: float | None = None):
        self.graph = graph
        self.cuts = list(cuts)
        self.batch = max(1, int(batch))
        self.gen = gen or "unknown"
        # NO v5e fallback here, unlike the cost model: the cost model
        # needs relative weights on any host, but MFU against a
        # borrowed peak is a fabricated percentage (utils/hw.py policy)
        self.peak_flops_s = float(peak_flops_s) if peak_flops_s \
            else hw.peak_flops(self.gen)
        self.hbm_bw_s = float(hbm_bw_s) if hbm_bw_s \
            else hw.hbm_bandwidth(self.gen)
        self.stages = stages_from_cuts(graph, self.cuts)
        self.stage_flops: list[float] = []
        self.stage_bytes: list[float] = []
        for names in self.stages:
            f, b = stage_flops_bytes(graph, names, batch=self.batch)
            self.stage_flops.append(f)
            self.stage_bytes.append(b)

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def roofline_s(self, stage: int) -> float | None:
        """Best-case stage seconds under the roofline: compute-bound at
        the peak or bandwidth-bound at HBM rate, whichever dominates.
        ``None`` without honest peaks."""
        if self.peak_flops_s <= 0 or self.hbm_bw_s <= 0:
            return None
        return max(self.stage_flops[stage] / self.peak_flops_s,
                   self.stage_bytes[stage] / self.hbm_bw_s)

    def mfu(self, stage: int, measured_s: float) -> float | None:
        return achieved_mfu(self.stage_flops[stage], measured_s,
                            self.peak_flops_s)

    def roofline_util(self, stage: int, measured_s: float
                      ) -> float | None:
        """Fraction of the roofline bound achieved: 1.0 = running at
        the model's best case (compute- or bandwidth-limited)."""
        best = self.roofline_s(stage)
        if best is None or measured_s <= 0:
            return None
        return best / measured_s

    def chain_mfu(self, bottleneck_s: float) -> float | None:
        """Pipeline-level MFU: total graph FLOPs over what the chain's
        aggregate silicon could do in one pipeline interval — the same
        figure the JAX package's benchmark publishes (``num_stages`` chips
        each spend ``bottleneck_s`` per frame at steady state)."""
        if self.peak_flops_s <= 0 or bottleneck_s <= 0:
            return None
        total = sum(self.stage_flops)
        return total / (bottleneck_s * self.peak_flops_s
                        * max(1, self.num_stages))

    def to_json(self) -> dict:
        return {
            "gen": self.gen, "batch": self.batch,
            "peak_flops_s": self.peak_flops_s, "hbm_bw_s": self.hbm_bw_s,
            "stage_flops": [float(f) for f in self.stage_flops],
            "stage_bytes": [float(b) for b in self.stage_bytes],
            "roofline_ms": [
                None if (r := self.roofline_s(k)) is None
                else round(r * 1e3, 6) for k in range(self.num_stages)],
        }


# ---------------------------------------------------------------------------
# prediction-drift auditing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriftFlag:
    stage: int
    predicted_ms: float
    measured_ms: float
    rel_err: float         #: (measured - predicted) / predicted, signed
    intervals: int         #: consecutive observe() calls sustained

    def to_json(self) -> dict:
        return {"stage": self.stage,
                "predicted_ms": round(self.predicted_ms, 4),
                "measured_ms": round(self.measured_ms, 4),
                "rel_err": round(self.rel_err, 4),
                "intervals": self.intervals}


class DriftAuditor:
    """Scores per-stage service predictions against live measurement.

    ``predicted_ms`` is the measurement-aligned prediction
    (:func:`~defer_tpu_torch.plan.calibrate.predict_stage_service_s`, in ms).
    Call :meth:`observe` once per monitor interval: a stage whose
    |relative error| exceeded ``threshold`` for ``sustain`` consecutive
    calls is flagged and emits ONE ``model_drift`` event; the event
    re-arms when the stage drops back under the threshold (same
    discipline as ``StragglerDetector``).  Measurements are
    window-bounded (``ClusterView.stage_service_ms(window=...)``) so a
    regime shift shows up within a few pushes instead of being averaged
    into the lifetime fold.

    :attr:`last` keeps the most recent per-stage audit rows
    (``{stage: {"pred_ms", "meas_ms", "err"}}``) for the monitor's
    PRED/MEAS/ERR% columns.
    """

    def __init__(self, predicted_ms, *, threshold: float = 0.25,
                 sustain: int = 2, window: int = SERVICE_WINDOW):
        self.predicted_ms = [float(v) for v in predicted_ms]
        self.threshold = float(threshold)
        self.sustain = max(1, int(sustain))
        self.window = max(2, int(window))
        self._over: dict[int, int] = {}
        self._emitted: set[int] = set()
        self.last: dict[int, dict] = {}

    def audit(self, view) -> dict[int, dict]:
        """One pass of predicted-vs-measured, no flagging: per-stage
        ``{"pred_ms", "meas_ms", "err"}`` (err ``None`` until a stage
        has both numbers)."""
        measured = view.stage_service_ms(window=self.window)
        rows: dict[int, dict] = {}
        for k, pred in enumerate(self.predicted_ms):
            meas = float(measured.get(k, 0.0))
            err = (meas - pred) / pred if pred > 0 and meas > 0 else None
            rows[k] = {"pred_ms": round(pred, 4),
                       "meas_ms": round(meas, 4),
                       "err": None if err is None else round(err, 4)}
        self.last = rows
        return rows

    def observe(self, view) -> list[DriftFlag]:
        rows = self.audit(view)
        flags = []
        for k, row in rows.items():
            err = row["err"]
            if err is not None and abs(err) > self.threshold:
                self._over[k] = self._over.get(k, 0) + 1
            else:
                self._over[k] = 0
                self._emitted.discard(k)
            if self._over[k] >= self.sustain:
                flag = DriftFlag(stage=k, predicted_ms=row["pred_ms"],
                                 measured_ms=row["meas_ms"],
                                 rel_err=err, intervals=self._over[k])
                flags.append(flag)
                if k not in self._emitted:
                    self._emitted.add(k)
                    emit_event("model_drift", **flag.to_json())
        return flags
