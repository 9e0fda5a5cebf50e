"""Telemetry-driven replanning: correct the cost model with live metrics.

The port of ``defer_tpu.plan.replan``; :class:`LiveReplan` cuts a chain of
the port's persistent ``StageNode``s over through its ``ChainDispatcher``.

The planner's compute model is analytic (or one-shot measured) and will
be wrong in ways only a running deployment can reveal — library
fusion across a stage, host dispatch overhead, a slow host.  The telemetry PR
already publishes per-stage latency histograms; this module closes the
loop:

1. :func:`measured_stage_seconds` pulls per-stage seconds out of either
   a ``MetricsRegistry`` snapshot (``<prefix>.stage<k>.latency_s``
   summaries from ``SpmdPipeline.stage_latencies`` /
   ``PipelineMetrics.bind``) or a ``ChainDispatcher.stats`` reply list
   (each node's ``infer_latency_s`` summary).
2. :func:`replan` scales every node cost inside old stage ``k`` by
   ``measured_k / predicted_k`` (the stage is the granularity telemetry
   gives us), re-solves with the corrected model, and reports a plan
   diff — so the cost model is corrected by what the chain actually did
   instead of trusted blindly.

Corrections are multiplicative and per-stage: relative node weights
inside a stage keep the model's shape, while the stage total matches
reality.  Stages with no samples keep factor 1.0.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Sequence

from ..graph.ir import LayerGraph
from .cost import CodecSpec, StageCostModel
from .solver import (Plan, ReplicatedPlan, evaluate_cuts, solve,
                     solve_replicated)

_STAGE_KEY = re.compile(r"(?:^|\.)stage(\d+)\.latency_s$")


def _window_mean(now, base) -> float | None:
    """Delta-mean of a cumulative summary against a baseline snapshot:
    ``(sum - sum0) / (count - count0)``.  Percentiles cannot be
    subtracted; the exact sum/count fields can — the window-bounded
    form that scores the CURRENT regime instead of the lifetime fold
    (a serve chain's cold-start/compile samples otherwise skew the
    average forever)."""
    if not isinstance(base, dict) or not base.get("count"):
        return None
    n = int(now.get("count", 0)) - int(base.get("count", 0))
    if n <= 0:
        return None
    return (float(now.get("sum", 0.0))
            - float(base.get("sum", 0.0))) / n


def measured_stage_seconds(source, *, quantile: str = "p50",
                           scale: float = 1.0,
                           baseline=None) -> dict[int, float]:
    """stage index -> measured seconds, from telemetry.

    ``source`` is a registry snapshot dict (histogram summaries under
    ``...stage<k>.latency_s`` keys, seconds), a list of node ``stats``
    dicts (``{"stage": k, "infer_latency_s": {...}}``), or a direct
    ``{stage: seconds}`` mapping (e.g. a live
    ``ClusterView.stage_service_ms()`` converted to seconds — the
    full-service estimate, which unlike infer-only latency includes a
    stage's per-hop codec costs).
    ``quantile`` picks the summary field (p50 by default — the
    steady-state number; mean is skewed by compile outliers).  ``scale``
    converts units if the source was exported scaled.

    ``baseline`` is an EARLIER snapshot of the same shape: when given,
    each summary is reduced to its window-bounded delta-mean against
    the matching baseline summary (see :func:`_window_mean`) — the form
    replan/calibration use on long-running chains, where the lifetime
    histograms average cold-start samples in forever.  Summaries with
    no baseline match (or no new samples) keep the lifetime figure.

    Replicated stages report one ``stats`` row per replica; their
    per-frame service times are averaged into one per-stage figure (a
    replica's latency measures the UNDIVIDED stage cost — the division
    by R happens in the solver's objective, not in telemetry).
    """
    acc: dict[int, list[float]] = {}
    base_map: dict = {}
    if isinstance(baseline, dict):
        for key, summ in baseline.items():
            m = _STAGE_KEY.search(key)
            if m:
                base_map[int(m.group(1))] = summ
    elif baseline is not None:
        for row in baseline:
            if isinstance(row, dict) and row.get("stage") is not None:
                base_map[(int(row["stage"]), row.get("replica"))] = \
                    row.get("infer_latency_s")

    def take(stage: int, summ, base_key=None) -> None:
        if not isinstance(summ, dict) or not summ.get("count"):
            return
        win = _window_mean(summ, base_map.get(base_key)) \
            if base_key is not None else None
        v = win if win is not None else summ.get(quantile,
                                                 summ.get("mean"))
        if v is not None:
            acc.setdefault(int(stage), []).append(float(v) * scale)

    if isinstance(source, dict) and source and all(
            (isinstance(k, int) or (isinstance(k, str) and k.isdigit()))
            and isinstance(v, (int, float)) and not isinstance(v, bool)
            for k, v in source.items()):
        # direct {stage: seconds} mapping: pass through (scaled).  Keys
        # must LOOK like stage indices — an all-numeric registry
        # snapshot (counters/gauges only) must fall through to the
        # pattern search below and yield {}, not crash on int("a.b")
        return {int(k): float(v) * scale for k, v in source.items()}
    if isinstance(source, dict):
        for key, summ in source.items():
            m = _STAGE_KEY.search(key)
            if m:
                take(int(m.group(1)), summ, base_key=int(m.group(1)))
    else:  # ChainDispatcher.stats reply list (one row per replica)
        for row in source:
            if isinstance(row, dict) and row.get("stage") is not None:
                take(row["stage"], row.get("infer_latency_s"),
                     base_key=(int(row["stage"]), row.get("replica")))
    return {k: sum(vs) / len(vs) for k, vs in acc.items()}


@dataclasses.dataclass
class ReplanResult:
    old_plan: Plan
    #: the old cuts re-scored under the corrected model — the honest
    #: baseline the new plan's improvement is measured against
    old_plan_corrected: Plan
    new_plan: Plan
    #: per-old-stage measured/predicted factors applied to node costs
    corrections: dict[int, float]
    measured_stage_s: dict[int, float]

    @property
    def moved(self) -> bool:
        return self.new_plan.cuts != self.old_plan.cuts \
            or self.new_plan.codecs != self.old_plan.codecs \
            or getattr(self.new_plan, "replicas", None) \
            != getattr(self.old_plan, "replicas", None)

    @property
    def predicted_improvement(self) -> float:
        """corrected-old bottleneck / new bottleneck (>1 = replan wins)."""
        if self.new_plan.bottleneck_s <= 0:
            return 1.0
        return self.old_plan_corrected.bottleneck_s \
            / self.new_plan.bottleneck_s

    def to_json(self) -> dict:
        return {
            "moved": self.moved,
            "predicted_improvement": round(self.predicted_improvement, 4),
            "corrections": {k: round(v, 4)
                            for k, v in sorted(self.corrections.items())},
            "measured_stage_ms": {
                k: round(v * 1e3, 4)
                for k, v in sorted(self.measured_stage_s.items())},
            "old": self.old_plan.to_json(),
            "old_corrected": self.old_plan_corrected.to_json(),
            "new": self.new_plan.to_json(),
        }

    def apply(self, live: "LiveReplan", *,
              min_improvement: float = 1.0) -> dict | None:
        """Act on the suggestion: cut the live chain over to
        ``new_plan`` through ``live`` (quiesce -> redeploy -> resume,
        docs/ROBUSTNESS.md).  Returns the cutover receipt, or None when
        the suggestion moved nothing / predicts less than
        ``min_improvement`` — a suggestion that is not worth a cutover
        should cost nothing."""
        if not self.moved or self.predicted_improvement < min_improvement:
            return None
        return live.apply(self.new_plan)


class LiveReplan:
    """Zero-downtime mid-stream replan over persist-mode stage nodes.

    The replay/quiesce substrate's second consumer (the first is
    replica failover — docs/ROBUSTNESS.md): between stream segments,
    quiesce every stage at a stable sequence point, end the segment's
    data-plane connections (the dispatcher's result server and sequence
    counter survive — :meth:`ChainDispatcher.end_stream`), ship the
    re-cut stage artifacts over the SAME in-band deploy path that
    booted the chain, and resume streaming.  The nodes never restart,
    no port moves, and the output stream stays byte-identical to an
    undisturbed run because the cutover sits exactly on a segment
    boundary.

    Requires every node to run ``--persist`` (survive stream END until
    an explicit ``shutdown``) — the constructor cannot verify that, so
    a non-persist node surfaces as a connect failure on the segment
    after the first cutover.

    The cutover redeploys onto the SAME process set: ``new_plan.cuts``
    must produce ``len(node_addrs)`` stages (replica-count changes need
    a supervisor respawn, which is failover's mechanism, not this one).
    """

    def __init__(self, dispatcher, graph, params,
                 node_addrs: Sequence, *, batch: int = 1,
                 codecs: Sequence[str] | None = None,
                 quiesce_timeout_s: float = 30.0):
        self.dispatcher = dispatcher
        self.graph = graph
        self.params = params
        self.node_addrs = list(node_addrs)
        self.batch = batch
        self.codecs = list(codecs) if codecs else None
        self.quiesce_timeout_s = quiesce_timeout_s
        #: cutovers performed (the obs counter's pull twin)
        self.cutovers = 0

    def apply(self, new_plan, *, at_seq: int | None = None) -> dict:
        """One cutover: quiesce -> end segment -> in-band redeploy ->
        ready for the next ``stream`` segment.  Returns a receipt dict
        (per-stage quiesced counts, stage count, recovery time)."""
        from ..obs.events import emit as _emit
        from ..partition.partitioner import partition

        t0 = time.perf_counter()
        disp = self.dispatcher
        stages = partition(self.graph, list(new_plan.cuts))
        if len(stages) != len(self.node_addrs):
            raise ValueError(
                f"plan cuts produce {len(stages)} stages but the live "
                f"chain has {len(self.node_addrs)} nodes — a live "
                f"replan keeps the process set")
        processed = disp.quiesce(self.node_addrs, at_seq=at_seq,
                                 timeout_s=self.quiesce_timeout_s)
        disp.end_stream()
        # plan codecs are per CUT (N-1 interior hops); deploy wants one
        # OUTBOUND codec per stage — the exit stage's result hop rides
        # the dispatcher default
        codecs = self.codecs
        if getattr(new_plan, "codecs", None):
            codecs = list(new_plan.codecs) + [disp.codec]
        disp.deploy(stages, self.params, self.node_addrs,
                    batch=self.batch, codecs=codecs)
        self.cutovers += 1
        receipt = {"stages": len(stages),
                   "quiesced": processed,
                   "cuts": list(new_plan.cuts),
                   "cutover_ms": round(
                       (time.perf_counter() - t0) * 1e3, 3)}
        _emit("cutover", stages=len(stages), quiesced=processed)
        return receipt

    def shutdown(self) -> None:
        """Release the persist nodes: send each the ``shutdown``
        control command so their serve loops return."""
        self.dispatcher.shutdown_nodes(self.node_addrs)


def cost_model_from_plan(graph: LayerGraph, plan: Plan) -> StageCostModel:
    """A cost model whose per-stage compute totals reproduce the plan's
    own ``stage_compute_s`` (spread uniformly over each stage's nodes).

    The right default when replanning against a plan whose original
    model is gone — a monitor that loaded plan JSON, or ``run_chain``'s
    live straggler suggestion: per-stage correction factors
    (measured / predicted) only need the stage TOTALS, which this model
    matches exactly; the uniform spread inside a stage makes the
    re-solve approximate, which a suggestion is anyway."""
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    bounds = [0] + [pos[c] + 1 for c in plan.cuts] + [len(order)]
    node_costs: dict[str, float] = {}
    for k in range(len(bounds) - 1):
        names = order[bounds[k]:bounds[k + 1]]
        per = plan.stage_compute_s[k] / max(1, len(names))
        for n in names:
            node_costs[n] = per
    # adopt the plan's per-hop transport tiers: a replan seeded from
    # plan JSON keeps scoring the deployment's colocated hops on their
    # tier pseudo-codecs instead of re-modeling them as TCP
    tiers = {c: t for c, t in zip(plan.cuts,
                                  getattr(plan, "hop_tiers", None) or [])
             if t != "tcp"}
    # a CALIBRATED model's codec table (fitted throughputs, possibly
    # codec names the analytic defaults never heard of) travels in the
    # plan's cost_model dict too — restore it, or a replan seeded from
    # a calibrated plan silently reverts to guessed codec constants
    codec_doc = (plan.cost or {}).get("codecs")
    codecs = {n: CodecSpec(**c) for n, c in codec_doc.items()} \
        if codec_doc else None
    return StageCostModel(
        graph, node_costs=node_costs, hop_tiers=tiers or None,
        codecs=codecs,
        # comm terms scale with the frame batch (cut_bytes): restore
        # the plan's, or a batch-N plan's hops re-price at batch 1
        batch=int((plan.cost or {}).get("batch") or 1),
        link_bw_s=(plan.cost or {}).get("link_bw_s"),
        # the tier map's bandwidth half travels in the plan's cost_model
        # dict — without it a calibrated local_bw_s would silently reset
        # to the default in replans seeded from plan JSON (likewise the
        # ici interconnect and host-sync bandwidths)
        local_bw_s=(plan.cost or {}).get("local_bw_s"),
        ici_bw_s=(plan.cost or {}).get("ici_bw_s"),
        host_sync_bw_s=(plan.cost or {}).get("host_sync_bw_s"))


def corrected_cost_model(graph: LayerGraph, plan: Plan,
                         cost: StageCostModel,
                         measured: dict[int, float]) -> StageCostModel:
    """``cost`` with node seconds rescaled so each old stage's total
    matches its measured seconds (unmeasured stages keep factor 1)."""
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    bounds = [0] + [pos[c] + 1 for c in plan.cuts] + [len(order)]
    node_costs: dict[str, float] = {}
    for k in range(len(bounds) - 1):
        names = order[bounds[k]:bounds[k + 1]]
        predicted = cost.compute_seconds(names)
        factor = 1.0
        if k in measured and predicted > 0:
            factor = measured[k] / predicted
        for n in names:
            # node_seconds is already at the model's batch; node_costs
            # entries are consumed as-is, so no batch rescaling here
            node_costs[n] = cost.node_seconds(n) * factor
    return StageCostModel(
        graph, batch=cost.batch, gen=cost.gen,
        peak_flops_s=cost.peak_flops_s, hbm_bw_s=cost.hbm_bw_s,
        link_bw_s=cost.link_bw_s, codecs=cost.codecs,
        node_costs=node_costs,
        # tier-aware costs survive the correction: colocated hops stay
        # colocated in the re-solve
        hop_tiers=getattr(cost, "hop_tiers", None) or None,
        local_bw_s=getattr(cost, "local_bw_s", None),
        ici_bw_s=getattr(cost, "ici_bw_s", None),
        host_sync_bw_s=getattr(cost, "host_sync_bw_s", None))


def replan(graph: LayerGraph, plan: Plan, source,
           cost: StageCostModel | None = None, *,
           quantile: str = "p50") -> ReplanResult:
    """Re-solve ``plan`` with telemetry-corrected stage costs.

    ``source`` is a registry snapshot or node-stats list (see
    :func:`measured_stage_seconds`).  ``cost`` defaults to a fresh
    analytic model matching the plan's stage count assumptions — pass
    the model the plan was built with when available.

    A :class:`ReplicatedPlan` replans under the SAME node budget: the
    corrected old plan keeps its cuts and replica counts, the new plan
    re-runs :func:`solve_replicated` with ``num_nodes`` — so telemetry
    can move replicas to whichever stage measurement proved slow, not
    just move the cuts.
    """
    if cost is None:
        cost = StageCostModel(graph)
    measured = measured_stage_seconds(source, quantile=quantile)
    corrected = corrected_cost_model(graph, plan, cost, measured)
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    bounds = [0] + [pos[c] + 1 for c in plan.cuts] + [len(order)]
    corrections = {}
    for k in range(len(bounds) - 1):
        names = order[bounds[k]:bounds[k + 1]]
        pred = cost.compute_seconds(names)
        corrections[k] = (measured[k] / pred
                          if k in measured and pred > 0 else 1.0)
    if isinstance(plan, ReplicatedPlan):
        old_corrected = evaluate_cuts(graph, plan.cuts, corrected,
                                      objective=plan.objective,
                                      replicas=plan.replicas)
        new_plan = solve_replicated(graph, corrected,
                                    num_nodes=plan.num_nodes)
    else:
        old_corrected = evaluate_cuts(graph, plan.cuts, corrected,
                                      objective=plan.objective)
        new_plan = solve(graph, plan.num_stages, corrected)
    return ReplanResult(old_plan=plan, old_plan_corrected=old_corrected,
                        new_plan=new_plan, corrections=corrections,
                        measured_stage_s=measured)
