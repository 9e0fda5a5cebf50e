"""Exact bottleneck-minimizing partition planner over the valid-cut chain.

The port of ``defer_tpu.plan.solver``: pure Python arithmetic in the
reference's order of operations, so the same cost inputs give the same
cuts, codecs and floats in both packages.

Pipeline throughput at steady state is ``1 / max_k max(compute_k,
comm_k)`` — the slowest of every stage's compute and every hop's
transport ("The TensorFlow Partitioning and Scheduling Problem: It's the
Critical Path!", PAPERS.md, makes the general form of this argument).
The greedy quantile heuristic in ``graph.analysis.auto_cut_points``
balances cumulative *compute* only; this module minimizes the true
bottleneck exactly:

* ``solve`` — O(C^2 * S) dynamic program over the C valid cuts:

      dp[s][i] = min over j < i of
                 max(dp[s-1][j], compute(j..i), comm(i))

  where ``compute(j..i)`` is the prefix-sum difference of per-node
  seconds and ``comm(i)`` is the *cheapest-codec* transport time at cut
  ``i`` (codec choice is separable: each hop's codec affects only that
  hop's term of the max, so the per-hop argmin is globally optimal).

* ``solve(method="bisect")`` — binary search over the O(C^2) candidate
  bottleneck values with a greedy O(C) feasibility check (place each cut
  as far right as the limit allows).  Same optimum, near-linear per
  probe; cross-checked against the DP in tests.

The final relay back to the dispatcher (SPMD wrap hop / chain result
hop) is cut-independent — the output tensor is fixed — so it is reported
on the plan but excluded from the objective.
"""

from __future__ import annotations

import dataclasses

from ..graph.analysis import valid_cut_points
from ..graph.ir import LayerGraph
from .cost import StageCostModel


@dataclasses.dataclass
class Plan:
    """A solved (or evaluated) pipeline partition with its predictions."""

    graph_name: str
    num_stages: int
    cuts: list[str]
    codecs: list[str]              #: per hop, len == len(cuts)
    stage_compute_s: list[float]   #: len == num_stages
    hop_comm_s: list[float]        #: len == len(cuts)
    bottleneck_s: float
    objective: str
    cost: dict                     #: StageCostModel.describe()
    #: per-hop transport tier (tcp|local|device, len == len(cuts)) —
    #: which hops the cost model scored on the colocated fast path
    hop_tiers: list[str] = dataclasses.field(default_factory=list)

    @property
    def stage_cost_s(self) -> list[float]:
        """Per-stage steady-state cost: max(compute_k, comm_k)."""
        return [max(c, self.hop_comm_s[k]) if k < len(self.hop_comm_s)
                else c for k, c in enumerate(self.stage_compute_s)]

    @property
    def bottleneck_stage(self) -> int:
        costs = self.stage_cost_s
        return costs.index(max(costs)) if costs else 0

    @property
    def bound_by(self) -> str:
        """"compute" or "comm" — which side of the max binds."""
        k = self.bottleneck_stage
        if k < len(self.hop_comm_s) and \
                self.hop_comm_s[k] > self.stage_compute_s[k]:
            return "comm"
        return "compute"

    def predicted_throughput_per_s(self, batch: int = 1) -> float:
        return batch / self.bottleneck_s if self.bottleneck_s > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "graph": self.graph_name,
            "objective": self.objective,
            "num_stages": self.num_stages,
            "cuts": list(self.cuts),
            "hop_codecs": list(self.codecs),
            "hop_tiers": list(self.hop_tiers)
            or ["tcp"] * len(self.cuts),
            "stage_compute_ms": [round(s * 1e3, 6)
                                 for s in self.stage_compute_s],
            "hop_comm_ms": [round(s * 1e3, 6) for s in self.hop_comm_s],
            "stage_cost_ms": [round(s * 1e3, 6) for s in self.stage_cost_s],
            "bottleneck_ms": round(self.bottleneck_s * 1e3, 6),
            "bottleneck_stage": self.bottleneck_stage,
            "bound_by": self.bound_by,
            "cost_model": self.cost,
        }


def _tables(graph: LayerGraph, cost: StageCostModel):
    """(cuts, cum compute prefix at each cut, total compute, per-cut
    (comm seconds, codec)) shared by every solver path."""
    cuts = valid_cut_points(graph)
    order = graph.topo_order
    node_s = {n: cost.node_seconds(n) for n in order}
    acc = 0.0
    cum_at = {}
    for n in order:
        acc += node_s[n]
        cum_at[n] = acc
    total = acc
    cum = [cum_at[c] for c in cuts]
    comm = []
    for c in cuts:
        name, s = cost.best_codec(c)
        comm.append((s, name))
    return cuts, cum, total, comm


def _mk_plan(graph, cost, chosen_idx, cuts, cum, total, comm,
             objective: str) -> Plan:
    bounds = [0.0] + [cum[i] for i in chosen_idx] + [total]
    stage_compute = [bounds[k + 1] - bounds[k]
                     for k in range(len(chosen_idx) + 1)]
    hop_comm = [comm[i][0] for i in chosen_idx]
    codecs = [comm[i][1] for i in chosen_idx]
    bottleneck = max([max(c, hop_comm[k]) if k < len(hop_comm) else c
                      for k, c in enumerate(stage_compute)] or [0.0])
    return Plan(graph_name=graph.name, num_stages=len(chosen_idx) + 1,
                cuts=[cuts[i] for i in chosen_idx], codecs=codecs,
                stage_compute_s=stage_compute, hop_comm_s=hop_comm,
                bottleneck_s=bottleneck, objective=objective,
                cost=cost.describe(),
                hop_tiers=[cost.hop_tier(cuts[i]) for i in chosen_idx])


def evaluate_cuts(graph: LayerGraph, cut_points: list[str],
                  cost: StageCostModel, *,
                  objective: str = "explicit",
                  replicas: list[int] | None = None,
                  hop_tiers: dict[str, str] | None = None,
                  hop_codecs: list[str] | None = None) -> Plan:
    """Predictions for an *explicit* cut list under ``cost`` (cheapest
    codec per hop) — how quantile or hand-picked cuts score on the same
    model the solver optimizes.  ``replicas`` (one count per stage)
    scores a replicated configuration instead: per-stage compute divides
    by its count and each hop's codec is re-chosen for the fan-adjusted
    ``enc/r_up + wire + dec/r_down`` cost.  ``hop_tiers`` (cut ->
    tcp|local|device) scores colocated hops on their tier pseudo-codec
    (:meth:`StageCostModel.with_hop_tiers`).

    ``hop_codecs`` (one per cut) PINS each hop to a codec instead of
    the argmin — how an audit rescoring a DEPLOYED plan prices the
    codecs that actually run; names the model has no row for fall back
    to ``raw`` (:meth:`StageCostModel.comm_parts_deployed`)."""
    if hop_tiers is not None:
        cost = cost.with_hop_tiers(hop_tiers)
    cuts, cum, total, comm = _tables(graph, cost)
    pos = {c: i for i, c in enumerate(cuts)}
    missing = [c for c in cut_points if c not in pos]
    if missing:
        raise ValueError(f"not valid cut points: {missing}")
    chosen = [pos[c] for c in cut_points]
    if hop_codecs is not None:
        if len(hop_codecs) != len(cut_points):
            raise ValueError(f"{len(cut_points)} cuts but "
                             f"{len(hop_codecs)} hop codecs")
        if replicas is not None:
            raise ValueError("hop_codecs pin is not supported together "
                             "with replicas (replicated hops re-choose "
                             "their codec for the fan shape)")
        comm = list(comm)
        for i, codec in zip(chosen, hop_codecs):
            comm[i] = (sum(cost.comm_parts_deployed(cuts[i], codec)),
                       codec)
    if replicas is None:
        return _mk_plan(graph, cost, chosen, cuts, cum, total, comm,
                        objective)
    return _mk_replicated_plan(graph, cost, chosen, cuts, cum, total,
                               list(replicas), objective)


def solve(graph: LayerGraph, num_stages: int, cost: StageCostModel, *,
          method: str = "dp",
          hop_tiers: dict[str, str] | None = None) -> Plan:
    """Optimal bottleneck plan for exactly ``num_stages`` stages.

    ``hop_tiers`` (cut -> tcp|local|device) lets cut placement exploit
    colocation: a cut whose hop is declared local/device costs its tier
    pseudo-codec (near zero) instead of the cheapest wire codec, so the
    solver is free to place cuts at fat boundaries the deployment
    crosses for free (docs/PLANNER.md)."""
    if hop_tiers is not None:
        cost = cost.with_hop_tiers(hop_tiers)
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    cuts, cum, total, comm = _tables(graph, cost)
    C = len(cuts)
    if C < num_stages - 1:
        raise ValueError(
            f"graph {graph.name!r} has only {C} valid cut points; "
            f"cannot make {num_stages} stages")
    if num_stages == 1:
        return _mk_plan(graph, cost, [], cuts, cum, total, comm,
                        "bottleneck")
    if method == "bisect":
        chosen = _solve_bisect(cum, total, [c[0] for c in comm],
                               num_stages)
    elif method == "dp":
        chosen = _solve_dp(cum, total, [c[0] for c in comm], num_stages)
    else:
        raise ValueError(f"unknown method {method!r}")
    return _mk_plan(graph, cost, chosen, cuts, cum, total, comm,
                    "bottleneck")


def _solve_dp(cum: list[float], total: float, comm: list[float],
              S: int) -> list[int]:
    """O(C^2 * S) DP; returns the chosen cut indices (len S-1)."""
    C = len(cum)
    INF = float("inf")
    # dp[i]: cut i is the s-th cut; parent[s][i]: the (s-1)-th cut's index
    dp = [INF] * C
    parent: list[list[int]] = []
    for i in range(C):
        # the s=1 row; cut i must leave >= S-2 cuts after it
        if C - 1 - i >= S - 2:
            dp[i] = max(cum[i], comm[i])
    parent.append([-1] * C)
    for s in range(2, S):
        nxt = [INF] * C
        par = [-1] * C
        for i in range(s - 1, C):
            if C - 1 - i < S - 1 - s:
                continue  # not enough cuts left for the later stages
            best, arg = INF, -1
            for j in range(s - 2, i):
                if dp[j] == INF:
                    continue
                v = max(dp[j], cum[i] - cum[j], comm[i])
                if v < best:
                    best, arg = v, j
            nxt[i], par[i] = best, arg
        dp, parent = nxt, parent + [par]
    best, last = INF, -1
    for i in range(S - 2, C):
        if dp[i] == INF:
            continue
        v = max(dp[i], total - cum[i])
        if v < best:
            best, last = v, i
    if last < 0:
        raise ValueError("no feasible plan (internal)")
    chosen = [last]
    for s in range(S - 2, 0, -1):
        chosen.append(parent[s][chosen[-1]])
    return chosen[::-1]


def _greedy_feasible(cum: list[float], total: float, comm: list[float],
                     S: int, limit: float) -> list[int] | None:
    """Cut indices (exactly S-1) achieving bottleneck <= limit, or None.

    With per-cut comm eligibility, naive farthest-cut greedy can strand
    the later stages on ineligible cuts, so the check is structural:

    * eligible cuts ``E`` = comm <= limit; any solution's cuts are a
      subset of ``E``, so if cutting at ALL of ``E`` still leaves a
      segment > limit, no subset can fix it -> infeasible;
    * the classic farthest-eligible greedy gives the MINIMAL cut count
      ``m``; using all of ``E`` gives the maximal; and adding any unused
      eligible cut to a valid solution keeps it valid (splitting only
      shrinks segments), so every count in ``[m, len(E)]`` is achievable
      -> feasible iff ``m <= S-1 <= len(E)``, padding the greedy
      solution with unused eligible cuts up to exactly S-1.
    """
    eps = 1e-12 + limit * 1e-9  # float-sum slack: DP and greedy add in
    #   different orders, so exact equality at the optimum must pass
    E = [i for i in range(len(cum)) if comm[i] <= limit + eps]
    if len(E) < S - 1:
        return None
    prev = 0.0
    for i in E:  # the finest available partition must itself fit
        if cum[i] - prev > limit + eps:
            return None
        prev = cum[i]
    if total - prev > limit + eps:
        return None
    chosen: list[int] = []
    prev_cum = 0.0
    idx = 0
    while total - prev_cum > limit + eps:
        pick = -1
        while idx < len(E) and cum[E[idx]] - prev_cum <= limit + eps:
            pick = E[idx]
            idx += 1
        if pick < 0:
            return None  # unreachable after the gap check; belt+braces
        chosen.append(pick)
        prev_cum = cum[pick]
    if len(chosen) > S - 1:
        return None  # needs more stages than allowed
    if len(chosen) < S - 1:  # pad with unused eligible cuts
        used = set(chosen)
        for i in E:
            if len(chosen) == S - 1:
                break
            if i not in used:
                chosen.append(i)
        chosen.sort()
    return chosen


def _solve_bisect(cum: list[float], total: float, comm: list[float],
                  S: int) -> list[int]:
    """Binary search over candidate bottleneck values + greedy check."""
    cands = set(comm)
    pts = [0.0] + cum
    for i, ci in enumerate(cum):
        for p in pts[: i + 1]:
            cands.add(ci - p)
    cands.update(total - c for c in cum)
    cands.add(total)
    ordered = sorted(c for c in cands if c >= 0.0)
    lo, hi = 0, len(ordered) - 1
    best: list[int] | None = None
    while lo <= hi:
        mid = (lo + hi) // 2
        got = _greedy_feasible(cum, total, comm, S, ordered[mid])
        if got is not None:
            best = got
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        raise ValueError("no feasible plan (internal)")
    return best


def sweep_stages(graph: LayerGraph, cost: StageCostModel, *,
                 max_stages: int | None = None,
                 latency_target_s: float | None = None) -> dict:
    """Solve for every stage count 1..max and pick a recommendation.

    Without a target: the stage count minimizing the bottleneck (ties to
    the fewest chips).  With ``latency_target_s``: the FEWEST stages
    whose bottleneck meets the target (chips are the scarce resource),
    falling back to the overall best when nothing meets it.
    """
    C = len(valid_cut_points(graph))
    hi = C + 1 if max_stages is None else min(max_stages, C + 1)
    plans = [solve(graph, n, cost) for n in range(1, hi + 1)]
    pick = min(plans, key=lambda p: (p.bottleneck_s, p.num_stages))
    met = None
    if latency_target_s is not None:
        feasible = [p for p in plans if p.bottleneck_s <= latency_target_s]
        if feasible:
            pick = min(feasible, key=lambda p: p.num_stages)
            met = True
        else:
            met = False
    return {"plans": plans, "recommended": pick,
            "latency_target_s": latency_target_s, "target_met": met}


def brute_force(graph: LayerGraph, num_stages: int,
                cost: StageCostModel) -> Plan:
    """Exhaustive reference solver (test oracle; exponential — keep the
    graph under ~12 valid cuts)."""
    import itertools
    cuts, cum, total, comm = _tables(graph, cost)
    if len(cuts) < num_stages - 1:
        raise ValueError("not enough cuts")
    best_plan = None
    for combo in itertools.combinations(range(len(cuts)), num_stages - 1):
        p = _mk_plan(graph, cost, list(combo), cuts, cum, total, comm,
                     "brute_force")
        if best_plan is None or p.bottleneck_s < best_plan.bottleneck_s:
            best_plan = p
    assert best_plan is not None
    return best_plan


def plan_from_json(doc: dict) -> "Plan":
    """Rebuild a :class:`Plan` / :class:`ReplicatedPlan` from its
    ``to_json()`` dict (what ``python -m defer_tpu_torch plan --json``
    prints, and the JAX package's plans alike) — so a
    saved plan can seed telemetry replanning without re-solving."""
    doc = doc.get("plan", doc)  # accept a whole `plan --json` document
    kw = dict(
        graph_name=doc.get("graph", ""),
        num_stages=int(doc["num_stages"]),
        cuts=list(doc.get("cuts", [])),
        codecs=list(doc.get("hop_codecs", [])),
        stage_compute_s=[v / 1e3 for v in doc["stage_compute_ms"]],
        hop_comm_s=[v / 1e3 for v in doc.get("hop_comm_ms", [])],
        bottleneck_s=float(doc["bottleneck_ms"]) / 1e3,
        objective=doc.get("objective", "explicit"),
        cost=doc.get("cost_model", {}),
        hop_tiers=list(doc.get("hop_tiers", [])))
    if doc.get("replicas"):
        return ReplicatedPlan(**kw, replicas=list(doc["replicas"]),
                              num_nodes=int(doc.get("num_nodes", 0)))
    return Plan(**kw)


# -- hybrid pipeline/data-parallel: cuts + per-stage replica counts ----------


@dataclasses.dataclass
class ReplicatedPlan(Plan):
    """A plan whose stages may run as R data-parallel replicas.

    ``stage_compute_s`` stays the RAW (unreplicated) per-stage compute;
    ``hop_comm_s`` holds the fan-adjusted effective hop seconds
    (``enc/r_up + wire + dec/r_down`` at the chosen codec).  The
    effective stage cost divides compute by the stage's replica count —
    the runtime analogue being R replica processes each serving every
    R-th microbatch (docs/PLANNER.md).
    """

    replicas: list[int] = dataclasses.field(default_factory=list)
    num_nodes: int = 0

    @property
    def stage_cost_s(self) -> list[float]:
        eff = [c / max(r, 1)
               for c, r in zip(self.stage_compute_s, self.replicas)]
        return [max(c, self.hop_comm_s[k]) if k < len(self.hop_comm_s)
                else c for k, c in enumerate(eff)]

    @property
    def bound_by(self) -> str:
        k = self.bottleneck_stage
        eff = self.stage_compute_s[k] / max(self.replicas[k], 1)
        if k < len(self.hop_comm_s) and self.hop_comm_s[k] > eff:
            return "comm"
        return "compute"

    def to_json(self) -> dict:
        d = super().to_json()
        d["replicas"] = list(self.replicas)
        d["num_nodes"] = self.num_nodes
        d["stage_effective_ms"] = [
            round(c / max(r, 1) * 1e3, 6)
            for c, r in zip(self.stage_compute_s, self.replicas)]
        return d


def _mk_replicated_plan(graph, cost, chosen_idx, cuts, cum, total,
                        replicas: list[int], objective: str
                        ) -> ReplicatedPlan:
    if len(replicas) != len(chosen_idx) + 1:
        raise ValueError(
            f"{len(chosen_idx) + 1} stages but {len(replicas)} replica "
            f"counts")
    if any(r < 1 for r in replicas):
        raise ValueError(f"replica counts must be >= 1: {replicas}")
    for k in range(len(replicas) - 1):
        if replicas[k] > 1 and replicas[k + 1] > 1:
            raise ValueError(
                f"stages {k} and {k + 1} are both replicated; adjacent "
                f"replication is not supported (a replica cannot restore "
                f"another fan-out's order)")
    bounds = [0.0] + [cum[i] for i in chosen_idx] + [total]
    stage_compute = [bounds[k + 1] - bounds[k]
                     for k in range(len(chosen_idx) + 1)]
    hop_comm, codecs = [], []
    for k, i in enumerate(chosen_idx):
        name, s = cost.best_codec_replicated(cuts[i], replicas[k],
                                             replicas[k + 1])
        codecs.append(name)
        hop_comm.append(s)
    eff = [c / r for c, r in zip(stage_compute, replicas)]
    bottleneck = max([max(c, hop_comm[k]) if k < len(hop_comm) else c
                      for k, c in enumerate(eff)] or [0.0])
    # a tier only holds when neither side fans (runtime constraint —
    # see StageCostModel.best_codec_replicated); report what was scored
    tiers = [cost.hop_tier(cuts[i])
             if replicas[k] == 1 and replicas[k + 1] == 1 else "tcp"
             for k, i in enumerate(chosen_idx)]
    return ReplicatedPlan(
        graph_name=graph.name, num_stages=len(chosen_idx) + 1,
        cuts=[cuts[i] for i in chosen_idx], codecs=codecs,
        stage_compute_s=stage_compute, hop_comm_s=hop_comm,
        bottleneck_s=bottleneck, objective=objective,
        cost=cost.describe(), replicas=list(replicas),
        num_nodes=sum(replicas), hop_tiers=tiers)


def solve_replicated(graph: LayerGraph, cost: StageCostModel, *,
                     num_nodes: int,
                     hop_tiers: dict[str, str] | None = None
                     ) -> ReplicatedPlan:
    """Jointly optimal cuts AND per-stage replica counts for a budget of
    ``num_nodes`` processes, minimizing::

        max_k max(compute_k / r_k,
                  min_codec enc_k/r_k + wire_k + dec_k/r_{k+1})

    — the steady-state period of the hybrid pipeline/data-parallel
    chain.  Replicating a stage divides its compute (and its share of
    the adjoining hops' codec work) by R at the price of R-1 extra
    nodes somewhere else; when no single fat stage dominates, the DP
    simply returns more stages instead.  Adjacent stages cannot both be
    replicated (runtime constraint: a replica cannot restore another
    fan-out's sequence order).

    O(C² · N³) dynamic program over (last cut, nodes used, last stage's
    replica count); cross-checked against
    :func:`brute_force_replicated` in the property tests.

    ``hop_tiers`` (cut -> tcp|local|device): colocated hops cost their
    tier pseudo-codec whenever neither side is replicated (fan paths
    always ride tcp), so the joint DP trades replicas against fused or
    same-process boundaries on one objective.
    """
    if hop_tiers is not None:
        cost = cost.with_hop_tiers(hop_tiers)
    if num_nodes < 1:
        raise ValueError("num_nodes must be >= 1")
    N = num_nodes
    cuts, cum, total, _ = _tables(graph, cost)
    C = len(cuts)
    INF = float("inf")

    # hop_tab[i][ru][rd]: cheapest effective hop seconds at cut i for
    # upstream/downstream replica counts (codec argmin re-run per pair)
    hop_tab = [[[cost.best_codec_replicated(cuts[i], ru, rd)[1]
                 for rd in range(N + 1)] for ru in range(N + 1)]
               for i in range(C)]

    # dp[i][b][r]: best achievable max-so-far when the last completed
    # stage ends at cut i, b nodes are spent, and that stage runs r
    # replicas (the hop at cut i is NOT yet charged — it needs the next
    # stage's count)
    dp = [[[INF] * (N + 1) for _ in range(N + 1)] for _ in range(C)]
    par: dict[tuple[int, int, int], tuple[int, int, int] | None] = {}
    for i in range(C):
        for r in range(1, N):  # >= 1 node must remain for later stages
            dp[i][r][r] = cum[i] / r
            par[(i, r, r)] = None
    for b in range(1, N):
        for i in range(C):
            row = dp[i][b]
            for r in range(1, b + 1):
                v = row[r]
                if v == INF:
                    continue
                for i2 in range(i + 1, C):
                    seg = cum[i2] - cum[i]
                    for r2 in range(1, N - b):
                        if r > 1 and r2 > 1:
                            continue  # adjacent replication forbidden
                        val = max(v, hop_tab[i][r][r2], seg / r2)
                        if val < dp[i2][b + r2][r2]:
                            dp[i2][b + r2][r2] = val
                            par[(i2, b + r2, r2)] = (i, b, r)

    best_val, best_state, best_r_last = INF, None, 1
    for r in range(1, N + 1):  # single stage: no cuts, r-way replicas
        if total / r < best_val:
            best_val, best_state, best_r_last = total / r, None, r
    for i in range(C):
        for b in range(1, N):
            for r in range(1, b + 1):
                v = dp[i][b][r]
                if v == INF:
                    continue
                tail = total - cum[i]
                for r2 in range(1, N - b + 1):
                    if r > 1 and r2 > 1:
                        continue
                    val = max(v, hop_tab[i][r][r2], tail / r2)
                    if val < best_val:
                        best_val = val
                        best_state = (i, b, r)
                        best_r_last = r2

    chosen: list[int] = []
    replicas: list[int] = [best_r_last]
    state = best_state
    while state is not None:
        i, b, r = state
        chosen.append(i)
        replicas.append(r)
        state = par[(i, b, r)]
    chosen.reverse()
    replicas.reverse()
    return _mk_replicated_plan(graph, cost, chosen, cuts, cum, total,
                               replicas, "bottleneck_replicated")


def brute_force_replicated(graph: LayerGraph, cost: StageCostModel, *,
                           num_nodes: int) -> ReplicatedPlan:
    """Exhaustive cuts x replica-count enumeration (test oracle for
    :func:`solve_replicated`; keep the graph under ~8 valid cuts and
    the budget under ~6)."""
    import itertools
    cuts, cum, total, _ = _tables(graph, cost)
    N = num_nodes
    best = None
    for S in range(1, N + 1):
        if S - 1 > len(cuts):
            break
        for combo in itertools.combinations(range(len(cuts)), S - 1):
            for reps in itertools.product(range(1, N + 1), repeat=S):
                if sum(reps) > N:
                    continue
                if any(reps[k] > 1 and reps[k + 1] > 1
                       for k in range(S - 1)):
                    continue
                p = _mk_replicated_plan(graph, cost, list(combo), cuts,
                                        cum, total, list(reps),
                                        "brute_force_replicated")
                if best is None or p.bottleneck_s < best.bottleneck_s:
                    best = p
    assert best is not None
    return best


def sweep_nodes(graph: LayerGraph, cost: StageCostModel, *,
                max_nodes: int,
                latency_target_s: float | None = None) -> dict:
    """:func:`solve_replicated` for every node budget 1..max and pick a
    recommendation — the replication-aware analogue of
    :func:`sweep_stages`.  Without a target: the budget minimizing the
    bottleneck (ties to the fewest nodes).  With ``latency_target_s``:
    the FEWEST nodes whose bottleneck meets the target, falling back to
    the overall best when nothing does."""
    plans = [solve_replicated(graph, cost, num_nodes=n)
             for n in range(1, max_nodes + 1)]
    pick = min(plans, key=lambda p: (p.bottleneck_s, p.num_nodes))
    met = None
    if latency_target_s is not None:
        feasible = [p for p in plans if p.bottleneck_s <= latency_target_s]
        if feasible:
            pick = min(feasible, key=lambda p: p.num_nodes)
            met = True
        else:
            met = False
    return {"plans": plans, "recommended": pick,
            "latency_target_s": latency_target_s, "target_met": met}
