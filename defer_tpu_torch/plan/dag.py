"""Critical-path-aware planner for DAG-shaped (branch-parallel) pipelines.

The port of ``defer_tpu.plan.dag``: the planner, its JSON and its
topology document, which ``runtime/topology.py`` reads and
``runtime.node.run_dag_chain`` deploys.

The chain solver (``plan/solver.py``) can only cut a branching model at
its articulation points, so everything between two articulations — an
inception block's parallel branches, a branched MoE layer's experts —
lands inside ONE stage, serialized.  "The TensorFlow Partitioning and
Scheduling Problem: It's the Critical Path!" (PAPERS.md) makes the
argument this module implements: for a branching graph the right plan
shape mirrors the graph — parallel branches become concurrent stages —
and the right accounting follows the stage GRAPH, not a flattened chain.

The solved :class:`DagPlan` is a stage graph (``topology`` in its JSON,
the schema ``runtime/topology.py`` deploys, as the JAX package's does):

* each trunk run of nodes is a chain of stages, cut by the same
  bottleneck DP as the linear solver;
* each parallelized fork/join region (``graph.analysis.branch_regions``)
  becomes: a broadcast hop out of the fork stage, one concurrent
  sub-chain per branch (cut independently at the branch's own internal
  cut points), and a join stage that merges all P paths and runs the
  graph's merge op;
* per-stage cost stays ``max(compute, comm)``; the plan reports BOTH
  graph-level aggregates: ``bottleneck_s`` — the max over stage
  vertices, the steady-state period of the pipelined stream — and
  ``critical_path_s`` — the longest root-to-sink path through the
  stage graph, the per-sample latency.  Branch-parallelism shrinks
  both: the region's vertices each hold one branch instead of the sum
  of all of them.

The solver enumerates which regions to parallelize (linear stays the
fallback whenever the node budget is tight or branching never pays),
then allocates the node budget across the independent chain components
(trunk segments and branches) by bisecting the bottleneck over the
per-component DP tables — cuts are chosen per branch independently,
exactly as the independence structure allows.  Objective order:
minimize the bottleneck, tie-break on the critical path, then on node
count.  ``brute_force_dag`` is the exhaustive oracle the property
tests cross-check.
"""

from __future__ import annotations

import dataclasses
import itertools

from ..graph.analysis import (BranchRegion, branch_regions,
                              dag_cut_points, segment_cut_points,
                              valid_cut_points)
from ..graph.ir import LayerGraph
from .cost import TIER_CODECS, StageCostModel
from .solver import _solve_dp

#: the JAX package's ``runtime.topology.TOPOLOGY_FORMAT``: a plan's
#: topology document is the same in both packages
TOPOLOGY_FORMAT = "defer_tpu.topology.v1"

_EPS = 1e-12


@dataclasses.dataclass
class DagVertex:
    """One stage vertex of a solved stage graph, with its predictions."""

    vid: int
    nodes: tuple[str, ...]
    inputs: tuple[str, ...]
    output: str
    next: tuple[int, ...]
    fan: str = "unicast"          #: "unicast" | "broadcast"
    join: int = 0                 #: >= 2: merges that many paths
    branch: int | None = None     #: path index inside its region
    codec: str = "raw"            #: outbound hop codec ("-" on the exit)
    compute_s: float = 0.0
    comm_s: float = 0.0           #: outbound hop seconds

    @property
    def cost_s(self) -> float:
        return max(self.compute_s, self.comm_s)

    @property
    def label(self) -> str:
        base = f"stage{self.vid}"
        return base if self.branch is None else f"{base}.b{self.branch}"


@dataclasses.dataclass
class DagPlan:
    """A solved branch-parallel stage graph with its predictions."""

    graph_name: str
    vertices: list[DagVertex]
    objective: str
    cost: dict
    parallel_regions: list[dict]   #: [{"fork", "join", "paths"}]

    @property
    def num_stages(self) -> int:
        return len(self.vertices)

    @property
    def num_nodes(self) -> int:
        return len(self.vertices)

    @property
    def bottleneck_s(self) -> float:
        return max(v.cost_s for v in self.vertices)

    @property
    def bottleneck_vertex(self) -> int:
        costs = [v.cost_s for v in self.vertices]
        return costs.index(max(costs))

    @property
    def critical_path_s(self) -> float:
        """Longest root-to-sink path through the stage graph (per-sample
        latency); on a pure chain this is simply the sum of stage
        costs."""
        cp: dict[int, float] = {}
        for v in reversed(self.vertices):
            nxt = max((cp[n] for n in v.next), default=0.0)
            cp[v.vid] = v.cost_s + nxt
        return cp[self.vertices[0].vid] if self.vertices else 0.0

    def predicted_throughput_per_s(self, batch: int = 1) -> float:
        b = self.bottleneck_s
        return batch / b if b > 0 else 0.0

    def topology_json(self) -> dict:
        return {"format": TOPOLOGY_FORMAT,
                "vertices": [{
                    "id": v.vid, "nodes": list(v.nodes),
                    "inputs": list(v.inputs), "output": v.output,
                    "next": list(v.next), "fan": v.fan, "join": v.join,
                    "branch": v.branch,
                    "codec": v.codec if v.codec != "-" else "raw",
                } for v in self.vertices]}

    def to_json(self) -> dict:
        return {
            "graph": self.graph_name,
            "objective": self.objective,
            "num_stages": self.num_stages,
            "num_nodes": self.num_nodes,
            "labels": [v.label for v in self.vertices],
            "stage_compute_ms": [round(v.compute_s * 1e3, 6)
                                 for v in self.vertices],
            "hop_comm_ms": [round(v.comm_s * 1e3, 6)
                            for v in self.vertices],
            "stage_cost_ms": [round(v.cost_s * 1e3, 6)
                              for v in self.vertices],
            "hop_codecs": [v.codec for v in self.vertices],
            "bottleneck_ms": round(self.bottleneck_s * 1e3, 6),
            "bottleneck_stage": self.bottleneck_vertex,
            "critical_path_ms": round(self.critical_path_s * 1e3, 6),
            "parallel_regions": list(self.parallel_regions),
            "topology": self.topology_json(),
            "cost_model": self.cost,
        }


def dag_plan_from_json(doc: dict) -> DagPlan:
    """Rebuild a :class:`DagPlan` from ``to_json`` output (accepts a
    whole ``plan --dag --json`` document)."""
    doc = doc.get("dag_plan", doc.get("plan", doc))
    topo = doc["topology"]
    comp = [v / 1e3 for v in doc["stage_compute_ms"]]
    comm = [v / 1e3 for v in doc["hop_comm_ms"]]
    vs = []
    for d, c, h, codec in zip(topo["vertices"], comp, comm,
                              doc.get("hop_codecs")
                              or [v.get("codec", "raw")
                                  for v in topo["vertices"]]):
        vs.append(DagVertex(
            vid=int(d["id"]), nodes=tuple(d["nodes"]),
            inputs=tuple(d["inputs"]), output=d["output"],
            next=tuple(d["next"]), fan=d.get("fan", "unicast"),
            join=int(d.get("join", 0)),
            branch=None if d.get("branch") is None else int(d["branch"]),
            codec=codec, compute_s=c, comm_s=h))
    return DagPlan(graph_name=doc.get("graph", ""), vertices=vs,
                   objective=doc.get("objective", "critical_path"),
                   cost=doc.get("cost_model", {}),
                   parallel_regions=list(doc.get("parallel_regions", [])))


# -- component machinery -----------------------------------------------------


@dataclasses.dataclass
class _Component:
    """One independently-cuttable chain of the stage graph: a trunk
    segment (between forced fork cuts) or a branch body."""

    kind: str                   #: "trunk" | "branch"
    nodes: list[str]
    cuts: list[str]             #: internal cut candidates, topo order
    edge_comm: float            #: fixed outbound-hop seconds (final stage)
    edge_codec: str
    region: BranchRegion | None = None
    path: int | None = None     #: branch path index
    # tables (filled by _build_tables)
    cum: list[float] = dataclasses.field(default_factory=list)
    total: float = 0.0
    comm: list[float] = dataclasses.field(default_factory=list)
    codec_of: list[str] = dataclasses.field(default_factory=list)

    @property
    def max_stages(self) -> int:
        return len(self.cuts) + 1

    def partition(self, m: int) -> tuple[list[int], float]:
        """(chosen cut indices, bottleneck incl. the fixed edge hop)
        for exactly ``m`` stages."""
        if m == 1:
            return [], max(self.total, self.edge_comm)
        chosen = _solve_dp(self.cum, self.total, self.comm, m)
        return chosen, self.evaluate(chosen)

    def evaluate(self, chosen: list[int]) -> float:
        bounds = [0.0] + [self.cum[i] for i in chosen] + [self.total]
        segs = [bounds[k + 1] - bounds[k] for k in range(len(chosen) + 1)]
        worst = max(max(s, 0.0) for s in segs)
        for k, i in enumerate(chosen):
            worst = max(worst, self.comm[i])
        return max(worst, self.edge_comm)


def _fork_comm(cost: StageCostModel, fork: str, paths: int
               ) -> tuple[str, float]:
    """Cheapest (codec, seconds) for the broadcast hop out of a fork:
    the P copies encode on P parallel channel threads and decode on P
    branch processes, but the WIRE serializes at the fork's endpoint —
    ``enc + P*wire + dec``."""
    best_name, best = None, float("inf")
    for n in cost.codecs:
        enc, wire, dec = cost.comm_parts(fork, n)
        s = enc + paths * wire + dec
        if s < best:
            best_name, best = n, s
    return best_name, best


def _validate_dag_tiers(graph: LayerGraph, hop_tiers: dict | None,
                        regions: list[BranchRegion]) -> None:
    """Stage-graph hop-tier policy: keys must name stage-graph cut
    points (checked by ``with_hop_tiers(valid_cuts=...)``), and a
    colocated (local/device) claim may not touch a fan boundary — a
    region's fork (the broadcast) or a branch output (a labeled join
    path): the ordered branch machinery is wire-framed by design, same
    rule the linear runtime applies to replicated hops."""
    if not hop_tiers:
        return
    fan_cuts = {}
    for r in regions:
        fan_cuts.setdefault(r.fork, f"fork of the {r.join} region")
        for b in r.branches:
            if not b.empty:
                fan_cuts.setdefault(
                    b.out, f"branch output into the {r.join} join")
    for cut, tier in hop_tiers.items():
        if tier in TIER_CODECS and cut in fan_cuts:
            raise ValueError(
                f"hop_tiers[{cut!r}] = {tier!r}, but that cut is the "
                f"{fan_cuts[cut]}: branch fan-out/join hops are "
                f"wire-framed by design and cannot be colocated (drop "
                f"the tier claim or plan without --dag)")


def _components_for(graph: LayerGraph, cost: StageCostModel,
                    node_s: dict[str, float],
                    chosen: list[BranchRegion]) -> list[_Component]:
    """The independent chain components of one topology candidate:
    trunk segments split at each chosen region's fork, plus every
    non-empty branch of the chosen regions."""
    branch_of = {}
    for r in chosen:
        for n in r.branch_nodes:
            branch_of[n] = r
    forks = {r.fork for r in chosen}
    linear_valid = set(valid_cut_points(graph))

    trunk = [n for n in graph.topo_order if n not in branch_of]
    segments: list[list[str]] = [[]]
    for n in trunk:
        segments[-1].append(n)
        if n in forks:
            segments.append([])
    if not segments[-1]:
        raise ValueError("internal: fork with no following trunk node")

    comps: list[_Component] = []
    by_fork = {r.fork: r for r in chosen}
    for i, seg in enumerate(segments):
        last = seg[-1]
        if last in by_fork:
            r = by_fork[last]
            codec, comm = _fork_comm(cost, r.fork, r.width)
        elif i == len(segments) - 1:
            codec, comm = "-", 0.0  # result hop: cut-independent
        else:
            raise AssertionError("trunk segment ends mid-graph")
        comps.append(_Component(
            kind="trunk", nodes=seg,
            cuts=[n for n in seg[:-1] if n in linear_valid],
            edge_comm=comm, edge_codec=codec))
        if last in by_fork:
            r = by_fork[last]
            for p, br in enumerate(r.branches):
                if br.empty:
                    continue
                codec, comm = cost.best_codec(br.out)
                comps.append(_Component(
                    kind="branch", nodes=list(br.nodes),
                    cuts=segment_cut_points(graph, br.nodes, r.fork),
                    edge_comm=comm, edge_codec=codec,
                    region=r, path=p))

    for c in comps:
        acc = 0.0
        cum_at = {}
        for n in c.nodes:
            acc += node_s[n]
            cum_at[n] = acc
        c.total = acc
        c.cum = [cum_at[x] for x in c.cuts]
        c.comm, c.codec_of = [], []
        for x in c.cuts:
            name, s = cost.best_codec(x)
            c.comm.append(s)
            c.codec_of.append(name)
    return comps


def _allocate(comps: list[_Component], num_nodes: int
              ) -> list[int] | None:
    """Stage counts per component minimizing the global bottleneck
    within the node budget: bisect over the union of per-component DP
    values; for a candidate bottleneck each component needs its
    SMALLEST stage count achieving it.  None when even one stage per
    component exceeds the budget."""
    if len(comps) > num_nodes:
        return None
    tables = []
    for c in comps:
        hi = min(c.max_stages, num_nodes - (len(comps) - 1))
        tables.append([c.partition(m)[1] for m in range(1, hi + 1)])
    cands = sorted({v for t in tables for v in t})

    def needs(limit: float) -> list[int] | None:
        out = []
        for t in tables:
            m = next((i + 1 for i, v in enumerate(t)
                      if v <= limit * (1 + _EPS) + _EPS), None)
            if m is None:
                return None
            out.append(m)
        return out if sum(out) <= num_nodes else None

    lo, hi = 0, len(cands) - 1
    best: list[int] | None = None
    while lo <= hi:
        mid = (lo + hi) // 2
        got = needs(cands[mid])
        if got is not None:
            best = got
            hi = mid - 1
        else:
            lo = mid + 1
    return best


def _assemble(graph: LayerGraph, cost: StageCostModel,
              node_s: dict[str, float], chosen: list[BranchRegion],
              comps: list[_Component], cuts_by_comp: list[list[int]],
              objective: str) -> DagPlan:
    """Materialize the stage-graph vertices for one topology candidate
    (component list + chosen cut indices per component) — shared by the
    DP solver and the brute-force oracle so both score identically."""
    by_fork = {r.fork: r for r in chosen}
    # group components back into spine order: trunk segments with their
    # regions' branch components attached
    plan_vertices: list[DagVertex] = []
    vid = 0

    def stage_slices(c: _Component, chosen_idx: list[int]):
        pos = {n: i for i, n in enumerate(c.nodes)}
        cut_pos = [pos[c.cuts[i]] for i in chosen_idx]
        bounds = [-1] + cut_pos + [len(c.nodes) - 1]
        out = []
        for k in range(len(cut_pos) + 1):
            lo, hi = bounds[k] + 1, bounds[k + 1] + 1
            out.append(c.nodes[lo:hi])
        return out

    def vertex_costs(c: _Component, chosen_idx: list[int]):
        bounds = [0.0] + [c.cum[i] for i in chosen_idx] + [c.total]
        comp_s = [bounds[k + 1] - bounds[k]
                  for k in range(len(chosen_idx) + 1)]
        comm_s = [c.comm[i] for i in chosen_idx] + [c.edge_comm]
        codecs = [c.codec_of[i] for i in chosen_idx] + [c.edge_codec]
        return comp_s, comm_s, codecs

    trunk_comps = [(i, c) for i, c in enumerate(comps)
                   if c.kind == "trunk"]
    branch_comps = {}
    for i, c in enumerate(comps):
        if c.kind == "branch":
            branch_comps.setdefault(id(c.region), {})[c.path] = (i, c)

    pending_join: BranchRegion | None = None
    for seg_no, (ci, c) in enumerate(trunk_comps):
        slices = stage_slices(c, cuts_by_comp[ci])
        comp_s, comm_s, codecs = vertex_costs(c, cuts_by_comp[ci])
        n_stages = len(slices)
        for k, sl in enumerate(slices):
            is_first = k == 0
            is_last = k == n_stages - 1
            join_of = pending_join if is_first else None
            if is_first and pending_join is not None:
                inputs = tuple(graph.nodes[pending_join.join].inputs)
                join_n = pending_join.width
                pending_join = None
            else:
                inputs = ((graph.input_name,) if vid == 0
                          else (plan_vertices[-1].output,))
                join_n = 0
            if is_first and join_of is not None:
                # seed order sanity: slice starts at the join node
                assert sl[0] == join_of.join
            fork_r = by_fork.get(sl[-1]) if is_last else None
            plan_vertices.append(DagVertex(
                vid=vid, nodes=tuple(sl), inputs=inputs,
                output=sl[-1], next=(),
                fan="broadcast" if fork_r is not None else "unicast",
                join=join_n if join_n >= 2 else 0,
                codec=codecs[k], compute_s=comp_s[k], comm_s=comm_s[k]))
            prev_vid = vid
            vid += 1
            if not is_last:
                plan_vertices[prev_vid].next = (vid,)
        if c.nodes[-1] in by_fork:
            r = by_fork[c.nodes[-1]]
            fork_vid = vid - 1
            # lay out each branch's sub-chain in path order; empty
            # branches wire the fork straight to the (future) join
            heads: list[int | None] = []
            per_branch = branch_comps.get(id(r), {})
            bvid = vid
            for p, br in enumerate(r.branches):
                if br.empty:
                    heads.append(None)
                    continue
                bi, bc = per_branch[p]
                b_slices = stage_slices(bc, cuts_by_comp[bi])
                b_comp, b_comm, b_codecs = vertex_costs(
                    bc, cuts_by_comp[bi])
                heads.append(bvid)
                for k, sl in enumerate(b_slices):
                    inputs = ((r.fork,) if k == 0
                              else (plan_vertices[-1].output,))
                    plan_vertices.append(DagVertex(
                        vid=bvid, nodes=tuple(sl), inputs=inputs,
                        output=sl[-1], next=(),
                        branch=p, codec=b_codecs[k],
                        compute_s=b_comp[k], comm_s=b_comm[k]))
                    if k > 0:
                        plan_vertices[bvid - 1].next = (bvid,)
                    bvid += 1
            join_vid = bvid
            vid = bvid
            # wire fork -> heads (empty branch -> join) and branch
            # tails -> join
            nxt = []
            for p, h in enumerate(heads):
                nxt.append(join_vid if h is None else h)
            plan_vertices[fork_vid].next = tuple(nxt)
            for p, h in enumerate(heads):
                if h is None:
                    continue
                tail = h
                while plan_vertices[tail].next:
                    tail = plan_vertices[tail].next[0]
                plan_vertices[tail].next = (join_vid,)
            pending_join = r

    plan = DagPlan(
        graph_name=graph.name, vertices=plan_vertices,
        objective=objective, cost=cost.describe(),
        parallel_regions=[{"fork": r.fork, "join": r.join,
                           "paths": r.width} for r in chosen])
    return plan


def _region_subsets(regions: list[BranchRegion], max_subsets: int):
    r = len(regions)
    if 2 ** r <= max_subsets:
        yield from itertools.product((False, True), repeat=r)
        return
    # too many regions to enumerate: free bits for the costliest ones
    # (by serialized branch work), the rest stay inline
    free = max(1, max_subsets.bit_length() - 1)
    order = sorted(range(r),
                   key=lambda i: -sum(len(b.nodes)
                                      for b in regions[i].branches))
    hot = set(order[:free])
    for bits in itertools.product((False, True), repeat=len(hot)):
        flags = [False] * r
        for i, b in zip(sorted(hot), bits):
            flags[i] = b
        yield tuple(flags)


def best_linear_plan(graph: LayerGraph, cost: StageCostModel,
                     num_nodes: int):
    """Best cuts-only chain plan within a node budget — the comparison
    baseline every DAG plan must beat (docs/PLANNER.md)."""
    from .solver import solve
    max_s = min(num_nodes, len(valid_cut_points(graph)) + 1)
    return min((solve(graph, s, cost) for s in range(1, max_s + 1)),
               key=lambda p: p.bottleneck_s)


def solve_dag(graph: LayerGraph, cost: StageCostModel, *,
              num_nodes: int, hop_tiers: dict[str, str] | None = None,
              max_subsets: int = 4096) -> DagPlan:
    """Best branch-parallel stage graph for a budget of ``num_nodes``
    processes (see module docstring).  Regions whose fork is the graph
    input stay inline — the dispatcher feeds exactly one entry stage.
    A graph with no separable regions (or a budget too tight to fan)
    degenerates to the linear chain plan, topology included."""
    if num_nodes < 1:
        raise ValueError("num_nodes must be >= 1")
    regions = [r for r in branch_regions(graph)
               if r.fork != graph.input_name]
    _validate_dag_tiers(graph, hop_tiers, regions)
    if hop_tiers is not None:
        # key namespace: every stage-graph cut plus the branch-output
        # boundaries (real deployable hops into a join; the wire-framed
        # check above already rejected non-tcp tiers on them)
        valid = list(dag_cut_points(graph)) + [
            b.out for r in regions for b in r.branches if not b.empty]
        cost = cost.with_hop_tiers(hop_tiers, valid_cuts=valid)
    node_s = {n: cost.node_seconds(n) for n in graph.topo_order}

    best: DagPlan | None = None
    best_key = None
    for flags in _region_subsets(regions, max_subsets):
        chosen = [r for r, f in zip(regions, flags) if f]
        min_nodes = (1 + len(chosen)
                     + sum(sum(1 for b in r.branches if not b.empty)
                           for r in chosen))
        if min_nodes > num_nodes:
            continue
        comps = _components_for(graph, cost, node_s, chosen)
        alloc = _allocate(comps, num_nodes)
        if alloc is None:
            continue
        cuts_by_comp = [c.partition(m)[0] for c, m in zip(comps, alloc)]
        plan = _assemble(graph, cost, node_s, chosen, comps,
                         cuts_by_comp, "critical_path")
        key = (round(plan.bottleneck_s, 12),
               round(plan.critical_path_s, 12), plan.num_nodes)
        if best_key is None or key < best_key:
            best, best_key = plan, key
    assert best is not None  # the empty subset with 1 node always fits
    return best


def brute_force_dag(graph: LayerGraph, cost: StageCostModel, *,
                    num_nodes: int) -> DagPlan:
    """Exhaustive region-subset x per-component cut enumeration (test
    oracle for :func:`solve_dag`; keep the graph under ~10 stage-graph
    cuts and the budget under ~6)."""
    regions = [r for r in branch_regions(graph)
               if r.fork != graph.input_name]
    node_s = {n: cost.node_seconds(n) for n in graph.topo_order}
    best: DagPlan | None = None
    best_key = None
    for flags in itertools.product((False, True), repeat=len(regions)):
        chosen = [r for r, f in zip(regions, flags) if f]
        comps = _components_for(graph, cost, node_s, chosen)
        if len(comps) > num_nodes:
            continue
        spare = num_nodes - len(comps)
        choice_sets = []
        for c in comps:
            opts = []
            for k in range(0, min(len(c.cuts), spare) + 1):
                opts.extend(list(x)
                            for x in itertools.combinations(
                                range(len(c.cuts)), k))
            choice_sets.append(opts)
        for combo in itertools.product(*choice_sets):
            if sum(len(x) + 1 for x in combo) > num_nodes:
                continue
            plan = _assemble(graph, cost, node_s, chosen, comps,
                             [list(x) for x in combo], "brute_force_dag")
            key = (round(plan.bottleneck_s, 12),
                   round(plan.critical_path_s, 12), plan.num_nodes)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    assert best is not None
    return best
