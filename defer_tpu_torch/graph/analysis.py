"""Graph analysis: cut-point discovery, cost model, auto-partitioning.

The port of ``defer_tpu.graph.analysis``.  A node ``v`` is a valid cut iff
*every* edge from the prefix (nodes up to and including ``v`` in
topological order) into the suffix originates at ``v`` — exactly one
tensor crosses the boundary.  Invalid cuts fail loudly in the
partitioner.  The branch structure below (fork/join regions and their
internal cuts) is what the DAG planner (``plan/dag.py``) places.
"""

from __future__ import annotations

import dataclasses

from .ir import LayerGraph


def valid_cut_points(graph: LayerGraph) -> list[str]:
    """Names of nodes whose output is the *only* tensor crossing the cut.

    Linear scan over the topological order: a cut after position ``i`` is
    valid iff no node earlier than ``i`` has a consumer later than ``i``.
    The graph output itself is excluded (cutting there yields an empty
    stage).
    """
    order = graph.topo_order
    pos = {name: i for i, name in enumerate(order)}
    pos[graph.input_name] = -1

    # Latest consumer position for every tensor (input + all nodes).
    last_use = {graph.input_name: -1}
    for name in order:
        last_use.setdefault(name, pos[name])
        for src in graph.nodes[name].inputs:
            last_use[src] = max(last_use[src], pos[name])

    cuts = []
    running_max = last_use[graph.input_name]
    for i, name in enumerate(order):
        if i > 0:
            running_max = max(running_max, last_use[order[i - 1]])
        # Edges from strictly-earlier nodes may not reach past position i.
        if running_max <= i and name != graph.output_name:
            cuts.append(name)
    return cuts


# -- branch structure (DAG-shaped pipelines) -------------------------------
#
# A linear cut can only split a branching model at its articulation
# points, so everything BETWEEN two articulations — the parallel
# branches of an inception block, the experts of a branched MoE layer —
# is an indivisible block to the chain runtime.  The structures below
# expose exactly that block structure: which articulation-to-
# articulation regions decompose into disjoint parallel branches, so the
# DAG planner (``plan/dag.py``) can place each branch on its own node(s)
# and a branched runtime can mirror the graph's shape instead of
# serializing it.


@dataclasses.dataclass(frozen=True)
class Branch:
    """One parallel branch of a :class:`BranchRegion`: a single-input
    (the region's fork tensor) single-output sub-DAG.  ``nodes`` is
    empty for a direct fork->join edge (a residual skip): the fork's
    tensor itself is that path's contribution to the join."""

    nodes: tuple[str, ...]   #: topo order; () = direct fork->join edge
    out: str                 #: the join input this branch feeds

    @property
    def empty(self) -> bool:
        return not self.nodes


@dataclasses.dataclass(frozen=True)
class BranchRegion:
    """A fork/join region of the DAG: every node strictly between the
    articulation point ``fork`` and the merge node ``join`` partitions
    into >= 2 disjoint parallel branches, one per ``join`` input (in the
    join op's input order — that order IS the runtime path order)."""

    fork: str                     #: articulation (or graph input)
    join: str                     #: the merge node (>= 2 inputs)
    branches: tuple[Branch, ...]  #: one per join input, in input order

    @property
    def width(self) -> int:
        return len(self.branches)

    @property
    def branch_nodes(self) -> tuple[str, ...]:
        return tuple(n for b in self.branches for n in b.nodes)


def branch_regions(graph: LayerGraph) -> list[BranchRegion]:
    """The graph's separable fork/join regions, in topological order.

    For every pair of consecutive articulation points ``(a, b)`` (graph
    input and output included) holding more than one node, the block is
    a region iff its final node ``b`` is a merge (>= 2 inputs) and the
    strictly-inner nodes partition into pairwise-disjoint ancestor sets,
    one per merge input (an input equal to ``a`` is an empty branch — a
    residual skip).  Non-separable blocks — a shared intermediate
    feeding two merge inputs, duplicate merge inputs, or a merge that is
    not the block's final node — are simply not regions: they stay
    indivisible to every planner, linear or DAG.
    """
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    pos[graph.input_name] = -1
    arts = ([graph.input_name] + valid_cut_points(graph)
            + [graph.output_name])
    regions: list[BranchRegion] = []
    for a, b in zip(arts, arts[1:]):
        block = order[pos[a] + 1: pos[b] + 1]
        if len(block) <= 1:
            continue
        join = block[-1]
        assert join == b
        jn = graph.nodes[join]
        if len(jn.inputs) < 2:
            continue
        inner = set(block[:-1])
        comps: list[tuple[str, ...]] = []
        claimed: set[str] = set()
        ok = True
        for inp in jn.inputs:
            if inp == a:
                if () in comps:
                    ok = False  # fork consumed twice: duplicate input
                    break
                comps.append(())  # residual skip: direct fork->join
                continue
            if inp not in inner:
                ok = False  # duplicate input, or reaches outside
                break
            # ancestor closure of this join input within the block
            comp: set[str] = set()
            stack = [inp]
            while stack:
                n = stack.pop()
                if n in comp:
                    continue
                comp.add(n)
                for p in graph.nodes[n].inputs:
                    if p in inner and p not in comp:
                        stack.append(p)
            if comp & claimed:
                ok = False  # shared intermediate: not separable
                break
            claimed |= comp
            comps.append(tuple(sorted(comp, key=pos.__getitem__)))
        if not ok or claimed != inner:
            continue
        regions.append(BranchRegion(
            fork=a, join=join,
            branches=tuple(Branch(nodes=c, out=c[-1] if c else a)
                           for c in comps)))
    return regions


def segment_cut_points(graph: LayerGraph, nodes, seed: str) -> list[str]:
    """Valid single-tensor cuts WITHIN an ordered node slice.

    ``nodes`` is a topologically ordered slice (a branch body, or a
    trunk segment) whose only external input is ``seed``'s tensor; a
    node ``v`` is a valid internal cut iff no earlier slice node (nor
    ``seed``) has a consumer after ``v`` inside the slice.  The slice's
    final node is excluded (cutting there is the slice's own outbound
    boundary, not an internal cut) — mirroring how
    :func:`valid_cut_points` excludes the graph output.
    """
    nodes = list(nodes)
    if len(nodes) <= 1:
        return []
    pos = {n: i for i, n in enumerate(nodes)}
    last_use = {seed: -1}
    for n in nodes:
        last_use.setdefault(n, pos[n])
        for src in graph.nodes[n].inputs:
            if src in pos or src == seed:
                last_use[src] = max(last_use.get(src, -1), pos[n])
    cuts = []
    running = last_use[seed]
    for i, n in enumerate(nodes[:-1]):
        if i > 0:
            running = max(running, last_use[nodes[i - 1]])
        if running <= i:
            cuts.append(n)
    return cuts


def dag_cut_points(graph: LayerGraph) -> list[str]:
    """Every cut point of the stage *graph*: the linear articulation
    cuts PLUS each separable branch's internal cuts — the namespace
    ``hop_tiers`` keys and DAG plans draw from (a branch-internal hop is
    a real deployable boundary once branches run as their own
    sub-pipelines)."""
    cuts = list(valid_cut_points(graph))
    seen = set(cuts)
    for r in branch_regions(graph):
        for br in r.branches:
            for c in segment_cut_points(graph, br.nodes, r.fork):
                if c not in seen:
                    seen.add(c)
                    cuts.append(c)
    order = {n: i for i, n in enumerate(graph.topo_order)}
    cuts.sort(key=order.__getitem__)
    return cuts


def linear_cut_shortage(graph: LayerGraph, num_stages: int) -> str | None:
    """Pre-validation for the linear planners: ``None`` when
    ``num_stages`` fits the graph's valid linear cuts, else a message
    that names the offending merge nodes — the branch regions whose
    bodies a linear cut cannot split — and points at the DAG planner.
    The CLI raises this instead of letting the request die deep in the
    DP with a bare cut-count error."""
    cuts = valid_cut_points(graph)
    if num_stages <= len(cuts) + 1:
        return None
    msg = (f"graph {graph.name!r} has only {len(cuts)} valid linear cut "
           f"points ({len(cuts) + 1} stages max); cannot make "
           f"{num_stages} stages.")
    regions = branch_regions(graph)
    if regions:
        locked = sum(len(r.branch_nodes) for r in regions)
        joins = [r.join for r in regions]
        shown = ",".join(joins[:6]) + ("..." if len(joins) > 6 else "")
        msg += (f"  {locked} of {len(graph.nodes)} nodes are locked "
                f"inside the parallel branches of {len(regions)} merge "
                f"node(s) [{shown}] — a linear cut cannot split a "
                f"branch body.  Use the DAG planner (`plan --dag`) to "
                f"run branches as concurrent sub-pipelines instead.")
    return msg


def node_flops(graph: LayerGraph, name: str) -> int:
    node = graph.nodes[name]
    in_specs = tuple(graph.out_spec(i) for i in node.inputs)
    return node.op.flops(in_specs, node.out_spec)


def total_flops(graph: LayerGraph) -> int:
    return sum(node_flops(graph, n) for n in graph.topo_order)


def auto_cut_points(graph: LayerGraph, num_stages: int,
                    costs: dict[str, float] | None = None, *,
                    objective: str = "quantile",
                    cost_model=None) -> list[str]:
    """Pick ``num_stages - 1`` valid cuts balancing per-stage cost:
    cumulative cost quantiles snapped to the nearest valid articulation
    point.

    ``costs`` maps node name -> per-node cost; default is the analytic
    FLOP model.  Pass measured per-node seconds (e.g. from
    ``utils.profiling.measured_node_costs``) to balance on what the card
    actually does.

    ``objective="bottleneck"`` delegates to the exact comm-aware solver
    (``defer_tpu_torch.plan``): it minimizes ``max_k max(compute_k,
    comm_k)`` instead of compute quantiles.  ``cost_model`` (a
    ``plan.StageCostModel``) sets the hardware and codec assumptions;
    otherwise an analytic model is built (using ``costs`` as measured
    node seconds when given).  The quantile greedy stays the default.
    """
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    if objective == "bottleneck":
        from ..plan import StageCostModel, solve
        if cost_model is None:
            cost_model = StageCostModel(graph, node_costs=costs)
        return solve(graph, num_stages, cost_model).cuts
    if objective != "quantile":
        raise ValueError(f"unknown objective {objective!r}; "
                         "use 'quantile' or 'bottleneck'")
    if num_stages == 1:
        return []
    cuts = valid_cut_points(graph)
    if len(cuts) < num_stages - 1:
        raise ValueError(
            f"graph {graph.name!r} has only {len(cuts)} valid cut points; "
            f"cannot make {num_stages} stages")

    order = graph.topo_order
    if costs is not None:
        missing = [n for n in order if n not in costs]
        if missing:
            raise ValueError(f"costs missing nodes: {missing[:5]}...")
    cum = {}
    acc = 0
    for name in order:
        acc += costs[name] if costs is not None else node_flops(graph, name)
        cum[name] = acc
    # guard ONLY exactly-zero totals (sub-1.0 measured-seconds sums are real)
    total = acc if acc > 0 else 1

    chosen: list[str] = []
    available = list(cuts)
    for j in range(1, num_stages):
        target = total * j / num_stages
        # nearest still-available cut by cumulative cost, keeping order and
        # leaving enough candidates for the later cuts
        remaining_after = num_stages - 1 - j
        cands = available[: len(available) - remaining_after]
        best = min(cands, key=lambda n: abs(cum[n] - target))
        chosen.append(best)
        available = available[available.index(best) + 1:]
    return chosen


def max_activation_elems(graph: LayerGraph, cut_points: list[str]) -> int:
    """Largest per-sample tensor crossing any stage boundary (incl. graph
    input/output) — sizes the pipeline's homogeneous transfer buffer."""
    sizes = [graph.input_spec.size, graph.output_spec.size]
    sizes += [graph.out_spec(c).size for c in cut_points]
    return max(sizes)


def max_activation_bytes(graph: LayerGraph, cut_points: list[str], *,
                         batch: int = 1) -> int:
    """Largest boundary tensor in BYTES (dtype itemsize included, times
    ``batch``)."""
    specs = [graph.input_spec, graph.output_spec]
    specs += [graph.out_spec(c) for c in cut_points]
    return max(s.size * s.dtype.itemsize for s in specs) * max(batch, 1)
