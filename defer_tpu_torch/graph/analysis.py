"""Graph analysis: cut-point discovery, cost model, auto-partitioning.

The port of the linear part of ``defer_tpu.graph.analysis``.  A node ``v``
is a valid cut iff *every* edge from the prefix (nodes up to and including
``v`` in topological order) into the suffix originates at ``v`` — exactly
one tensor crosses the boundary.  Invalid cuts fail loudly in the
partitioner.
"""

from __future__ import annotations

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


def node_flops(graph: LayerGraph, name: str) -> int:
    node = graph.nodes[name]
    in_specs = tuple(graph.out_spec(i) for i in node.inputs)
    return node.op.flops(in_specs, node.out_spec)


def total_flops(graph: LayerGraph) -> int:
    return sum(node_flops(graph, n) for n in graph.topo_order)


def auto_cut_points(graph: LayerGraph, num_stages: int,
                    costs: dict[str, float] | None = None, *,
                    objective: str = "quantile") -> list[str]:
    """Pick ``num_stages - 1`` valid cuts balancing per-stage cost:
    cumulative cost quantiles snapped to the nearest valid articulation
    point.

    ``costs`` maps node name -> per-node cost; default is the analytic
    FLOP model.  The comm-aware ``objective="bottleneck"`` solver is not
    ported yet (ROADMAP queue A11).
    """
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    if objective == "bottleneck":
        raise NotImplementedError(
            "objective='bottleneck' (the comm-aware planner) is not ported "
            "yet: ROADMAP queue A11")
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
