"""Model partitioner: layer graph + cut points -> ordered StageSpecs.

The port of ``defer_tpu.partition.partitioner.partition``.  Cut validity
is checked against articulation analysis, and partitioning is O(V+E)
metadata slicing.
"""

from __future__ import annotations

from ..graph.analysis import auto_cut_points, valid_cut_points
from ..graph.ir import LayerGraph
from .stage import StageSpec


def partition(graph: LayerGraph, cut_points: list[str] | None = None,
              *, num_stages: int | None = None,
              costs: dict[str, float] | None = None,
              objective: str = "quantile") -> list[StageSpec]:
    """Split ``graph`` into ``len(cut_points)+1`` sequential stages.

    Either pass explicit ``cut_points`` (node names, in topological order)
    or ``num_stages`` for automatic cuts (``costs`` and ``objective`` go
    to :func:`~defer_tpu_torch.graph.analysis.auto_cut_points`).
    """
    if cut_points is None:
        if num_stages is None:
            raise ValueError("pass cut_points or num_stages")
        cut_points = auto_cut_points(graph, num_stages, costs=costs,
                                     objective=objective)
    elif costs is not None:
        raise ValueError("explicit cut_points leave nothing to balance: "
                         "drop costs or drop cut_points")

    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    valid = set(valid_cut_points(graph))
    for c in cut_points:
        if c not in graph.nodes:
            raise ValueError(f"cut point {c!r} is not a node of {graph.name!r}")
        if c not in valid:
            raise ValueError(
                f"cut point {c!r} is not a single-tensor cut: more than one "
                f"tensor crosses the boundary (valid cuts: {sorted(valid)})")
    if any(pos[a] >= pos[b] for a, b in zip(cut_points, cut_points[1:])):
        raise ValueError("cut_points must be in topological order and unique")

    bounds = [graph.input_name] + list(cut_points) + [graph.output_name]
    stages = []
    for s in range(len(cut_points) + 1):
        start, end = bounds[s], bounds[s + 1]
        lo = pos[start] + 1 if start != graph.input_name else 0
        hi = pos[end] + 1
        stages.append(StageSpec(
            index=s,
            name=f"{graph.name}/stage{s}",
            graph=graph,
            node_names=tuple(order[lo:hi]),
            input_name=start,
            output_name=end,
            in_spec=graph.out_spec(start),
            out_spec=graph.out_spec(end),
        ))
    return stages
