"""Model partitioner: layer graph + cut points -> ordered StageSpecs.

The port of ``defer_tpu.partition.partitioner.partition`` and
``fuse_stages``.  Cut validity is checked against articulation analysis,
and partitioning is O(V+E) metadata slicing.  ``stage_specs_for_vertices``
(branched stage graphs) comes with ROADMAP item A10c.
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


def fuse_stages(stages: "list[StageSpec]", hop_tiers: "list[str]"
                ) -> "tuple[list[StageSpec], list[list[int]]]":
    """Collapse every ``device``-tier hop: adjacent stages that share a
    device run as one stage program instead of paying a frame, a dispatch
    and a copy per boundary.

    A stage is a contiguous graph slice, so fusing stages ``k`` and
    ``k+1`` is re-partitioning without the cut between them: the merged
    slice exports as one ``torch.export`` program, and the hop ceases to
    exist rather than being made cheap.

    ``hop_tiers`` has one entry per inter-stage hop (``len(stages) - 1``);
    every ``"device"`` entry fuses its two sides.  Returns
    ``(fused_stages, groups)``, where ``groups[j]`` lists the original
    stage indices merged into fused stage ``j`` — callers remap per-stage
    settings (hop codecs, delays) through it.
    """
    if len(hop_tiers) != len(stages) - 1:
        raise ValueError(f"{len(stages)} stages need {len(stages) - 1} "
                         f"hop tiers, got {len(hop_tiers)}")
    groups: list[list[int]] = [[0]]
    for k, tier in enumerate(hop_tiers):
        if tier == "device":
            groups[-1].append(k + 1)
        else:
            groups.append([k + 1])
    if len(groups) == len(stages):
        return list(stages), groups  # nothing to fuse
    keep = [stages[g[-1]].output_name for g in groups[:-1]]
    return partition(stages[0].graph, keep), groups
