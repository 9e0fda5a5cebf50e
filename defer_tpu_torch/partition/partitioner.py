"""Model partitioner: layer graph + cut points -> ordered StageSpecs.

The port of ``defer_tpu.partition.partitioner``: ``partition``,
``stage_specs_for_vertices`` (the stages of a branched topology) and
``fuse_stages``.  Cut validity is checked against articulation analysis,
and partitioning is O(V+E) metadata slicing.
"""

from __future__ import annotations

from ..graph.analysis import auto_cut_points, valid_cut_points
from ..graph.ir import LayerGraph
from .stage import JoinStageSpec, StageSpec


def partition(graph: LayerGraph, cut_points: list[str] | None = None,
              *, num_stages: int | None = None,
              costs: dict[str, float] | None = None,
              objective: str = "quantile",
              cost_model=None) -> list[StageSpec]:
    """Split ``graph`` into ``len(cut_points)+1`` sequential stages.

    Either pass explicit ``cut_points`` (node names, in topological order)
    or ``num_stages`` for automatic cuts (``costs``, ``objective`` and
    ``cost_model`` go to
    :func:`~defer_tpu_torch.graph.analysis.auto_cut_points`).
    """
    if cut_points is None:
        if num_stages is None:
            raise ValueError("pass cut_points or num_stages")
        cut_points = auto_cut_points(graph, num_stages, costs=costs,
                                     objective=objective,
                                     cost_model=cost_model)
    elif costs is not None or cost_model is not None:
        raise ValueError("explicit cut_points leave nothing to balance: "
                         "drop costs/cost_model or drop cut_points")

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


def stage_specs_for_vertices(graph: LayerGraph, vertices) -> list:
    """One stage spec per :class:`~defer_tpu_torch.runtime.topology.TopoVertex`
    — the DAG partitioner.

    Where :func:`partition` slices the graph at a linear cut list, a
    topology names each vertex's node slice (branch bodies are not
    contiguous in the full graph's topological order), so this is a
    checked projection, not a search: every vertex becomes a
    :class:`StageSpec` (or a :class:`JoinStageSpec` when it merges P
    paths), and each must evaluate a closed slice — every node's inputs
    come from the vertex's own nodes or its seed tensors.
    """
    order = {n: i for i, n in enumerate(graph.topo_order)}
    specs = []
    for v in vertices:
        have = set(v.inputs) | set(v.nodes)
        for n in v.nodes:
            if n not in graph.nodes:
                raise ValueError(f"vertex {v.vid}: unknown node {n!r}")
            missing = [i for i in graph.nodes[n].inputs if i not in have]
            if missing:
                raise ValueError(
                    f"vertex {v.vid}: node {n!r} needs {missing} which "
                    f"neither the vertex slice nor its seed inputs "
                    f"{list(v.inputs)} provide")
        nodes = tuple(sorted(v.nodes, key=order.__getitem__))
        if not nodes or nodes[-1] != v.output:
            raise ValueError(f"vertex {v.vid}: output {v.output!r} must "
                             f"be the slice's final node")
        name = f"{graph.name}/{v.label}"
        if v.join >= 2:
            specs.append(JoinStageSpec(
                index=v.vid, name=name, graph=graph, node_names=nodes,
                input_names=tuple(v.inputs), output_name=v.output,
                in_specs=tuple(graph.out_spec(i) for i in v.inputs),
                out_spec=graph.out_spec(v.output)))
        else:
            specs.append(StageSpec(
                index=v.vid, name=name, graph=graph, node_names=nodes,
                input_name=v.inputs[0], output_name=v.output,
                in_spec=graph.out_spec(v.inputs[0]),
                out_spec=graph.out_spec(v.output)))
    return specs


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
