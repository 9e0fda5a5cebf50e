"""Graph/partition visualization: the port of ``defer_tpu.graph.viz``.

Graphviz DOT text and a column summary, dependency-free; given the same
graph, both strings equal the JAX package's.
"""

from __future__ import annotations

from .analysis import node_flops
from .ir import LayerGraph


def to_dot(graph: LayerGraph, stage_of: dict[str, int] | None = None) -> str:
    """Render the layer graph as Graphviz DOT; optional stage coloring."""
    palette = ["#a6cee3", "#b2df8a", "#fb9a99", "#fdbf6f", "#cab2d6",
               "#ffff99", "#1f78b4", "#33a02c", "#e31a1c", "#ff7f00"]
    lines = [f'digraph "{graph.name}" {{', "  rankdir=TB;",
             "  node [shape=box, style=filled, fillcolor=white];",
             f'  "{graph.input_name}" [fillcolor="#eeeeee"];']
    for name, node in graph.nodes.items():
        label = f"{name}\\n{type(node.op).__name__} {node.out_spec.shape}"
        color = ""
        if stage_of is not None and name in stage_of:
            color = f', fillcolor="{palette[stage_of[name] % len(palette)]}"'
        lines.append(f'  "{name}" [label="{label}"{color}];')
        for src in node.inputs:
            lines.append(f'  "{src}" -> "{name}";')
    lines.append("}")
    return "\n".join(lines)


def summary(graph: LayerGraph) -> str:
    """Keras-``model.summary()``-style table."""
    rows = [("node", "op", "inputs", "out_shape", "MFLOPs")]
    for name, node in graph.nodes.items():
        rows.append((name, type(node.op).__name__, ",".join(node.inputs),
                     str(node.out_spec.shape),
                     f"{node_flops(graph, name) / 1e6:.2f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    out = [f"LayerGraph {graph.name!r}  input={graph.input_spec.shape}"]
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)
