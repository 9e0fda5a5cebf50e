from .analysis import (auto_cut_points, max_activation_bytes,
                       max_activation_elems, node_flops, total_flops,
                       valid_cut_points)
from .ir import GraphBuilder, LayerGraph, LayerNode, Op, ShapeSpec

__all__ = ["auto_cut_points", "max_activation_bytes", "max_activation_elems",
           "node_flops", "total_flops", "valid_cut_points", "GraphBuilder",
           "LayerGraph", "LayerNode", "Op", "ShapeSpec"]
