from .analysis import (auto_cut_points, max_activation_bytes,
                       max_activation_elems, node_flops, total_flops,
                       valid_cut_points)
from .ir import GraphBuilder, LayerGraph, LayerNode, Op, ShapeSpec
from .optimize import fold_batchnorm
from .viz import summary, to_dot

__all__ = ["auto_cut_points", "max_activation_bytes", "max_activation_elems",
           "node_flops", "total_flops", "valid_cut_points", "GraphBuilder",
           "LayerGraph", "LayerNode", "Op", "ShapeSpec", "fold_batchnorm",
           "summary", "to_dot"]
