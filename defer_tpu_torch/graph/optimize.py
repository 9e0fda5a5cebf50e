"""Graph optimization passes: the port of ``defer_tpu.graph.optimize``.

**BatchNorm folding** — inference-mode batch norm is an affine map per
channel, so it folds exactly into the preceding convolution's weights and
bias, removing the op (and its passes over the activation) from every
stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .ir import LayerGraph, LayerNode, ShapeSpec, tree_map
from .ops import BatchNorm, Conv2D, DepthwiseConv2D


def _consumers(graph: LayerGraph, name: str) -> list[str]:
    return [n.name for n in graph.nodes.values() if name in n.inputs]


def _f64(t) -> np.ndarray:
    return torch.as_tensor(t).detach().to("cpu", torch.float64).numpy()


def fold_batchnorm(graph: LayerGraph, params: dict[str, Any]
                   ) -> tuple[LayerGraph, dict[str, Any], int]:
    """Fold inference BatchNorm into the preceding (depthwise) conv.

    For every ``conv -> bn`` pair where the conv output feeds ONLY the bn
    (and is not the graph output), rewrites

        bn(conv(x)) == conv'(x),  w' = w * g/sqrt(v+eps),
                                  b' = (b - mean) * g/sqrt(v+eps) + beta

    in float64, cast to float32 (the JAX package's arithmetic, so the
    folded leaves are bit-equal to its fold carried over), drops the bn
    node, and rewires its consumers.  The port's kernels are OIHW (and
    ``[c, 1, k, k]`` depthwise): the out-channel axis is the FIRST, where
    the JAX package's HWIO puts it last.  Returns ``(new_graph,
    new_params, folded_count)`` — ``graph, params, 0`` themselves when
    nothing folds; the inputs are left untouched.  Folded leaves land on
    the conv weight's device.
    """
    nodes = dict(graph.nodes)
    new_params = dict(params)
    rename: dict[str, str] = {}  # bn name -> conv name
    folded = 0

    for bn_name, bn_node in graph.nodes.items():
        if not isinstance(bn_node.op, BatchNorm):
            continue
        (src,) = bn_node.inputs
        conv_node = nodes.get(src)
        if conv_node is None:  # graph input feeds the bn
            continue
        if not isinstance(conv_node.op, (Conv2D, DepthwiseConv2D)):
            continue
        if len(_consumers(graph, src)) != 1 or graph.output_name == src:
            continue

        bnp = params[bn_name]
        inv = _f64(bnp["scale"]) / np.sqrt(_f64(bnp["var"]) + bn_node.op.eps)
        cp = dict(params[src])
        device = torch.as_tensor(cp["w"]).device
        w = _f64(cp["w"])
        b = _f64(cp["b"]) if "b" in cp else np.zeros(w.shape[0])
        # out-channel axis first (OIHW), not last as in HWIO
        cp["w"] = torch.from_numpy(
            (w * inv.reshape(-1, 1, 1, 1)).astype(np.float32)).to(device)
        cp["b"] = torch.from_numpy(
            ((b - _f64(bnp["mean"])) * inv + _f64(bnp["bias"]))
            .astype(np.float32)).to(device)

        op = dataclasses.replace(conv_node.op, use_bias=True)
        param_spec = tree_map(lambda t: ShapeSpec(t.shape, t.dtype), cp)
        nodes[src] = LayerNode(src, op, conv_node.inputs,
                               conv_node.out_spec, param_spec)
        new_params[src] = cp
        del nodes[bn_name]
        new_params.pop(bn_name, None)
        rename[bn_name] = src
        folded += 1

    if not folded:
        return graph, params, 0

    # rewire consumers of removed bn nodes (chase chains of renames)
    def resolve(name: str) -> str:
        while name in rename:
            name = rename[name]
        return name

    rewired = {}
    for name, node in nodes.items():
        inputs = tuple(resolve(i) for i in node.inputs)
        if inputs != node.inputs:
            node = LayerNode(name, node.op, inputs, node.out_spec,
                             node.param_spec)
        rewired[name] = node

    out = LayerGraph(graph.name + "+bnfold", rewired, graph.input_name,
                     resolve(graph.output_name), graph.input_spec)
    return out, new_params, folded
