"""Weight carry-over from the JAX package, and placement on a device.

:func:`params_from_jax` is the one place where a layout differs between
the two packages: the JAX package's conv kernels are HWIO, the port's are
OIHW (a depthwise kernel ``[k, k, 1, c]`` becomes ``[c, 1, k, k]`` by the
same transpose).  Every other leaf (Dense ``w [d, f]``, used as ``x @ w``
and never turned into ``nn.Linear``'s ``[f, d]``; biases; BatchNorm
statistics; a transformer block's nested ``{"qkv": {"w", "b"}, ...}``;
MoE's stacked ``[e, d, h]`` experts) crosses unchanged.
:func:`params_to_jax` is its inverse, and :func:`jax_param_spec` gives the
JAX-layout shapes the checkpoint loaders check files against.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.ir import (LayerGraph, ShapeSpec, flatten_tree, tree_map,
                        unflatten_tree)
from ..graph.ops import Conv2D, DepthwiseConv2D


def _is_conv(node) -> bool:
    # DepthwiseConv2D is not a Conv2D subclass, in either package
    return isinstance(node.op, (Conv2D, DepthwiseConv2D))


def is_hwio_leaf(node, path: str) -> bool:
    """Whether ``node``'s leaf at ``/``-joined ``path`` is a conv kernel:
    the one leaf whose layout differs between the packages (JAX HWIO, the
    port OIHW)."""
    return _is_conv(node) and path == "w"


def hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    """A JAX conv kernel in the port's layout (a transposed view)."""
    return a.transpose(3, 2, 0, 1)


def oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    """A port conv kernel in the JAX layout (inverse of
    :func:`hwio_to_oihw`)."""
    return a.transpose(2, 3, 1, 0)


def jax_param_spec(graph: LayerGraph) -> dict[str, dict[str, Any]]:
    """``graph``'s parameter shapes as the JAX package lays them out:
    ``param_spec`` with conv kernels turned from OIHW back to HWIO (what
    ``jax.eval_shape(graph.init)`` gives in the JAX package)."""
    out = {}
    for node in graph.nodes.values():
        if not node.param_spec:
            continue
        flat = flatten_tree(node.param_spec)
        if _is_conv(node):
            w = flat["w"]
            o, i, h, k = w.shape
            flat["w"] = ShapeSpec((h, k, i, o), w.dtype)
        out[node.name] = unflatten_tree(flat)
    return out


def _checked_leaves(graph: LayerGraph, params: dict[str, Any]):
    """``(node, flat leaves, flat param_spec)`` per parametric node of
    ``graph``; raises ``ValueError`` when a node or leaf is missing or
    extra."""
    expected = {n.name for n in graph.nodes.values() if n.param_spec}
    if set(params) != expected:
        raise ValueError(
            f"parameter nodes differ from graph {graph.name!r}: missing "
            f"{sorted(expected - set(params))[:5]}, extra "
            f"{sorted(set(params) - expected)[:5]}")
    for name, leaves in params.items():
        node = graph.nodes[name]
        if not isinstance(leaves, dict):
            raise ValueError(f"node {name!r}: parameters must be a dict")
        flat, spec = flatten_tree(leaves), flatten_tree(node.param_spec)
        if set(flat) != set(spec):
            raise ValueError(f"node {name!r}: leaves {sorted(flat)} != "
                             f"{sorted(spec)}")
        yield node, flat, spec


def params_from_jax(graph: LayerGraph, np_params: dict[str, Any]
                    ) -> dict[str, dict[str, Any]]:
    """The JAX package's parameters (nested dicts of numpy arrays keyed by
    node name, as ``defer_tpu``'s ``LayerGraph.init`` lays them out) -> the
    port's parameters for ``graph``, as CPU tensors in the same nesting.

    Raises ``ValueError`` when a node or leaf is missing or extra, or a
    leaf's shape does not match the port's graph.
    """
    out = {}
    for node, flat, spec in _checked_leaves(graph, np_params):
        p = {}
        for path, v in flat.items():
            a = np.asarray(v)
            if is_hwio_leaf(node, path):
                a = hwio_to_oihw(a)
            if a.shape != spec[path].shape:
                raise ValueError(f"node {node.name!r} leaf {path!r}: shape "
                                 f"{a.shape} != {spec[path].shape}")
            p[path] = torch.from_numpy(np.array(a)).to(spec[path].dtype)
        out[node.name] = unflatten_tree(p)
    return out


def params_to_jax(graph: LayerGraph, params: dict[str, Any]
                  ) -> dict[str, dict[str, Any]]:
    """Inverse of :func:`params_from_jax`: the port's parameters for
    ``graph`` -> nested dicts of numpy arrays in the JAX package's layout
    (conv kernels HWIO).  bfloat16 leaves become float32 (exact; numpy has
    no bfloat16).  Raises ``ValueError`` as :func:`params_from_jax`."""
    out = {}
    for node, flat, spec in _checked_leaves(graph, params):
        p = {}
        for path, v in flat.items():
            if tuple(v.shape) != spec[path].shape:
                raise ValueError(f"node {node.name!r} leaf {path!r}: shape "
                                 f"{tuple(v.shape)} != {spec[path].shape}")
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            a = t.numpy()
            if is_hwio_leaf(node, path):
                a = oihw_to_hwio(a)
            p[path] = np.ascontiguousarray(a)
        out[node.name] = unflatten_tree(p)
    return out


def params_to_device(params: dict[str, Any], device: torch.device | str
                     ) -> dict[str, Any]:
    """Copy ``params`` (any nesting) to ``device``; 4-D (conv) weights
    become channels_last, the layout the ops feed cuDNN activations in."""
    return tree_map(
        lambda v: v.to(device, memory_format=torch.channels_last)
        if v.dim() == 4 else v.to(device), params)
