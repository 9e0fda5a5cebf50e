"""Weight carry-over from the JAX package, and placement on a device.

:func:`params_from_jax` is the one place where a layout differs between
the two packages: the JAX package's conv kernels are HWIO, the port's are
OIHW.  Every other leaf (Dense ``w [d, f]``, used as ``x @ w`` and never
turned into ``nn.Linear``'s ``[f, d]``; biases; BatchNorm statistics;
a transformer block's nested ``{"qkv": {"w", "b"}, ...}``) crosses
unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.ir import LayerGraph, flatten_tree, tree_map, unflatten_tree
from ..graph.ops import Conv2D


def params_from_jax(graph: LayerGraph, np_params: dict[str, Any]
                    ) -> dict[str, dict[str, Any]]:
    """The JAX package's parameters (nested dicts of numpy arrays keyed by
    node name, as ``defer_tpu``'s ``LayerGraph.init`` lays them out) -> the
    port's parameters for ``graph``, as CPU tensors in the same nesting.

    Raises ``ValueError`` when a node or leaf is missing or extra, or a
    leaf's shape does not match the port's graph.
    """
    expected = {n.name for n in graph.nodes.values() if n.param_spec}
    if set(np_params) != expected:
        raise ValueError(
            f"parameter nodes differ from graph {graph.name!r}: missing "
            f"{sorted(expected - set(np_params))[:5]}, extra "
            f"{sorted(set(np_params) - expected)[:5]}")
    out = {}
    for name, leaves in np_params.items():
        node = graph.nodes[name]
        if not isinstance(leaves, dict):
            raise ValueError(f"node {name!r}: parameters must be a dict")
        flat, spec = flatten_tree(leaves), flatten_tree(node.param_spec)
        if set(flat) != set(spec):
            raise ValueError(f"node {name!r}: leaves {sorted(flat)} != "
                             f"{sorted(spec)}")
        conv = isinstance(node.op, Conv2D)
        p = {}
        for path, v in flat.items():
            a = np.asarray(v)
            if conv and path == "w":
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if a.shape != spec[path].shape:
                raise ValueError(f"node {name!r} leaf {path!r}: shape "
                                 f"{a.shape} != {spec[path].shape}")
            p[path] = torch.from_numpy(np.array(a)).to(spec[path].dtype)
        out[name] = unflatten_tree(p)
    return out


def params_to_device(params: dict[str, Any], device: torch.device | str
                     ) -> dict[str, Any]:
    """Copy ``params`` (any nesting) to ``device``; 4-D (conv) weights
    become channels_last, the layout the ops feed cuDNN activations in."""
    return tree_map(
        lambda v: v.to(device, memory_format=torch.channels_last)
        if v.dim() == 4 else v.to(device), params)
