"""Weight carry-over from the JAX package, and placement on a device.

:func:`params_from_jax` is the one place where a layout differs between
the two packages: the JAX package's conv kernels are HWIO, the port's are
OIHW.  Every other leaf (Dense ``w [d, f]``, biases, BatchNorm statistics)
crosses unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..graph.ir import LayerGraph
from ..graph.ops import Conv2D


def params_from_jax(graph: LayerGraph, np_params: dict[str, Any]
                    ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's parameters (numpy arrays keyed by node name, as
    ``defer_tpu``'s ``LayerGraph.init`` lays them out) -> the port's
    parameters for ``graph``, as CPU tensors.

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
        if set(leaves) != set(node.param_spec):
            raise ValueError(f"node {name!r}: leaves {sorted(leaves)} != "
                             f"{sorted(node.param_spec)}")
        conv = isinstance(node.op, Conv2D)
        p = {}
        for k, v in leaves.items():
            a = np.asarray(v)
            if conv and k == "w":
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            spec = node.param_spec[k]
            if a.shape != spec.shape:
                raise ValueError(f"node {name!r} leaf {k!r}: shape "
                                 f"{a.shape} != {spec.shape}")
            p[k] = torch.from_numpy(np.array(a)).to(spec.dtype)
        out[name] = p
    return out


def params_to_device(params: dict[str, dict[str, torch.Tensor]],
                     device: torch.device | str
                     ) -> dict[str, dict[str, torch.Tensor]]:
    """Copy ``params`` to ``device``; 4-D (conv) weights become
    channels_last, the layout the ops feed cuDNN activations in."""
    out = {}
    for name, leaves in params.items():
        out[name] = {
            k: v.to(device, memory_format=torch.channels_last)
            if v.dim() == 4 else v.to(device)
            for k, v in leaves.items()}
    return out
