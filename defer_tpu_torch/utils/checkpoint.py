"""Checkpoint save and restore for the port's parameters.

The port of ``defer_tpu.utils.checkpoint``.  ``.npz`` is the interchange
format, written in the JAX package's layout (conv kernels HWIO, through
:func:`~defer_tpu_torch.utils.convert.params_to_jax`) under the JAX
package's flat keys (``node/`` plus the ``/``-joined leaf path, e.g.
``block_0/qkv/w``), so each package loads the other's files.  ``.pt`` takes
the place of orbax: the port's own tensors (layout and dtype as they are)
under the same flat keys, read back with ``weights_only=True``.

Both loaders take the graph: its ``param_spec`` is the contract, and a
missing key, an extra key or a wrong shape raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..graph.ir import LayerGraph, flatten_tree, unflatten_tree
from .convert import jax_param_spec, params_from_jax, params_to_jax

_SEP = "/"


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to suffix-less paths; normalize so save and
    # load always agree on the on-disk name
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(params: dict[str, Any]) -> dict[str, Any]:
    """Flat ``node/leaf/path`` -> leaf map (the JAX package's keys)."""
    return {node + _SEP + path: leaf for node, sub in params.items()
            for path, leaf in flatten_tree(sub).items()}


def _check_keys(stored: dict, expected: dict) -> None:
    missing = set(expected) - set(stored)
    extra = set(stored) - set(expected)
    if missing or extra:
        raise ValueError(
            f"checkpoint mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")


def _unflatten(stored: dict, expected: dict) -> dict[str, Any]:
    """Shape-checked flat map -> nested parameters keyed by node."""
    _check_keys(stored, expected)
    by_node: dict[str, dict] = {}
    for key, spec in expected.items():
        arr = stored[key]
        if tuple(arr.shape) != spec.shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                f"model expects {spec.shape}")
        node, path = key.split(_SEP, 1)
        by_node.setdefault(node, {})[path] = arr
    return {node: unflatten_tree(flat) for node, flat in by_node.items()}


def save_params(path: str, params: dict[str, Any], graph: LayerGraph):
    """Save ``graph``'s parameters to ``<path>`` (npz, JAX layout)."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(params_to_jax(graph, params)))


def load_params(path: str, graph: LayerGraph) -> dict[str, Any]:
    """Restore parameters saved by :func:`save_params` (or by the JAX
    package's ``save_params``) as the port's parameters for ``graph``."""
    with np.load(_npz_path(path)) as data:
        stored = dict(data)
    nested = _unflatten(stored, _flatten(jax_param_spec(graph)))
    return params_from_jax(graph, nested)


def save_params_pt(path: str, params: dict[str, Any]):
    """Save the port's parameters as they are (layout and dtype) with
    ``torch.save``, under the npz format's flat keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in _flatten(params).items()},
               path)


def load_params_pt(path: str, graph: LayerGraph) -> dict[str, Any]:
    """Restore parameters saved by :func:`save_params_pt`, checked against
    ``graph``'s ``param_spec``."""
    stored = torch.load(path, map_location="cpu", weights_only=True)
    spec = {n.name: n.param_spec for n in graph.nodes.values()
            if n.param_spec}
    return _unflatten(stored, _flatten(spec))
