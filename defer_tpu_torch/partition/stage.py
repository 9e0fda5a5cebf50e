"""StageSpec: one pipeline stage = a contiguous slice of the layer graph.

The port of ``defer_tpu.partition.stage`` (``StageSpec`` and
``buffer_footprint``).  A StageSpec is pure metadata + a plain tensor
function; the engines wrap it in a :class:`StageModule` that holds the
stage's own parameters on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..graph.ir import LayerGraph, ShapeSpec, flatten_tree, unflatten_tree
from ..ops.quant import BLOCK
from ..utils.convert import params_to_device


def buffer_footprint(stages, *, microbatch: int = 1, itemsize: int = 4,
                     wire: str = "buffer") -> dict:
    """Homogeneous transfer-buffer geometry for a stage list.

    ``buf_elems`` (max stage boundary, padded to the int8 block size under
    ``wire="int8"``), ``hop_utilization`` (hop k = stage k's output), and
    ``bytes_per_hop`` (int8: 1 byte/value + one f32 scale per block).
    """
    buf = max([s.in_spec.size for s in stages]
              + [s.out_spec.size for s in stages])
    if wire == "int8":
        buf = -(-buf // BLOCK) * BLOCK
        hop_bytes = microbatch * (buf + 4 * (buf // BLOCK))
    else:
        hop_bytes = buf * microbatch * itemsize
    return {
        "buf_elems": buf,
        "hop_utilization": [s.out_spec.size / buf for s in stages],
        "bytes_per_hop": hop_bytes,
    }


@dataclasses.dataclass(frozen=True)
class StageSpec:
    index: int
    name: str
    graph: LayerGraph
    node_names: tuple[str, ...]   # topo-ordered nodes evaluated by this stage
    input_name: str               # upstream node (or graph input) feeding it
    output_name: str
    in_spec: ShapeSpec
    out_spec: ShapeSpec

    def fn(self, stage_params: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Batched forward for this stage."""
        return self.graph.apply(stage_params, x, start=self.input_name,
                                upto=self.output_name,
                                node_names=self.node_names)

    def select_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """Subset of the full parameters owned by this stage."""
        return {n: params[n] for n in self.node_names if n in params}

    def __repr__(self):
        return (f"StageSpec({self.index}: {self.input_name} -> "
                f"{self.output_name}, {len(self.node_names)} nodes, "
                f"in={self.in_spec.shape}, out={self.out_spec.shape})")


class StageModule(nn.Module):
    """One stage holding its own parameters on ``device``.

    Parameters are frozen ``nn.Parameter``s, one ``ParameterDict`` per
    node keyed by each leaf's ``/``-joined path (``"qkv/w"``;
    ``ParameterDict`` keys may not contain ``.``).  ``forward`` hands the
    stage function the nested dict the ops expect.  Conv weights are
    stored channels_last (``params_to_device``) so cuDNN reads them
    without a per-call relayout.
    """

    def __init__(self, stage: StageSpec, params: dict[str, Any],
                 device: torch.device):
        super().__init__()
        self.stage = stage
        self.nodes = nn.ModuleDict({
            name: nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False)
                for k, v in flatten_tree(leaves).items()})
            for name, leaves in params_to_device(
                stage.select_params(params), device).items()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {name: unflatten_tree(dict(pd.items()))
                  for name, pd in self.nodes.items()}
        return self.stage.fn(params, x)
