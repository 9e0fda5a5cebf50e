"""MobileNetV2 on the layer-graph IR: the port of
``defer_tpu.models.mobilenet``.

BASELINE.md config 4: 2 partitions — a small model, the communication-bound
regime.  Inverted-residual bottlenecks with depthwise convs and ReLU6;
residual adds are named ``add_k`` (node for node as in the JAX package),
so block boundaries are the natural cut points.
"""

from __future__ import annotations

import torch

from ..graph.ir import GraphBuilder, LayerGraph
from ..graph.ops import (Activation, Add, BatchNorm, Conv2D, Dense,
                         DepthwiseConv2D, GlobalAvgPool)


def _cbr6(b, x, feats, kernel, stride=1):
    # symmetric k//2 padding: torch's convention (== SAME at stride 1,
    # differs from XLA SAME at stride 2) so torchvision weights reproduce
    x = b.add(Conv2D(feats, kernel, stride, (kernel // 2, kernel // 2),
                     use_bias=False), x)
    x = b.add(BatchNorm(), x)
    return b.add(Activation("relu6"), x)


def _inverted_residual(b: GraphBuilder, x: str, in_ch: int, out_ch: int,
                       stride: int, expand: int, add_idx: list[int]) -> str:
    inp = x
    if expand != 1:
        x = _cbr6(b, x, in_ch * expand, 1)
    x = b.add(DepthwiseConv2D(3, stride, (1, 1)), x)
    x = b.add(BatchNorm(), x)
    x = b.add(Activation("relu6"), x)
    x = b.add(Conv2D(out_ch, 1, use_bias=False), x)
    x = b.add(BatchNorm(), x)
    if stride == 1 and in_ch == out_ch:
        name = "add" if add_idx[0] == 0 else f"add_{add_idx[0]}"
        x = b.add(Add(), [x, inp], name=name)
        add_idx[0] += 1
    return x


# (expand, out_channels, repeats, stride) per stage — standard V2 recipe
_V2_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def mobilenet_v2(num_classes: int = 1000, image_size: int = 224,
                 width_mult: float = 1.0,
                 name: str = "mobilenet_v2") -> LayerGraph:
    def c(ch):
        return max(8, int(ch * width_mult))

    b = GraphBuilder(name)
    x = b.input((image_size, image_size, 3), torch.float32)
    x = _cbr6(b, x, c(32), 3, stride=2)
    in_ch = c(32)
    add_idx = [0]
    for expand, out, reps, stride in _V2_CFG:
        for i in range(reps):
            x = _inverted_residual(b, x, in_ch, c(out),
                                   stride if i == 0 else 1, expand, add_idx)
            in_ch = c(out)
    x = _cbr6(b, x, c(1280), 1)
    x = b.add(GlobalAvgPool(), x, name="avg_pool")
    x = b.add(Dense(num_classes), x, name="predictions")
    return b.build()


def mobilenet_tiny(num_classes: int = 10, image_size: int = 32) -> LayerGraph:
    return mobilenet_v2(num_classes, image_size, width_mult=0.25,
                        name="mobilenet_tiny")


#: the 2-stage comm-bound config (BASELINE.md config 4): cut mid-network
MOBILENETV2_2STAGE_CUTS = ["add_3"]
