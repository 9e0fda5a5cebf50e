"""ResNet family on the layer-graph IR (NHWC, inference-mode BN).

The port of ``defer_tpu.models.resnet``: the same graph, node for node and
name for name.  ResNet50 is the reference's flagship benchmark: 8
partitions cut at the residual-add articulation layers ``add_2, add_4,
..., add_14``.  ``resnet_tiny`` is a scaled-down variant for fast tests.
"""

from __future__ import annotations

import torch

from ..graph.ir import GraphBuilder, LayerGraph
from ..graph.ops import (Activation, Add, BatchNorm, Conv2D, Dense,
                         GlobalAvgPool, MaxPool)


def _conv_bn(b: GraphBuilder, x: str, features: int, kernel: int,
             stride: int = 1, relu: bool = True) -> str:
    # explicit symmetric k//2 padding: SAME at stride 1, torch's convention
    # at stride 2 (where XLA SAME would pad asymmetrically)
    pad = (kernel // 2, kernel // 2)
    x = b.add(Conv2D(features, kernel, stride, pad, use_bias=False), x)
    x = b.add(BatchNorm(), x)
    if relu:
        x = b.add(Activation("relu"), x)
    return x


def _bottleneck(b: GraphBuilder, x: str, features: int, stride: int,
                project: bool, add_idx: int) -> str:
    """Post-activation bottleneck block ending in a named ``add_k`` node
    (stride on the 3x3 conv: ResNet v1.5, torchvision's layout)."""
    shortcut = x
    if project:
        shortcut = _conv_bn(b, x, 4 * features, 1, stride, relu=False)
    y = _conv_bn(b, x, features, 1, 1)
    y = _conv_bn(b, y, features, 3, stride)
    y = _conv_bn(b, y, 4 * features, 1, 1, relu=False)
    name = "add" if add_idx == 0 else f"add_{add_idx}"
    out = b.add(Add(), [y, shortcut], name=name)
    return b.add(Activation("relu"), out)


def resnet(depths: list[int], width: int = 64, num_classes: int = 1000,
           image_size: int = 224, name: str = "resnet") -> LayerGraph:
    b = GraphBuilder(name)
    x = b.input((image_size, image_size, 3), torch.float32)
    x = _conv_bn(b, x, width, 7, 2)
    x = b.add(MaxPool(3, 2, padding=(1, 1)), x)
    add_idx = 0
    for s, blocks in enumerate(depths):
        feats = width * (2 ** s)
        for i in range(blocks):
            stride = 2 if (s > 0 and i == 0) else 1
            x = _bottleneck(b, x, feats, stride, project=(i == 0),
                            add_idx=add_idx)
            add_idx += 1
    x = b.add(GlobalAvgPool(), x)
    x = b.add(Dense(num_classes), x, name="predictions")
    return b.build()


def resnet50(num_classes: int = 1000, image_size: int = 224) -> LayerGraph:
    return resnet([3, 4, 6, 3], 64, num_classes, image_size, "resnet50")


def resnet_tiny(num_classes: int = 10, image_size: int = 32,
                width: int = 8) -> LayerGraph:
    """4 residual blocks / 8 valid add-cuts worth of structure, test-fast."""
    return resnet([2, 2], width, num_classes, image_size, "resnet_tiny")


#: the reference benchmark's exact 8-stage cut list
RESNET50_8STAGE_CUTS = ["add_2", "add_4", "add_6", "add_8", "add_10",
                        "add_12", "add_14"]
