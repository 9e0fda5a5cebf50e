"""VGG family on the layer-graph IR: the port of ``defer_tpu.models.vgg``.

BASELINE.md config 2: VGG19 in 4 partitions — a deep sequential model with
large early activations.  Every layer output is a valid cut point.
``Flatten`` reads NHWC order, the order ``fc1``'s ``[25088, 4096]`` weight
is laid out for.
"""

from __future__ import annotations

import torch

from ..graph.ir import GraphBuilder, LayerGraph
from ..graph.ops import Activation, Conv2D, Dense, Flatten, MaxPool


def vgg(cfg: list[int | str], num_classes: int = 1000, image_size: int = 224,
        fc_width: int = 4096, name: str = "vgg") -> LayerGraph:
    b = GraphBuilder(name)
    x = b.input((image_size, image_size, 3), torch.float32)
    block, conv_in_block = 1, 1
    for v in cfg:
        if v == "M":
            x = b.add(MaxPool(2, 2), x, name=f"pool{block}")
            block += 1
            conv_in_block = 1
        else:
            x = b.add(Conv2D(int(v), 3), x,
                      name=f"conv{block}_{conv_in_block}")
            x = b.add(Activation("relu"), x,
                      name=f"relu{block}_{conv_in_block}")
            conv_in_block += 1
    x = b.add(Flatten(), x, name="flatten")
    x = b.add(Dense(fc_width), x, name="fc1")
    x = b.add(Activation("relu"), x, name="fc1_relu")
    x = b.add(Dense(fc_width), x, name="fc2")
    x = b.add(Activation("relu"), x, name="fc2_relu")
    x = b.add(Dense(num_classes), x, name="predictions")
    return b.build()


VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19(num_classes: int = 1000, image_size: int = 224) -> LayerGraph:
    return vgg(VGG19_CFG, num_classes, image_size, name="vgg19")


def vgg_tiny(num_classes: int = 10, image_size: int = 32) -> LayerGraph:
    return vgg([8, "M", 16, "M", 16, "M"], num_classes, image_size,
               fc_width=32, name="vgg_tiny")


#: natural 4-stage cuts for VGG19 (BASELINE.md config 2): block boundaries
VGG19_4STAGE_CUTS = ["pool2", "pool3", "pool4"]
