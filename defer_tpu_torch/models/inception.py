"""Inception-v3 on the layer-graph IR: the port of
``defer_tpu.models.inception`` (BASELINE.md config 3: 6 partitions — the
branching-DAG stress test for the partitioner).

Inside each inception block, parallel branches diverge and re-join at a
channel ``Concat``, so nothing inside a block is a valid cut point: the
articulation analysis offers only the sequential stem and the
block-boundary ``mixed_k`` concat nodes.  Two graphs, node for node as in
the JAX package: the parametric ``inception`` (its pool branches divide by
the valid-element count) and the torchvision-exact ``inception_v3`` (BN
eps 1e-3, pool branches divide by 9 at the borders).
"""

from __future__ import annotations

import torch

from ..graph.ir import GraphBuilder, LayerGraph
from ..graph.ops import (Activation, AvgPool, BatchNorm, Concat, Conv2D,
                         Dense, GlobalAvgPool, MaxPool)


def _cbr(b: GraphBuilder, x: str, feats: int, kernel, stride=1,
         padding="SAME", eps=1e-5) -> str:
    x = b.add(Conv2D(feats, kernel, stride, padding, use_bias=False), x)
    x = b.add(BatchNorm(eps=eps), x)
    return b.add(Activation("relu"), x)


def _block_a(b: GraphBuilder, x: str, f: int, pool_f: int, idx: int) -> str:
    b1 = _cbr(b, x, f, 1)
    b2 = _cbr(b, _cbr(b, x, f * 3 // 4, 1), f, 5)
    b3 = _cbr(b, _cbr(b, _cbr(b, x, f, 1), f * 3 // 2, 3), f * 3 // 2, 3)
    b4 = _cbr(b, b.add(AvgPool(3, 1, "SAME"), x), pool_f, 1)
    return b.add(Concat(), [b1, b2, b3, b4], name=f"mixed_{idx}")


def _reduction(b: GraphBuilder, x: str, f: int, idx: int) -> str:
    b1 = _cbr(b, x, f * 2, 3, stride=2, padding="VALID")
    b2 = _cbr(b, _cbr(b, _cbr(b, x, f, 1), f, 3), f, 3, stride=2,
              padding="VALID")
    b3 = b.add(MaxPool(3, 2, "VALID"), x)
    return b.add(Concat(), [b1, b2, b3], name=f"mixed_{idx}")


def _block_b(b: GraphBuilder, x: str, f: int, out_f: int, idx: int) -> str:
    b1 = _cbr(b, x, out_f, 1)
    b2 = _cbr(b, _cbr(b, _cbr(b, x, f, 1), f, (1, 7)), out_f, (7, 1))
    b3 = _cbr(b, _cbr(b, _cbr(b, _cbr(b, _cbr(
        b, x, f, 1), f, (7, 1)), f, (1, 7)), f, (7, 1)), out_f, (1, 7))
    b4 = _cbr(b, b.add(AvgPool(3, 1, "SAME"), x), out_f, 1)
    return b.add(Concat(), [b1, b2, b3, b4], name=f"mixed_{idx}")


def _block_c(b: GraphBuilder, x: str, f: int, idx: int) -> str:
    b1 = _cbr(b, x, f, 1)
    mid2 = _cbr(b, x, f, 1)
    b2 = b.add(Concat(), [_cbr(b, mid2, f, (1, 3)), _cbr(b, mid2, f, (3, 1))])
    mid3 = _cbr(b, _cbr(b, x, f * 3 // 2, 1), f, 3)
    b3 = b.add(Concat(), [_cbr(b, mid3, f, (1, 3)), _cbr(b, mid3, f, (3, 1))])
    b4 = _cbr(b, b.add(AvgPool(3, 1, "SAME"), x), f // 2, 1)
    return b.add(Concat(), [b1, b2, b3, b4], name=f"mixed_{idx}")


def inception(width: int = 64, num_classes: int = 1000,
              image_size: int = 299, name: str = "inception") -> LayerGraph:
    w = width
    b = GraphBuilder(name)
    x = b.input((image_size, image_size, 3), torch.float32)
    # stem
    x = _cbr(b, x, w // 2, 3, stride=2, padding="VALID")
    x = _cbr(b, x, w // 2, 3, padding="VALID")
    x = _cbr(b, x, w, 3)
    x = b.add(MaxPool(3, 2, "VALID"), x, name="stem_pool")
    x = _cbr(b, x, w * 5 // 4, 1)
    x = _cbr(b, x, w * 3, 3, padding="VALID")
    x = b.add(MaxPool(3, 2, "VALID"), x, name="stem_pool2")
    # inception stacks
    idx = 0
    for _ in range(3):
        x = _block_a(b, x, w, w // 2, idx)
        idx += 1
    x = _reduction(b, x, w * 3, idx)
    idx += 1
    for _ in range(4):
        x = _block_b(b, x, w * 2, w * 3, idx)
        idx += 1
    x = _reduction(b, x, w * 3, idx)
    idx += 1
    for _ in range(2):
        x = _block_c(b, x, w * 6, idx)
        idx += 1
    x = b.add(GlobalAvgPool(), x, name="avg_pool")
    x = b.add(Dense(num_classes), x, name="predictions")
    return b.build()


def _tcbr(b: GraphBuilder, x: str, feats: int, kernel, stride=1,
          padding="SAME") -> str:
    """torchvision ``BasicConv2d``: conv (no bias) + BN(eps=1e-3) + relu.

    All stride-2 convs in InceptionV3 are pad-0 (= VALID, identical in
    torch and XLA); all stride-1 convs pad symmetrically to k//2 per side
    (= SAME at stride 1), so no explicit padding tuples are needed —
    unlike the torch-trained ResNet/MobileNet imports.
    """
    return _cbr(b, x, feats, kernel, stride, padding, eps=1e-3)


def _tpool_branch(b: GraphBuilder, x: str, feats: int) -> str:
    # torch F.avg_pool2d(x, 3, stride=1, padding=1): count_include_pad
    pool = b.add(AvgPool(3, 1, "SAME", count_include_pad=True), x)
    return _tcbr(b, pool, feats, 1)


def _t_block_a(b: GraphBuilder, x: str, pool_feats: int, idx: int) -> str:
    b1 = _tcbr(b, x, 64, 1)
    b5 = _tcbr(b, _tcbr(b, x, 48, 1), 64, 5)
    bd = _tcbr(b, _tcbr(b, _tcbr(b, x, 64, 1), 96, 3), 96, 3)
    bp = _tpool_branch(b, x, pool_feats)
    return b.add(Concat(), [b1, b5, bd, bp], name=f"mixed_{idx}")


def _t_block_b(b: GraphBuilder, x: str, idx: int) -> str:
    b3 = _tcbr(b, x, 384, 3, stride=2, padding="VALID")
    bd = _tcbr(b, _tcbr(b, _tcbr(b, x, 64, 1), 96, 3), 96, 3, stride=2,
               padding="VALID")
    bp = b.add(MaxPool(3, 2, "VALID"), x)
    return b.add(Concat(), [b3, bd, bp], name=f"mixed_{idx}")


def _t_block_c(b: GraphBuilder, x: str, c7: int, idx: int) -> str:
    b1 = _tcbr(b, x, 192, 1)
    b7 = _tcbr(b, _tcbr(b, _tcbr(b, x, c7, 1), c7, (1, 7)), 192, (7, 1))
    bd = _tcbr(b, _tcbr(b, _tcbr(b, _tcbr(b, _tcbr(
        b, x, c7, 1), c7, (7, 1)), c7, (1, 7)), c7, (7, 1)), 192, (1, 7))
    bp = _tpool_branch(b, x, 192)
    return b.add(Concat(), [b1, b7, bd, bp], name=f"mixed_{idx}")


def _t_block_d(b: GraphBuilder, x: str, idx: int) -> str:
    b3 = _tcbr(b, _tcbr(b, x, 192, 1), 320, 3, stride=2, padding="VALID")
    b7 = _tcbr(b, _tcbr(b, _tcbr(b, _tcbr(
        b, x, 192, 1), 192, (1, 7)), 192, (7, 1)), 192, 3, stride=2,
        padding="VALID")
    bp = b.add(MaxPool(3, 2, "VALID"), x)
    return b.add(Concat(), [b3, b7, bp], name=f"mixed_{idx}")


def _t_block_e(b: GraphBuilder, x: str, idx: int) -> str:
    b1 = _tcbr(b, x, 320, 1)
    m3 = _tcbr(b, x, 384, 1)
    b3 = b.add(Concat(),
               [_tcbr(b, m3, 384, (1, 3)), _tcbr(b, m3, 384, (3, 1))])
    md = _tcbr(b, _tcbr(b, x, 448, 1), 384, 3)
    bd = b.add(Concat(),
               [_tcbr(b, md, 384, (1, 3)), _tcbr(b, md, 384, (3, 1))])
    bp = _tpool_branch(b, x, 192)
    return b.add(Concat(), [b1, b3, bd, bp], name=f"mixed_{idx}")


def inception_v3(num_classes: int = 1000, image_size: int = 299) -> LayerGraph:
    """Exact torchvision InceptionV3 (eval semantics, no aux head).

    Block-for-block and channel-for-channel the torchvision module tree —
    Conv2d_1a..4a stem, Mixed_5b/5c/5d (A, pool 32/64/64), Mixed_6a (B),
    Mixed_6b..6e (C, c7 128/160/160/192), Mixed_7a (D), Mixed_7b/7c (E) —
    named ``mixed_0..mixed_10`` here, so torchvision checkpoints import
    weight-for-weight (``utils/pretrained.py: inception_v3_torch_mapping``)
    and the benchmark config measures the real InceptionV3 FLOPs.  BN eps
    is 1e-3 and the pool branches divide by 9 at the borders
    (``count_include_pad``), both matching torch.  The aux classifier and
    train-time dropout do not exist in the inference graph; torchvision's
    ``transform_input`` re-normalization is a preprocessing concern (feed
    TF-style ``(x-0.5)/0.5`` inputs, or apply the affine before ingest).
    """
    b = GraphBuilder("inception_v3")
    x = b.input((image_size, image_size, 3), torch.float32)
    x = _tcbr(b, x, 32, 3, stride=2, padding="VALID")   # Conv2d_1a_3x3
    x = _tcbr(b, x, 32, 3, padding="VALID")             # Conv2d_2a_3x3
    x = _tcbr(b, x, 64, 3)                              # Conv2d_2b_3x3
    x = b.add(MaxPool(3, 2, "VALID"), x, name="stem_pool")
    x = _tcbr(b, x, 80, 1, padding="VALID")             # Conv2d_3b_1x1
    x = _tcbr(b, x, 192, 3, padding="VALID")            # Conv2d_4a_3x3
    x = b.add(MaxPool(3, 2, "VALID"), x, name="stem_pool2")
    idx = 0
    for pool_feats in (32, 64, 64):                     # Mixed_5b/5c/5d
        x = _t_block_a(b, x, pool_feats, idx)
        idx += 1
    x = _t_block_b(b, x, idx)                           # Mixed_6a
    idx += 1
    for c7 in (128, 160, 160, 192):                     # Mixed_6b..6e
        x = _t_block_c(b, x, c7, idx)
        idx += 1
    x = _t_block_d(b, x, idx)                           # Mixed_7a
    idx += 1
    for _ in range(2):                                  # Mixed_7b/7c
        x = _t_block_e(b, x, idx)
        idx += 1
    x = b.add(GlobalAvgPool(), x, name="avg_pool")
    x = b.add(Dense(num_classes), x, name="predictions")
    return b.build()


def inception_tiny(num_classes: int = 10, image_size: int = 75) -> LayerGraph:
    return inception(8, num_classes, image_size, name="inception_tiny")


#: 6-stage cuts at block boundaries (BASELINE.md config 3)
INCEPTION_6STAGE_CUTS = ["mixed_0", "mixed_2", "mixed_4", "mixed_6",
                         "mixed_8"]
