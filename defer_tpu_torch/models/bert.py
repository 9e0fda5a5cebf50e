"""BERT-Base encoder on the layer-graph IR (12 partitions, one transformer
block per pipeline stage).

The port of ``defer_tpu.models.bert``: the same graph, node for node and
name for name (``embeddings``, ``block_i``, ``pooler``), so the JAX
package's weights cross by name.  Each encoder block is one graph node
(``ops.TransformerBlock``), so ``block_k`` nodes are the natural cut points
and the 12-stage config is ``cut_points=[block_0 .. block_10]``.

The graph input is ``int32 (seq_len,)`` token ids.  They ride the
pipeline's float32 transfer buffer exactly (ids < 2**24), and each stage
casts its input back to its spec dtype.  An out-of-range id wraps and
clamps as in JAX (``graph.ops.take_rows``).
"""

from __future__ import annotations

import math

import torch

from ..graph.ir import GraphBuilder, LayerGraph, Op
from ..graph.ops import (_full, _layer_norm, _normal, TransformerBlock,
                         take_rows)


class BertEmbedding(Op):
    """Token + learned positional embeddings, followed by layer norm.

    HF's segment (token-type) embedding is not a separate table: for
    single-segment inputs it is a constant vector added before the norm,
    so an importer folds ``token_type_embeddings[0]`` into ``pos``.
    """

    def __init__(self, vocab: int, features: int, max_len: int,
                 eps: float = 1e-12):
        self.vocab = vocab
        self.features = features
        self.max_len = max_len
        self.eps = eps

    def init(self, gen, in_specs):
        del in_specs
        f = self.features
        return {"tok": _normal(gen, (self.vocab, f)) * 0.02,
                "pos": _normal(gen, (self.max_len, f)) * 0.02,
                "ln": {"scale": _full(gen, (f,), 1.0),
                       "bias": _full(gen, (f,), 0.0)}}

    def apply(self, params, ids):
        t = ids.shape[1]
        x = take_rows(params["tok"], ids) + params["pos"][:t]
        return _layer_norm(params["ln"], x, self.eps)

    def flops(self, in_specs, out_spec):
        return out_spec.size


class Pooler(Op):
    """[CLS] pooling + tanh projection (BERT's pooler head)."""

    def __init__(self, features: int):
        self.features = features

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        return {"w": _normal(gen, (d, self.features)) / math.sqrt(d),
                "b": _full(gen, (self.features,), 0.0)}

    def apply(self, params, x):
        cls = x[:, 0, :]
        return torch.tanh(cls @ params["w"].to(x.dtype)
                          + params["b"].to(x.dtype))

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        return 2 * spec.shape[-1] * self.features


def bert(num_layers: int, hidden: int, heads: int, seq_len: int,
         vocab: int = 30522, name: str = "bert") -> LayerGraph:
    """Original-BERT encoder: post-LN residual blocks with exact GELU and
    eps=1e-12 (as HF ``bert-base-uncased``), no trailing LayerNorm."""
    b = GraphBuilder(name)
    x = b.input((seq_len,), torch.int32)
    x = b.add(BertEmbedding(vocab, hidden, seq_len), x, name="embeddings")
    for i in range(num_layers):
        x = b.add(TransformerBlock(heads, norm="post", ln_eps=1e-12),
                  x, name=f"block_{i}")
    x = b.add(Pooler(hidden), x, name="pooler")
    return b.build()


def bert_base(seq_len: int = 128) -> LayerGraph:
    return bert(12, 768, 12, seq_len, name="bert_base")


def bert_tiny(seq_len: int = 16) -> LayerGraph:
    return bert(4, 32, 2, seq_len, vocab=100, name="bert_tiny")


#: one encoder block per stage (BASELINE.md config 5): 12 stages — stage 0
#: holds embeddings + block_0, stage 11 holds block_11 + pooler
BERT_BASE_12STAGE_CUTS = [f"block_{i}" for i in range(11)]
