"""Mixture-of-experts transformer family: the port of
``defer_tpu.models.moe``.

Alternates attention blocks (``TransformerBlock``, the flash kernel on the
card) with switch-MoE FFN layers (``ops.MoE``); every block output is a
single-tensor cut point, so the family pipelines exactly like BERT.
``moe_branched`` puts each expert on its own graph branch
(``ops.ExpertBranch``) joined by an ``Add``.  The expert-parallel
all_to_all execution is ``parallel/expert.py``.
"""

from __future__ import annotations

import torch

from ..graph.ir import GraphBuilder, LayerGraph
from ..graph.ops import Add, ExpertBranch, LayerNorm, MoE, TransformerBlock
from .bert import BertEmbedding, Pooler


def moe_transformer(num_layers: int, hidden: int, heads: int,
                    num_experts: int, expert_hidden: int, seq_len: int,
                    vocab: int = 30522,
                    name: str = "moe_transformer") -> LayerGraph:
    b = GraphBuilder(name)
    x = b.input((seq_len,), torch.int32)
    x = b.add(BertEmbedding(vocab, hidden, seq_len), x, name="embeddings")
    for i in range(num_layers):
        x = b.add(TransformerBlock(heads), x, name=f"block_{i}")
        x = b.add(MoE(num_experts, expert_hidden), x, name=f"moe_{i}")
    x = b.add(LayerNorm(), x, name="final_ln")
    x = b.add(Pooler(hidden), x, name="pooler")
    return b.build()


def moe_tiny(seq_len: int = 16) -> LayerGraph:
    return moe_transformer(2, 32, 2, 4, 64, seq_len, vocab=100,
                           name="moe_tiny")


#: one (attention block + MoE) pair per stage
def moe_stage_cuts(num_layers: int) -> list[str]:
    return [f"moe_{i}" for i in range(num_layers - 1)]


def moe_branched(num_layers: int, hidden: int, heads: int,
                 num_experts: int, expert_hidden: int, seq_len: int,
                 vocab: int = 30522,
                 name: str = "moe_branched") -> LayerGraph:
    """Expert-parallel-shaped MoE: each expert is its own GRAPH branch.

    The fused :class:`~defer_tpu_torch.graph.ops.MoE` op above evaluates
    every expert inside one node, so a pipeline cut can never separate
    them.  This variant expands each MoE layer into a fork/join region: the
    attention block's output forks to ``num_experts``
    :class:`ExpertBranch` nodes (each one expert's gate-weighted FFN) plus
    a residual skip, joined by an ``Add`` — soft-mixture semantics, one
    expert of compute per branch.  Only the ``moe_k`` joins and the blocks
    are valid linear cuts.  The branch-parallel planner
    (``plan.solve_dag``) prices each expert branch on its own stage, and
    ``runtime.node.run_dag_chain`` deploys the solved stage graph.
    """
    b = GraphBuilder(name)
    x = b.input((seq_len,), torch.int32)
    x = b.add(BertEmbedding(vocab, hidden, seq_len), x, name="embeddings")
    for i in range(num_layers):
        x = b.add(TransformerBlock(heads), x, name=f"block_{i}")
        experts = [
            b.add(ExpertBranch(num_experts, e, expert_hidden), x,
                  name=f"moe_{i}_e{e}")
            for e in range(num_experts)]
        # residual skip first: branch 0 of the region is the empty
        # (direct fork->join) path, experts are paths 1..E
        x = b.add(Add(), [x] + experts, name=f"moe_{i}")
    x = b.add(LayerNorm(), x, name="final_ln")
    x = b.add(Pooler(hidden), x, name="pooler")
    return b.build()


def moe_branched_tiny(seq_len: int = 16) -> LayerGraph:
    return moe_branched(2, 32, 2, 4, 64, seq_len, vocab=100,
                        name="moe_branched_tiny")
