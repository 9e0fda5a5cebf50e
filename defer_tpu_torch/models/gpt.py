"""GPT-style causal decoder family: full-sequence graph + KV-cache decode.

The port of ``defer_tpu.models.gpt``: the same graph, node for node and
name for name (``embeddings``, ``block_i``, ``final_ln``, ``lm_head``), so
the JAX package's weights cross by name.  The full-sequence forward
(scoring, ``Defer.logits``) rides the ordinary ring engine, one
``block_k`` node per stage as in BERT-Base; token-by-token generation is
served by :mod:`defer_tpu_torch.runtime.decode`, which calls each block's
:meth:`CausalTransformerBlock.decode`.

Attention in the full-sequence forward (and in the decoder's fused
prefill) is the flash kernel's causal mode.  The one-token ``decode`` step
keeps its two small contractions as ``torch.matmul``: the JAX package
computes them outside any Pallas kernel too.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..graph.ir import GraphBuilder, LayerGraph, Op
from ..graph.ops import (Dense, LayerNorm, TransformerBlock, _cast, _full,
                         _layer_norm, _normal, take_rows)
from ..ops.quant import INV_127


@dataclasses.dataclass(frozen=True, repr=False)
class CausalTransformerBlock(TransformerBlock):
    """Pre-LN decoder block: causal self-attention + MLP.

    Full-sequence ``apply`` masks causally (the flash kernel's bottom-right
    alignment); ``decode`` is the one-token step the pipelined decoder
    runs.  ``num_kv_heads`` enables grouped-query attention (MQA at 1):
    query heads share ``num_heads // num_kv_heads``-way KV groups, which
    shrinks the decode cache by that factor.  ``None`` keeps multi-head
    attention.
    """

    num_kv_heads: int | None = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def _check_kv(self):
        if self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.kv_heads}")

    def init(self, gen, in_specs):
        kv = self.kv_heads
        if kv == self.num_heads:
            return super().init(gen, in_specs)
        self._check_kv()
        (spec,) = in_specs
        d = spec.shape[-1]
        hd = d // self.num_heads
        p = super().init(gen, in_specs)
        # narrow the fused qkv projection: d query cols + 2*kv*hd KV cols
        w = p["qkv"]["w"]
        p["qkv"] = {
            "w": torch.cat([w[:, :d], w[:, d: d + kv * hd],
                            w[:, 2 * d: 2 * d + kv * hd]], dim=-1),
            "b": _full(gen, (d + 2 * kv * hd,), 0.0),
        }
        return p

    def _split_qkv(self, qkv):
        """Static q/k/v column split: d query cols, kv*hd each for K/V."""
        nh, kv = self.num_heads, self.kv_heads
        hd = qkv.shape[-1] // (nh + 2 * kv)
        dq = nh * hd
        return (qkv[..., :dq], qkv[..., dq: dq + kv * hd],
                qkv[..., dq + kv * hd:])

    def _kv_head_count(self) -> int:
        return self.kv_heads

    def flops(self, in_specs, out_spec):
        # the base formula assumes a 3d-wide qkv projection; GQA narrows it
        (spec,) = in_specs
        t, d = spec.shape
        qkv_cols = d + 2 * self.kv_heads * (d // self.num_heads)
        return (2 * t * d * (qkv_cols + d + 2 * self.mlp_ratio * d)
                + 4 * t * t * d)

    def _attend(self, q, k, v):
        impl = self.attn_impl
        if impl not in ("auto", "flash", "xla"):
            raise ValueError(
                f"attn_impl must be 'auto', 'flash' or 'xla', got {impl!r}")
        if impl != "xla":
            from ..ops.flash_attention import flash_attention
            return flash_attention(q, k, v, causal=True)
        hd = q.shape[-1]
        t_q, t_k = q.shape[2], k.shape[2]
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)
        mask = q_pos >= torch.arange(t_k, device=q.device)[None, :]
        att = att.masked_fill(~mask, -math.inf).softmax(dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", att, v)

    # apply/apply_with_kv are inherited: the base TransformerBlock forward
    # is the one implementation, made causal through _attend.  The K/V
    # columns apply_with_kv returns are what decode() writes row by row, so
    # the fused prefill bulk-writes cache rows 0..t-1 (after the head-major
    # relayout) and decoding continues at t.

    @staticmethod
    def quantize_row(row):
        """Symmetric per-(head, position)-row int8: ``[..., hd]`` float ->
        (``[..., hd]`` int8, ``[...]`` f32 scale).  The scale is
        ``amax * f32(1/127)``, the form XLA compiles the JAX package's
        ``amax / 127.0`` into under ``jit`` (ROADMAP queue C); ``row /
        scale`` stays a division and rounds half to even."""
        rowf = row.to(torch.float32)
        amax = rowf.abs().amax(dim=-1)
        scale = torch.where(amax > 0, amax * INV_127, 1.0)
        q = torch.clamp(torch.round(rowf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    def decode(self, params, x, k_cache, v_cache, pos,
               k_scale=None, v_scale=None):
        """One-token step: ``x`` [b, d] at position ``pos``: an int, a
        one-element int64 tensor on x's device (which keeps the step free
        of host syncs inside a CUDA graph), or a ``[b]`` int64 tensor
        giving each row its own position (the continuous-batching engine,
        ``serve/engine.py``: the port's form of the JAX engine's
        ``vmap`` of single-row decodes).

        ``k_cache``/``v_cache`` are head-major ``[b, kv, L, hd]`` with L
        above every position; under GQA kv < num_heads and each cache head
        serves its query group without repeats.  The new key/value row is
        written at ``pos`` IN PLACE (callers pass a scratch index for
        bubble steps) and attention covers positions <= ``pos``, each row
        at its own position when ``pos`` has one per row.  With
        ``k_scale``/``v_scale`` (``[b, kv, L]`` f32) the caches hold int8
        rows from :meth:`quantize_row`; the per-row scales fold into the
        contractions exactly.  Returns ``(y, k_cache, v_cache)``, plus the
        scales when quantized — the same tensors, updated.
        """
        p = _cast(params, x.dtype)
        b, d = x.shape
        nh, kv = self.num_heads, self.kv_heads
        grp = nh // kv
        hd = d // nh
        cache_len = k_cache.shape[2]
        quant = k_scale is not None
        pos = torch.as_tensor(pos, device=x.device).reshape(-1)
        per_row = pos.numel() > 1
        if per_row and pos.numel() != b:
            raise ValueError(f"pos has {pos.numel()} positions for {b} rows")

        y = _layer_norm(p["ln1"], x, self.ln_eps)
        qkv = y @ p["qkv"]["w"] + p["qkv"]["b"]
        q, k_new, v_new = self._split_qkv(qkv)
        k_row = k_new.reshape(b, kv, 1, hd)
        v_row = v_new.reshape(b, kv, 1, hd)
        if quant:
            k_row, ks_row = self.quantize_row(k_row)
            v_row, vs_row = self.quantize_row(v_row)
            _write_rows(k_scale, pos, ks_row, per_row)
            _write_rows(v_scale, pos, vs_row, per_row)
        _write_rows(k_cache, pos, k_row.to(k_cache.dtype), per_row)
        _write_rows(v_cache, pos, v_row.to(v_cache.dtype), per_row)

        qh = q.reshape(b, kv, grp, hd)
        att = (qh @ k_cache.to(x.dtype).transpose(-1, -2)) / math.sqrt(hd)
        if quant:
            att = att * k_scale[:, :, None, :].to(att.dtype)
        live = torch.arange(cache_len, device=x.device) <= (
            pos[:, None, None, None] if per_row else pos)
        att = att.masked_fill(~live, -math.inf).softmax(dim=-1)
        if quant:
            att = att * v_scale[:, :, None, :].to(att.dtype)
        y = (att @ v_cache.to(x.dtype)).reshape(b, d)
        x = x + (y @ p["proj"]["w"] + p["proj"]["b"])

        y = _layer_norm(p["ln2"], x, self.ln_eps)
        y = F.gelu(y @ p["fc1"]["w"] + p["fc1"]["b"], approximate="tanh")
        out = x + (y @ p["fc2"]["w"] + p["fc2"]["b"])
        if quant:
            return out, k_cache, v_cache, k_scale, v_scale
        return out, k_cache, v_cache


def _write_rows(cache, pos, rows, per_row: bool) -> None:
    """Write ``rows`` ``[b, kv, 1(, hd)]`` into ``cache`` ``[b, kv, L(,
    hd)]`` at position ``pos`` IN PLACE: one ``index_copy_`` for a shared
    position, one ``index_put_`` at ``(row, pos[row])`` when each row has
    its own (both capture into a CUDA graph)."""
    if not per_row:
        cache.index_copy_(2, pos, rows)
        return
    b = cache.shape[0]
    cache.transpose(1, 2).index_put_(
        (torch.arange(b, device=cache.device), pos), rows[:, :, 0])


class GptEmbedding(Op):
    """Token + learned positional embeddings (GPT-2 style, no post-LN).
    Out-of-range token ids follow ``graph.ops.take_rows``."""

    def __init__(self, vocab: int, features: int, max_len: int):
        self.vocab = vocab
        self.features = features
        self.max_len = max_len

    def init(self, gen, in_specs):
        del in_specs
        return {"wte": _normal(gen, (self.vocab, self.features)) * 0.02,
                "wpe": _normal(gen, (self.max_len, self.features)) * 0.01}

    def apply(self, params, ids):
        t = ids.shape[1]
        return take_rows(params["wte"], ids) + params["wpe"][:t]

    def embed_at(self, params, ids, pos):
        """Decode-path embedding: ``ids`` [b] at position ``pos`` (an int
        or a one-element tensor, read without a host sync), clamped into
        the positional table as ``lax.dynamic_slice`` clamps."""
        wpe = params["wpe"]
        idx = torch.as_tensor(pos, device=wpe.device).reshape(1)
        idx = idx.clamp(0, wpe.shape[0] - 1)
        return take_rows(params["wte"], ids) + wpe.index_select(0, idx)[0]

    def flops(self, in_specs, out_spec):
        return out_spec.size


def gpt(num_layers: int, hidden: int, heads: int, seq_len: int,
        vocab: int = 50257, kv_heads: int | None = None,
        ln_eps: float = 1e-6, name: str = "gpt") -> LayerGraph:
    """Causal LM graph: ids [t] -> logits [t, vocab].

    ``block_k`` nodes are the pipeline cut points; the decoder consumes the
    same graph by node name (``embeddings``, ``block_0..``, ``final_ln``,
    ``lm_head``).  ``kv_heads`` < ``heads`` builds a GQA model (MQA at 1).
    ``ln_eps`` goes to every block and the final LayerNorm.
    """
    b = GraphBuilder(name)
    x = b.input((seq_len,), torch.int32)
    x = b.add(GptEmbedding(vocab, hidden, seq_len), x, name="embeddings")
    for i in range(num_layers):
        x = b.add(CausalTransformerBlock(heads, num_kv_heads=kv_heads,
                                         ln_eps=ln_eps),
                  x, name=f"block_{i}")
    x = b.add(LayerNorm(eps=ln_eps), x, name="final_ln")
    x = b.add(Dense(vocab), x, name="lm_head")
    return b.build()


def gpt_small(seq_len: int = 256, kv_heads: int | None = None) -> LayerGraph:
    """GPT-2 small geometry (12 layers, d=768, 12 heads)."""
    return gpt(12, 768, 12, seq_len, kv_heads=kv_heads, name="gpt_small")


def gpt2_small(seq_len: int = 256) -> LayerGraph:
    """GPT-2 small as Hugging Face's ``gpt2`` has it: the geometry of
    :func:`gpt_small` with GPT-2's trained LayerNorm epsilon, 1e-5."""
    return gpt(12, 768, 12, seq_len, ln_eps=1e-5, name="gpt2_small")


def gpt_tiny(seq_len: int = 16, vocab: int = 97,
             kv_heads: int | None = None) -> LayerGraph:
    return gpt(4, 32, 2, seq_len, vocab=vocab, kv_heads=kv_heads,
               name="gpt_tiny")


def gpt_stage_cuts(num_layers: int, num_stages: int) -> list[str]:
    """Even block-boundary cut points for a ``num_stages``-stage pipeline."""
    if not 1 <= num_stages <= num_layers:
        raise ValueError(f"need 1 <= stages <= {num_layers}")
    per = num_layers / num_stages
    return [f"block_{round(per * (s + 1)) - 1}"
            for s in range(num_stages - 1)]
