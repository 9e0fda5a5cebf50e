"""Pipelined autoregressive decoding with per-stage KV caches.

The port of ``defer_tpu.runtime.decode``.  Token t+1 of a sequence cannot
enter stage 0 before token t has left the last stage, so one sequence
would keep one stage of N busy.  The fix, as in the JAX package: N
independent *groups* of sequences interleaved round-robin, so at every
step stage k serves group ``(t - k) mod N`` and every stage decodes every
step.

On one card:

  * Weights: one flat row per stage (``runtime/flatbuf.py``) in the compute
    dtype, or W8A16 (``weight_dtype="int8"``): int8 values plus a parallel
    f32 scale row, dequantized inside each stage call.  ``reweight``
    copies new weights into the same rows.
  * KV caches: per stage ``[Lmax, N, mb, kv, max_len+1, hd]`` (local
    blocks x groups, head-major), in the compute dtype or int8 with f32
    scales per row.  Position row ``max_len`` is the scratch row bubble
    steps write.
  * The ring: ``[N, mb, d(+1)]`` float32.  A step runs every stage on its
    slot in turn, then rotates the ring one slot (``lax.ppermute`` in the
    JAX package).  On the wrap link the last stage's token ids ride column
    0 (exact for ids < 2**24) and, under beam search, parent indices the
    extra column.
  * Dispatch: the JAX package scans a whole chunk of steps in one program.
    Here the unit is ``N`` steps — one token per group — and the step
    counter ``t`` lives in a device tensor that the unit advances; a
    dispatch runs ``ceil(chunk_steps / N)`` units.  Because every unit
    starts at a multiple of N, the group each stage serves at each step of
    the unit is static, so every cache access is a view.  On the card a
    unit is one CUDA-graph replay (captured once per sampling mode); the
    CPU runs the same steps eagerly.  Every schedule scalar (``t``,
    ``t_stop``, ``plen``, ``start``, ``first_pos``, ``seed``, ``temp``)
    lives in a static device tensor, so a replay needs no host value.
    Steps past ``t_stop`` are bubbles, so the extra steps of a rounded-up
    dispatch change nothing.
  * Prompts: teacher forcing at decode rate (stage 0 takes the known
    prompt token while ``pos < prompt_len``), or the fused prefill
    (``prefill=True``): each group's whole prompt crosses each stage in one
    causal-attention step and bulk-writes the caches.  On one card only
    the ``N*N`` live stage-steps of its ``2N-1``-step schedule run; the
    JAX program also runs the bubble ones, into a scratch group the port
    does not need.
  * Sampling: greedy argmax, or temperature softmax sampling with optional
    top-k as Gumbel-max, the noise a pure counter-based hash of ``(seed,
    t, row, column)`` in tensor ops — results do not depend on chunking,
    and a graph replay draws anew from its device step counter.  The
    draws cannot equal the JAX package's ``jax.random`` ones; what holds
    is their distribution.

Scope: the ``gpt()`` node contract (``embeddings`` / ``block_i`` /
``final_ln`` / ``lm_head`` — models/gpt.py).
"""

from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from ..graph.ir import LayerGraph, as_dtype
from ..models.gpt import CausalTransformerBlock, GptEmbedding
from ..obs import REGISTRY, tracer
from ..utils.config import resolve_device
from . import flatbuf
from .cuda_graph import capture
from .spmd import COMPUTE_DTYPES

_M32 = 0xFFFFFFFF
#: step key of the fused prefill's draws: ``PREFILL_KEY + group``, a domain
#: disjoint from the decode steps' keys
PREFILL_KEY = 1 << 30


def _mul32(h, c: int):
    """``h * c mod 2**32`` for ``0 <= h < 2**32`` in int64 without
    overflow: the constant in 16-bit halves."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer (an int or an int64 tensor)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seed, t, shape: tuple[int, int], device) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[rows, cols]``, a pure function of ``(seed, t,
    row, col)``: ``seed`` and ``t`` are ints or int64 tensors (device
    scalars inside a CUDA graph)."""
    rows, cols = shape
    return _gumbel(_step_key(seed, t),
                   torch.arange(rows * cols, device=device).view(rows, cols))


def gumbel_noise_rows(seeds, ts, cols: int) -> torch.Tensor:
    """Row-keyed Gumbel(0, 1) noise ``[rows, cols]``: ``seeds`` and ``ts``
    are ``[rows]`` int64 tensors, and row r equals ``gumbel_noise(seeds[r],
    ts[r], (1, cols))[0]`` — a row's draw depends only on its own (seed,
    t), never on its index in the batch.  The continuous-batching engine
    keys each row by its request's seed and position, as the JAX engine
    keys it by ``fold_in(PRNGKey(seed), position)``."""
    return _gumbel(_step_key(seeds, ts)[:, None],
                   torch.arange(cols, device=seeds.device)[None, :])


def _step_key(seed, t):
    return _fmix32(_fmix32(seed & _M32) ^ (t & _M32))


def _gumbel(key, idx) -> torch.Tensor:
    """Gumbel(0, 1) noise from a hash of each ``idx`` under ``key``."""
    h = _fmix32((_fmix32(idx) + key) & _M32)
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24  # in (0, 1)
    return -torch.log(-torch.log(u))


def _sample_ids(logits, temp, top_k: int | None, seed, t) -> torch.Tensor:
    """Temperature softmax sampling with optional top-k truncation, as
    Gumbel-max.  The one definition the decode and prefill steps share:
    both draw from the same distribution.  ``temp`` is a scalar tensor or
    one per row (``[rows, 1]``); ``seed`` and ``t`` are ints or scalar
    tensors (the noise hashes the row index), or ``[rows]`` tensors, which
    key each row by its own pair (:func:`gumbel_noise_rows`)."""
    lg = logits / temp.clamp_min(1e-6)
    if top_k is not None:
        kth = lg.topk(top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, -math.inf)
    if torch.is_tensor(seed) and seed.dim() == 1:
        noise = gumbel_noise_rows(seed, t, lg.shape[1])
    else:
        noise = gumbel_noise(seed, t, tuple(lg.shape), lg.device)
    return (lg + noise).argmax(-1)


def _split_blocks(num_blocks: int, num_stages: int) -> list[list[int]]:
    """Contiguous, balanced block assignment (stage i gets ~L/N blocks)."""
    bounds = [round(num_blocks * s / num_stages)
              for s in range(num_stages + 1)]
    out = [list(range(bounds[s], bounds[s + 1])) for s in range(num_stages)]
    if any(not b for b in out):
        raise ValueError(
            f"{num_blocks} blocks cannot fill {num_stages} stages")
    return out


class PipelinedDecoder:
    """Autoregressive generation over a ring of stages on one device.

    Usage::

        graph = gpt_tiny()
        dec = PipelinedDecoder(graph, graph.init(gen), num_stages=4,
                               microbatch=2, max_len=32)
        tokens = dec.generate(prompt_ids, max_new_tokens=16)

    ``prompt_ids`` is [B, prompt_len]; returns [B, prompt_len +
    max_new_tokens].  ``device=None`` means the CUDA card (an error when
    CUDA is absent).  On the card each unit is a graph replay; setting
    ``cuda_graphs = False`` runs the same steps eagerly there (the CPU
    always does), which is what a replay is checked against.
    """

    def __init__(
        self,
        graph: LayerGraph,
        params: dict[str, Any],
        *,
        num_stages: int,
        max_len: int | None = None,
        device: str | torch.device | None = None,
        microbatch: int = 1,
        compute_dtype=None,
        kv_cache: str = "buffer",
        weight_dtype: str | None = None,
        beam_width: int = 1,
    ):
        self.device = dev = resolve_device(device)
        self.graph = graph
        self.num_stages = n = num_stages
        self.microbatch = mb = microbatch
        self.compute_dtype = cd = (torch.float32 if compute_dtype is None
                                   else as_dtype(compute_dtype))
        if cd not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r} is not ported (float32 or "
                "bfloat16)")
        if kv_cache not in ("buffer", "int8"):
            raise ValueError(
                f"kv_cache must be 'buffer' or 'int8', got {kv_cache!r}")
        self.kv_cache = kv_cache
        if weight_dtype not in (None, "int8"):
            raise ValueError(
                f"weight_dtype must be None or 'int8', got {weight_dtype!r}")
        #: W8A16: int8 weight rows with channel-wise f32 scales
        self.weight_quant = weight_dtype == "int8"
        if beam_width < 1 or mb % beam_width:
            raise ValueError(
                f"beam_width={beam_width} must be >= 1 and divide "
                f"microbatch={mb} (each group's rows hold "
                "microbatch/beam_width sequences x beam_width beams)")
        self.beam_width = beam_width
        self.cuda_graphs = dev.type == "cuda"

        nodes = graph.nodes
        for req in ("embeddings", "final_ln", "lm_head"):
            if req not in nodes:
                raise ValueError(
                    f"decoder graphs must follow the gpt() node contract; "
                    f"missing {req!r} (models/gpt.py)")
        self.embed_op: GptEmbedding = nodes["embeddings"].op
        if max_len is None:
            max_len = self.embed_op.max_len  # the positional table's reach
        self.max_len = max_len
        if max_len > self.embed_op.max_len:
            raise ValueError(
                f"max_len {max_len} exceeds the model's positional table "
                f"({self.embed_op.max_len})")
        block_names = [nm for nm in graph.topo_order
                       if nm.startswith("block_")]
        self.block_names = block_names
        for nm in block_names:
            if not isinstance(nodes[nm].op, CausalTransformerBlock):
                raise TypeError(f"{nm} is not a CausalTransformerBlock")
        self.d_model = d = nodes[block_names[0]].out_spec.shape[-1]
        self.num_heads = nodes[block_names[0]].op.num_heads
        self.num_kv_heads = nodes[block_names[0]].op.kv_heads
        self.head_dim = d // self.num_heads
        self.vocab = nodes["lm_head"].out_spec.shape[-1]
        for nm in block_names:
            op = nodes[nm].op
            if (op.num_heads, op.kv_heads) != (self.num_heads,
                                               self.num_kv_heads):
                raise ValueError(
                    f"{nm} has heads ({op.num_heads}, kv {op.kv_heads}) "
                    f"!= block_0's ({self.num_heads}, "
                    f"{self.num_kv_heads}); the homogeneous cache needs "
                    "one head geometry")

        assign = _split_blocks(len(block_names), n)
        self.stage_blocks = [[block_names[i] for i in idxs]
                             for idxs in assign]
        self.l_max = max(len(b) for b in self.stage_blocks)
        self._stage_param_names = []
        for s in range(n):
            names = list(self.stage_blocks[s])
            if s == 0:
                names.insert(0, "embeddings")
            if s == n - 1:
                names += ["final_ln", "lm_head"]
            self._stage_param_names.append(names)

        # --- per-stage weight rows (in the compute dtype, or W8A16)
        self._paths: list = []
        self._wmeta: list = []
        self._smeta: list = []
        self._rows = [tuple(r.to(dev) for r in rows)
                      for rows in self._pack(params, init=True)]
        self._views = [None if self.weight_quant else
                       flatbuf.unflatten_leaves(
                           self._paths[s],
                           flatbuf.unpack_leaves(self._rows[s][0],
                                                 self._wmeta[s]))
                       for s in range(n)]

        # --- state the steps read and write in place (a graph holds it)
        self._cache_shape = (self.l_max, n, mb, self.num_kv_heads,
                             max_len + 1, self.head_dim)
        #: per-row f32 scales for the int8 cache (one per head x position)
        self._scale_shape = self._cache_shape[:-1]
        cdt = torch.int8 if kv_cache == "int8" else cd
        self.caches: dict[str, list[torch.Tensor]] = {
            "k": [torch.zeros(self._cache_shape, dtype=cdt, device=dev)
                  for _ in range(n)],
            "v": [torch.zeros(self._cache_shape, dtype=cdt, device=dev)
                  for _ in range(n)]}
        if kv_cache == "int8":
            for name in ("ks", "vs"):
                self.caches[name] = [torch.zeros(self._scale_shape,
                                                 device=dev)
                                     for _ in range(n)]
        #: ring width: beam mode adds a column carrying each row's parent
        self._ring_width = d + (1 if beam_width > 1 else 0)
        self._a = torch.zeros((n, mb, self._ring_width), device=dev)
        #: per-group cumulative beam scores (the last stage's ledger)
        self._beam_cum = torch.zeros((n, mb), device=dev)
        #: what arrived on the wrap link at each step of a unit
        self._emit = torch.zeros((n, mb, 2) if beam_width > 1 else (n, mb),
                                 device=dev)
        self._prompt = torch.zeros((n, mb, max_len), dtype=torch.int64,
                                   device=dev)
        self._first_ids = torch.zeros((n, mb), dtype=torch.int64, device=dev)

        def scalar(dtype=torch.int64):
            return torch.zeros((), dtype=dtype, device=dev)

        self._t, self._t_stop, self._plen = scalar(), scalar(), scalar()
        self._start, self._first_pos, self._seed = (scalar(), scalar(),
                                                    scalar())
        self._temp = scalar(torch.float32)

        #: captured graphs: ("decode", sample, top_k) and ("prefill",
        #: prompt_len, sample, top_k)
        self._graphs: dict[tuple, Any] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def _pack(self, params, *, init: bool = False) -> list[tuple]:
        """Each stage's rows (CPU tensors): ``(row,)``, or ``(q_row,
        scale_row)`` under W8A16.  With ``init=False`` (reweight) the new
        leaves must match the deployed paths, shapes and dtypes."""
        out = []
        for s, names in enumerate(self._stage_param_names):
            paths, leaves = flatbuf.flatten_leaves(
                {nm: params[nm] for nm in names})
            if init:
                self._paths.append(paths)
                self._wmeta.append(flatbuf.leaf_meta(leaves))
            else:
                flatbuf.check_layout(leaves, paths, self._wmeta[s],
                                     self._paths[s], f"reweight: stage {s}")
            leaves = [leaf.detach().cpu() for leaf in leaves]
            if not self.weight_quant:
                wdt = self.compute_dtype
                out.append((flatbuf.pack_leaves(leaves, self._wmeta[s], wdt,
                                                lambda a: a.to(wdt)),))
                continue
            q_row, s_row, smeta = flatbuf.quantize_leaves(leaves,
                                                          self._wmeta[s])
            if init:
                self._smeta.append(smeta)
            out.append((q_row, s_row))
        return out

    def reweight(self, params) -> None:
        """Install fresh weights into the deployed rows, in place: captured
        graphs keep serving, now with the new weights, and the caches are
        untouched.  Every stage is packed and checked before any row is
        copied.  Call between ``generate`` rounds."""
        rows = self._pack(params, init=False)
        with torch.inference_mode():
            for dst, src in zip(self._rows, rows):
                for d_row, s_row in zip(dst, src):
                    d_row.copy_(s_row)

    def _stage_params(self, s: int) -> dict:
        if not self.weight_quant:
            return self._views[s]
        q_row, s_row = self._rows[s]
        return flatbuf.unflatten_leaves(
            self._paths[s], flatbuf.unpack_quant_leaves(
                q_row, s_row, self._wmeta[s], self._smeta[s],
                self.compute_dtype))

    # ------------------------------------------------------------------
    # one decode step of one stage, and a unit of N steps
    # ------------------------------------------------------------------

    def _branch(self, s: int, g: int, a: torch.Tensor, t: torch.Tensor,
                sample: bool, top_k: int | None) -> torch.Tensor:
        """Stage ``s`` at step ``t`` on its ring slot ``a`` [mb, width],
        serving group ``g`` (static: ``(t - s) mod N``).  Returns the slot
        it sends on; caches and the beam ledger are updated in place."""
        n, mb, d = self.num_stages, self.microbatch, self.d_model
        nodes = self.graph.nodes
        cd = self.compute_dtype
        is_first, is_last = s == 0, s == n - 1
        beam = self.beam_width
        p = self._stage_params(s)
        # warm-up skew (t < s) and steps at or past t_stop are bubbles:
        # they write the cache's scratch row, and nothing reads their output
        rel = t - s
        live = (rel >= 0) & (t < self._t_stop)
        pos = torch.where(live, self._start + rel.div(n, rounding_mode="floor"),
                          -1)
        valid = (pos >= 0) & (pos < self.max_len)
        safe_pos = pos.clamp(0, self.max_len - 1)
        write_pos = torch.where(valid, safe_pos, self.max_len)
        # this stage's caches of group g: views [Lmax, mb, ...]
        caches = {name: cs[s][:, g] for name, cs in self.caches.items()}

        if beam > 1:
            # re-parent this group's cache rows before appending: the
            # incoming activation came from the CHOSEN beam's token.  Only
            # beam-expansion arrivals (pos >= plen, non-bubble) carry real
            # parents; elsewhere the gather is the identity
            parents = a[:, d].round().long().clamp(0, mb - 1)
            applies = valid & (safe_pos >= self._plen)
            parents = torch.where(applies, parents,
                                  torch.arange(mb, device=a.device))
            for c in caches.values():
                c.copy_(c.index_select(1, parents))

        if is_first:
            recv_ids = a[:, 0].round().long()
            prompt_ids = self._prompt[g].index_select(
                1, safe_pos.reshape(1))[:, 0]
            ids = torch.where(safe_pos < self._plen, prompt_ids, recv_ids)
            # after a fused prefill the first generated token comes from
            # the prefill, not the ring (first_pos = -1 disables)
            ids = torch.where(safe_pos == self._first_pos,
                              self._first_ids[g], ids)
            x = self.embed_op.embed_at(p["embeddings"], ids,
                                       safe_pos).to(cd)
        else:
            x = a[:, :d].to(cd)

        for l, nm in enumerate(self.stage_blocks[s]):
            if self.kv_cache == "int8":
                x = nodes[nm].op.decode(
                    p[nm], x, caches["k"][l], caches["v"][l], write_pos,
                    caches["ks"][l], caches["vs"][l])[0]
            else:
                x = nodes[nm].op.decode(p[nm], x, caches["k"][l],
                                        caches["v"][l], write_pos)[0]

        if not is_last:
            out = x.to(torch.float32)
            if beam > 1:
                # pass the incoming parent column on unchanged: every
                # stage re-derives applicability from pos
                out = torch.cat([out, a[:, d:]], dim=-1)
            return out
        h = nodes["final_ln"].op.apply(p["final_ln"], x)
        logits = nodes["lm_head"].op.apply(p["lm_head"], h).to(torch.float32)
        out = torch.zeros((mb, self._ring_width), device=a.device)
        if beam > 1:
            # beam expansion: per sequence, the best `beam` of beam*V
            # continuations by cumulative log-probability
            nseq, vocab = mb // beam, logits.shape[-1]
            cum = self._beam_cum[g]
            sc = (cum.view(nseq, beam, 1)
                  + logits.log_softmax(dim=-1).view(nseq, beam, vocab))
            # first expansion: every beam of a sequence is the same
            # prompt, so only beam 0's continuations count
            dup = (safe_pos == self._plen - 1) & (
                torch.arange(beam, device=a.device)[None, :, None] > 0)
            sc = sc.masked_fill(dup, -math.inf)
            best, idx = sc.view(nseq, beam * vocab).topk(beam, dim=-1)
            ids = (idx % vocab).view(mb)
            par = (torch.arange(nseq, device=a.device)[:, None] * beam
                   + idx.div(vocab, rounding_mode="floor")).view(mb)
            # forced prompt steps keep the identity and the scores;
            # bubbles leave the ledger untouched
            forced = safe_pos < self._plen - 1
            ids = torch.where(forced, logits.argmax(dim=-1), ids)
            par = torch.where(forced, torch.arange(mb, device=a.device),
                              par)
            keep = forced | ~valid
            self._beam_cum[g].copy_(torch.where(keep, cum, best.view(mb)))
            out[:, d] = par.to(torch.float32)
        elif sample:
            # keyed by the global step: the same under any chunking
            ids = _sample_ids(logits, self._temp, top_k, self._seed, t)
        else:
            ids = logits.argmax(dim=-1)
        out[:, 0] = ids.to(torch.float32)
        return out

    def _unit(self, sample: bool, top_k: int | None) -> None:
        """N steps from ``self._t`` (a multiple of N): each step runs every
        stage on its slot, then rotates the ring; what arrives on the wrap
        link at step j lands in ``self._emit[j]``."""
        n, d = self.num_stages, self.d_model
        a = self._a
        for j in range(n):
            t = self._t + j
            y = torch.empty_like(a)
            for s in range(n):
                y[s] = self._branch(s, (j - s) % n, a[s], t, sample, top_k)
            a = torch.roll(y, 1, 0)
            if self.beam_width > 1:
                self._emit[j, :, 0] = a[0, :, 0]
                self._emit[j, :, 1] = a[0, :, d]
            else:
                self._emit[j] = a[0, :, 0]
        self._a.copy_(a)
        self._t += n

    # ------------------------------------------------------------------
    # the fused prefill
    # ------------------------------------------------------------------

    def _prefill_stage(self, s: int, g: int, x, plen: int, sample: bool,
                       top_k: int | None):
        """Stage ``s`` on group ``g``'s whole prompt: each block runs the
        full-sequence causal forward (``apply_with_kv``, the flash kernel)
        and bulk-writes cache rows ``0..plen-1``; the last stage writes the
        group's first generated token (position ``plen``) to
        ``self._first_ids``.  ``x`` comes in float32, as on the ring."""
        nodes = self.graph.nodes
        cd = self.compute_dtype
        mb, kvh, hd = self.microbatch, self.num_kv_heads, self.head_dim
        p = self._stage_params(s)
        if s == 0:
            x = self.embed_op.apply(p["embeddings"],
                                    self._prompt[g, :, :plen]).to(cd)
        else:
            x = x.to(cd)
        for l, nm in enumerate(self.stage_blocks[s]):
            op = nodes[nm].op
            x, k, v = op.apply_with_kv(p[nm], x)
            # head-major relayout (one transpose per prompt)
            k = k.reshape(mb, plen, kvh, hd).transpose(1, 2)
            v = v.reshape(mb, plen, kvh, hd).transpose(1, 2)
            if self.kv_cache == "int8":
                k, ks = op.quantize_row(k)  # [mb, kv, plen] scales
                v, vs = op.quantize_row(v)
                self.caches["ks"][s][l, g, :, :, :plen] = ks
                self.caches["vs"][s][l, g, :, :, :plen] = vs
            self.caches["k"][s][l, g, :, :, :plen] = k
            self.caches["v"][s][l, g, :, :, :plen] = v
        if s < self.num_stages - 1:
            return x.to(torch.float32)
        h = nodes["final_ln"].op.apply(p["final_ln"], x[:, -1])
        logits = nodes["lm_head"].op.apply(p["lm_head"], h).to(torch.float32)
        if sample:
            # key domain disjoint from the decode steps'
            ids = _sample_ids(logits, self._temp, top_k, self._seed,
                              PREFILL_KEY + g)
        else:
            ids = logits.argmax(dim=-1)
        self._first_ids[g] = ids
        return None

    def _prefill(self, plen: int, sample: bool, top_k: int | None) -> None:
        """The pipelined prefill schedule: ``2N-1`` steps, stage s serving
        group ``t - s`` at step t.  Only the N*N live stage-steps run; the
        JAX program's bubble steps write a scratch group and change no
        result."""
        n = self.num_stages
        xs: list = [None] * n
        for t in range(2 * n - 1):
            for s in range(n):
                if 0 <= t - s < n:
                    xs[t - s] = self._prefill_stage(s, t - s, xs[t - s],
                                                    plen, sample, top_k)

    # ------------------------------------------------------------------
    # running: graphs or eager
    # ------------------------------------------------------------------

    def _fn(self, key: tuple):
        if key[0] == "decode":
            return lambda: self._unit(*key[1:])
        return lambda: self._prefill(*key[1:])

    def _prepare(self, keys: list[tuple]) -> None:
        """Capture the graphs ``keys`` name that are not captured yet (on
        the card), then reset the state: the captures' warm-up passes
        write it."""
        if self.cuda_graphs:
            for key in keys:
                if key not in self._graphs:
                    t0 = time.perf_counter()
                    g = self._graphs[key] = capture(self._fn(key),
                                                    self.device)
                    self.capture_s += time.perf_counter() - t0
                    self.captures += 1
                    self.graph_pool_bytes += g.pool_bytes
        with torch.inference_mode():
            self._a.zero_()
            self._beam_cum.zero_()
            self._first_ids.zero_()
            self._t.zero_()
            for cs in self.caches.values():
                for c in cs:
                    c.zero_()

    def _run(self, key: tuple) -> None:
        if self.cuda_graphs:
            self._graphs[key].replay()
            return
        with torch.inference_mode():
            self._fn(key)()

    def _dispatch(self, key: tuple, units: int) -> torch.Tensor:
        """``units`` units back to back (no host sync); the wrap link's
        ids for each step, ``[units*N, mb(, 2)]`` on the device."""
        emits = []
        for _ in range(units):
            self._run(key)
            emits.append(self._emit.clone())
        return torch.cat(emits)

    def _load(self, prompt: np.ndarray, plen: int, seed: int,
              temperature: float) -> None:
        """The prompts and the per-call scalars into their device
        tensors."""
        with torch.inference_mode():
            self._prompt[:, :, :plen] = torch.from_numpy(prompt)
            self._plen.fill_(plen)
            self._seed.fill_(seed)
            self._temp.fill_(float(temperature))

    def _set_schedule(self, t_stop: int, start: int, first_pos: int) -> None:
        with torch.inference_mode():
            self._t_stop.fill_(t_stop)
            self._start.fill_(start)
            self._first_pos.fill_(first_pos)

    # ------------------------------------------------------------------
    # the schedule on the host
    # ------------------------------------------------------------------

    def _schedule(self, t_tok: int, start: int,
                  token_chunk: int | None) -> tuple[int, int]:
        """(num_steps, chunk_steps) for decoding positions (start, t_tok).

        The last needed step emits position t_tok-1 of the last group:
        ``(n-1) + n*(t_tok-2-start) + (n-1)``; one schedule shared by the
        greedy/sampling and beam paths."""
        n = self.num_stages
        num_steps = (n - 1) + n * (t_tok - 2 - start) + (n - 1) + 1 \
            if t_tok - 1 > start else 0
        chunk_steps = max(num_steps, n) if token_chunk is None \
            else max(n, n * int(token_chunk))
        return num_steps, chunk_steps

    def _gather_init(self, prompt: np.ndarray, plen: int, t_tok: int,
                     start: int,
                     first_ids: np.ndarray | None) -> tuple[np.ndarray, int]:
        """Token output skeleton + the first position decode steps fill."""
        n, mb = self.num_stages, self.microbatch
        out = np.zeros((n, mb, t_tok), np.int64)
        out[:, :, :plen] = prompt[:, :, :plen]
        if first_ids is not None and start < t_tok:
            out[:, :, start] = first_ids.astype(np.int64)
            return out, start + 1
        return out, max(1, plen)

    def _gather_into(self, out: np.ndarray, ids_steps: np.ndarray,
                     t0: int, t_tok: int, start: int, p0: int) -> None:
        """Scatter one chunk of emitted wrap-link ids into ``out``.

        Each decode step t >= n-1 emits exactly one (group, position):
        ``g = (t - (n-1)) % n``, ``p = start + 1 + (t - (n-1) - g) // n``
        — the inverse of "token p of group g is sampled at step
        (n-1) + n*(p-1-start) + g".
        """
        n = self.num_stages
        for i in range(ids_steps.shape[0]):
            t = t0 + i
            if t < n - 1:
                continue
            g = (t - (n - 1)) % n
            p = start + 1 + (t - (n - 1) - g) // n
            if p0 <= p < t_tok:
                out[g, :, p] = ids_steps[i].astype(np.int64)

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int | None = None,
                 seed: int = 0, eos_id: int | None = None,
                 token_chunk: int | None = None,
                 prefill: bool = False,
                 on_tokens=None) -> np.ndarray:
        """Decode ``max_new_tokens`` past each prompt.

        ``prompt_ids``: [B, prompt_len] ints, B % microbatch == 0; batches
        beyond one pipeline fill (num_stages * microbatch) run in
        successive rounds, round ``lo`` with seed ``seed + lo``.  All
        prompts share one length.  Returns [B, prompt_len +
        max_new_tokens].

        ``temperature=0`` is greedy argmax; ``temperature>0`` samples the
        softmax (optionally truncated to ``top_k``), keyed by ``(seed,
        step)`` so results do not depend on dispatch chunking.
        ``token_chunk`` splits the steps into dispatches of that many
        tokens per group (the default is the whole generation in one
        dispatch).  ``eos_id`` stops early once every sequence has emitted
        it and fills the tail with ``eos_id``.  ``prefill=True`` seeds the
        caches with the fused full-sequence prefill instead of decode-rate
        teacher forcing (greedy results equal up to float reduction order;
        sampled results draw the first token under another key).

        ``on_tokens(lo, hi, tokens, rows=(r0, r1))`` streams newly
        decodable positions after each dispatch: ``tokens`` is [r1-r0,
        hi-lo] for positions [lo, hi) of sequence rows [r0, r1).  With
        ``eos_id``, streamed tokens past a sequence's EOS are garbage the
        final result replaces with ``eos_id``.
        """
        prompt_ids = np.asarray(prompt_ids)
        if prompt_ids.ndim != 2:
            raise ValueError("prompt_ids must be [B, prompt_len]")
        b, plen = prompt_ids.shape
        if plen < 1:
            raise ValueError("prompt must contain at least one token "
                             "(position 0 has nothing to condition on)")
        n, mb = self.num_stages, self.microbatch
        if self.beam_width > 1:
            if prefill or eos_id is not None or float(temperature) > 0:
                raise ValueError(
                    "beam search currently composes with neither prefill, "
                    "eos_id, nor temperature sampling")
            if on_tokens is not None:
                raise ValueError(
                    "beam search cannot stream tokens (sequences are only "
                    "final after the last re-parenting)")
            return self._generate_beam(prompt_ids, max_new_tokens,
                                       token_chunk=token_chunk)
        if b % mb or b == 0:
            raise ValueError(
                f"B={b} must be a non-zero multiple of microbatch={mb}")
        if b > n * mb:
            # more sequences than one pipeline fill: successive rounds,
            # each with its own seed (identical prompts in two rounds must
            # not sample identical continuations)
            outs = []
            for lo in range(0, b, n * mb):
                cb = None
                if on_tokens is not None:
                    def cb(a, c, t, rows, _lo=lo):  # noqa: E306
                        on_tokens(a, c, t,
                                  rows=(_lo + rows[0], _lo + rows[1]))
                outs.append(self.generate(
                    prompt_ids[lo: lo + n * mb], max_new_tokens,
                    temperature=temperature, top_k=top_k, seed=seed + lo,
                    eos_id=eos_id, token_chunk=token_chunk,
                    prefill=prefill, on_tokens=cb))
            return np.concatenate(outs, axis=0)
        t_tok = plen + max_new_tokens
        if t_tok > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {t_tok} exceeds "
                f"max_len={self.max_len}")

        prompt = np.zeros((n, mb, plen), np.int64)
        prompt.reshape(n * mb, plen)[:b] = prompt_ids
        if t_tok == plen:
            return prompt.reshape(n * mb, plen)[:b].copy()
        sample = float(temperature) > 0.0
        if not sample:
            top_k = None  # unused by argmax: one graph serves every greedy call
        start = plen if prefill else 0
        num_steps, chunk_steps = self._schedule(t_tok, start, token_chunk)
        units = -(-chunk_steps // n)
        dkey = ("decode", sample, top_k)
        pkey = ("prefill", plen, sample, top_k)
        self._load(prompt, plen, seed, temperature)
        self._prepare(([pkey] if prefill else [])
                      + ([dkey] if num_steps else []))

        first_ids_np = None
        if prefill:
            self._run(pkey)
            first_ids_np = self._first_ids.cpu().numpy()
        self._set_schedule(num_steps, start, plen if prefill else -1)

        chunks: list = []  # device chunks (batch path), read at the end
        out3, p0 = self._gather_init(prompt, plen, t_tok, start,
                                     first_ids_np)
        incremental = eos_id is not None or on_tokens is not None
        p_done = plen - 1  # last position already delivered to on_tokens
        if on_tokens is not None and prefill and t_tok > plen:
            # the prefill already produced position plen (first_ids)
            flat = out3.reshape(n * mb, t_tok)[:b]
            on_tokens(plen, plen + 1, flat[:, plen: plen + 1].copy(),
                      rows=(0, b))
            p_done = plen
        steps_run = 0
        dec_count = REGISTRY.counter("decode.dispatches")
        dec_hist = REGISTRY.histogram("decode.dispatch_s")
        tr = tracer()
        while steps_run < num_steps:
            t0_disp = time.perf_counter()
            ids = self._dispatch(dkey, units)
            dt_disp = time.perf_counter() - t0_disp
            dec_count.n += 1
            dec_hist.record(dt_disp)
            if tr.enabled:
                tr.record("decode.chunk", t0_disp, dt_disp,
                          {"steps_run": steps_run,
                           "chunk_steps": units * n})
            if incremental:
                # incremental scatter of just this chunk: linear host work
                self._gather_into(out3, ids.cpu().numpy(), steps_run,
                                  t_tok, start, p0)
            else:
                chunks.append(ids)
            steps_run += units * n
            if incremental:
                # positions already decodable for EVERY group this far
                p_avail = start + min(
                    (steps_run - 1 - (n - 1) - g) // n + 1
                    for g in range(n))
                p_avail = min(p_avail, t_tok - 1)
                flat = out3.reshape(n * mb, t_tok)[:b]
                if on_tokens is not None and p_avail > p_done \
                        and p_avail >= plen:
                    lo = max(p_done + 1, plen)
                    on_tokens(lo, p_avail + 1,
                              flat[:, lo: p_avail + 1].copy(),
                              rows=(0, b))
                    p_done = p_avail
                if eos_id is not None and p_avail >= plen and np.all(
                        (flat[:, plen: p_avail + 1] == eos_id).any(axis=1)):
                    break
        if chunks:  # non-incremental: one read and one pass at the end
            self._gather_into(out3, torch.cat(chunks).cpu().numpy(), 0,
                              t_tok, start, p0)
        out = out3.reshape(n * mb, t_tok)[:b]
        if eos_id is not None:
            # freeze everything after each sequence's first generated EOS
            gen = out[:, plen:]
            hit = gen == eos_id
            first = np.where(hit.any(1), hit.argmax(1), gen.shape[1])
            mask = np.arange(gen.shape[1])[None, :] > first[:, None]
            gen[mask] = eos_id
        return out

    def _generate_beam(self, prompt_ids: np.ndarray, max_new_tokens: int,
                       *, token_chunk: int | None) -> np.ndarray:
        """Pipelined beam search; returns each prompt's best sequence.

        Each prompt occupies ``beam_width`` adjacent microbatch rows.  The
        last stage expands beams (top ``beam`` of beam*V continuations by
        cumulative log-probability, duplicate-masked on the first
        expansion) and the chosen parent indices ride the ring's extra
        column so every stage re-parents its cache rows before appending
        (``_branch``).  The host backtracks the recorded (token, parent)
        pairs and picks the best final beam per prompt.
        """
        n, mb, beam = self.num_stages, self.microbatch, self.beam_width
        b, plen = prompt_ids.shape
        nspg = mb // beam  # sequences per group
        if b % nspg or b == 0:
            raise ValueError(
                f"B={b} must be a non-zero multiple of "
                f"microbatch/beam_width = {nspg}")
        if b > n * nspg:
            return np.concatenate(
                [self._generate_beam(prompt_ids[lo: lo + n * nspg],
                                     max_new_tokens,
                                     token_chunk=token_chunk)
                 for lo in range(0, b, n * nspg)], axis=0)
        t_tok = plen + max_new_tokens
        if t_tok > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {t_tok} exceeds "
                f"max_len={self.max_len}")

        # each prompt duplicated over its beam rows
        rows = np.repeat(prompt_ids, beam, axis=0)
        prompt = np.zeros((n, mb, plen), np.int64)
        prompt.reshape(n * mb, plen)[: rows.shape[0]] = rows
        if t_tok == plen:
            return prompt_ids.astype(np.int64)

        num_steps, chunk_steps = self._schedule(t_tok, 0, token_chunk)
        units = -(-chunk_steps // n)
        key = ("decode", False, None)
        self._load(prompt, plen, 0, 0.0)
        self._prepare([key])
        self._set_schedule(num_steps, 0, -1)
        chunks = []
        steps_run = 0
        while steps_run < num_steps:
            chunks.append(self._dispatch(key, units))
            steps_run += units * n
        arr = torch.cat(chunks).cpu().numpy()
        toks = np.round(arr[..., 0]).astype(np.int64)   # [T, mb]
        pars = np.round(arr[..., 1]).astype(np.int64)
        cum = self._beam_cum.cpu().numpy()              # [n_groups, mb]

        out = np.zeros((b, t_tok), np.int64)
        out[:, :plen] = prompt_ids
        for s in range(b):
            g, si = divmod(s, nspg)
            row_lo = si * beam
            r = row_lo + int(np.argmax(cum[g, row_lo: row_lo + beam]))
            for p in range(t_tok - 1, plen - 1, -1):
                t = (n - 1) + n * (p - 1) + g
                out[s, p] = toks[t, r]
                r = int(pars[t, r])
        return out
