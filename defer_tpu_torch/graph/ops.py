"""Layer op library: the port of ``defer_tpu.graph.ops``.

Conventions:

  * The public surface is NHWC, as in the JAX package, so the same input
    arrays feed both packages.  Inside, an NHWC tensor is viewed as NCHW
    with ``permute(0, 3, 1, 2)`` — which is PyTorch's ``channels_last``
    memory format — and handed to the library call; its channels_last
    result is permuted back.  Neither direction copies.
  * Conv weights are OIHW (depthwise ``[c, 1, k, k]``), PyTorch's layout
    (the JAX package's HWIO weights convert in ``utils/convert.py`` and
    nowhere else).
  * ``"SAME"`` padding follows XLA's rule; where it is asymmetric (stride
    2, even kernels) the op pads explicitly with ``F.pad`` — zeros for
    convolutions and average pools, ``-inf`` for max pools.
  * ``apply`` computes in the incoming activation dtype (params cast to
    it).  Convolution, matmul and pooling are PyTorch's library calls
    (cuDNN / cuBLAS on the card), as the JAX package leaves them to XLA.
  * BatchNorm is inference-mode, in the JAX package's formula.
  * Attention goes through ``ops.flash_attention``: the hand-written Hopper
    kernel for a CUDA tensor, its plain PyTorch version on the CPU.
  * Tensor parallelism (``parallel/tensor.py``): ``Dense`` and
    ``TransformerBlock`` shard their weights Megatron-style
    (``tp_shard``/``tp_unshard``) and ``tp_apply`` loops over the ranks
    it is given (a ``parallel.mesh.ModelLine``'s: this process's, where
    the line crosses processes), summing partial products with the line's
    psum; every other op keeps the replicated default of ``graph/ir.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .ir import Op, as_dtype, tree_map


def _device(gen: torch.Generator | None) -> torch.device:
    """Where ``init`` draws: the generator's device, or ``meta`` for shape
    inference (``gen=None``)."""
    return gen.device if gen is not None else torch.device("meta")


def _normal(gen, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=_device(gen))


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=_device(gen)) \
        * (hi - lo) + lo


def _full(gen, shape, value: float) -> torch.Tensor:
    return torch.full(shape, value, device=_device(gen))


def _cast(p: dict, dtype: torch.dtype) -> dict:
    return tree_map(lambda v: v.to(dtype), p)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` rule on one spatial axis: ``out = ceil(size / s)``,
    ``total = max((out - 1) * s + k - size, 0)``, ``(total // 2, total -
    total // 2)`` — the larger half after the data, so it is asymmetric
    at stride 2 and for even kernels."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(padding, hw, kernel, stride) -> tuple[tuple[int, int], ...]:
    """``((top, bottom), (left, right))`` for ``"SAME"``/``"VALID"`` (in
    either case, as ``lax`` accepts them) or an explicit symmetric
    ``(ph, pw)``, for an input of spatial size ``hw``."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0), (0, 0))
        if mode == "SAME":
            return tuple(_same_pad(n, k, s) for n, k, s in
                         zip(hw, _pair(kernel), _pair(stride)))
        raise ValueError(f"padding must be 'SAME', 'VALID' or (ph, pw), "
                         f"got {padding!r}")
    ph, pw = padding
    return ((ph, ph), (pw, pw))


def _padded(x: torch.Tensor, pads, value: float = 0.0):
    """NCHW ``x`` and the padding argument for the library call: the
    symmetric pads go to the call (``(ph, pw)``); asymmetric ones are
    applied here with ``F.pad`` (``value`` fills) and the call gets 0."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# dense / conv
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class Dense(Op):
    features: int
    use_bias: bool = True

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        scale = 1.0 / math.sqrt(d)
        p = {"w": _uniform(gen, (d, self.features), -scale, scale)}
        if self.use_bias:
            p["b"] = _full(gen, (self.features,), 0.0)
        return p

    def apply(self, params, x):
        return self.tp_apply([params], [x])[0]

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        return 2 * spec.size * self.features

    # -- tensor parallelism: row-parallel (input dim sharded, one psum) ----

    def tp_shard(self, params, tp, rank):
        w = params["w"]
        d = w.shape[0]
        if d % tp:
            raise ValueError(f"Dense input dim {d} not divisible by tp={tp}")
        blk = d // tp
        out = {"w": w[rank * blk:(rank + 1) * blk]}
        if self.use_bias:
            out["b"] = params["b"]  # replicated; added once after the psum
        return out

    def tp_apply(self, params, x, *, tp=1):
        """Each rank multiplies its block of the input by its rows of
        ``w``, one psum over the line (``tp``, see ``Op.tp_apply``), the
        bias once; one rank is :meth:`apply` (the psum of one tensor is
        that tensor)."""
        from ..parallel.mesh import ModelLine
        line = ModelLine.of(tp, len(params))
        ps = [_cast(p, xr.dtype) for p, xr in zip(params, x)]
        blk = ps[0]["w"].shape[0]
        ys = line.psum([xr[..., r * blk:(r + 1) * blk] @ p["w"]
                        for r, p, xr in zip(line.ranks, ps, x)])
        if self.use_bias:
            ys = [y + p["b"] for y, p in zip(ys, ps)]
        return ys

    def tp_unshard(self, shards):
        out = {"w": torch.cat([s["w"] for s in shards], dim=0)}
        if self.use_bias:
            out["b"] = shards[0]["b"]  # replicated
        return out


@dataclasses.dataclass(frozen=True, repr=False)
class Conv2D(Op):
    features: int
    kernel: int | tuple[int, int] = 3
    stride: int | tuple[int, int] = 1
    #: "SAME"/"VALID" (XLA's rule, asymmetric at stride 2), or an explicit
    #: symmetric (ph, pw) pad — torch's convention, which ResNet's and
    #: MobileNetV2's convs use
    padding: str | tuple[int, int] = "SAME"
    use_bias: bool = True
    groups: int = 1

    def init(self, gen, in_specs):
        (spec,) = in_specs
        kh, kw = _pair(self.kernel)
        cin = spec.shape[-1]
        fan_in = kh * kw * cin // self.groups
        p = {"w": _normal(gen, (self.features, cin // self.groups, kh, kw))
             * math.sqrt(2.0 / fan_in)}
        if self.use_bias:
            p["b"] = _full(gen, (self.features,), 0.0)
        return p

    def apply(self, params, x):
        return _conv(_cast(params, x.dtype), x, self.kernel, self.stride,
                     self.padding, self.groups)

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        kh, kw = _pair(self.kernel)
        cin = spec.shape[-1]
        return 2 * out_spec.size * kh * kw * cin // self.groups


def _conv(p: dict, x: torch.Tensor, kernel, stride, padding,
          groups: int) -> torch.Tensor:
    """NHWC ``x`` through ``F.conv2d`` (zero padding)."""
    xc, pad = _padded(_nchw(x), _pads(padding, x.shape[1:3], kernel, stride))
    return _nhwc(F.conv2d(xc, p["w"], p.get("b"), _pair(stride), pad,
                          groups=groups))


@dataclasses.dataclass(frozen=True, repr=False)
class DepthwiseConv2D(Op):
    """One ``k x k`` filter per channel: weights ``[c, 1, k, k]`` (the JAX
    package's HWIO ``[k, k, 1, c]``), ``F.conv2d`` with ``groups=c``."""

    kernel: int = 3
    stride: int = 1
    #: "SAME"/"VALID" or explicit symmetric (ph, pw) — see Conv2D.padding
    padding: str | tuple[int, int] = "SAME"
    use_bias: bool = False  # enabled by the BatchNorm-folding pass

    def init(self, gen, in_specs):
        (spec,) = in_specs
        c = spec.shape[-1]
        k = self.kernel
        p = {"w": _normal(gen, (c, 1, k, k)) * math.sqrt(2.0 / (k * k))}
        if self.use_bias:
            p["b"] = _full(gen, (c,), 0.0)
        return p

    def apply(self, params, x):
        return _conv(_cast(params, x.dtype), x, self.kernel, self.stride,
                     self.padding, x.shape[-1])

    def flops(self, in_specs, out_spec):
        return 2 * out_spec.size * self.kernel * self.kernel


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class BatchNorm(Op):
    """Inference-mode batch norm (running statistics folded at apply)."""

    eps: float = 1e-5

    def init(self, gen, in_specs):
        (spec,) = in_specs
        c = spec.shape[-1]
        return {
            "scale": _full(gen, (c,), 1.0),
            "bias": _full(gen, (c,), 0.0),
            "mean": _full(gen, (c,), 0.0),
            "var": _full(gen, (c,), 1.0),
        }

    def apply(self, params, x):
        p = _cast(params, x.dtype)
        inv = torch.rsqrt(p["var"] + self.eps)
        return (x - p["mean"]) * (inv * p["scale"]) + p["bias"]


def _layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX package's formula, ``(x-mu) * rsqrt(var+eps) * scale +
    bias`` over the last axis (biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


@dataclasses.dataclass(frozen=True, repr=False)
class LayerNorm(Op):
    eps: float = 1e-6

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        return {"scale": _full(gen, (d,), 1.0), "bias": _full(gen, (d,), 0.0)}

    def apply(self, params, x):
        return _layer_norm(_cast(params, x.dtype), x, self.eps)


# ---------------------------------------------------------------------------
# activations / pooling / structural
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class Activation(Op):
    kind: str = "relu"  # relu | relu6 | gelu | swish | softmax | tanh

    def apply(self, params, x):
        del params
        if self.kind == "relu":
            return torch.relu(x)
        if self.kind == "relu6":
            return torch.clamp_max(torch.relu(x), 6)
        if self.kind == "gelu":
            # jax.nn.gelu defaults to the tanh approximation; F.gelu's
            # default is the exact erf form
            return F.gelu(x, approximate="tanh")
        if self.kind == "swish":
            return F.silu(x)
        if self.kind == "softmax":
            return torch.softmax(x, dim=-1)
        if self.kind == "tanh":
            return torch.tanh(x)
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True, repr=False)
class MaxPool(Op):
    window: int = 2
    stride: int | None = None
    #: "SAME"/"VALID" or explicit symmetric (ph, pw) — see Conv2D.padding;
    #: pads with -inf, as the reference's reduce_window does
    padding: str | tuple[int, int] = "VALID"

    def apply(self, params, x):
        del params
        s = self.stride or self.window
        xc, pad = _padded(_nchw(x), _pads(self.padding, x.shape[1:3],
                                          self.window, s), -math.inf)
        return _nhwc(F.max_pool2d(xc, self.window, s, pad))


@functools.lru_cache(maxsize=256)
def _window_counts(hw: tuple[int, int], window: int, stride: int,
                   padding: str) -> np.ndarray:
    """[1, H', W', 1] valid-element count per pooling window (XLA SAME/
    VALID semantics), as a host-side constant: the JAX package's own
    function, copied."""
    h, w = hw
    padding = padding.upper()  # lax accepts lowercase padding strings
    if padding == "VALID":
        oh = (h - window) // stride + 1
        ow = (w - window) // stride + 1
        return np.full((1, oh, ow, 1), float(window * window), np.float32)
    oh, ow = -(-h // stride), -(-w // stride)
    ph = max((oh - 1) * stride + window - h, 0)
    pw = max((ow - 1) * stride + window - w, 0)
    mask = np.zeros((h + ph, w + pw), np.float32)
    mask[ph // 2: ph // 2 + h, pw // 2: pw // 2 + w] = 1.0
    out = np.empty((oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            out[i, j] = mask[i * stride: i * stride + window,
                             j * stride: j * stride + window].sum()
    return out.reshape(1, oh, ow, 1)


@dataclasses.dataclass(frozen=True, repr=False)
class AvgPool(Op):
    window: int = 2
    stride: int | None = None
    padding: str = "VALID"
    #: True = divide by window**2 even where the window overlaps padding
    #: (torch ``avg_pool2d``'s default, used by torchvision InceptionV3's
    #: pool branches); False = divide by the valid-element count (XLA/
    #: Keras semantics).
    count_include_pad: bool = False

    def __post_init__(self):
        # the counts (one device copy per device and dtype) are per op
        object.__setattr__(self, "_counts", {})

    def apply(self, params, x):
        del params
        s = self.stride or self.window
        # the window sums (divisor 1), zero padding; torch's own
        # count_include_pad=False divides as JAX does only where the pads
        # are symmetric
        xc, pad = _padded(_nchw(x), _pads(self.padding, x.shape[1:3],
                                          self.window, s))
        summed = _nhwc(F.avg_pool2d(xc, self.window, s, pad,
                                    divisor_override=1))
        if self.count_include_pad:
            return summed / (self.window * self.window)
        return summed / self._device_counts(x)

    def _device_counts(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`_window_counts` on ``x``'s device in ``x``'s dtype,
        copied there once (the eager pass before a CUDA-graph capture
        makes the copy; the graph reads the cached tensor).  A trace
        (``torch.export``, ``utils/export.py``) takes the counts as a
        constant of its program and caches nothing: its tensors are fake.
        """
        s = self.stride or self.window
        key = (tuple(x.shape[1:3]), x.device, x.dtype)
        counts = self._counts.get(key)
        if counts is None:
            counts = torch.from_numpy(_window_counts(
                key[0], self.window, s, self.padding)).to(x.device, x.dtype)
            if not torch.compiler.is_compiling():
                self._counts[key] = counts
        return counts


@dataclasses.dataclass(frozen=True, repr=False)
class GlobalAvgPool(Op):
    def apply(self, params, x):
        del params
        return x.mean(dim=(1, 2))


@dataclasses.dataclass(frozen=True, repr=False)
class ZeroPad2D(Op):
    pad: int = 1

    def apply(self, params, x):
        del params
        p = self.pad
        return F.pad(x, (0, 0, p, p, p, p))


@dataclasses.dataclass(frozen=True, repr=False)
class Concat(Op):
    axis: int = -1

    def apply(self, params, *xs):
        del params
        # the NHWC tensors are views of channels_last storage, contiguous
        # in NHWC order, so the join is one copy into NHWC order
        return torch.cat(xs, dim=self.axis)


@dataclasses.dataclass(frozen=True, repr=False)
class Flatten(Op):
    """Flattens each sample in NHWC order (VGG's ``fc1`` weights are laid
    out for it)."""

    def apply(self, params, x):
        del params
        return x.reshape(x.shape[0], -1)


@dataclasses.dataclass(frozen=True, repr=False)
class Tile(Op):
    """Repeat the per-sample input ``reps`` times along a new leading
    axis — a cheap fat-activation producer (a broadcast view)."""

    reps: int = 2

    def apply(self, params, x):
        del params
        return x[:, None].expand((x.shape[0], self.reps) + x.shape[1:])


@dataclasses.dataclass(frozen=True, repr=False)
class Cast(Op):
    """Element dtype cast; ``dtype`` is the dtype's name, as in JAX."""

    dtype: str = "bfloat16"

    def apply(self, params, x):
        del params
        return x.to(as_dtype(self.dtype))


@dataclasses.dataclass(frozen=True, repr=False)
class ReduceMean(Op):
    """Mean over one per-sample axis — the matching fat-activation
    consumer (one read pass, thin output)."""

    axis: int = 1

    def apply(self, params, x):
        del params
        return x.mean(dim=self.axis)

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        return spec.size  # one add per reduced element


@dataclasses.dataclass(frozen=True, repr=False)
class Add(Op):
    """Residual merge — DEFER's canonical cut-point layer."""

    def apply(self, params, *xs):
        del params
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return y


# ---------------------------------------------------------------------------
# embeddings / transformer block (one node per block => BERT cut points)
# ---------------------------------------------------------------------------


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` under the JAX package's index rule: a negative id
    wraps once (``-1`` is the last row), then every id clamps into
    ``[0, rows)`` — for a 5-row table, ids ``[-1, 7, 2]`` give rows
    ``[4, 4, 2]``.  Plain indexing would raise on an out-of-range id (on
    the card, a device-side assert inside a captured graph); the decoder
    reads ids back off its float ring, bubbles included, so every
    embedding looks ids up here."""
    n = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


@dataclasses.dataclass(frozen=True, repr=False)
class Embedding(Op):
    """Table lookup; out-of-range ids follow :func:`take_rows`."""

    vocab: int
    features: int

    def init(self, gen, in_specs):
        del in_specs
        return {"table": _normal(gen, (self.vocab, self.features)) * 0.02}

    def apply(self, params, x):
        return take_rows(params["table"].to(torch.float32), x)


@dataclasses.dataclass(frozen=True, repr=False)
class TransformerBlock(Op):
    """Transformer encoder block as a single graph node.

    One node per block puts one block per pipeline stage in the BERT-Base
    12-stage configuration; every block output is a single-tensor cut.
    The large products (qkv, proj, fc1, fc2) are ``x @ w`` library calls,
    as the JAX package leaves them to XLA; attention is the port's flash
    kernel.
    """

    num_heads: int
    mlp_ratio: int = 4
    #: "auto" and "flash" = ``ops.flash_attention`` (the hand kernel on a
    #: CUDA tensor, its plain version on the CPU); "xla" = the plain
    #: einsum-softmax path that divides the scores by sqrt(head dim)
    attn_impl: str = "auto"
    #: "pre" (GPT-style: x + f(LN(x))) or "post" (original BERT:
    #: LN(x + f(x)))
    norm: str = "pre"
    ln_eps: float = 1e-6

    def __post_init__(self):
        if self.norm not in ("pre", "post"):
            raise ValueError(
                f"norm must be 'pre' or 'post', got {self.norm!r}")

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        h = self.mlp_ratio * d
        s = 1.0 / math.sqrt(d)

        def ln():
            return {"scale": _full(gen, (d,), 1.0),
                    "bias": _full(gen, (d,), 0.0)}

        def dense(fan_in, fan_out, scale):
            return {"w": _normal(gen, (fan_in, fan_out)) * scale,
                    "b": _full(gen, (fan_out,), 0.0)}

        return {"ln1": ln(), "qkv": dense(d, 3 * d, s),
                "proj": dense(d, d, s), "ln2": ln(),
                "fc1": dense(d, h, s), "fc2": dense(h, d, 1.0 / math.sqrt(h))}

    def _attend(self, q, k, v):
        """Scaled-dot-product attention on [b, nh, t, hd] (impl dispatch)."""
        impl = self.attn_impl
        if impl not in ("auto", "flash", "xla"):
            raise ValueError(
                f"attn_impl must be 'auto', 'flash' or 'xla', got {impl!r}")
        if impl != "xla":
            from ..ops.flash_attention import flash_attention
            return flash_attention(q, k, v)
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
        return torch.einsum("bhqk,bhkd->bhqd", att.softmax(dim=-1), v)

    def _split_qkv(self, qkv):
        """q/k/v column split of the fused projection, or of a tensor-
        parallel rank's share of it (subclass hook)."""
        return qkv.chunk(3, dim=-1)

    def _kv_head_count(self) -> int:
        """KV head count (subclass hook; GQA blocks return fewer)."""
        return self.num_heads

    def apply(self, params, x):
        return self.apply_with_kv(params, x)[0]

    def apply_with_kv(self, params, x):
        """Forward that also returns the raw K/V projections
        ([b, t, kv*hd], before the head split) for decode-cache seeding."""
        outs, ks, vs = self._rank_forward([params], [x])
        return outs[0], ks[0], vs[0]

    def _rank_forward(self, params, x, tp=1):
        """The block on each rank's shard (``params`` and ``x`` one per
        rank of ``tp``, see ``Op.tp_apply``), in two phases between its
        two psums over the line: each rank runs its ``num_heads / tp``
        query heads and its rows of the output projection, then, after the
        first psum, its column block of the MLP.  Returns the per-rank
        outputs and raw K/V projections.  With one rank the psums return
        their input: this is the whole block."""
        from ..parallel.mesh import ModelLine
        line = ModelLine.of(tp, len(params))
        tp = line.size
        ps = [_cast(p, xr.dtype) for p, xr in zip(params, x)]
        b, t, d = x[0].shape
        hd = d // self.num_heads
        nh = self.num_heads // tp           # local query heads
        kvh = self._kv_head_count() // tp   # local KV heads (GQA: fewer)
        eps = self.ln_eps
        post = self.norm == "post"

        partial, ks, vs = [], [], []
        for p, xr in zip(ps, x):
            y = xr if post else _layer_norm(p["ln1"], xr, eps)
            q, k, v = self._split_qkv(y @ p["qkv"]["w"] + p["qkv"]["b"])
            ks.append(k)
            vs.append(v)
            # head-split views (no copy): the kernel reads them by stride
            qh = q.reshape(b, t, nh, hd).transpose(1, 2)
            kh = k.reshape(b, t, kvh, hd).transpose(1, 2)
            vh = v.reshape(b, t, kvh, hd).transpose(1, 2)
            if kvh != nh:
                # broadcast each KV head over its query group (exact GQA)
                kh = kh.repeat_interleave(nh // kvh, dim=1)
                vh = vh.repeat_interleave(nh // kvh, dim=1)
            y = self._attend(qh, kh, vh).transpose(1, 2).reshape(
                b, t, nh * hd)
            partial.append(y @ p["proj"]["w"])
        mids, partial2 = [], []
        for p, xr, y in zip(ps, x, line.psum(partial)):
            y = y + p["proj"]["b"]
            h = _layer_norm(p["ln1"], xr + y, eps) if post else xr + y
            mids.append(h)
            y = h if post else _layer_norm(p["ln2"], h, eps)
            # post-LN (BERT) uses the exact erf GELU; pre-LN the tanh form
            y = F.gelu(y @ p["fc1"]["w"] + p["fc1"]["b"],
                       approximate="none" if post else "tanh")
            partial2.append(y @ p["fc2"]["w"])
        outs = []
        for p, h, y in zip(ps, mids, line.psum(partial2)):
            y = y + p["fc2"]["b"]
            outs.append(_layer_norm(p["ln2"], h + y, eps) if post
                        else h + y)
        return outs, ks, vs

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        t, d = spec.shape
        return 2 * t * d * (4 * d + 2 * self.mlp_ratio * d) + 4 * t * t * d

    # -- tensor parallelism: Megatron column->row pairing, heads sharded ---

    def tp_shard(self, params, tp, rank):
        nh, kv = self.num_heads, self._kv_head_count()
        if nh % tp or kv % tp:
            raise ValueError(
                f"heads={nh}/kv_heads={kv} not divisible by tp={tp} "
                f"(each rank must hold whole query groups)")
        d = params["qkv"]["w"].shape[0]
        hd = d // nh
        blk = d // tp                 # query columns per rank
        kvblk = (kv // tp) * hd       # K (and V) columns per rank
        # fused layout: [q (nh*hd) | k (kv*hd) | v (kv*hd)]; kv == nh
        # reduces to the classic Megatron equal-thirds slice
        q0, k0, v0 = 0, d, d + kv * hd

        def qkv_cols(a):
            # per-chunk column slice so each rank gets whole (query) heads
            return torch.cat(
                [a[..., q0 + rank * blk: q0 + (rank + 1) * blk],
                 a[..., k0 + rank * kvblk: k0 + (rank + 1) * kvblk],
                 a[..., v0 + rank * kvblk: v0 + (rank + 1) * kvblk]],
                dim=-1)

        return {
            "qkv": {"w": qkv_cols(params["qkv"]["w"]),
                    "b": qkv_cols(params["qkv"]["b"])},
            **self._tp_shard_common(params, tp, rank),
        }

    def _tp_shard_common(self, params, tp, rank):
        """The non-qkv Megatron shards (LNs replicated, proj rows, MLP
        column->row pair), shared by the MHA and GQA qkv schemes."""
        d = params["qkv"]["w"].shape[0]
        h = params["fc1"]["w"].shape[1]
        if h % tp:
            raise ValueError(f"mlp width {h} not divisible by tp={tp}")
        blk, hblk = d // tp, h // tp
        return {
            "ln1": params["ln1"],
            "proj": {"w": params["proj"]["w"][rank * blk:(rank + 1) * blk],
                     "b": params["proj"]["b"]},
            "ln2": params["ln2"],
            "fc1": {"w": params["fc1"]["w"][:, rank * hblk:(rank + 1) * hblk],
                    "b": params["fc1"]["b"][rank * hblk:(rank + 1) * hblk]},
            "fc2": {"w": params["fc2"]["w"][rank * hblk:(rank + 1) * hblk],
                    "b": params["fc2"]["b"]},
        }

    def tp_unshard(self, shards):
        """Inverse of :meth:`tp_shard`: each rank's query/K/V column groups
        back into the fused layout, proj/fc2 rows and fc1 columns back to
        full width; LNs and biases are replicated."""
        tp = len(shards)
        nh, kv = self.num_heads, self._kv_head_count()
        d = shards[0]["proj"]["w"].shape[1]
        hd = d // nh
        blk, kvblk = d // tp, (kv // tp) * hd

        def qkv_cat(key):
            qs, ks, vs = [], [], []
            for sh in shards:
                a = sh["qkv"][key]
                qs.append(a[..., :blk])
                ks.append(a[..., blk: blk + kvblk])
                vs.append(a[..., blk + kvblk:])
            return torch.cat(qs + ks + vs, dim=-1)

        return {
            "ln1": shards[0]["ln1"],
            "qkv": {"w": qkv_cat("w"), "b": qkv_cat("b")},
            "proj": {"w": torch.cat([sh["proj"]["w"] for sh in shards], 0),
                     "b": shards[0]["proj"]["b"]},
            "ln2": shards[0]["ln2"],
            "fc1": {"w": torch.cat([sh["fc1"]["w"] for sh in shards], 1),
                    "b": torch.cat([sh["fc1"]["b"] for sh in shards], 0)},
            "fc2": {"w": torch.cat([sh["fc2"]["w"] for sh in shards], 0),
                    "b": shards[0]["fc2"]["b"]},
        }

    def tp_apply(self, params, x, *, tp=1):
        return self._rank_forward(params, x, tp)[0]


# ---------------------------------------------------------------------------
# mixture of experts (expert parallelism rides parallel/expert.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class MoE(Op):
    """Switch-style top-1 mixture-of-experts FFN (with residual).

    ``apply`` evaluates every expert and masks (exact, as in the JAX
    package); expert weights are stacked ``[e, d, h]`` and ``[e, h, d]``.
    The expert-parallel path (experts sharded over an "expert" mesh axis,
    capacity-based ``all_to_all`` token dispatch) is
    :mod:`defer_tpu_torch.parallel.expert`, equal to ``apply`` whenever no
    token exceeds capacity.
    """

    num_experts: int
    hidden: int

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        e, h = self.num_experts, self.hidden
        return {
            "gate": _normal(gen, (d, e)) * 0.02,
            "fc1": {"w": _normal(gen, (e, d, h)) / math.sqrt(d),
                    "b": _full(gen, (e, h), 0.0)},
            "fc2": {"w": _normal(gen, (e, h, d)) / math.sqrt(h),
                    "b": _full(gen, (e, d), 0.0)},
        }

    def route(self, params, x):
        """Top-1 routing: (expert_id [b,t], gate_prob [b,t]); a tie goes to
        the first expert, as ``jnp.argmax`` breaks it."""
        logits = x @ params["gate"].to(x.dtype)
        probs = torch.softmax(logits, dim=-1)
        eid = logits.argmax(dim=-1)
        return eid, probs.gather(-1, eid[..., None])[..., 0]

    def expert_fn(self, params, x, eid: int):
        """Run local expert ``eid`` on tokens ``x`` [..., d]: ``params``
        holds stacked expert weights ``[E_local, ...]`` and ``eid`` indexes
        that local stack."""
        w1 = params["fc1"]["w"][eid].to(x.dtype)
        b1 = params["fc1"]["b"][eid].to(x.dtype)
        w2 = params["fc2"]["w"][eid].to(x.dtype)
        b2 = params["fc2"]["b"][eid].to(x.dtype)
        # jax.nn.gelu's default is the tanh form
        h = F.gelu(x @ w1 + b1, approximate="tanh")
        return h @ w2 + b2

    def apply(self, params, x):
        eid, pe = self.route(params, x)
        p = _cast({k: params[k] for k in ("fc1", "fc2")}, x.dtype)
        # jax.nn.gelu's default is the tanh form
        h1 = F.gelu(torch.einsum("btd,edh->bteh", x, p["fc1"]["w"])
                    + p["fc1"]["b"], approximate="tanh")
        y = torch.einsum("bteh,ehd->bted", h1, p["fc2"]["w"]) + p["fc2"]["b"]
        sel = F.one_hot(eid, self.num_experts).to(x.dtype)
        return x + (y * sel[..., None]).sum(dim=2) * pe[..., None]

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        t, d = spec.shape
        # effective top-1 cost: one expert per token
        return 2 * t * d * (2 * self.hidden) + 2 * t * d * self.num_experts


@dataclasses.dataclass(frozen=True, repr=False)
class ExpertBranch(Op):
    """One expert's branch of a branched mixture-of-experts layer: its own
    softmax gate weight times its FFN, ``probs[..., expert] * ffn(x)``.
    The region's join is an ``Add`` over the residual and every branch
    (the soft mixture ``x + sum_e p_e(x) * ffn_e(x)``)."""

    num_experts: int
    expert: int
    hidden: int

    def init(self, gen, in_specs):
        (spec,) = in_specs
        d = spec.shape[-1]
        return {
            "gate": _normal(gen, (d, self.num_experts)) * 0.02,
            "fc1": {"w": _normal(gen, (d, self.hidden)) / math.sqrt(d),
                    "b": _full(gen, (self.hidden,), 0.0)},
            "fc2": {"w": _normal(gen, (self.hidden, d))
                    / math.sqrt(self.hidden),
                    "b": _full(gen, (d,), 0.0)},
        }

    def apply(self, params, x):
        p = _cast(params, x.dtype)
        pe = torch.softmax(x @ p["gate"], dim=-1)[..., self.expert]
        h = F.gelu(x @ p["fc1"]["w"] + p["fc1"]["b"], approximate="tanh")
        return (h @ p["fc2"]["w"] + p["fc2"]["b"]) * pe[..., None]

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        t, d = spec.shape
        return 2 * t * d * (2 * self.hidden) + 2 * t * d * self.num_experts
