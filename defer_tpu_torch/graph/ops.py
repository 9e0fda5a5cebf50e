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
  * The tensor-parallel methods (``tp_shard``/``tp_apply``) are not ported
    yet (ROADMAP queue A15).
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
        p = _cast(params, x.dtype)
        y = x @ p["w"]
        if self.use_bias:
            y = y + p["b"]
        return y

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        return 2 * spec.size * self.features


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
        makes the copy; the graph reads the cached tensor)."""
        s = self.stride or self.window
        key = (tuple(x.shape[1:3]), x.device, x.dtype)
        if key not in self._counts:
            counts = _window_counts(key[0], self.window, s, self.padding)
            self._counts[key] = torch.from_numpy(counts).to(x.device,
                                                            x.dtype)
        return self._counts[key]


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
        """q/k/v column split of the fused projection (subclass hook)."""
        return qkv.chunk(3, dim=-1)

    def _kv_head_count(self) -> int:
        """KV head count (subclass hook; GQA blocks return fewer)."""
        return self.num_heads

    def apply(self, params, x):
        return self.apply_with_kv(params, x)[0]

    def apply_with_kv(self, params, x):
        """Forward that also returns the raw K/V projections
        ([b, t, kv*hd], before the head split) for decode-cache seeding."""
        p = _cast(params, x.dtype)
        b, t, d = x.shape
        nh = self.num_heads
        hd = d // nh
        kvh = self._kv_head_count()
        eps = self.ln_eps
        post = self.norm == "post"

        y = x if post else _layer_norm(p["ln1"], x, eps)
        qkv = y @ p["qkv"]["w"] + p["qkv"]["b"]
        q, k, v = self._split_qkv(qkv)
        # head-split views (no copy): the kernel reads them by stride
        qh = q.reshape(b, t, nh, hd).transpose(1, 2)
        kh = k.reshape(b, t, kvh, hd).transpose(1, 2)
        vh = v.reshape(b, t, kvh, hd).transpose(1, 2)
        if kvh != nh:
            # broadcast each KV head over its query group (exact GQA)
            kh = kh.repeat_interleave(nh // kvh, dim=1)
            vh = vh.repeat_interleave(nh // kvh, dim=1)
        y = self._attend(qh, kh, vh)
        y = y.transpose(1, 2).reshape(b, t, d)
        y = y @ p["proj"]["w"] + p["proj"]["b"]
        x = _layer_norm(p["ln1"], x + y, eps) if post else x + y

        y = x if post else _layer_norm(p["ln2"], x, eps)
        # post-LN (BERT) uses the exact erf GELU; pre-LN the tanh form
        y = F.gelu(y @ p["fc1"]["w"] + p["fc1"]["b"],
                   approximate="none" if post else "tanh")
        y = y @ p["fc2"]["w"] + p["fc2"]["b"]
        out = _layer_norm(p["ln2"], x + y, eps) if post else x + y
        return out, k, v

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        t, d = spec.shape
        return 2 * t * d * (4 * d + 2 * self.mlp_ratio * d) + 4 * t * t * d


# ---------------------------------------------------------------------------
# mixture of experts (the expert-parallel path waits for ROADMAP queue A15)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class MoE(Op):
    """Switch-style top-1 mixture-of-experts FFN (with residual).

    ``apply`` evaluates every expert and masks (exact, as in the JAX
    package); expert weights are stacked ``[e, d, h]`` and ``[e, h, d]``.
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
