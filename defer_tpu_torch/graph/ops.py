"""Layer op library: the ResNet, BERT and GPT subset of ``defer_tpu.graph.ops``.

Conventions:

  * The public surface is NHWC, as in the JAX package, so the same input
    arrays feed both packages.  Inside, an NHWC tensor is viewed as NCHW
    with ``permute(0, 3, 1, 2)`` — which is PyTorch's ``channels_last``
    memory format — and handed to the library call; its channels_last
    result is permuted back.  Neither direction copies.
  * Conv weights are OIHW, PyTorch's layout (the JAX package's HWIO
    weights convert in ``utils/convert.py`` and nowhere else).
  * ``apply`` computes in the incoming activation dtype (params cast to
    it).  Convolution, matmul and pooling are PyTorch's library calls
    (cuDNN / cuBLAS on the card), as the JAX package leaves them to XLA.
  * BatchNorm is inference-mode, in the JAX package's formula.
  * Attention goes through ``ops.flash_attention``: the hand-written Hopper
    kernel for a CUDA tensor, its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .ir import Op, tree_map


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


def _pads(padding) -> tuple[int, int]:
    """Symmetric ``(ph, pw)`` for ``"VALID"`` or an explicit ``(ph, pw)``.

    XLA's ``"SAME"`` pads asymmetrically at stride 2; no op of the ported
    models uses it (ResNet's convs pad explicitly), so it waits for the
    ops that do (ROADMAP queue A8)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0)
        raise NotImplementedError(
            f"padding {padding!r} is not ported yet (ROADMAP queue A8)")
    ph, pw = padding
    return (ph, pw)


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
    #: "VALID" or an explicit symmetric (ph, pw) pad (ResNet's convs use
    #: the explicit form); the reference's default "SAME" is not ported
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
        p = _cast(params, x.dtype)
        y = F.conv2d(_nchw(x), p["w"], p.get("b"), _pair(self.stride),
                     _pads(self.padding), groups=self.groups)
        return _nhwc(y)

    def flops(self, in_specs, out_spec):
        (spec,) = in_specs
        kh, kw = _pair(self.kernel)
        cin = spec.shape[-1]
        return 2 * out_spec.size * kh * kw * cin // self.groups


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
    kind: str = "relu"

    def apply(self, params, x):
        del params
        if self.kind == "relu":
            return torch.relu(x)
        if self.kind == "gelu":
            # jax.nn.gelu defaults to the tanh approximation; F.gelu's
            # default is the exact erf form
            return F.gelu(x, approximate="tanh")
        raise NotImplementedError(
            f"activation {self.kind!r} is not ported yet (ROADMAP queue A8)")


@dataclasses.dataclass(frozen=True, repr=False)
class MaxPool(Op):
    window: int = 2
    stride: int | None = None
    #: "VALID" or explicit symmetric (ph, pw); pads with -inf
    padding: str | tuple[int, int] = "VALID"

    def apply(self, params, x):
        del params
        # max_pool2d pads with -inf, as the reference's reduce_window does
        return _nhwc(F.max_pool2d(_nchw(x), self.window,
                                  self.stride or self.window,
                                  _pads(self.padding)))


@dataclasses.dataclass(frozen=True, repr=False)
class GlobalAvgPool(Op):
    def apply(self, params, x):
        del params
        return x.mean(dim=(1, 2))


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
