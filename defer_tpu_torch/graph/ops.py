"""Layer op library: the ResNet subset of ``defer_tpu.graph.ops``.

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
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .ir import Op


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
    return {k: v.to(dtype) for k, v in p.items()}


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
