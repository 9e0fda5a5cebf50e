"""Pretrained-weight import: standard checkpoint layouts -> the port's params.

The port of ``defer_tpu.utils.pretrained``.  The mapping tables and
:func:`convert_state_dict` are the JAX package's, unchanged: they map the
de-facto standard layouts (torchvision ``state_dict`` names for ResNet50,
VGG19, MobileNetV2 and InceptionV3, Hugging Face names for BERT and GPT-2)
onto the JAX package's parameter layout (NHWC/HWIO), shape-checked against
:func:`~defer_tpu_torch.utils.convert.jax_param_spec` of the port's graph.
Each loader then passes the result through
:func:`~defer_tpu_torch.utils.convert.params_from_jax`, the one place where
the two packages' layouts differ, so the port's loader returns exactly
``params_from_jax(graph, <the JAX loader's output>)``.

Accepted containers:

* ``.npz`` — numpy archive keyed either by the standard names
  (``conv1.weight``, ``layer1.0.conv1.weight``, ...) or by the flat
  ``node/leaf`` names of :func:`~defer_tpu_torch.utils.checkpoint.save_params`;
* ``.pt`` / ``.pth`` / ``.bin`` — a ``torch.save``d ``state_dict``, loaded
  with ``weights_only=True``; bfloat16 tensors are widened to float32
  (exact) where the JAX package's ``.numpy()`` raises;
* ``.safetensors`` — if the optional ``safetensors`` package is present.

Tensor-layout transforms applied for torchvision sources:

* conv kernels  OIHW -> HWIO  (``transpose(2, 3, 1, 0)``), then back to
  OIHW in ``params_from_jax``
* fc weight     [out, in] -> [in, out]
* batchnorm     weight/bias/running_mean/running_var ->
  scale/bias/mean/var (same eps, 1e-5, on both sides)
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np

import torch

from ..graph.ir import LayerGraph
from .checkpoint import load_params
from .convert import jax_param_spec, params_from_jax

#: torchvision bn leaf -> our BatchNorm leaf
_BN_LEAVES = {
    "weight": "scale",
    "bias": "bias",
    "running_mean": "mean",
    "running_var": "var",
}


def _conv_t(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO


def _fc_t(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (1, 0))  # [out, in] -> [in, out]


def _ident(a: np.ndarray) -> np.ndarray:
    return a


def resnet50_torch_mapping(depths=(3, 4, 6, 3)
                           ) -> dict[tuple[str, str],
                                     tuple[str, Callable[[np.ndarray],
                                                         np.ndarray]]]:
    """(our_node, our_leaf) -> (torchvision_key, layout transform).

    The graph builder numbers ``conv2d_k``/``batchnorm_k`` pairs globally in
    build order (models/resnet.py): stem first, then per bottleneck the
    projection shortcut (first block of a stage) *before* conv1..conv3 —
    whereas torchvision lists ``downsample`` last.  This mapping encodes
    that order difference once, structurally, instead of relying on
    enumeration order of either side.
    """
    m: dict[tuple[str, str], tuple[str, Callable]] = {}

    def pair(our_idx: int, conv_key: str, bn_key: str):
        conv = "conv2d" if our_idx == 0 else f"conv2d_{our_idx}"
        bn = "batchnorm" if our_idx == 0 else f"batchnorm_{our_idx}"
        m[(conv, "w")] = (f"{conv_key}.weight", _conv_t)
        for theirs, ours in _BN_LEAVES.items():
            m[(bn, ours)] = (f"{bn_key}.{theirs}", _ident)

    pair(0, "conv1", "bn1")
    idx = 1
    for s, blocks in enumerate(depths):
        for i in range(blocks):
            t = f"layer{s + 1}.{i}"
            branches = [(f"{t}.conv1", f"{t}.bn1"),
                        (f"{t}.conv2", f"{t}.bn2"),
                        (f"{t}.conv3", f"{t}.bn3")]
            if i == 0:  # builder emits the projection shortcut first
                branches.insert(0, (f"{t}.downsample.0", f"{t}.downsample.1"))
            for conv_key, bn_key in branches:
                pair(idx, conv_key, bn_key)
                idx += 1
    m[("predictions", "w")] = ("fc.weight", _fc_t)
    m[("predictions", "b")] = ("fc.bias", _ident)
    return m


def _fc1_t(h: int, w: int, c: int) -> Callable[[np.ndarray], np.ndarray]:
    """First-FC transform for VGG: torch flattens NCHW ([C,H,W] order per
    sample), this framework flattens NHWC — the weight's input axis must be
    re-permuted, not just transposed."""
    def t(a: np.ndarray) -> np.ndarray:
        out = a.shape[0]
        return (a.reshape(out, c, h, w).transpose(0, 2, 3, 1)
                .reshape(out, -1).T)
    t.__name__ = "_fc1_t"
    return t


def vgg_torch_mapping(cfg, spatial_hwc: tuple[int, int, int]
                      ) -> dict[tuple[str, str], tuple[str, Callable]]:
    """(our_node, our_leaf) -> (torchvision key, transform) for a VGG built
    by ``models.vgg.vgg(cfg, ...)``.

    torchvision's ``features`` Sequential numbers conv/relu/maxpool slots
    consecutively; the builder names ``conv{block}_{i}``.  ``spatial_hwc``
    is the activation shape entering ``flatten`` (needed because torch
    flattens CHW, we flatten HWC — see ``_fc1_t``).
    """
    m: dict[tuple[str, str], tuple[str, Callable]] = {}
    feat_idx = 0
    block, conv_in_block = 1, 1
    for v in cfg:
        if v == "M":
            feat_idx += 1
            block += 1
            conv_in_block = 1
        else:
            node = f"conv{block}_{conv_in_block}"
            m[(node, "w")] = (f"features.{feat_idx}.weight", _conv_t)
            m[(node, "b")] = (f"features.{feat_idx}.bias", _ident)
            feat_idx += 2  # conv + its relu
            conv_in_block += 1
    h, w, c = spatial_hwc
    m[("fc1", "w")] = ("classifier.0.weight", _fc1_t(h, w, c))
    m[("fc1", "b")] = ("classifier.0.bias", _ident)
    m[("fc2", "w")] = ("classifier.3.weight", _fc_t)
    m[("fc2", "b")] = ("classifier.3.bias", _ident)
    m[("predictions", "w")] = ("classifier.6.weight", _fc_t)
    m[("predictions", "b")] = ("classifier.6.bias", _ident)
    return m


def mobilenet_v2_torch_mapping() -> dict[tuple[str, str],
                                         tuple[str, Callable]]:
    """(our_node, our_leaf) -> (torchvision key, transform) for
    ``models.mobilenet.mobilenet_v2``.

    Mirrors the builder's auto-naming counters (conv2d_k / batchnorm_k /
    depthwiseconv2d_k in build order) against torchvision's module tree:
    ``features.0`` ConvBNReLU stem, ``features.1..17`` InvertedResiduals
    (``.conv`` holds [expand ConvBNReLU,] depthwise ConvBNReLU, linear
    conv, bn), ``features.18`` ConvBNReLU head, ``classifier.1`` Linear.
    Depthwise kernels are OIHW ``[C,1,k,k]`` -> HWIO ``[k,k,1,C]`` via the
    same transpose as dense convs.
    """
    from ..models.mobilenet import _V2_CFG
    m: dict[tuple[str, str], tuple[str, Callable]] = {}
    counters = {"conv2d": 0, "batchnorm": 0, "depthwiseconv2d": 0}

    def nm(base: str) -> str:
        n = counters[base]
        counters[base] += 1
        return base if n == 0 else f"{base}_{n}"

    def conv(src: str):
        m[(nm("conv2d"), "w")] = (f"{src}.weight", _conv_t)

    def dwconv(src: str):
        m[(nm("depthwiseconv2d"), "w")] = (f"{src}.weight", _conv_t)

    def bn(src: str):
        node = nm("batchnorm")
        for theirs, ours in _BN_LEAVES.items():
            m[(node, ours)] = (f"{src}.{theirs}", _ident)

    conv("features.0.0")
    bn("features.0.1")
    f = 1
    for expand, _out, reps, _stride in _V2_CFG:
        for _ in range(reps):
            base = f"features.{f}.conv"
            f += 1
            if expand != 1:
                conv(f"{base}.0.0")
                bn(f"{base}.0.1")
                dwconv(f"{base}.1.0")
                bn(f"{base}.1.1")
                conv(f"{base}.2")
                bn(f"{base}.3")
            else:
                dwconv(f"{base}.0.0")
                bn(f"{base}.0.1")
                conv(f"{base}.1")
                bn(f"{base}.2")
    conv(f"features.{f}.0")
    bn(f"features.{f}.1")
    m[("predictions", "w")] = ("classifier.1.weight", _fc_t)
    m[("predictions", "b")] = ("classifier.1.bias", _ident)
    return m


#: torchvision InceptionV3 ``BasicConv2d`` module prefixes, in the exact
#: order ``models.inception.inception_v3`` adds its conv/bn pairs.  The
#: builder constructs branches in torch constructor order (branch1x1,
#: branch5x5/3x3/7x7 chains, branch_pool), so this is a straight walk of
#: the torchvision module tree.
_INCEPTION_A = ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")
_INCEPTION_B = ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                "branch3x3dbl_3")
_INCEPTION_C = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
_INCEPTION_D = ("branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4")
_INCEPTION_E = ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                "branch3x3dbl_3b", "branch_pool")


def inception_v3_conv_order() -> list[str]:
    """torchvision module prefixes of every BasicConv2d, forward order."""
    order = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
             "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    blocks = (
        [("Mixed_5b", _INCEPTION_A), ("Mixed_5c", _INCEPTION_A),
         ("Mixed_5d", _INCEPTION_A), ("Mixed_6a", _INCEPTION_B)]
        + [(f"Mixed_6{s}", _INCEPTION_C) for s in "bcde"]
        + [("Mixed_7a", _INCEPTION_D), ("Mixed_7b", _INCEPTION_E),
           ("Mixed_7c", _INCEPTION_E)])
    for block, branches in blocks:
        order.extend(f"{block}.{br}" for br in branches)
    return order


def inception_v3_torch_mapping() -> dict[tuple[str, str],
                                         tuple[str, Callable]]:
    """(our_node, our_leaf) -> (torchvision key, transform) for
    ``models.inception.inception_v3``.

    Same builder-order-counter scheme as the MobileNetV2 mapping: the
    k-th conv2d/batchnorm pair the builder creates corresponds to the
    k-th ``BasicConv2d`` in torchvision forward order
    (``inception_v3_conv_order``).  ``AuxLogits.*`` keys are ignored —
    the aux head does not exist in eval-mode inference.
    """
    m: dict[tuple[str, str], tuple[str, Callable]] = {}
    for i, prefix in enumerate(inception_v3_conv_order()):
        conv = "conv2d" if i == 0 else f"conv2d_{i}"
        bn = "batchnorm" if i == 0 else f"batchnorm_{i}"
        m[(conv, "w")] = (f"{prefix}.conv.weight", _conv_t)
        for theirs, ours in _BN_LEAVES.items():
            m[(bn, ours)] = (f"{prefix}.bn.{theirs}", _ident)
    m[("predictions", "w")] = ("fc.weight", _fc_t)
    m[("predictions", "b")] = ("fc.bias", _ident)
    return m


def _fuse_qkv(q: np.ndarray, k: np.ndarray, v: np.ndarray) -> np.ndarray:
    """HF's separate q/k/v ``[out, in]`` matrices -> one fused ``[in, 3d]``."""
    return np.concatenate([q.T, k.T, v.T], axis=1)


def _fuse_qkv_bias(q: np.ndarray, k: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.concatenate([q, k, v])


def _fold_pos_tt(max_len: int) -> Callable:
    """position_embeddings[:max_len] + token_type_embeddings[0]:
    single-segment inputs add the segment-0 vector at every position
    pre-LN, so it folds into the positional table exactly; the real
    checkpoint's 512-row table is cropped to the deployed sequence
    length (HF slices position_ids the same way)."""
    def t(pos: np.ndarray, tt: np.ndarray) -> np.ndarray:
        return pos[:max_len] + tt[0]
    t.__name__ = "_fold_pos_tt"
    return t


def bert_torch_mapping(num_layers: int, max_len: int = 512
                       ) -> dict[tuple[str, str], tuple[Any, Callable]]:
    """(our_node, our_leaf_path) -> (HF state_dict key(s), transform) for
    ``models.bert.bert`` (post-LN blocks, fused qkv).

    HF prefix conventions: plain ``bert-base-uncased`` state_dicts carry
    ``bert.``-prefixed keys when saved from a task model; strip that
    before calling (see ``load_pretrained_bert_base``).
    """
    m: dict[tuple[str, str], tuple[Any, Callable]] = {}
    e = "embeddings"
    m[(e, "tok")] = (f"{e}.word_embeddings.weight", _ident)
    m[(e, "pos")] = ((f"{e}.position_embeddings.weight",
                      f"{e}.token_type_embeddings.weight"),
                     _fold_pos_tt(max_len))
    m[(e, "ln/scale")] = (f"{e}.LayerNorm.weight", _ident)
    m[(e, "ln/bias")] = (f"{e}.LayerNorm.bias", _ident)
    for i in range(num_layers):
        b = f"encoder.layer.{i}"
        node = f"block_{i}"
        a = f"{b}.attention"
        m[(node, "qkv/w")] = ((f"{a}.self.query.weight",
                               f"{a}.self.key.weight",
                               f"{a}.self.value.weight"), _fuse_qkv)
        m[(node, "qkv/b")] = ((f"{a}.self.query.bias",
                               f"{a}.self.key.bias",
                               f"{a}.self.value.bias"), _fuse_qkv_bias)
        m[(node, "proj/w")] = (f"{a}.output.dense.weight", _fc_t)
        m[(node, "proj/b")] = (f"{a}.output.dense.bias", _ident)
        m[(node, "ln1/scale")] = (f"{a}.output.LayerNorm.weight", _ident)
        m[(node, "ln1/bias")] = (f"{a}.output.LayerNorm.bias", _ident)
        m[(node, "fc1/w")] = (f"{b}.intermediate.dense.weight", _fc_t)
        m[(node, "fc1/b")] = (f"{b}.intermediate.dense.bias", _ident)
        m[(node, "fc2/w")] = (f"{b}.output.dense.weight", _fc_t)
        m[(node, "fc2/b")] = (f"{b}.output.dense.bias", _ident)
        m[(node, "ln2/scale")] = (f"{b}.output.LayerNorm.weight", _ident)
        m[(node, "ln2/bias")] = (f"{b}.output.LayerNorm.bias", _ident)
    m[("pooler", "w")] = ("pooler.dense.weight", _fc_t)
    m[("pooler", "b")] = ("pooler.dense.bias", _ident)
    return m


def load_pretrained_bert_base(path: str, graph: LayerGraph | None = None
                              ) -> dict[str, Any]:
    """Load an HF-layout BERT checkpoint (or our flat layout) as params."""
    if graph is None:
        from ..models import bert_base
        graph = bert_base()
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    # task-model saves prefix everything with "bert." — strip it
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()
              if k.startswith("bert.")}
    if any(k.startswith("encoder.layer.") for k in sd):  # HF layout
        n_layers = sum(1 for n in graph.nodes if n.startswith("block_"))
        max_len = graph.input_spec.shape[0]
        return params_from_jax(graph, convert_state_dict(
            bert_torch_mapping(n_layers, max_len), sd, expected, "BERT"))
    return load_params(path, graph)


def _read_state_dict(path: str) -> dict[str, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if ext in (".pt", ".pth", ".bin"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        # numpy has no bfloat16: widen (exact) where the JAX package raises
        return {k: np.asarray((v.float() if v.dtype == torch.bfloat16
                               else v).detach().cpu().numpy())
                for k, v in sd.items()}
    if ext == ".safetensors":
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(
                "safetensors is not available in this environment; "
                "convert the checkpoint to .npz or .pt") from e
        return load_file(path)
    raise ValueError(f"unsupported checkpoint extension {ext!r} "
                     f"(want .npz, .pt/.pth/.bin, or .safetensors)")


def convert_state_dict(
    mapping: dict[tuple[str, str], tuple["str | tuple[str, ...]", Callable]],
    sd: dict[str, np.ndarray],
    expected: dict[str, Any],
    what: str,
) -> dict[str, Any]:
    """Apply a (our_node, our_leaf_path) -> (source_key(s), transform)
    mapping, shape-checked leaf by leaf.  ``source_key(s)`` may be a
    tuple — the transform then fuses several source arrays into one leaf
    (HF BERT's q/k/v -> fused qkv, segment fold).

    ``expected`` is :func:`jax_param_spec` of the graph — its shapes are
    the contract; any missing source key or post-transform shape mismatch
    raises with the full offending list (no silent partial loads).  A
    parametric node the mapping does not address is left out, and
    ``params_from_jax`` then raises for it.
    """
    out: dict[str, Any] = {}
    missing, mismatched = [], []
    for (node, leaf), (src, tf) in mapping.items():
        # leaf may be a "/"-joined path into a nested node pytree, and
        # src may be a tuple of source keys fused by the transform
        # (e.g. HF BERT's separate q/k/v -> one fused qkv matrix)
        srcs = src if isinstance(src, tuple) else (src,)
        absent = [k for k in srcs if k not in sd]
        if absent:
            missing.extend(absent)
            continue
        path = leaf.split("/")
        want_leaf = expected[node]
        for part in path:
            want_leaf = want_leaf[part]
        want = np.shape(want_leaf)
        arr = tf(*(np.asarray(sd[k]) for k in srcs))
        if arr.shape != want:
            mismatched.append(f"{src} -> {node}/{leaf}: got {arr.shape}, "
                              f"want {want}")
            continue
        dst = out.setdefault(node, {})
        for part in path[:-1]:
            dst = dst.setdefault(part, {})
        dst[path[-1]] = arr.astype(np.float32)
    if missing or mismatched:
        raise ValueError(
            f"checkpoint does not match {what}: "
            f"{len(missing)} missing keys {missing[:5]}..., "
            f"{len(mismatched)} shape mismatches {mismatched[:5]}")
    return out


def convert_resnet50_state_dict(sd: dict[str, np.ndarray],
                                expected: dict[str, Any],
                                depths=(3, 4, 6, 3)) -> dict[str, Any]:
    """torchvision ResNet ``state_dict`` -> JAX-layout params
    (shape-checked against ``expected``, :func:`jax_param_spec`)."""
    return convert_state_dict(resnet50_torch_mapping(depths), sd, expected,
                              "ResNet50")


def load_pretrained_resnet50(path: str, graph: LayerGraph | None = None,
                             depths=(3, 4, 6, 3)) -> dict[str, Any]:
    """Load a ResNet50 checkpoint (any accepted container) as graph params.

    Returns the port's parameters for ``graph`` (structured as
    ``graph.init``'s) with every parametric leaf replaced by the
    checkpoint's (layout-transformed) tensor.  ``graph`` defaults to
    ``models.resnet50()``.
    """
    if graph is None:
        from ..models import resnet50
        graph = resnet50()
    # shapes only — no need to materialize a random init just to validate
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    if any(k.startswith("conv1.") for k in sd):  # torchvision layout
        return params_from_jax(graph, convert_resnet50_state_dict(
            sd, expected, depths))
    # our own flat node/leaf layout: checkpoint.load_params already
    # restores it with loud missing/extra/shape validation
    return load_params(path, graph)


def load_pretrained_vgg19(path: str,
                          graph: LayerGraph | None = None) -> dict[str, Any]:
    """Load a VGG19 checkpoint (torchvision layout or our flat layout)."""
    if graph is None:
        from ..models import vgg19
        graph = vgg19()
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    if any(k.startswith("features.") for k in sd):  # torchvision layout
        from ..models.vgg import VGG19_CFG
        pre_flatten = graph.nodes["flatten"].inputs[0]
        spatial = graph.out_spec(pre_flatten).shape
        return params_from_jax(graph, convert_state_dict(
            vgg_torch_mapping(VGG19_CFG, spatial), sd, expected, "VGG19"))
    return load_params(path, graph)


def load_pretrained_mobilenet_v2(path: str, graph: LayerGraph | None = None
                                 ) -> dict[str, Any]:
    """Load a MobileNetV2 checkpoint (torchvision or our flat layout)."""
    if graph is None:
        from ..models import mobilenet_v2
        graph = mobilenet_v2()
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    if any(k.startswith("features.") for k in sd):  # torchvision layout
        return params_from_jax(graph, convert_state_dict(
            mobilenet_v2_torch_mapping(), sd, expected, "MobileNetV2"))
    return load_params(path, graph)


def _crop_rows(n: int) -> Callable[[np.ndarray], np.ndarray]:
    def t(a: np.ndarray) -> np.ndarray:
        return a[:n]
    t.__name__ = "_crop_rows"
    return t


def gpt2_torch_mapping(num_layers: int, max_len: int
                       ) -> dict[tuple[str, str], tuple[str, Callable]]:
    """(our_node, our_leaf) -> (HF GPT-2 key, transform) for
    ``models.gpt.gpt``-family graphs (``gpt2_small`` for checkpoints).

    HF GPT-2 uses Conv1D modules whose weights are stored ``[in, out]``
    — exactly this framework's layout — so every projection maps with
    ``_ident`` (no transposes, unlike the torchvision CNN imports).  The
    fused ``attn.c_attn`` packs q|k|v along columns in the same order as
    our fused qkv split.  The LM head is weight-tied to ``wte`` in HF
    (logits = x @ wte.T): our untied ``lm_head`` imports ``wte.T`` with
    a zero bias.  The positional table is cropped to the graph's
    ``seq_len`` (HF ships 1024 rows).
    """
    m: dict[tuple[str, str], tuple[str, Callable]] = {
        ("embeddings", "wte"): ("wte.weight", _ident),
        ("embeddings", "wpe"): ("wpe.weight", _crop_rows(max_len)),
        ("final_ln", "scale"): ("ln_f.weight", _ident),
        ("final_ln", "bias"): ("ln_f.bias", _ident),
        ("lm_head", "w"): ("wte.weight", _fc_t),  # tied head: wte.T
        ("lm_head", "b"): ("wte.weight", _zero_rows),
    }
    for i in range(num_layers):
        h = f"h.{i}"
        blk = f"block_{i}"
        for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2")):
            m[(blk, f"{ours}/scale")] = (f"{h}.{theirs}.weight", _ident)
            m[(blk, f"{ours}/bias")] = (f"{h}.{theirs}.bias", _ident)
        for ours, theirs in (("qkv", "attn.c_attn"), ("proj", "attn.c_proj"),
                             ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            m[(blk, f"{ours}/w")] = (f"{h}.{theirs}.weight", _ident)
            m[(blk, f"{ours}/b")] = (f"{h}.{theirs}.bias", _ident)
    return m


def _zero_rows(a: np.ndarray) -> np.ndarray:
    """Zero bias sized by the source's leading dim (tied-head import)."""
    return np.zeros((a.shape[0],), np.float32)


def load_pretrained_gpt2(path: str, graph: LayerGraph | None = None
                         ) -> dict[str, Any]:
    """Load an HF GPT-2 checkpoint (``GPT2Model``/``GPT2LMHeadModel``
    state_dict, optionally ``transformer.``-prefixed) or our flat layout.

    No reference analogue (the reference is CNN-only); this extends the
    trained-deployment story (reference test/test.py:13-14) to the
    generation family: imported weights drive ``PipelinedDecoder`` /
    ``Defer.generate`` directly.
    """
    if graph is None:
        from ..models import gpt2_small
        graph = gpt2_small()
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    sd = {(k[len("transformer."):] if k.startswith("transformer.") else k): v
          for k, v in sd.items()}
    if any(k.startswith("h.0.") or k == "wte.weight" for k in sd):
        layers = sum(1 for node in expected if node.startswith("block_"))
        max_len = graph.input_spec.shape[0]
        return params_from_jax(graph, convert_state_dict(
            gpt2_torch_mapping(layers, max_len), sd, expected, "GPT-2"))
    return load_params(path, graph)


def load_pretrained_inception_v3(path: str, graph: LayerGraph | None = None
                                 ) -> dict[str, Any]:
    """Load an InceptionV3 checkpoint (torchvision or our flat layout).

    Reference parity: the reference benchmarks trained Keras models
    (reference test/test.py:13-14); InceptionV3 is BASELINE config 3.
    Inputs must be TF-style normalized (``(x-0.5)/0.5``) — torchvision's
    ``transform_input=True`` re-normalization is preprocessing, not part
    of the graph.
    """
    if graph is None:
        from ..models import inception_v3
        graph = inception_v3()
    expected = jax_param_spec(graph)
    sd = _read_state_dict(path)
    if any(k.startswith(("Conv2d_1a", "Mixed_")) for k in sd):
        return params_from_jax(graph, convert_state_dict(
            inception_v3_torch_mapping(), sd, expected, "InceptionV3"))
    return load_params(path, graph)


#: model-family name -> loader, for generic call sites (bench/CLI)
PRETRAINED_LOADERS: dict[str, Callable] = {
    "resnet50": load_pretrained_resnet50,
    "vgg19": load_pretrained_vgg19,
    "mobilenet_v2": load_pretrained_mobilenet_v2,
    "bert_base": load_pretrained_bert_base,
    "inception_v3": load_pretrained_inception_v3,
    "gpt2": load_pretrained_gpt2,
}


def load_pretrained(model: str, path: str,
                    graph: LayerGraph | None = None) -> dict[str, Any]:
    """Generic front door: ``load_pretrained("vgg19", path, graph)``."""
    if model not in PRETRAINED_LOADERS:
        raise ValueError(f"no pretrained loader for {model!r} "
                         f"(have {sorted(PRETRAINED_LOADERS)})")
    return PRETRAINED_LOADERS[model](path, graph)
