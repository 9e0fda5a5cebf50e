"""Flat per-stage weight rows: the port of ``defer_tpu.runtime.flatbuf``.

Each stage's parameters live in ONE contiguous tensor on its device (the
stage's row), and every leaf the stage function reads is a view into it
(``narrow`` + ``view``), so installing new weights is one ``copy_`` into
the row and anything that captured the views (a CUDA graph) sees them.
On one card there is no ``[N, Pmax]`` stack: nothing shards the rows yet.

Leaves are laid out in the JAX package's order — sorted key paths, the
order ``jax.tree.flatten`` gives a dict — so a row holds the JAX row's
leaves in the same sequence.  Two layout choices differ from it:

* a 4-D leaf (a conv kernel, OIHW in the port) is stored in O-H-W-I order
  and viewed as OIHW with channels_last strides, the layout cuDNN reads
  without a per-call copy (the JAX row holds HWIO);
* every leaf starts at a multiple of :data:`ALIGN` elements (the JAX row
  packs them back to back), so each view is at least 16-byte aligned for
  cuBLAS and cuDNN.

The decoder's W8A16 rows (:func:`quantize_leaves`) keep the same leaf
offsets in an int8 row, beside an f32 scale row laid out as the JAX
package lays it.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

#: per-leaf layout record: (offset, size, shape, dtype), offsets in elements
LeafMeta = tuple[int, int, tuple[int, ...], torch.dtype]
#: a leaf's key path: node name, then its nested keys
Path = tuple[str, ...]

#: leaf offsets are multiples of this many elements (>= 16 bytes for any
#: dtype of 1 byte or more)
ALIGN = 64


def flatten_leaves(tree: dict) -> tuple[tuple[Path, ...], list[torch.Tensor]]:
    """``(paths, leaves)`` of a nested dict, in sorted key-path order.

    The paths play the part of the JAX treedef: two trees with the same
    paths unflatten alike."""
    flat: dict[Path, Any] = {}

    def walk(node: dict, prefix: Path) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(tree, ())
    paths = tuple(sorted(flat))
    return paths, [torch.as_tensor(flat[p]) for p in paths]


def unflatten_leaves(paths: Sequence[Path], leaves: Sequence[Any]) -> dict:
    """Inverse of :func:`flatten_leaves`."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def leaf_meta(leaves: Sequence[torch.Tensor]) -> list[LeafMeta]:
    """Offsets/sizes/shapes/dtypes of ``leaves`` laid out in order, each
    offset rounded up to :data:`ALIGN`."""
    meta, off = [], 0
    for leaf in leaves:
        off = -(-off // ALIGN) * ALIGN
        meta.append((off, leaf.numel(), tuple(leaf.shape), leaf.dtype))
        off += leaf.numel()
    return meta


def check_layout(leaves: Sequence[torch.Tensor], paths: Sequence[Path],
                 want_meta: Sequence[LeafMeta], want_paths: Sequence[Path],
                 what: str) -> None:
    """Validate PRE-cast leaves and their paths against a deployed row.

    The deployed views were cut with the recorded paths, shapes and
    dtypes: all three must match, or new values would land in the wrong
    leaves or be cast blindly — so this raises before anything touches
    the deployed row."""
    if tuple(paths) != tuple(want_paths):
        raise ValueError(
            f"{what}: param tree structure differs from the deployed one")
    want = [(m[2], m[3]) for m in want_meta]
    got = [(tuple(l.shape), l.dtype) for l in leaves]
    if want != got:
        raise ValueError(f"{what}: leaves {got} != deployed {want}")


def _storage_order(leaf: torch.Tensor) -> torch.Tensor:
    """A 4-D OIHW leaf in O-H-W-I order; any other leaf as it is."""
    return leaf.permute(0, 2, 3, 1) if leaf.dim() == 4 else leaf


def pack_leaves(leaves: Sequence[torch.Tensor], meta: Sequence[LeafMeta],
                wire_dtype: torch.dtype,
                cast: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """One flat row on the leaves' device: each leaf, in storage order and
    cast to ``wire_dtype`` by ``cast``, at its offset; the gaps between
    leaves are zero."""
    device = leaves[0].device if leaves else None
    row = torch.zeros(max((off + n for off, n, _, _ in meta), default=0),
                      dtype=wire_dtype, device=device)
    for leaf, (off, n, _, _) in zip(leaves, meta):
        row[off:off + n] = cast(_storage_order(leaf)).reshape(-1)
    return row


#: per-leaf scale slot within the scale row: (offset, size)
ScaleMeta = tuple[int, int]


def quantize_leaves(leaves: Sequence[torch.Tensor], meta: Sequence[LeafMeta]
                    ) -> tuple[torch.Tensor, torch.Tensor, list[ScaleMeta]]:
    """W8A16 rows: symmetric int8 with channel-wise (last-axis) scales.

    Returns ``(q_row int8, scale_row f32, smeta)`` as CPU tensors: each
    leaf's int8 values at its ``meta`` offset (the port's aligned layout,
    zeros between leaves), and the f32 scales back to back, as the JAX
    package lays them.  1-D leaves (LayerNorm scales, biases) get
    per-element scales, exactly invertible.  The arithmetic is the JAX
    package's host numpy, so values and scales are bit-equal to its rows.
    Leaves keep their own shape and order (no 4-D relayout): the rows serve
    the decoder, whose leaves are at most 2-D.
    """
    q_row = np.zeros(max((off + n for off, n, _, _ in meta), default=0),
                     np.int8)
    ss, smeta, soff = [], [], 0
    for leaf, (off, n, _, _) in zip(leaves, meta):
        a = leaf.detach().to("cpu", torch.float32).numpy()
        red = tuple(range(max(a.ndim - 1, 0)))  # all axes but the last
        scale = np.maximum(np.abs(a).max(axis=red) / 127.0, 1e-12) \
            if a.ndim else np.maximum(np.abs(a) / 127.0, 1e-12)
        q_row[off:off + n] = np.clip(np.rint(a / scale), -127,
                                     127).astype(np.int8).ravel()
        ss.append(np.asarray(scale, np.float32).ravel())
        smeta.append((soff, ss[-1].size))
        soff += ss[-1].size
    s_row = np.concatenate(ss) if ss else np.zeros((0,), np.float32)
    return torch.from_numpy(q_row), torch.from_numpy(s_row), smeta


def unpack_quant_leaves(q_row: torch.Tensor, s_row: torch.Tensor,
                        meta: Sequence[LeafMeta], smeta: Sequence[ScaleMeta],
                        dtype: torch.dtype) -> list[torch.Tensor]:
    """The leaves of a W8A16 row pair, dequantized to ``dtype``: ``q *
    scale``, each factor cast to ``dtype`` first, as the JAX package
    computes it inside its stage branch."""
    leaves = []
    for (off, size, shape, _), (soff, ssize) in zip(meta, smeta):
        q = q_row.narrow(0, off, size).view(shape)
        sc = s_row.narrow(0, soff, ssize).view(shape[-1:] if shape else ())
        leaves.append(q.to(dtype) * sc.to(dtype))
    return leaves


def unpack_leaves(row: torch.Tensor, meta: Sequence[LeafMeta]
                  ) -> list[torch.Tensor]:
    """Each leaf as a view into ``row``, in the row's dtype: 4-D leaves as
    OIHW with channels_last strides, the others contiguous.

    The views come from one ``split`` of the row (the gaps between leaves
    are pieces of their own), so on a row that requires grad the leaves'
    gradients gather into the row's in one ``cat`` — a view per leaf
    (``narrow``) would give each leaf a row-sized zero gradient to add."""
    sizes, pieces, end = [], [], 0
    for off, size, _, _ in meta:
        if off > end:
            sizes.append(off - end)  # the gap before the leaf
        pieces.append(len(sizes))
        sizes.append(size)
        end = off + size
    if row.numel() > end:
        sizes.append(row.numel() - end)
    parts = row.split(sizes)
    leaves = []
    for p, (_, _, shape, _) in zip(pieces, meta):
        seg = parts[p]
        if len(shape) == 4:
            o, i, h, w = shape
            leaves.append(seg.view(o, h, w, i).permute(0, 3, 1, 2))
        else:
            leaves.append(seg.view(shape))
    return leaves
