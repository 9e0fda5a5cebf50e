"""Layer-graph IR: the model representation the partitioner operates on.

The port of ``defer_tpu.graph.ir``.  Models are an explicit DAG of named
layer nodes (op + input edges); the partitioner, the stage modules and the
pipeline engines all consume this IR.

  * Graph structure is static and explicit; forward evaluation is a
    memoized topological traversal.
  * Parameters live apart from structure, as a dict keyed by node name
    whose values are nested dicts of tensors (``{node: {leaf: tensor}}``,
    or ``{node: {"qkv": {"w": tensor, ...}, ...}}`` for a transformer
    block) — the same layout as the JAX package's parameter pytree, so
    weights cross between the two packages by name (``utils/convert.py``).
    Shapes are stored *batchless*; ``apply`` is batched.
  * Shape inference runs the op on ``meta``-device tensors where the
    JAX package uses ``jax.eval_shape``: no memory, no compute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

Params = Any  # nested dict of tensors (or None for parameterless ops)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict (a node's parameters
    or their ``param_spec``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> ``{"a/b/c": leaf}`` (``/``-joined key paths)."""
    flat = {}
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"parameter key {k!r} may not contain '/'")
        if isinstance(v, dict):
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def unflatten_tree(flat: dict[str, Any]) -> dict:
    """Inverse of :func:`flatten_tree`."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def as_dtype(dtype: Any) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = getattr(torch, str(dtype), None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return d


class ShapeSpec:
    """Batchless shape+dtype of one inter-layer tensor."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Sequence[int], dtype: Any = torch.float32):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = as_dtype(dtype)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def batched(self, batch: int) -> torch.Tensor:
        """A ``meta`` tensor of shape ``(batch, *shape)`` (shape inference)."""
        return torch.empty((batch,) + self.shape, dtype=self.dtype,
                           device="meta")

    def __repr__(self):
        return f"ShapeSpec({self.shape}, {str(self.dtype)[6:]})"

    def __eq__(self, other):
        return (
            isinstance(other, ShapeSpec)
            and self.shape == other.shape
            and self.dtype == other.dtype
        )


class Op:
    """Base class for layer ops.

    Subclasses implement ``init`` (parameter construction from input
    shapes, drawing from a ``torch.Generator`` on the generator's device,
    or on the ``meta`` device when the generator is ``None``) and ``apply``
    (batched forward, a plain tensor function of the parameters).
    """

    def init(self, gen: torch.Generator | None,
             in_specs: tuple[ShapeSpec, ...]) -> Params:
        del gen, in_specs
        return None

    def apply(self, params: Params, *xs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def flops(self, in_specs: tuple[ShapeSpec, ...], out_spec: ShapeSpec) -> int:
        """Rough per-sample FLOP estimate, used for balanced auto-partition."""
        del in_specs
        return out_spec.size  # elementwise default

    def __repr__(self):
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class LayerNode:
    name: str
    op: Op
    inputs: tuple[str, ...]
    out_spec: ShapeSpec
    param_spec: dict[str, Any] | None  # nested dict of ShapeSpec


class LayerGraph:
    """A single-input single-output DAG of layer nodes in topological order.

    ``nodes`` is an insertion-ordered dict; ``GraphBuilder`` only appends
    a node after all of its inputs exist, so iteration order *is* a
    topological order — the linearization partitioning cuts along.
    """

    def __init__(
        self,
        name: str,
        nodes: dict[str, LayerNode],
        input_name: str,
        output_name: str,
        input_spec: ShapeSpec,
    ):
        self.name = name
        self.nodes = nodes
        self.input_name = input_name
        self.output_name = output_name
        self.input_spec = input_spec

    # -- structure ---------------------------------------------------------

    @property
    def topo_order(self) -> list[str]:
        return list(self.nodes)

    def predecessors(self, name: str) -> tuple[str, ...]:
        """DEFER's ``get_previous`` (reference src/dag_util.py:3-7)."""
        return self.nodes[name].inputs

    def out_spec(self, name: str) -> ShapeSpec:
        if name == self.input_name:
            return self.input_spec
        return self.nodes[name].out_spec

    @property
    def output_spec(self) -> ShapeSpec:
        return self.out_spec(self.output_name)

    # -- parameters --------------------------------------------------------

    def init(self, generator: torch.Generator) -> dict[str, Params]:
        """Fresh parameters keyed by node name, drawn in topological order
        from ``generator`` onto the generator's device."""
        params: dict[str, Params] = {}
        for node in self.nodes.values():
            if node.param_spec is None:
                continue
            in_specs = tuple(self.out_spec(i) for i in node.inputs)
            params[node.name] = node.op.init(generator, in_specs)
        return params

    # -- evaluation --------------------------------------------------------

    def apply(
        self,
        params: dict[str, Params],
        x: torch.Tensor | None = None,
        *,
        upto: str | None = None,
        start: str | None = None,
        node_names: Sequence[str] | None = None,
        seeds: dict[str, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """Memoized forward pass over (a sub-range of) the graph.

        With ``start=c`` the cache is seeded with ``{c: x}`` and only
        ``node_names`` are evaluated — how one pipeline stage runs its
        slice of the graph.  ``seeds`` (name -> tensor) seeds the cache
        with several boundary tensors instead — how the join stage of a
        branched pipeline resumes from all of its merge op's inputs at
        once (``partition.stage.JoinStageSpec``).
        """
        if x is None and seeds is None:
            raise TypeError("apply() needs an input tensor x (or seeds= "
                            "boundary tensors)")
        start = start or self.input_name
        upto = upto or self.output_name
        cache: dict[str, torch.Tensor] = (
            dict(seeds) if seeds is not None else {start: x})
        names = node_names if node_names is not None else self.topo_order
        for name in names:
            if name in cache:  # the seeded start node
                continue
            node = self.nodes[name]
            xs = [cache[i] for i in node.inputs]
            cache[name] = node.op.apply(params.get(name), *xs)
            if name == upto:
                break
        return cache[upto]

    # -- derived graphs ----------------------------------------------------

    def with_input_shape(self, shape: Sequence[int],
                         dtype: Any = None) -> "LayerGraph":
        """Same ops and parameters, specs re-inferred for a new input
        shape (on ``meta`` tensors, as ``GraphBuilder.add`` infers them).

        The ops must take any length in ``apply`` (the sequence ops do:
        embeddings slice ``wpe[:t]``, attention masks follow the runtime
        shape); parameter shapes come from the constructor, not the
        input, so the original graph's parameters stay valid.
        ``Defer.logits`` runs short sequences through a power-of-two
        length bucket this way instead of padding to the graph's
        length."""
        spec = ShapeSpec(shape, dtype or self.input_spec.dtype)
        nodes: dict[str, LayerNode] = {}

        def spec_of(n: str) -> ShapeSpec:
            return spec if n == self.input_name else nodes[n].out_spec

        for name, node in self.nodes.items():
            meta = None if node.param_spec is None else tree_map(
                lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                node.param_spec)
            out = node.op.apply(meta, *(spec_of(i).batched(1)
                                        for i in node.inputs))
            nodes[name] = LayerNode(name, node.op, node.inputs,
                                    ShapeSpec(out.shape[1:], out.dtype),
                                    node.param_spec)
        return LayerGraph(self.name, nodes, self.input_name,
                          self.output_name, spec)

    def __repr__(self):
        return f"LayerGraph({self.name!r}, {len(self.nodes)} nodes)"


class GraphBuilder:
    """Functional-style graph construction.

    Shape inference runs eagerly at build time on ``meta`` tensors, so no
    parameters are materialized until ``graph.init(generator)``.  Nodes
    without an explicit name are named ``type(op).__name__.lower()`` plus a
    per-type counter — exactly the JAX package's names, so parameters keyed
    by node name line up across the two packages.
    """

    def __init__(self, name: str):
        self.name = name
        self._nodes: dict[str, LayerNode] = {}
        self._input_name: str | None = None
        self._input_spec: ShapeSpec | None = None
        self._counts: dict[str, int] = {}
        self._last: str | None = None

    def input(self, shape: Sequence[int], dtype: Any = torch.float32) -> str:
        if self._input_name is not None:
            raise ValueError("graph already has an input")
        self._input_name = "input"
        self._input_spec = ShapeSpec(shape, dtype)
        self._last = self._input_name
        return self._input_name

    def _auto_name(self, op: Op) -> str:
        base = type(op).__name__.lower()
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        return f"{base}_{n}" if n else base

    def _spec_of(self, name: str) -> ShapeSpec:
        if name == self._input_name:
            return self._input_spec
        return self._nodes[name].out_spec

    def add(
        self,
        op: Op,
        inputs: str | Sequence[str] | None = None,
        *,
        name: str | None = None,
    ) -> str:
        """Append a node; returns its name (usable as a cut point)."""
        if self._input_name is None:
            raise ValueError("call input() first")
        if inputs is None:
            inputs = [self._last]
        if isinstance(inputs, str):
            inputs = [inputs]
        inputs = tuple(inputs)
        for i in inputs:
            if i != self._input_name and i not in self._nodes:
                raise ValueError(f"unknown input node {i!r}")
        name = name or self._auto_name(op)
        if name in self._nodes or name == self._input_name:
            raise ValueError(f"duplicate node name {name!r}")

        in_specs = tuple(self._spec_of(i) for i in inputs)
        meta_params = op.init(None, in_specs)
        out = op.apply(meta_params, *(s.batched(1) for s in in_specs))
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"op {op!r} must return a single tensor")
        out_spec = ShapeSpec(out.shape[1:], out.dtype)
        param_spec = None
        if meta_params:
            param_spec = tree_map(lambda v: ShapeSpec(v.shape, v.dtype),
                                  meta_params)
        self._nodes[name] = LayerNode(name, op, inputs, out_spec, param_spec)
        self._last = name
        return name

    def build(self, output: str | None = None) -> LayerGraph:
        if self._input_name is None or not self._nodes:
            raise ValueError("empty graph")
        output = output or self._last
        return LayerGraph(self.name, dict(self._nodes), self._input_name,
                          output, self._input_spec)
