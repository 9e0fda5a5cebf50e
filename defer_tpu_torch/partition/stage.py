"""StageSpec: one pipeline stage = a contiguous slice of the layer graph.

The port of ``defer_tpu.partition.stage`` (``StageSpec``,
``JoinStageSpec`` and ``buffer_footprint``).  A StageSpec is pure metadata + a plain tensor
function; the engines wrap it in a :class:`StageModule` that holds the
stage's own parameters on its device, in one flat row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..graph.ir import LayerGraph, ShapeSpec, as_dtype
from ..ops.quant import BLOCK


def buffer_footprint(stages, *, microbatch: int = 1, itemsize: int = 4,
                     wire: str = "buffer") -> dict:
    """Homogeneous transfer-buffer geometry for a stage list.

    ``buf_elems`` (max stage boundary, padded to the int8 block size under
    ``wire="int8"``), ``hop_utilization`` (hop k = stage k's output), and
    ``bytes_per_hop`` (int8: 1 byte/value + one f32 scale per block).
    """
    buf = max([s.in_spec.size for s in stages]
              + [s.out_spec.size for s in stages])
    if wire == "int8":
        buf = -(-buf // BLOCK) * BLOCK
        hop_bytes = microbatch * (buf + 4 * (buf // BLOCK))
    else:
        hop_bytes = buf * microbatch * itemsize
    return {
        "buf_elems": buf,
        "hop_utilization": [s.out_spec.size / buf for s in stages],
        "bytes_per_hop": hop_bytes,
    }


@dataclasses.dataclass(frozen=True)
class StageSpec:
    index: int
    name: str
    graph: LayerGraph
    node_names: tuple[str, ...]   # topo-ordered nodes evaluated by this stage
    input_name: str               # upstream node (or graph input) feeding it
    output_name: str
    in_spec: ShapeSpec
    out_spec: ShapeSpec

    def fn(self, stage_params, x, *, tp: int = 1):
        """Batched forward for this stage; with ``tp > 1`` over the ranks'
        shards and inputs (lists), one output per rank."""
        return self.graph.apply(stage_params, x, start=self.input_name,
                                upto=self.output_name,
                                node_names=self.node_names, tp=tp)

    def select_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """Subset of the full parameters owned by this stage."""
        return {n: params[n] for n in self.node_names if n in params}

    def tp_shard_params(self, params: dict[str, Any], tp: int,
                        rank: int) -> dict[str, Any]:
        """Rank ``rank``'s TP shard of this stage's parameters."""
        sp = self.select_params(params)
        return {n: self.graph.nodes[n].op.tp_shard(sp[n], tp, rank)
                for n in sp}

    def tp_unshard_params(self, rank_params: list[dict[str, Any]]
                          ) -> dict[str, Any]:
        """Inverse of :meth:`tp_shard_params`: all ranks' stage shards ->
        the stage's full parameters (op-specific reassembly)."""
        return {n: self.graph.nodes[n].op.tp_unshard(
                    [rp[n] for rp in rank_params])
                for n in rank_params[0]}

    def __repr__(self):
        return (f"StageSpec({self.index}: {self.input_name} -> "
                f"{self.output_name}, {len(self.node_names)} nodes, "
                f"in={self.in_spec.shape}, out={self.out_spec.shape})")


@dataclasses.dataclass(frozen=True)
class JoinStageSpec:
    """A multi-input pipeline stage: the join of a branched stage graph.

    Where :class:`StageSpec` resumes the graph from one boundary tensor, a
    join stage resumes from ``P`` of them: its first node is the graph's
    merge op (Concat/Add), whose inputs arrive as separate frames from the
    parallel branch paths, in the merge op's input order, which is the
    transport's path order (``transport/branch.py``).  Everything after
    the merge up to the stage's output rides in the same program, so the
    join costs one dispatch like any other stage.
    """

    index: int
    name: str
    graph: LayerGraph
    node_names: tuple[str, ...]
    input_names: tuple[str, ...]  # P seed tensors, in merge-input order
    output_name: str
    in_specs: tuple[ShapeSpec, ...]
    out_spec: ShapeSpec

    @property
    def in_spec(self) -> ShapeSpec:
        """The first input's spec (the single-input surface; callers that
        need every boundary read :attr:`in_specs`)."""
        return self.in_specs[0]

    @property
    def num_inputs(self) -> int:
        return len(self.input_names)

    def fn(self, stage_params: dict[str, Any],
           *xs: torch.Tensor) -> torch.Tensor:
        if len(xs) != len(self.input_names):
            raise ValueError(f"join stage {self.index} takes "
                             f"{len(self.input_names)} inputs, got "
                             f"{len(xs)}")
        return self.graph.apply(stage_params, upto=self.output_name,
                                node_names=self.node_names,
                                seeds=dict(zip(self.input_names, xs)))

    def select_params(self, params: dict[str, Any]) -> dict[str, Any]:
        return {n: params[n] for n in self.node_names if n in params}

    def __repr__(self):
        return (f"JoinStageSpec({self.index}: "
                f"[{','.join(self.input_names)}] -> {self.output_name}, "
                f"{len(self.node_names)} nodes)")


class StageModule(nn.Module):
    """One stage holding its parameters on ``device`` in one flat row (one
    row per rank under tensor parallelism).

    ``row`` is one contiguous tensor in ``weight_dtype`` — the compute
    dtype when one is set and ``master_weights`` is off, else float32, as
    in the JAX engine (``runtime/flatbuf.py`` lays it out) — and each leaf
    the stage function reads is a frozen view into it — conv kernels as
    OIHW with channels_last strides, so cuDNN reads them without a
    per-call relayout.  :meth:`load` packs and validates new parameters
    and :meth:`install` copies them into the same rows, so every view (and
    any CUDA graph that captured them) sees the new weights.

    Given a model ``line`` (``parallel.mesh.ModelLine`` of ``tp > 1``
    ranks) the module holds ``rows``, one per rank of the line it runs
    (``ranks``: every rank in one process, this process's where the line
    crosses processes; ``rows[i]`` is rank ``ranks[i]``'s, on
    ``devices[i]``, default ``device``): rank r's row packs
    ``StageSpec.tp_shard_params(params, tp, r)``, so each row is shorter
    than the whole stage's; the ranks' shards share one layout (``paths``,
    ``meta``), and ``replicated`` flags the leaves every rank holds whole.
    The forward runs the stage's tensor-parallel path on those ranks'
    leaves, its psums over the line, and returns the first one's output.

    Leaf dtypes follow the JAX engine: under ``compute_dtype`` a float
    leaf is read in the compute dtype; otherwise every leaf comes back in
    its original dtype.  A leaf whose dtype is the row's is a view; any
    other (an integer leaf, or a float leaf of an f32 master row under a
    bf16 compute dtype) is cast from its view at each call.

    Training (``runtime/training.py``) sets ``requires_grad`` on the rows.
    Views cut before that carry no graph, so with grad mode on the leaves
    are cut from the rows at each call; the rows themselves are only ever
    updated in place, so the frozen views and captured graphs read the
    trained weights.
    """

    def __init__(self, stage: StageSpec, params: dict[str, Any],
                 device: torch.device, *, compute_dtype=None,
                 master_weights: bool = False, devices=None, line=None):
        # imported here: ``runtime``'s package imports this module
        from ..runtime import flatbuf

        super().__init__()
        self.stage = stage
        #: the model line the forward's psums run over (None: no tensor
        #: parallelism)
        self.line = line
        self.tp = 1 if line is None else line.size
        #: the ranks of the line whose rows this module holds, in order
        self.ranks = (0,) if line is None else tuple(line.ranks)
        self.devices = (list(devices) if devices is not None
                        else [device] * len(self.ranks))
        self.compute_dtype = (None if compute_dtype is None
                              else as_dtype(compute_dtype))
        self.weight_dtype = (torch.float32 if master_weights
                             else self.compute_dtype or torch.float32)
        shards = self._shards(params)
        self.paths, leaves = flatbuf.flatten_leaves(shards[0])
        self.meta = flatbuf.leaf_meta(leaves)
        full = flatbuf.flatten_leaves(stage.select_params(params))[1]
        #: per leaf: every rank holds it whole (its shard is the leaf)
        self.replicated = [tuple(a.shape) == tuple(b.shape)
                           for a, b in zip(leaves, full)]
        self.rows = [self._pack(flatbuf.flatten_leaves(sh)[1]).to(d)
                     for sh, d in zip(shards, self.devices)]
        #: each rank's leaves as views into its row (in the row's dtype);
        #: ``leaves`` is rank 0's
        self.rank_leaves = [flatbuf.unpack_leaves(r, self.meta)
                            for r in self.rows]
        self.leaves = self.rank_leaves[0]
        self._dtypes = [self._leaf_dtype(m[3]) for m in self.meta]
        self._trees = None
        if all(d == self.row.dtype for d in self._dtypes):
            self._trees = [flatbuf.unflatten_leaves(self.paths, lv)
                           for lv in self.rank_leaves]

    @property
    def row(self) -> torch.Tensor:
        """The first rank's row (the stage's only row without tensor
        parallelism)."""
        return self.rows[0]

    def _shards(self, params: dict[str, Any]) -> list[dict[str, Any]]:
        if self.tp == 1:
            return [self.stage.select_params(params)]
        return [self.stage.tp_shard_params(params, self.tp, r)
                for r in self.ranks]

    def _leaf_dtype(self, dtype: torch.dtype) -> torch.dtype:
        if self.compute_dtype is not None and dtype.is_floating_point:
            return self.compute_dtype
        return dtype

    def _to_wire(self, leaf: torch.Tensor) -> torch.Tensor:
        """One leaf in the row's dtype.  Float leaves simply cast (lossy
        to bf16 is the deployment's choice); integer and bool leaves only
        when they round-trip exactly, since a silently corrupted integer
        parameter would be far worse than a loud error."""
        wdt = self.weight_dtype
        cast = leaf.to(wdt)
        if leaf.is_floating_point() or torch.equal(cast.to(leaf.dtype), leaf):
            return cast
        raise ValueError(
            f"stage {self.stage.name!r} has a non-float param leaf (dtype "
            f"{leaf.dtype}) whose values do not survive the {wdt} weight "
            f"buffer; use compute_dtype=None (float32 buffer, exact for "
            f"|int| < 2**24) or keep such leaves out of the flat buffer")

    def _pack(self, leaves) -> torch.Tensor:
        from ..runtime import flatbuf
        return flatbuf.pack_leaves(leaves, self.meta, self.weight_dtype,
                                   self._to_wire)

    def load(self, params: dict[str, Any], what: str) -> list[torch.Tensor]:
        """``params``' leaves for this stage packed into new rows, one per
        rank (on the leaves' device), after checking them against the
        deployed layout."""
        from ..runtime import flatbuf
        rows = []
        for shard in self._shards(params):
            paths, leaves = flatbuf.flatten_leaves(shard)
            flatbuf.check_layout(leaves, paths, self.meta, self.paths, what)
            rows.append(self._pack(leaves))
        return rows

    def install(self, rows: list[torch.Tensor]) -> None:
        """Copy rows from :meth:`load` into the deployed ones, in place
        (also when the rows require grad)."""
        with torch.inference_mode():
            for row, new in zip(self.rows, rows):
                row.copy_(new)

    def params(self, rank: int = 0) -> dict[str, Any]:
        """The nested parameters the stage function of ``rows[rank]``
        reads."""
        from ..runtime import flatbuf
        row, leaves = self.rows[rank], self.rank_leaves[rank]
        if torch.is_grad_enabled() and row.requires_grad:
            leaves = flatbuf.unpack_leaves(row, self.meta)
        elif self._trees is not None:
            return self._trees[rank]
        return flatbuf.unflatten_leaves(
            self.paths, [v if v.dtype == d else v.to(d)
                         for v, d in zip(leaves, self._dtypes)])

    def forward(self, *xs: torch.Tensor, cross: bool = True) -> torch.Tensor:
        """The stage on its input (a join stage: its P inputs, in path
        order); under tensor parallelism the input goes to every rank held
        here and the first one's output comes back.  ``cross=False`` sums
        the psums over this module's ranks only, all-reducing nothing
        across processes (a stage checked on its own: the shapes and ops
        of the real call)."""
        if self.tp == 1:
            return self.stage.fn(self.params(), *xs)
        (x,) = xs
        line = self.line if cross else self.line.local()
        return self.stage.fn([self.params(i) for i in range(len(self.rows))],
                             [x.to(d) for d in self.devices], tp=line)[0]
