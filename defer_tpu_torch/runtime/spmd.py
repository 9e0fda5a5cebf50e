"""Ring pipeline engine: the port of ``defer_tpu.runtime.spmd``.

The JAX engine is one SPMD program over a ``stage`` mesh axis: per step
every device runs its stage on its slot of the activation ring and
``lax.ppermute``s the result to its successor.  On one card the ring is one
``[N, microbatch, buf_elems]`` tensor in ``buffer_dtype``, and a step is:

  1. slot 0 takes the injected input (not quantized);
  2. each stage k runs on slot k, its input cast to the compute dtype
     (floating inputs only); its output is reshaped to ``[b, out_sz]``,
     cast to ``buffer_dtype`` and zero-padded to ``buf_elems``;
  3. the ring rotates one slot (stage k's output to slot k+1, the last
     wraps to slot 0).  Under ``wire="int8"`` the whole ring is
     block-quantized in ONE kernel launch before the rotation and
     dequantized after it (``ops.quant.quantized_ring_hop``) — the wrap hop
     too, so the output read at slot 0 is a dequantized value, exactly as
     on the TPU.

Schedule (unchanged): at step t stage 0 starts microbatch t, stage k
computes microbatch t-k, and the output at slot 0 after step t is
microbatch t-N+1.

The mesh: as in the JAX engine, a pipeline runs on a (data, stage[,
model]) mesh (``parallel/mesh.py``); with no ``mesh=`` the engine builds
the one-card mesh of the extents it is asked for (``data_parallel``,
``tensor_parallel``) on its ``device``.  A process runs its positions on
one device: positions of one process naming two or more devices raise
before anything is placed (ROADMAP A15b).  On one device a process's
positions share its ring:

  * data parallelism splits the microbatch over the data axis (it must
    divide); the replicas' slices sit side by side on the ring's batch axis
    and, sharing the card and the stage rows, run as one batch — the same
    ops on the same weights, as the JAX engine runs each shard;
  * tensor parallelism gives each stage one weight row per rank of the
    model axis (its Megatron shard, ``StageModule``); each step runs every
    rank's shard of the stage in turn, with the in-stage psums between
    them (``Op.tp_apply``), and the ring carries the activation every rank
    holds after the stage's last psum (rank 0's).  A chunk is still one
    CUDA-graph replay, the int8 hop still one quantizer launch a step.

Across processes (a mesh from ``multihost_pipeline_mesh``, one
``torch.distributed`` process per card or several sharing one): each
process holds a block of consecutive stages of consecutive data lines,
builds the ``StageModule``s of its stages only and a ring ``[n_local,
microbatch * lines / data_parallel, buf_elems]``.  Every process is called
with the same inputs, as JAX's multi-controller program is; the process
holding stage 0 of a line injects that line's rows, and only it copies
them to its device.  At each hop the ring rotates within the process and
the slot leaving it crosses to the process of the next stage (``_cross``:
one ``batch_isend_irecv`` a step); under ``wire="int8"`` the process
quantizes its slots in one launch and the boundary slot's int8 payload
and scales are what cross (``ops.quant.quantized_ring_hop``).  The wrap
hop lands the outputs on stage 0's process; every push then gathers them
over the data lines and broadcasts them, so ``run``/``push``/``flush``
return the full rows on EVERY process (JAX's ``outs[0]`` is readable only
on the process holding device 0: returning them everywhere is the port's
choice).
``hop_transport`` names how the hop crosses: ``"local"`` (one process),
``"gloo"`` (host-staged: gloo's sends take host tensors, so a CUDA slot
goes through pinned memory) or ``"nccl"`` (device tensors; the engine
first refuses ranks whose rings share a card, which NCCL cannot run,
keyed on each ring's own device: :func:`ring_transport`).  Such a ring
runs its chunks eagerly: a CUDA graph cannot hold a gloo send, and the
engine decides that from the mesh at construction.  ``metrics`` counts the
bytes that cross (``boundary_bytes``, ``boundary_sends``).  The schedule
and the outputs are the one-process ring's; only the microbatches that
complete in a push are broadcast (the real ones, unless ``raw``).  The
crossings and broadcasts run on the mesh's group (``Mesh.world``: the
default one, or a serving generation's own from ``regroup``).  A loop that
one process decides (the dispatcher's serve loops) hands a push's input
out with :meth:`SpmdPipeline.deal`: the deciding process holds every row,
sends each data line's to the processes holding its stage 0, and a
process that injects none pushes the bubble block.

A model axis may cross processes too (``multihost_pipeline_mesh(S,
tensor_parallel=T)`` with fewer than T devices a process): a process then
holds a block of the model line's ranks (``ranks``; the same block at each
of its stages, every block as long), its ``StageModule``s the rows of
those ranks only, and the stages' psums all-reduce over the line's
processes (``parallel.mesh.ModelLine``, counted in
``metrics.allreduce_calls``/``allreduce_bytes``).  Every rank holds the
stage's output after its last psum, so each block of ranks rides a ring of
its own along the stage axis: the slot leaving rank block b of stage k
crosses to rank block b of stage k + 1 (:func:`ring_block`), every process
of stage 0 injects the rows, and the outputs are read from the processes
of the first block.

Weights: each stage holds one flat row (``runtime/flatbuf.py``) in
``weight_dtype`` — ``compute_dtype`` when set, else float32, as in the JAX
engine; ``master_weights=True`` keeps the rows float32 and casts each float
leaf to the compute dtype at each call (the mixed-precision training
recipe) — and ``reweight`` copies new weights into the same rows.
``runtime/training.py`` differentiates the same step (:meth:`_stages`, then
:meth:`_hop`) and updates the rows in place, so the deployment that trains
is the one that serves.

A chunk of steps: the JAX engine compiles it into one program (``lax.scan``
inside ``jit``).  On the card its counterpart is one CUDA-graph replay per
chunk.  The graph of a chunk length is captured at the first push of that
length, on the pushing thread, after one eager warm-up pass on a scratch
ring; the ring, the input block and the output slab are static tensors the
graph reads and writes.  On the CPU a chunk is the same steps run eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..graph.ir import ShapeSpec, as_dtype
from ..obs import tracer
from ..ops.launches import counted_kernels
from ..ops.quant import ste_ring_hop
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh,
                             ModelLine, broadcast, current_process,
                             exchange, line_group, mesh_placement,
                             one_card_mesh)
from ..partition.stage import StageModule, StageSpec, buffer_footprint
from ..utils.config import resolve_device
from ..utils.metrics import PipelineMetrics
from .cuda_graph import CapturedGraph, capture

#: compute dtypes the port runs (its kernels take float32 and bfloat16)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_single_card(*, compute_dtype=None) -> None:
    """Raise for a compute dtype the port's kernels do not take."""
    if compute_dtype is not None and as_dtype(compute_dtype) \
            not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype!r} is not ported (float32 or "
            "bfloat16)")


def ring_mesh(engine: str, num_stages: int, mesh: Mesh | None, device,
              data_parallel: int = 1, tensor_parallel: int = 1
              ) -> tuple[Mesh, torch.device]:
    """``(mesh, device)`` of a ring engine: the given mesh and this
    process's one device, or the one-card mesh of these extents on
    ``device``.  Before anything is placed, several devices in this
    process raise naming ROADMAP A15b."""
    if mesh is None:
        dev = resolve_device(device)
        return one_card_mesh(dev, num_stages, data_parallel,
                             tensor_parallel), dev
    dev = mesh_placement(mesh, engine)[1]
    if mesh.shape.get(STAGE_AXIS) != num_stages:
        raise ValueError(f"mesh stage axis is {mesh.shape.get(STAGE_AXIS)} "
                         f"but the pipeline has {num_stages} stages")
    for axis, asked in ((DATA_AXIS, data_parallel),
                        (MODEL_AXIS, tensor_parallel)):
        if asked != 1 and mesh.shape.get(axis, 1) != asked:
            raise ValueError(f"{axis} axis {mesh.shape.get(axis, 1)} of the "
                             f"mesh != the {asked} asked for")
    if device is not None and resolve_device(device) != resolve_device(dev):
        raise ValueError(f"device {device!r} is not the mesh's {dev}")
    return mesh, resolve_device(dev)


def model_ranks(mesh: Mesh, mine: np.ndarray) -> range:
    """This process's ranks of the mesh's model axis (``range(1)`` without
    one; every rank within one process).  Every process must hold the same
    ranks at each (line, stage) it holds, a block of consecutive ranks as
    long as every other process's and starting at a multiple of its
    length, so that each block of one stage faces the same block of the
    next stage (the ring of that block: :func:`ring_block`)."""
    names = mesh.axis_names
    if MODEL_AXIS not in names:
        return range(1)
    i = names.index(MODEL_AXIS)
    t = mesh.devices.shape[i]

    def ranks_of(held: np.ndarray) -> range:
        per = np.moveaxis(held, i, -1).reshape(-1, t)
        per = per[per.any(1)]
        rs = np.flatnonzero(per[0])
        if (per != per[0]).any() or rs[-1] - rs[0] + 1 != len(rs):
            raise ValueError(
                f"a process's positions on the model axis must be the same "
                f"consecutive ranks at each (line, stage) it holds: "
                f"{np.argwhere(held).tolist()}")
        return range(int(rs[0]), int(rs[-1]) + 1)

    blocks = {ranks_of(mesh.processes == p)
              for p in np.unique(mesh.processes)}
    if any(len(b) != len(next(iter(blocks))) or b.start % len(b)
           for b in blocks):
        raise ValueError(f"the processes' blocks of model ranks are not "
                         f"aligned blocks of one length: "
                         f"{sorted((b.start, b.stop) for b in blocks)}")
    return ranks_of(mine) if mesh.spans_processes else range(t)


def _owners(mesh: Mesh, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """``(procs, names)``: the process owning each position at model rank
    ``rank`` (every position without a model axis), and its axes."""
    names, procs = mesh.axis_names, mesh.processes
    if MODEL_AXIS in names:
        procs = np.take(procs, rank, axis=names.index(MODEL_AXIS))
        names = tuple(a for a in names if a != MODEL_AXIS)
    return procs, names


def ring_block(mesh: Mesh, mine: np.ndarray, rank: int | None = None
               ) -> tuple[range, range, np.ndarray]:
    """``(lines, stages, owners)`` of this process on a (data, stage[,
    model]) mesh: the data lines and the stages whose positions it holds
    (``mine``), which must be consecutive and form one block, and the
    process owning each (line, stage), ``[data, stage]``, at model rank
    ``rank``: by default this process's first (:func:`model_ranks`), so
    ``owners`` names the processes of the ring its slots ride (each block
    of model ranks has its own ring along the stage axis); ``rank=0``
    names those holding the line's first rank (the outputs' and the
    leader's)."""
    if rank is None:
        rank = model_ranks(mesh, mine).start
    procs, names = _owners(mesh, rank)
    held = mine
    if MODEL_AXIS in mesh.axis_names:
        held = mine.any(axis=mesh.axis_names.index(MODEL_AXIS))
    if DATA_AXIS not in names:
        procs, held, names = procs[None], held[None], (DATA_AXIS,) + names
    if set(names) != {DATA_AXIS, STAGE_AXIS}:
        raise ValueError(f"a ring mesh has axes (data, stage[, model]), "
                         f"not {mesh.axis_names}")
    order = [names.index(DATA_AXIS), names.index(STAGE_AXIS)]
    procs, held = procs.transpose(order), held.transpose(order)
    ds, ss = np.flatnonzero(held.any(1)), np.flatnonzero(held.any(0))
    lines = range(int(ds[0]), int(ds[-1]) + 1)
    stages = range(int(ss[0]), int(ss[-1]) + 1)
    if held.sum() != len(lines) * len(stages):
        raise ValueError(
            f"process {current_process()}'s positions are not consecutive "
            f"stages of consecutive data lines: {np.argwhere(held).tolist()}")
    return lines, stages, procs


def ring_transport(mesh: Mesh, device: torch.device) -> str:
    """How a ring's hop crosses on ``mesh`` (see the module's docstring):
    ``"local"`` in one process, else the group's backend.  The mesh must
    cover every process of the group.  Under NCCL, ranks whose rings share
    a card are refused first, keyed on ``device``, the ring's own
    (``parallel/distributed.py`` ``refuse_shared_cards``).  Then every
    axis that crosses processes gets its line groups, made by every
    process in one order (``line_group``): call this at construction, on
    every process."""
    if not mesh.spans_processes:
        return "local"
    import torch.distributed as dist
    if set(int(p) for p in mesh.processes.flat) != set(
            range(dist.get_world_size())):
        raise ValueError("a ring across processes needs a mesh over every "
                         "process of the group")
    backend = dist.get_backend()
    if backend == "nccl":
        from ..parallel.distributed import refuse_shared_cards
        refuse_shared_cards(device)
    for axis in mesh.axis_names:  # every process, in one order
        if mesh.axis_crosses_processes(axis):
            line_group(mesh, axis)
    return backend


def cross_slot(slot: list[torch.Tensor], sends, recvs,
               metrics: PipelineMetrics, group=None) -> list[torch.Tensor]:
    """Send the tensors of the slot leaving this process (their rows per
    data line: ``sends``, ``[(rows, process)]``) to the process of the
    next stage, and return the slot arriving from the previous stage's
    (``recvs``): one ``batch_isend_irecv`` on ``group`` (a mesh's
    ``world``).  ``metrics`` counts the sends, their bytes and the
    seconds spent in them."""
    out_sends = [(t[rows], p) for rows, p in sends for t in slot]
    got = iter(exchange(out_sends, [(t[rows], p) for rows, p in recvs
                                    for t in slot], group, metrics))
    out = [torch.empty_like(t) for t in slot]
    for rows, _ in recvs:
        for o in out:
            o[rows] = next(got)
    metrics.boundary_sends += len(sends)
    metrics.boundary_bytes += sum(t.numel() * t.element_size()
                                  for t, _ in out_sends)
    return out


class _CrossSlot(torch.autograd.Function):
    """:func:`cross_slot` of one tensor with a backward: the forward sends
    the slot leaving this process to the next stage's and returns the one
    arriving from the previous stage's; the backward sends the arriving
    slot's gradient back to the process that sent it and returns the
    gradient of the slot this process sent, received from the next
    stage's (the same ``batch_isend_irecv`` with the sends and receives
    swapped: the JAX trainer's transpose of ``lax.ppermute``).  Both count
    in ``metrics``.  It saves nothing, so a recompute never reruns it.
    Every process must run the backward of every crossing, in reverse
    order, or a neighbour blocks in its receive: ``token`` (the
    pipeline's ``_cross_token``, a leaf that requires grad) records the
    crossing under autograd even where nothing this process trains feeds
    the slot (a stage without weights), and ``runtime/training.py`` asks
    for the token's gradient beside the rows' and makes each ring a step
    leaves a root, so autograd runs every crossing's backward."""

    @staticmethod
    def forward(ctx, slot, token, sends, recvs, metrics, group):
        ctx.route = (sends, recvs, metrics, group)
        return cross_slot([slot], sends, recvs, metrics, group)[0]

    @staticmethod
    def backward(ctx, g):
        sends, recvs, metrics, group = ctx.route
        return (cross_slot([g], recvs, sends, metrics, group)[0], None, None,
                None, None, None)


def _runs(owners, lines: range, per: int, base: int = 0):
    """``[(rows, process)]``: consecutive data lines with one owner as one
    slice of rows (``per`` rows a line, counted from line ``base``)."""
    out = []
    for d in lines:
        p = int(owners[d])
        rows = slice((d - base) * per, (d - base + 1) * per)
        if out and out[-1][1] == p:
            out[-1] = (slice(out[-1][0].start, rows.stop), p)
        else:
            out.append((rows, p))
    return out


class _RingOf(torch.autograd.Function):
    """The ring of the stages' outputs ``[b, out_sz_k]``: slot k holds
    output k cast to ``dtype`` and zero-padded to ``buf`` values (written
    in place into one new ring, as inference always did).  The backward
    hands each output its slot's slice of the ring's gradient, a view:
    written through autograd, each slot's in-place copy would clone the
    whole ring's gradient in the backward."""

    @staticmethod
    def forward(ctx, buf: int, dtype, *outs):
        y = outs[0].new_empty((len(outs), outs[0].shape[0], buf),
                              dtype=dtype)
        for k, out in enumerate(outs):
            sz = out.shape[1]
            y[k, :, :sz] = out  # cast to the buffer
            if sz < buf:
                y[k, :, sz:] = 0
        ctx.outs = [(out.shape[1], out.dtype) for out in outs]
        return y

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g[k, :, :sz].to(dt)
                              for k, (sz, dt) in enumerate(ctx.outs)))


@dataclasses.dataclass
class _ChunkGraph:
    """One captured chunk: its graph and its static input block and output
    slab."""

    graph: CapturedGraph
    xs: torch.Tensor
    outs: torch.Tensor


class SpmdPipeline:
    """Inference pipeline over a ring of stage slots on one device.

    Usage::

        stages = partition(graph, cut_points)
        pipe = SpmdPipeline(stages, params, device="cuda")
        outputs = pipe.run(inputs)          # [M, B, ...] -> [M, B, ...]

    or streaming: ``reset()`` / ``push(chunk, n_real)`` / ``flush()``.
    ``device=None`` means the CUDA card (an error when CUDA is absent).
    ``mesh=`` (a one-card ``pipeline_mesh``, or a mesh over several
    ``torch.distributed`` processes from ``multihost_pipeline_mesh``) or
    ``data_parallel`` / ``tensor_parallel`` run the pipeline pp x dp x tp.
    Across processes, ``modules`` holds this process's stages
    (``local_stages``), ``run``/``push``/``flush`` return every row on
    every process, and ``stage_latencies`` and ``metrics`` are this
    process's (see the module's docstring).
    """

    def __init__(
        self,
        stages: Sequence[StageSpec],
        params: dict[str, Any],
        *,
        mesh: Mesh | None = None,
        device: str | torch.device | None = None,
        microbatch: int = 1,
        chunk: int = 16,
        buffer_dtype=torch.float32,
        compute_dtype=None,
        wire: str = "buffer",
        data_parallel: int = 1,
        tensor_parallel: int = 1,
        master_weights: bool = False,
    ):
        self.stages = list(stages)
        self.num_stages = n = len(self.stages)
        self.mesh, self.device = ring_mesh(
            "SpmdPipeline", n, mesh, device, data_parallel, tensor_parallel)
        check_single_card(compute_dtype=compute_dtype)
        if wire not in ("buffer", "int8"):
            raise ValueError(f"wire must be 'buffer' or 'int8', got {wire!r}")
        self.data_parallel = self.mesh.shape.get(DATA_AXIS, 1)
        self.tensor_parallel = tp = self.mesh.shape.get(MODEL_AXIS, 1)
        if microbatch % self.data_parallel:
            raise ValueError(f"microbatch {microbatch} must divide by "
                             f"data_parallel {self.data_parallel}")
        self.microbatch = microbatch
        self.chunk = chunk
        self.buffer_dtype = as_dtype(buffer_dtype)
        self.compute_dtype = cd = (None if compute_dtype is None
                                   else as_dtype(compute_dtype))
        self.master_weights = bool(master_weights)
        #: the flat rows' dtype: the compute dtype when set (and not
        #: ``master_weights``), else float32
        self.weight_dtype = (torch.float32 if self.master_weights
                             else cd or torch.float32)
        self.wire = wire

        self._in_sizes = [s.in_spec.size for s in self.stages]
        self._out_sizes = [s.out_spec.size for s in self.stages]
        # stage k's input dtype: the compute dtype for floating inputs
        self._x_dtypes = [cd if cd is not None
                          and s.in_spec.dtype.is_floating_point
                          else s.in_spec.dtype for s in self.stages]
        self._footprint = buffer_footprint(
            self.stages, microbatch=microbatch,
            itemsize=self.buffer_dtype.itemsize, wire=wire)
        self.buf_elems = self._footprint["buf_elems"]
        self.in_spec: ShapeSpec = self.stages[0].in_spec
        self.out_spec: ShapeSpec = self.stages[-1].out_spec
        if (not self.in_spec.dtype.is_floating_point
                and self.buffer_dtype != torch.float32):
            raise ValueError(
                "integer model inputs (e.g. token ids) require "
                "buffer_dtype=float32: ids above 256 are not exactly "
                f"representable in {self.buffer_dtype}")

        self.metrics = PipelineMetrics(
            num_stages=n, microbatch=microbatch, buffer_elems=self.buf_elems,
            buffer_bytes_per_hop=self._footprint["bytes_per_hop"])
        self._place(microbatch)
        #: the model line the stages' psums run over: this process's ranks
        #: (``ranks``), all-reduced across processes where the line
        #: crosses them, counted in ``metrics.allreduce_*``
        self.line = (ModelLine(tp, self.ranks, self.mesh, MODEL_AXIS,
                               count=self.metrics) if tp > 1 else None)
        #: this process's stages' modules (``local_stages``), each holding
        #: its flat weight rows on the device: one per rank of the model
        #: axis that this process holds (``ranks``)
        self.modules = [StageModule(self.stages[k], params, self.device,
                                    compute_dtype=cd,
                                    master_weights=self.master_weights,
                                    line=self.line)
                        for k in self.local_stages]
        self.metrics.bind()
        self._flush_zeros = None  # lazy device-resident bubble block
        #: the ring (this process's slots and rows): allocated once, zeroed
        #: in place by ``reset``, read and written in place by every chunk
        #: (a captured graph holds it)
        self._a = torch.zeros((len(self.local_stages), self._b,
                               self.buf_elems),
                              dtype=self.buffer_dtype, device=self.device)
        self._graphs: dict[int, _ChunkGraph] = {}
        self.reset()

    def _place(self, microbatch: int) -> None:
        """This process's block of the ring, the hop's transport and the
        sends and receives across process boundaries (none in one
        process)."""
        n, mesh = self.num_stages, self.mesh
        mine, _ = mesh_placement(mesh, "SpmdPipeline")
        #: this process's ranks of the model axis (every rank in one
        #: process)
        self.ranks = model_ranks(mesh, mine)
        lines, self.local_stages, owners = ring_block(mesh, mine)
        # the processes holding each line's first model rank: the outputs
        # are read there (every rank holds them after the last psum)
        first = ring_block(mesh, mine, rank=0)[2]
        per = microbatch // self.data_parallel
        #: this process's rows of a microbatch, and their count
        self._rows = slice(lines.start * per, lines.stop * per)
        self._b = len(lines) * per
        #: the rows of a microbatch this process injects: its lines' where
        #: it holds stage 0, none elsewhere (every row in one process)
        self._in_rows = (self._rows if self.local_stages.start == 0
                         else slice(0, 0))
        #: the process holding stage 0 of data line 0 (its first model
        #: rank; this one within one process): the one that takes the
        #: dispatcher's decisions
        self.first_process = int(first[0, 0])
        #: the group the crossings and broadcasts run on (the mesh's)
        self._group = mesh.world
        self._sends = self._recvs = self._out_srcs = self._in_dsts = None
        #: across processes, an input of every crossing under autograd
        #: (:class:`_CrossSlot`): a leaf that requires grad
        self._cross_token = None
        self.hop_transport = ring_transport(mesh, self.device)
        if mesh.spans_processes:
            #: stage 0's rows, gathered from their processes each push
            #: (those of the lines' first model rank)
            self._out_srcs = _runs(first[:, 0], range(first.shape[0]), per)
            #: every process injecting rows: stage 0's of each line, at
            #: each block of model ranks (where :meth:`deal` sends them)
            t, b = self.mesh.shape.get(MODEL_AXIS, 1), len(self.ranks)
            self._in_dsts = [run for r in range(0, t, b) for run in _runs(
                ring_block(mesh, mine, rank=r)[2][:, 0],
                range(first.shape[0]), per)]
            if len(self.local_stages) < n:
                nxt = self.local_stages.stop % n
                prv = (self.local_stages.start - 1) % n
                self._sends = _runs(owners[:, nxt], lines, per, lines.start)
                self._recvs = _runs(owners[:, prv], lines, per, lines.start)
                self._cross_token = torch.zeros(0, device=self.device,
                                                requires_grad=True)
        #: CUDA graphs per chunk only within one process (a graph cannot
        #: hold a gloo send); chosen here, from the mesh
        self._graphed = (self.device.type == "cuda"
                         and self.hop_transport == "local")

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def reweight(self, params) -> None:
        """Install fresh weights into the live pipeline, in place.

        The new params (same graph, same leaf shapes and dtypes) are
        packed and checked for every stage first; only then is each row
        copied into the deployed one, so a layout error leaves the
        deployment untouched.  Captured graphs keep serving, now with the
        new weights.  Microbatches still inside the pipe run their
        REMAINING stages under the new weights (mixed-generation
        execution) — call ``flush()`` first when a clean cut matters.
        """
        self.install_weights(self.pack_weights(params))

    def pack_weights(self, params) -> list:
        """``params`` packed into this process's stages' rows and checked
        (a layout error raises here); :meth:`install_weights` copies them
        in.  ``reweight`` is the two in turn."""
        return [m.load(params, f"reweight: stage {self.stages[k].name!r}")
                for m, k in zip(self.modules, self.local_stages)]

    def install_weights(self, rows: list) -> None:
        for m, r in zip(self.modules, rows):
            m.install(r)

    # ------------------------------------------------------------------
    # one stage / one pipeline step / one chunk
    # ------------------------------------------------------------------

    def _branch(self, i: int, slot: torch.Tensor,
                cross: bool = True) -> torch.Tensor:
        """This process's i-th stage on one ring slot ``[b, buf_elems]``:
        ``[b, out_sz]`` in the stage's compute dtype (``cross=False``: its
        psums all-reduce nothing across processes,
        ``StageModule.forward``)."""
        k = self.local_stages[i]
        b = slot.shape[0]
        spec = self.stages[k].in_spec
        x = slot[:, :self._in_sizes[k]].reshape((b,) + spec.shape)
        return self.modules[i](x.to(self._x_dtypes[k]), cross=cross).reshape(
            b, self._out_sizes[k])

    def _stages(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Run every stage (of this process) on its slot of ring ``a``,
        stage 0 on the injected input ``x`` (the dispatcher feeding node 0)
        in place of slot 0: the ring before the hop (``a`` is not
        modified).  The slots are one ``unbind`` of the ring, whose
        backward stacks the slots' gradients once."""
        slots = a.unbind(0)
        return _RingOf.apply(
            a.shape[2], self.buffer_dtype,
            *(self._branch(i, x if k == 0 else slots[i])
              for i, k in enumerate(self.local_stages)))

    def _hop(self, y: torch.Tensor) -> torch.Tensor:
        """Rotate the ring one slot (stage k's output to slot k+1); under
        ``wire="int8"`` through the quantized hop, whose backward is the
        straight-through roll back.  Across processes the slot leaving
        this process crosses to the next stage's (:meth:`_cross`) and,
        under autograd, its gradient crosses back (:class:`_CrossSlot`;
        on the int8 wire the straight-through hop's :meth:`_cross_back`):
        the forward's launches, bytes and rows are the same either way."""
        if self._sends is None:
            if self.wire == "int8":
                return ste_ring_hop(y, self.buffer_dtype)
            return torch.roll(y, 1, 0)
        if self.wire == "int8":
            return ste_ring_hop(y, self.buffer_dtype, self._cross,
                                self._cross_back, self._cross_token)
        y = torch.roll(y, 1, 0)
        y[0] = _CrossSlot.apply(y[0], self._cross_token, self._sends,
                                self._recvs, self.metrics, self._group)
        return y

    def _cross(self, slot: list[torch.Tensor]) -> list[torch.Tensor]:
        """The slot leaving this process to the next stage's, the one
        arriving from the previous stage's (:func:`cross_slot`)."""
        return cross_slot(slot, self._sends, self._recvs, self.metrics,
                          self._group)

    def _cross_back(self, g: torch.Tensor) -> torch.Tensor:
        """The gradient of the arriving slot back to the previous stage's
        process; returns the gradient of the slot this process sent,
        from the next stage's (in the buffer dtype, as JAX's
        ``ppermute(g, inv_perm)``)."""
        return cross_slot([g], self._recvs, self._sends, self.metrics,
                          self._group)[0]

    def _chunk(self, ring: torch.Tensor, xs: torch.Tensor,
               outs: torch.Tensor) -> None:
        """Advance ``ring`` by ``xs.shape[0]`` steps, in place, writing
        what the last stage delivered to slot 0 at step t to ``outs[t]``."""
        out_sz = self._out_sizes[-1]
        a = ring
        for t in range(xs.shape[0]):
            a = self._hop(self._stages(a, xs[t]))
            outs[t] = a[0, :, :out_sz]
        if a is not ring:
            ring.copy_(a)

    def _slab(self, c: int, rows: int | None = None) -> torch.Tensor:
        return torch.empty((c, rows or self._b, self._out_sizes[-1]),
                           dtype=self.buffer_dtype, device=self.device)

    @torch.inference_mode()
    def _eager_chunk(self, xs: torch.Tensor) -> torch.Tensor:
        """One chunk run step by step (the CPU's path, and every ring
        across processes): ``[C, B, out_sz]``, this process's rows (across
        processes :meth:`_collect` gathers the ones it returns)."""
        outs = self._slab(xs.shape[0])
        self._chunk(self._a, xs, outs)
        return outs

    @torch.inference_mode()
    def _gather(self, outs: torch.Tensor) -> torch.Tensor:
        """Every row of outputs ``[k, rows, out_sz]`` on every process:
        each data line's rows broadcast from the process holding its stage
        0."""
        full = self._slab(outs.shape[0], self.microbatch)
        me, r0 = current_process(), self._rows.start
        for rows, src in self._out_srcs:
            block = (outs[:, rows.start - r0:rows.stop - r0].contiguous()
                     if src == me else full[:, rows].contiguous())
            full[:, rows] = broadcast(block, src, self._group)
        return full

    def _capture(self, c: int) -> _ChunkGraph:
        """Capture the chunk of length ``c`` as a CUDA graph over static
        buffers (``runtime/cuda_graph.py``), its warm-up pass on a scratch
        ring."""
        xs = torch.zeros((c, self.microbatch, self.buf_elems),
                         dtype=self.buffer_dtype, device=self.device)
        outs = self._slab(c)
        g = capture(lambda: self._chunk(self._a, xs, outs), self.device,
                    warmup=lambda: self._chunk(self._a.clone(), xs, outs),
                    label=f"spmd.chunk{c}")
        self.metrics.graph_pool_bytes += g.pool_bytes
        self.metrics.captures += 1
        return _ChunkGraph(g, xs, outs)

    def _graph_chunk(self, xs: torch.Tensor) -> torch.Tensor:
        """One chunk as one replay of its captured graph (captured at the
        first push of its length); returns the static output slab."""
        c = xs.shape[0]
        g = self._graphs.get(c)
        if g is None:
            g = self._graphs[c] = self._capture(c)
        with torch.inference_mode():
            g.xs.copy_(xs)
        g.graph.replay()
        return g.outs

    def _run_chunk(self, xs: torch.Tensor) -> torch.Tensor:
        """Advance ``xs.shape[0]`` steps; returns ``[C, B, out_sz_last]``:
        what the last stage delivered to slot 0 at each step (on the card,
        the graph's slab, which the next replay overwrites)."""
        if self._graphed:
            return self._graph_chunk(xs)
        return self._eager_chunk(xs)

    # ------------------------------------------------------------------
    # streaming interface
    # ------------------------------------------------------------------

    def reset(self):
        """Empty the pipe (all stages hold bubbles): the ring is zeroed in
        place, never reallocated, so captured graphs stay valid."""
        with torch.inference_mode():
            self._a.zero_()
        self._step_count = 0
        self._fed = 0
        self._real: collections.deque[bool] = collections.deque()
        self._emitted = 0

    @property
    def _n_in(self) -> int:
        return self._in_rows.stop - self._in_rows.start

    def _flatten_inputs(self, xs, staged: bool = False,
                        rows: slice | None = None) -> torch.Tensor:
        """``xs`` as the ring's input block on the device, ``[C, rows,
        buf_elems]``: only the rows this process injects (``_in_rows``),
        or ``rows`` of the microbatch."""
        rows = self._in_rows if rows is None else rows
        n_in = rows.stop - rows.start
        if (isinstance(xs, torch.Tensor) and xs.device == self.device
                and xs.ndim == 3 and xs.dtype == self.buffer_dtype
                and xs.shape[2] == self.buf_elems
                and xs.shape[1] in (n_in, self.microbatch)):
            # already staged via stage_inputs() (or a full staged block)
            return xs if xs.shape[1] == n_in else xs[:, rows]
        if not isinstance(xs, torch.Tensor):
            xs = torch.from_numpy(np.asarray(xs, np.float32))
        if staged:
            # host block already in transfer-buffer layout; opt-in only, so
            # a mis-shaped input never skips validation by coincidence
            if xs.ndim != 3 or tuple(xs.shape[1:]) != (self.microbatch,
                                                       self.buf_elems):
                raise ValueError(
                    f"staged block must be [C, {self.microbatch}, "
                    f"{self.buf_elems}], got {tuple(xs.shape)}")
            return xs[:, rows].to(self.device, self.buffer_dtype)
        c = xs.shape[0]
        flat = xs.reshape(c, self.microbatch, -1)
        if flat.shape[-1] != self._in_sizes[0]:
            raise ValueError(
                f"input sample size {flat.shape[-1]} != stage-0 input "
                f"size {self._in_sizes[0]}")
        buf = torch.zeros((c, n_in, self.buf_elems),
                          dtype=self.buffer_dtype, device=self.device)
        buf[..., :flat.shape[-1]] = flat[:, rows].to(self.device,
                                                     torch.float32)
        return buf

    def stage_inputs(self, xs, every_row: bool = False) -> torch.Tensor:
        """Pre-stage a [C, microbatch, *in_shape] block on the device (the
        rows this process injects, or with ``every_row`` all of them, as
        :meth:`deal` takes them); ``push`` takes the result as it is."""
        return self._flatten_inputs(
            xs, rows=slice(0, self.microbatch) if every_row else None)

    def deal(self, block: torch.Tensor | None, src: int) -> torch.Tensor:
        """The input block of one push of a full chunk that process ``src``
        decided, on every process of a ring across processes (each calls
        it): ``src`` passes its every-row staged block
        (``stage_inputs(xs, every_row=True)``) and sends each other process
        holding stage 0 of a data line that line's rows, which it receives
        (one ``batch_isend_irecv`` on the mesh's group); a process that
        injects no rows gets the bubble block (the others pass None).
        Returns what this process's ``push`` injects.  The rows are the
        input's, not the ring's slots: ``metrics`` does not count them."""
        if current_process() == src:
            exchange([(block[:, rows], p) for rows, p in self._in_dsts
                      if p != src], [], self._group)
            return block
        if self._n_in == 0:
            return self._bubble_block()
        like = torch.empty((self.chunk, self._n_in, self.buf_elems),
                           dtype=self.buffer_dtype, device=self.device)
        return exchange([], [(like, src)], self._group)[0]

    def push(self, xs, n_real: int | None = None, *,
             staged: bool = False, raw: bool = False):
        """Advance the pipe by ``xs.shape[0]`` steps, feeding ``xs``.

        ``xs``: [C, microbatch, *in_shape] host array or tensor, or a device
        block from ``stage_inputs``.  ``n_real`` marks how many leading
        entries are real inputs (the rest are bubble padding).
        ``staged=True`` declares a block already in transfer-buffer layout
        ``[C, microbatch, buf_elems]``.  Returns the list of completed
        output microbatches (device tensors [microbatch, *out_shape]), in
        feed order.

        ``raw=True`` returns ``(slab, real_mask)`` instead: one device
        tensor ``[n_completed, microbatch, out_size]`` of every microbatch
        that completed this chunk (bubbles included; None when none did)
        plus a bool mask of which entries are real.
        """
        c = xs.shape[0]
        if n_real is None:
            n_real = c
        xs_dev = self._flatten_inputs(xs, staged=staged)
        t0 = time.perf_counter()
        outs = self._run_chunk(xs_dev)
        self.metrics.chunk_calls += 1
        self.metrics.steps += c
        self._real.extend([True] * n_real + [False] * (c - n_real))
        self._fed += c

        ready = self._collect(outs, c, raw=raw)
        dt = time.perf_counter() - t0
        self.metrics.wall_s += dt
        self.metrics.push_latency.record(dt)
        tr = tracer()
        if tr.enabled:
            tr.record("spmd.push", t0, dt, {"chunk": c, "n_real": n_real})
        return ready

    def _collect(self, outs: torch.Tensor, c: int, raw: bool = False):
        """Map step outputs back to microbatch indices and drop bubbles.
        The completed range is cloned once: on the card ``outs`` is the
        graph's slab, which the next replay overwrites."""
        n = self.num_stages
        out_shape = (self.microbatch,) + self.out_spec.shape
        # steps j in this chunk completing a microbatch m = step+j-(n-1)
        # with 0 <= m < fed form one contiguous local range [j0, j1)
        j0 = max(0, (n - 1) - self._step_count)
        j1 = min(c, self._fed + (n - 1) - self._step_count)
        cnt = max(0, j1 - j0)
        if cnt and self._step_count + j0 - (n - 1) != self._emitted:
            raise RuntimeError("pipeline outputs out of feed order: "
                               f"{(self._step_count, j0, n, self._emitted)}")
        self._step_count += c
        mask = np.array([self._real.popleft() for _ in range(cnt)], bool)
        self._emitted += cnt
        self.metrics.inferences += int(mask.sum()) * self.microbatch
        if raw:
            done = outs[j0:j1] if cnt else None
            if done is not None:
                done = (done.clone() if self._out_srcs is None
                        else self._gather(done))
            return done, mask
        # the real ones (across processes only they are broadcast)
        keep = [j0 + j for j in range(cnt) if mask[j]]
        if not keep:
            return []
        done = outs[keep] if len(keep) < j1 - j0 else outs[j0:j1].clone()
        if self._out_srcs is not None:
            done = self._gather(done)
        return [o.reshape(out_shape) for o in done]

    def _bubble_block(self) -> torch.Tensor:
        """Cached device-resident all-bubble [chunk, ...] input block."""
        if self._flush_zeros is None:
            self._flush_zeros = torch.zeros(
                (self.chunk, self._n_in, self.buf_elems),
                dtype=self.buffer_dtype, device=self.device)
        return self._flush_zeros

    @torch.inference_mode()
    def check_stages(self) -> None:
        """Run this process's stages once on a bubble slot, crossing
        nothing: a stage that cannot run raises here, on its own process,
        where a push would leave its neighbours waiting in an exchange."""
        slot = torch.zeros((self._b, self.buf_elems),
                           dtype=self.buffer_dtype, device=self.device)
        for i in range(len(self.local_stages)):
            self._branch(i, slot, cross=False)

    def warmup(self):
        """Run one full bubble chunk, leaving the pipe empty (the probe
        ``Defer.health_check`` and the dispatcher's preflight use; on the
        card it captures the chunk's graph)."""
        self.reset()
        self.push(self._bubble_block(), n_real=0)
        self.reset()

    def flush(self):
        """Drain the pipe: run bubble chunks until every fed microbatch has
        emerged (the fill/drain of the classic pipeline schedule).  Always
        full chunks, so draining replays the graph that serves traffic."""
        emitted = []
        target = self._fed  # overshoot bubbles beyond this are ignored
        block = self._bubble_block()
        while self._emitted < target:
            emitted.extend(self.push(block, n_real=0))
        return emitted

    # ------------------------------------------------------------------
    # batch convenience
    # ------------------------------------------------------------------

    def run(self, inputs) -> np.ndarray:
        """Feed [M, microbatch, *in_shape]; return [M, microbatch, *out]."""
        inputs = np.asarray(inputs)
        m = inputs.shape[0]
        if inputs.shape[1] != self.microbatch:
            raise ValueError(
                f"inputs microbatch dim {inputs.shape[1]} != {self.microbatch}")
        self.reset()
        outs = []
        for lo in range(0, m, self.chunk):
            hi = min(lo + self.chunk, m)
            block = inputs[lo:hi]
            n_real = hi - lo
            if n_real < self.chunk:
                pad = np.zeros((self.chunk - n_real,) + block.shape[1:],
                               block.dtype)
                block = np.concatenate([block, pad], 0)
            outs.extend(self.push(block, n_real=n_real))
        outs.extend(self.flush())
        if len(outs) != m:
            raise RuntimeError(f"pipeline emitted {len(outs)} of {m} inputs")
        return torch.stack(outs).float().cpu().numpy()

    def __call__(self, inputs) -> np.ndarray:
        return self.run(inputs)

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------

    @property
    def hop_utilization(self) -> list[float]:
        """Fraction of the homogeneous ``buf_elems`` hop buffer each
        stage->successor boundary actually carries (hop k = stage k's
        output; the last entry is the wrap link back to slot 0)."""
        return list(self._footprint["hop_utilization"])

    @torch.inference_mode()
    def stage_latencies(self, params: dict[str, Any] | None = None,
                        iters: int = 10) -> list[float]:
        """Per-stage latency (seconds) of the deployed stages on a bubble
        slot: ``iters`` calls of each stage, timed with CUDA events on the
        card and the host clock on the CPU.  The deployment's own rows
        (this process's ranks' shards, with the in-stage psums, under
        tensor parallelism), compute dtype and buffer dtype are what run.  ``params`` is
        accepted for the JAX signature and unused.  Fills
        ``metrics.stage_latency_s``; kernel launches made here are not
        pipeline steps and are not counted.  Across processes: this
        process's stages (``local_stages``) only."""
        del params  # weights come from the deployed rows
        kernels = counted_kernels()
        before = [k.snapshot() for k in kernels]
        slot = torch.zeros((self._b, self.buf_elems),
                           dtype=self.buffer_dtype, device=self.device)
        cuda = self.device.type == "cuda"
        lats = []
        for i, k in enumerate(self.local_stages):
            self._branch(i, slot)  # warm-up
            t0 = time.perf_counter()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            for _ in range(iters):
                self._branch(i, slot)
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                lat = ev[0].elapsed_time(ev[1]) / 1e3 / iters
            else:
                lat = (time.perf_counter() - t0) / iters
            lats.append(lat)
            self.metrics.record_stage_latency(k, lat)
            tr = tracer()
            if tr.enabled:
                tr.record(f"stage{k}:{self.stages[k].name}", t0,
                          time.perf_counter() - t0,
                          {"stage": k, "mean_latency_s": lat,
                           "iters": iters})
        for kernel, snap in zip(kernels, before):
            kernel.restore(snap)
        if len(lats) == self.num_stages:
            self.metrics.stage_latency_s = lats
        return lats
