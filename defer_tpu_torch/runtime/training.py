"""Pipeline-parallel training over the ring engine: the port of
``defer_tpu.runtime.training``.

The JAX trainer differentiates the inference chunk program itself (``lax.scan``
over ``lax.switch`` + ``lax.ppermute``); JAX transposes the ring into the
reverse ring for the backward pass.  On one card the port does the same with
autograd: a chunk is the inference engine's own step (``SpmdPipeline._stages``
then ``_hop``) run ``M + N - 1`` times from a zero ring of the trainer's own,
and ``torch.autograd.grad`` runs the ring backwards:

  * forward: microbatch t enters stage 0 at step t and stage k computes
    microbatch t-k; the loss of microbatch j is taken at step j+N-1, when
    it arrives back at slot 0.  ``loss_fn`` is called on real steps only,
    so a loss that is not finite on the bubbles' zero padding cannot poison
    the chunk;
  * backward: the reverse wavefront, scheduled by autograd; under
    ``wire="int8"`` the hop is a straight-through estimator
    (``ops.quant.ste_ring_hop``): forward the deployment's quantized wire,
    backward the cotangent rolled one slot back;
  * remat: each step's stage compute is wrapped in
    ``torch.utils.checkpoint.checkpoint`` (the counterpart of the JAX
    trainer's ``jax.checkpoint``), so only the ring entering each step is
    kept.  The hop stays outside the checkpoint: it saves nothing, so the
    recompute never reruns it, and a chunk of T steps launches the
    quantizer T times;
  * weights: a stage's gradient is one flat row in the row's layout (the
    port's counterpart of the JAX ``[N, Pmax]`` buffer); the optimizer
    updates the deployed rows in place, so the CUDA graphs captured for
    inference serve the trained weights without a new capture.

Training runs eagerly (a chunk is not captured as a CUDA graph), pp x dp x
tp as the JAX trainer, on the pipeline's one-card mesh or across processes:

  * data parallelism: ``loss_fn`` sees each data-parallel shard's
    ``[microbatch/dp, ...]`` logits and targets, and the shards' losses are
    averaged (the JAX trainer's pmean over the data axis), so a wider dp
    does not scale the learning rate;
  * tensor parallelism: each stage trains one row per rank of the model
    axis.  Autograd differentiates the ranks' loop and its psums exactly
    (a psum's backward hands every rank the summed cotangent once), so a
    sharded leaf's gradient is its rank's.  A replicated leaf (a
    LayerNorm, a bias added after a psum) is one weight held by every rank:
    its copies get the SUM of their gradients, as the JAX trainer's
    tied-copy fix gives them, and so stay equal after every update.
    ``trained_params`` and ``stage_grads`` reassemble the ranks' shards
    (``tp_unshard_params``);
  * across processes (a mesh from ``multihost_pipeline_mesh``: each
    process holds a block of consecutive stages of consecutive data lines,
    ``SpmdPipeline``'s ``local_stages``), every process calls
    ``loss_and_grad``/``step``/``accumulate_step`` with the same inputs, as
    every process calls ``run``.  A process trains its own stages' rows
    (``rows``).  The hop's crossing is an autograd function whose backward
    sends each slot's gradient back to the process that sent the slot
    (``runtime/spmd.py`` ``_CrossSlot``; on the int8 wire the straight-
    through hop's), the transpose of the JAX trainer's ``ppermute``.  Each
    such backward is one exchange its neighbours' must match, so every
    process runs every crossing's backward, in reverse step order: every
    ring a step leaves is a root of ``autograd.grad`` under a zero
    cotangent (with the local loss, where the process holds stage 0), and
    the engine runs a graph's nodes from the last made.  The loss is
    all-reduced over the processes (JAX's psum over the stage axis, pmean
    over the data axis), so every process returns the same; a stage whose
    rows sit on several processes (data lines on different processes)
    gets the sum of their gradients over its data line's group.
    ``trained_params``, ``stage_grads`` and the checkpoints give the
    one-process view: every stage's leaves on every process, gathered from
    each stage's process, and one npz in the one-process layout;
  * a model axis across processes (each process holds a block of the
    model line's ranks): every process of the line computes the same
    outputs after a stage's last psum, and the psum's backward all-reduces
    the cotangents, so the loss enters the backward once over the line,
    on the process holding stage 0 and the line's first rank (the others
    seed none; seeding it on each would scale every gradient upstream of a
    psum by the line's length).  A replicated leaf's copies then hold
    only their own ranks' shares, summed over the line's processes in one
    all-reduce before the optimizer, so the copies stay equal.
    ``trained_params``, ``stage_grads`` and the checkpoints gather every
    rank's shards from its process.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, broadcast,
                             current_process, exchange, line_group,
                             mesh_placement)
from ..utils.checkpoint import _npz_path
from . import flatbuf
from .spmd import SpmdPipeline, ring_block


def _sgd(rows: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """The default optimizer, as the JAX trainer's ``optax.sgd(1e-2)``."""
    return torch.optim.SGD(rows, lr=1e-2)


def _move(t: torch.Tensor, src: int, dst: int | None) -> torch.Tensor:
    """``t`` of process ``src`` on process ``dst`` (every process when
    ``dst`` is None: a broadcast; every process passes a tensor of the
    shape and dtype).  With a ``dst`` only ``src`` and ``dst`` call it."""
    if dst is None:
        return broadcast(t, src)
    if src == dst:
        return t
    if current_process() == src:
        exchange([(t, dst)], [])
        return t
    return exchange([], [(t, src)])[0]


def _share(named, src: int, device, dst: int | None = None):
    """``named`` (``[(key, tensor)]``, JSON-able keys) of process ``src``
    as CPU tensors on process ``dst`` (every process when None; elsewhere
    None): its sizes, a JSON header (keys, dtypes, shapes), then every
    tensor's bytes in one buffer, on ``device`` for the move.  ``named``
    is None except on ``src``."""
    me = current_process()
    if me == src:
        cpu = [(k, t.detach().to("cpu").contiguous()) for k, t in named]
        head = torch.tensor(list(json.dumps([
            [k, str(t.dtype).removeprefix("torch."), list(t.shape)]
            for k, t in cpu]).encode()), dtype=torch.uint8)
        body = torch.cat([torch.empty(0, dtype=torch.uint8)] + [
            t.reshape(-1).view(torch.uint8) for _, t in cpu])
        sizes = torch.tensor([head.numel(), body.numel()])
    elif dst is not None and me != dst:
        return None  # neither sends nor receives
    else:
        sizes = torch.zeros(2, dtype=torch.int64)
    sizes = _move(sizes.to(device), src, dst).cpu()
    if me != src:
        head = torch.empty(int(sizes[0]), dtype=torch.uint8)
        body = torch.empty(int(sizes[1]), dtype=torch.uint8)
    head = _move(head.to(device), src, dst).cpu()
    if body.numel():  # a stage without weights sends no bytes
        body = _move(body.to(device), src, dst).cpu()
    if dst is not None and me != dst:
        return None
    out, off = [], 0
    for key, dtype, shape in json.loads(bytes(head.tolist()).decode()):
        dt = getattr(torch, dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append((key, body[off:off + n].clone().view(dt).reshape(shape)))
        off += n
    return out


class PipelineTrainer:
    """Train a model through an :class:`SpmdPipeline` deployment.

    ``loss_fn(logits, targets) -> scalar tensor`` is applied per microbatch
    (``[microbatch/dp, *out_shape]`` logits in the ring's buffer dtype, per
    data-parallel shard), SUMMED over the chunk's microbatches and
    AVERAGED across the shards.  ``optimizer`` is a callable that
    takes the stage rows and returns a ``torch.optim.Optimizer`` (e.g.
    ``lambda rows: torch.optim.Adam(rows, lr=1e-3)``); the default is SGD
    at 1e-2.  ``wire="int8"`` pipelines train through the straight-through
    hop.  The trainer sets ``requires_grad`` on the pipeline's rows
    (``rows``: every stage's of this process, rank by rank under tensor
    parallelism).  Across processes every process builds its trainer and
    calls each method in the same order (see the module's docstring).
    """

    def __init__(self, pipe: SpmdPipeline, loss_fn: Callable,
                 optimizer: Callable[[Sequence[torch.Tensor]],
                                     torch.optim.Optimizer] | None = None):
        if not isinstance(pipe, SpmdPipeline):
            raise TypeError(f"PipelineTrainer trains an SpmdPipeline, got "
                            f"{type(pipe).__name__}")
        self.pipe = pipe
        self.loss_fn = loss_fn
        #: whether the pipeline's mesh spreads over processes
        self._spread = pipe.mesh.spans_processes
        #: whether this process takes the loss: it holds stage 0 and the
        #: model line's first rank (where the line crosses processes, each
        #: of its processes holds the same outputs, and the loss enters
        #: the backward once over the line)
        self._takes_loss = (pipe.local_stages.start == 0
                            and pipe.ranks.start == 0)
        #: the group over which the replicated leaves' gradients sum (the
        #: model line's processes; None within one process)
        self._model_group = None
        if self._spread:
            self._place()
        #: the one-process index of each row of ``rows`` (stage major, rank
        #: minor): its key in a checkpoint
        t = pipe.tensor_parallel
        self._row_ids = [k * t + r for k in pipe.local_stages
                         for r in pipe.ranks]
        #: the deployed flat rows, stage by stage (rank by rank within a
        #: stage under tensor parallelism; this process's stages across
        #: processes): the trained tensors
        self.rows = [r for m in pipe.modules for r in m.rows]
        for row in self.rows:
            row.requires_grad_(True)
        #: stage k's rows are ``rows[_spans[k]]``
        self._spans, i = [], 0
        for m in pipe.modules:
            self._spans.append(slice(i, i + len(m.rows)))
            i += len(m.rows)
        #: per tensor-parallel stage: True over its replicated leaves
        self._tied = {k: self._tied_mask(m) for k, m in
                      enumerate(pipe.modules) if m.tp > 1}
        self.optimizer = (optimizer or _sgd)(self.rows)
        self._a0: torch.Tensor | None = None  # the trainer's zero ring

    def _place(self) -> None:
        """Across processes: the processes holding each stage's rows for
        the one-process view (line 0's, with their model ranks), the group
        over which this process's stages' gradients sum (the processes
        holding those stages of the other data lines; None where this one
        holds them all), and the model line's group."""
        pipe, mesh = self.pipe, self.pipe.mesh
        mine, _ = mesh_placement(mesh, "PipelineTrainer")
        _, stages, owners = ring_block(mesh, mine)
        t, b = pipe.tensor_parallel, len(pipe.ranks)
        firsts = {r: ring_block(mesh, mine, rank=r)[2][0]
                  for r in range(0, t, b)}
        #: per stage: ``[(process, ranks)]``, its blocks of model ranks
        self._holders = [[(int(firsts[r][k]), range(r, r + b))
                          for r in range(0, t, b)]
                         for k in range(pipe.num_stages)]
        if MODEL_AXIS in mesh.axis_names and mesh.axis_crosses_processes(
                MODEL_AXIS):
            self._model_group = line_group(mesh, MODEL_AXIS)
        holders = {tuple(sorted({int(p) for p in owners[:, k]}))
                   for k in stages}
        if len(holders) != 1:
            raise ValueError(f"PipelineTrainer: this process's stages "
                             f"{list(stages)} are held by different sets "
                             f"of processes across the data lines: "
                             f"{sorted(holders)}")
        self._data_group = (line_group(pipe.mesh, DATA_AXIS)
                            if len(holders.pop()) > 1 else None)

    @staticmethod
    def _tied_mask(mod) -> torch.Tensor:
        """A row-shaped mask over the leaves every rank holds whole."""
        mask = torch.zeros(mod.row.shape[0], dtype=torch.bool,
                           device=mod.row.device)
        for (off, size, _, _), rep in zip(mod.meta, mod.replicated):
            if rep:
                mask[off:off + size] = True
        return mask

    # -- one chunk ----------------------------------------------------------

    def _schedule(self, xs, ys) -> tuple[torch.Tensor, torch.Tensor]:
        """Lay out one self-contained chunk: M real inputs then N-1 bubble
        steps, so every microbatch's loss lands inside the chunk (the
        target of microbatch j is read at step j+N-1).  Token-id inputs
        ride the float32 buffer."""
        pipe = self.pipe
        if isinstance(xs, torch.Tensor):
            xs = xs.detach().cpu().numpy()
        xs = np.asarray(xs, np.float32)
        ys = torch.as_tensor(ys).to(pipe.device)
        m = xs.shape[0]
        if m < 1 or ys.shape[0] != m:
            raise ValueError(f"{m} input microbatches and {ys.shape[0]} "
                             "targets: a chunk needs at least one, with "
                             "one target each")
        if xs.ndim < 2 or xs.shape[1] != pipe.microbatch:
            raise ValueError(f"inputs must be [M, microbatch="
                             f"{pipe.microbatch}, ...], got {xs.shape}")
        full = np.zeros((m + pipe.num_stages - 1,) + xs.shape[1:],
                        np.float32)
        full[:m] = xs
        return pipe._flatten_inputs(full), ys

    def _chunk_loss(self, xs: torch.Tensor, ys: torch.Tensor
                    ) -> tuple[torch.Tensor | None, list[torch.Tensor]]:
        """The chunk's summed loss, the ring run from zeros through the
        inference engine's step (each step's stages under remat), and,
        across processes, the ring each step left (every crossing's
        output; ``[]`` in one process).  The loss is this process's data
        lines', None where it does not take one (``_takes_loss``)."""
        pipe = self.pipe
        n = pipe.num_stages
        dp = pipe.data_parallel
        per = pipe.microbatch // dp
        r0 = pipe._rows.start
        out_sz = pipe._out_sizes[-1]
        out_shape = (per,) + pipe.out_spec.shape
        if self._a0 is None:
            self._a0 = torch.zeros(
                (len(pipe.local_stages), pipe._b, pipe.buf_elems),
                dtype=pipe.buffer_dtype, device=pipe.device)
        a = self._a0
        total, rings = None, []
        for t in range(xs.shape[0]):
            a = pipe._hop(checkpoint(pipe._stages, a, xs[t],
                                     use_reentrant=False,
                                     preserve_rng_state=False))
            if self._spread:
                rings.append(a)
            j = t - (n - 1)
            if j >= 0 and self._takes_loss:
                # microbatch j is back at slot 0: each data shard's loss
                out = a[0, :, :out_sz]
                loss = None
                for r in range(0, pipe._b, per):
                    part = self.loss_fn(out[r:r + per].reshape(out_shape),
                                        ys[j][r0 + r:r0 + r + per])
                    loss = part if loss is None else loss + part
                if dp > 1:
                    loss = loss / dp
                total = loss if total is None else total + loss
        return total, rings

    # -- stepping -----------------------------------------------------------

    def loss_and_grad(self, xs, ys) -> tuple[torch.Tensor,
                                             list[torch.Tensor]]:
        """Summed loss and per-stage row gradients for one chunk.

        ``xs``: [M, microbatch, *in_shape]; ``ys``: [M, microbatch, ...]
        targets (whatever ``loss_fn`` consumes).  Returns the loss (a
        detached scalar tensor, the same on every process) and one
        gradient row per row of ``rows``, each shaped and typed as the
        row (rank by rank under tensor parallelism, a replicated leaf
        holding the sum of its copies' gradients in every rank's row)."""
        xs_dev, ys_dev = self._schedule(xs, ys)
        with torch.enable_grad():
            loss, rings = self._chunk_loss(xs_dev, ys_dev)
            if not self._spread:
                grads = torch.autograd.grad(loss, self.rows,
                                            allow_unused=True)
            else:
                grads = self._spread_grads(loss, rings)
        grads = [torch.zeros_like(r) if g is None else g
                 for r, g in zip(self.rows, grads)]
        tots = {k: sum(g.to(mask.device) for g in grads[self._spans[k]])
                for k, mask in self._tied.items()}
        if self._model_group is not None and tots:
            tots = self._sum_tied(tots)
        for k, mask in self._tied.items():
            span = self._spans[k]
            grads[span] = [torch.where(mask.to(g.device), tots[k].to(g.device),
                                       g) for g in grads[span]]
        if self._spread:
            loss, grads = self._reduce(loss, grads)
        return loss.detach(), grads

    def _spread_grads(self, loss, rings) -> tuple:
        """Across processes, the rows' gradients of the local loss with
        every crossing's backward run on this process, the last step's
        first: each ring a step left is a root under a zero cotangent, and
        the pipeline's crossing token is asked for beside the rows, so no
        crossing is pruned (see the module's docstring)."""
        roots = [r for r in rings if r.requires_grad]
        cots = [torch.zeros_like(rings[0])] * len(roots)
        if loss is not None:
            roots, cots = [loss] + roots, [torch.ones_like(loss)] + cots
        token = self.pipe._cross_token
        wrt = self.rows + ([] if token is None else [token])
        return torch.autograd.grad(roots, wrt, cots,
                                   allow_unused=True)[:len(self.rows)]

    def _sum_tied(self, tots: dict) -> dict:
        """The replicated leaves' gradient sums of this process's ranks
        (``tots``, per stage), summed over the model line's processes in
        one all-reduce: each copy of a replicated leaf saw only its rank's
        share of the loss."""
        import torch.distributed as dist

        masks = {k: self._tied[k] for k in tots}
        flat = torch.cat([tots[k][m] for k, m in masks.items()])
        dist.all_reduce(flat, group=self._model_group)
        out, off = {}, 0
        for k, m in masks.items():
            n = int(m.sum())
            t = tots[k].clone()
            t[m] = flat[off:off + n]
            out[k], off = t, off + n
        return out

    def _reduce(self, loss, grads):
        """Across processes: the loss summed over every process (0 where
        a process takes none), and each gradient row summed over
        the processes holding its stage of the other data lines."""
        import torch.distributed as dist

        total = (torch.zeros(1, device=self.pipe.device) if loss is None
                 else loss.detach().float().reshape(1))
        dist.all_reduce(total)
        if self._data_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self._data_group)
            grads = [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        return total.reshape(()), grads

    def _apply(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update of the rows, in place."""
        for row, g in zip(self.rows, grads):
            row.grad = g
        self.optimizer.step()
        for row in self.rows:
            row.grad = None

    def step(self, xs, ys) -> float:
        """One optimizer step over a chunk; returns the summed loss."""
        loss, grads = self.loss_and_grad(xs, ys)
        self._apply(grads)
        return float(loss)

    def accumulate_step(self, batches: Iterable) -> float:
        """One optimizer step over SEVERAL chunks (gradient accumulation).

        ``batches`` iterates ``(xs, ys)`` chunk pairs; their gradient rows
        are summed on the device, then one update applies.  Returns the
        summed loss."""
        total, acc = None, None
        for xs, ys in batches:
            loss, grads = self.loss_and_grad(xs, ys)
            total = loss if total is None else total + loss
            acc = grads if acc is None else [a + g for a, g in
                                             zip(acc, grads)]
        if acc is None:
            raise ValueError("accumulate_step needs at least one batch")
        self._apply(acc)
        return float(total)

    # -- interop ------------------------------------------------------------

    def _rank_trees(self, k: int, rows: Sequence[torch.Tensor],
                    dtype: torch.dtype | None) -> list[dict[str, Any]]:
        """Local stage k's leaves of its row-shaped tensors (one per rank
        this process holds) as CPU copies in the port's layout, each in
        ``dtype`` (None: the leaf's own), one tree per rank."""
        mod = self.pipe.modules[k]
        return [flatbuf.unflatten_leaves(mod.paths, [
            v.to("cpu", dtype or meta[3], copy=True).contiguous()
            for v, meta in zip(flatbuf.unpack_leaves(row.detach(), mod.meta),
                               mod.meta)]) for row in rows]

    def _unshard(self, k: int, trees: list[dict[str, Any]]
                 ) -> dict[str, Any]:
        """Stage k's leaves from every rank's tree (one without tensor
        parallelism; none, shared across processes, for a stage without
        weights): the ranks' shards reassembled."""
        if len(trees) <= 1:
            return trees[0] if trees else {}
        return self.pipe.stages[k].tp_unshard_params(trees)

    def _stages_unpacked(self, rows: Sequence[torch.Tensor],
                         dtype: torch.dtype | None) -> list[dict[str, Any]]:
        """Every stage's leaves of the row-shaped ``rows`` (one per row of
        ``rows``), stage by stage: across processes each stage's from the
        process holding it (line 0's), on every process."""
        if not self._spread:
            return [self._unshard(k, self._rank_trees(k, rows[span], dtype))
                    for k, span in enumerate(self._spans)]
        first, me, out = self.pipe.local_stages.start, current_process(), []
        for k, holders in enumerate(self._holders):
            trees = []
            for src, _ in holders:  # each block of model ranks, in order
                named = None
                if src == me:
                    i = k - first
                    named = [((j,) + path, leaf) for j, tree in enumerate(
                        self._rank_trees(i, rows[self._spans[i]], dtype))
                        for path, leaf in zip(*flatbuf.flatten_leaves(tree))]
                got = _share(named, src, self.pipe.device)
                for j in sorted({key[0] for key, _ in got}):
                    trees.append(flatbuf.unflatten_leaves(
                        [tuple(key[1:]) for key, _ in got if key[0] == j],
                        [v for key, v in got if key[0] == j]))
            out.append(self._unshard(k, trees))
        return out

    def trained_params(self) -> dict[str, Any]:
        """The deployment's CURRENT weights as a standard parameter dict
        (CPU tensors in their original dtypes, unsharded): a fresh
        deployment, a decoder's ``reweight`` or ``save_params`` takes
        it.  Across processes every stage's, on every process."""
        params: dict[str, Any] = {}
        for tree in self._stages_unpacked(self.rows, None):
            params.update(tree)
        return params

    def stage_grads(self, grads: Sequence[torch.Tensor]
                    ) -> list[dict[str, Any]]:
        """Per-stage gradient rows unflattened into the stages' parameter
        dicts (float32 CPU tensors, the port's layout, unsharded;
        ``params_to_jax`` carries a whole graph's to the JAX layout).
        Across processes every stage's, on every process."""
        return self._stages_unpacked(grads, torch.float32)

    def save_checkpoint(self, path: str) -> None:
        """Persist the training state: each row of ``rows`` (``w/<k>``) and
        every tensor of the optimizer's state (``opt/<param>/<name>``), in
        float32, in one npz.  Before the first step the optimizer holds no
        state (torch makes it at the first update), and none is written.
        Across processes process 0 writes the one-process layout (``k``
        the row's index over every stage), gathered from each stage's
        process; every process returns once the file is written."""
        state = self.optimizer.state_dict()["state"]
        ids = self._row_ids

        def arrays_of(rows: range) -> list:
            out = []
            for i in rows:
                out.append((f"w/{ids[i]}", self.rows[i].detach().float()))
                out += [(f"opt/{ids[i]}/{name}", v.detach().float())
                        for name, v in state.get(i, {}).items()
                        if isinstance(v, torch.Tensor)]
            return out

        if not self._spread:
            np.savez(_npz_path(path), **{
                k: v.cpu().numpy() for k, v in arrays_of(
                    range(len(self.rows)))})
            return
        me, first, arrays = current_process(), self.pipe.local_stages.start, {}
        for k, holders in enumerate(self._holders):
            for src, _ in holders:
                span = self._spans[k - first] if src == me else None
                got = _share(None if span is None else arrays_of(
                    range(span.start, span.stop)), src, self.pipe.device,
                    dst=0)
                if me == 0:
                    arrays.update((key, v.numpy()) for key, v in got)
        if me == 0:
            np.savez(_npz_path(path), **arrays)
        broadcast(torch.zeros(1, device=self.pipe.device), 0)

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` file into this deployment
        (same partition and optimizer): the rows in place (captured
        graphs keep serving), the optimizer's state through its
        ``load_state_dict``.  Across processes each process reads its own
        rows and their state (a checkpoint of one process loads across
        processes, and the reverse)."""
        with np.load(_npz_path(path)) as z:
            rows = {}
            state: dict[int, dict[str, torch.Tensor]] = {}
            for key in z.files:
                kind, *rest = key.split("/")
                if kind == "w":
                    rows[int(rest[0])] = z[key]
                elif kind == "opt":
                    state.setdefault(int(rest[0]), {})[rest[1]] = \
                        torch.from_numpy(z[key])
        mine = self._row_ids
        shapes = [tuple(r.shape) for r in self.rows]
        got = [rows[k].shape if k in rows else None for k in mine]
        if (len(rows) != self.pipe.num_stages * self.pipe.tensor_parallel
                or got != shapes):
            raise ValueError(f"checkpoint mismatch: rows {got} != the "
                             f"deployment's {shapes}")
        with torch.no_grad():
            for k, row in zip(mine, self.rows):
                row.copy_(torch.from_numpy(rows[k]))
        sd = self.optimizer.state_dict()
        sd["state"] = {i: state[k] for i, k in enumerate(mine) if k in state}
        self.optimizer.load_state_dict(sd)
