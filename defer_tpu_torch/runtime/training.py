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

Training runs eagerly (a chunk is not captured as a CUDA graph), on the
pipeline's one-card mesh, pp x dp x tp as the JAX trainer:

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
    (``tp_unshard_params``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..utils.checkpoint import _npz_path
from . import flatbuf
from .spmd import SpmdPipeline


def _sgd(rows: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """The default optimizer, as the JAX trainer's ``optax.sgd(1e-2)``."""
    return torch.optim.SGD(rows, lr=1e-2)


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
    (``rows``: every stage's, rank by rank under tensor parallelism).
    """

    def __init__(self, pipe: SpmdPipeline, loss_fn: Callable,
                 optimizer: Callable[[Sequence[torch.Tensor]],
                                     torch.optim.Optimizer] | None = None):
        if not isinstance(pipe, SpmdPipeline):
            raise TypeError(f"PipelineTrainer trains an SpmdPipeline, got "
                            f"{type(pipe).__name__}")
        if pipe.hop_transport != "local":
            raise NotImplementedError(
                "PipelineTrainer runs within one process; this pipeline's "
                "ring crosses processes (autograd through its sends and "
                "receives is ROADMAP queue A15c)")
        self.pipe = pipe
        self.loss_fn = loss_fn
        #: the deployed flat rows, stage by stage (rank by rank within a
        #: stage under tensor parallelism): the trained tensors
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

    def _chunk_loss(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """The chunk's summed loss, the ring run from zeros through the
        inference engine's step (each step's stages under remat)."""
        pipe = self.pipe
        n = pipe.num_stages
        dp = pipe.data_parallel
        out_sz = pipe._out_sizes[-1]
        out_shape = (pipe.microbatch,) + pipe.out_spec.shape
        shards = [slice(d * pipe.microbatch // dp,
                        (d + 1) * pipe.microbatch // dp) for d in range(dp)]
        if self._a0 is None:
            self._a0 = torch.zeros(
                (n, pipe.microbatch, pipe.buf_elems),
                dtype=pipe.buffer_dtype, device=pipe.device)
        a = self._a0
        total = None
        for t in range(xs.shape[0]):
            a = pipe._hop(checkpoint(pipe._stages, a, xs[t],
                                     use_reentrant=False,
                                     preserve_rng_state=False))
            j = t - (n - 1)
            if j >= 0:  # microbatch j is back at slot 0
                out = a[0, :, :out_sz].reshape(out_shape)
                loss = self.loss_fn(out[shards[0]], ys[j][shards[0]])
                for sh in shards[1:]:
                    loss = loss + self.loss_fn(out[sh], ys[j][sh])
                if dp > 1:
                    loss = loss / dp
                total = loss if total is None else total + loss
        return total

    # -- stepping -----------------------------------------------------------

    def loss_and_grad(self, xs, ys) -> tuple[torch.Tensor,
                                             list[torch.Tensor]]:
        """Summed loss and per-stage row gradients for one chunk.

        ``xs``: [M, microbatch, *in_shape]; ``ys``: [M, microbatch, ...]
        targets (whatever ``loss_fn`` consumes).  Returns the loss (a
        detached scalar tensor) and one gradient row per stage, each
        shaped and typed as the stage's row (one per row of ``rows``: rank
        by rank under tensor parallelism, a replicated leaf holding the sum
        of its copies' gradients in every rank's row)."""
        xs_dev, ys_dev = self._schedule(xs, ys)
        with torch.enable_grad():
            loss = self._chunk_loss(xs_dev, ys_dev)
            grads = torch.autograd.grad(loss, self.rows, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g
                 for r, g in zip(self.rows, grads)]
        for k, mask in self._tied.items():
            span = self._spans[k]
            tot = sum(g.to(mask.device) for g in grads[span])
            grads[span] = [torch.where(mask.to(g.device), tot.to(g.device),
                                       g) for g in grads[span]]
        return loss.detach(), grads

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

    def _unpack(self, k: int, rows: Sequence[torch.Tensor],
                dtype: torch.dtype | None) -> dict[str, Any]:
        """Stage k's leaves of its row-shaped tensors (one per rank) as CPU
        copies in the port's layout, each in ``dtype`` (None: the leaf's
        own); the ranks' shards reassembled under tensor parallelism."""
        mod = self.pipe.modules[k]
        trees = [flatbuf.unflatten_leaves(mod.paths, [
            v.to("cpu", dtype or meta[3], copy=True).contiguous()
            for v, meta in zip(flatbuf.unpack_leaves(row.detach(), mod.meta),
                               mod.meta)]) for row in rows]
        if mod.tp == 1:
            return trees[0]
        return mod.stage.tp_unshard_params(trees)

    def trained_params(self) -> dict[str, Any]:
        """The deployment's CURRENT weights as a standard parameter dict
        (CPU tensors in their original dtypes, unsharded): a fresh
        deployment, a decoder's ``reweight`` or ``save_params`` takes
        it."""
        params: dict[str, Any] = {}
        for k, span in enumerate(self._spans):
            params.update(self._unpack(k, self.rows[span], None))
        return params

    def stage_grads(self, grads: Sequence[torch.Tensor]
                    ) -> list[dict[str, Any]]:
        """Per-stage gradient rows unflattened into the stages' parameter
        dicts (float32 CPU tensors, the port's layout, unsharded;
        ``params_to_jax`` carries a whole graph's to the JAX layout)."""
        return [self._unpack(k, grads[span], torch.float32)
                for k, span in enumerate(self._spans)]

    def save_checkpoint(self, path: str) -> None:
        """Persist the training state: each row of ``rows`` (``w/<k>``) and
        every tensor of the optimizer's state (``opt/<param>/<name>``), in
        float32, in one npz.  Before the first step the optimizer holds no
        state (torch makes it at the first update), and none is written."""
        arrays = {f"w/{k}": row.detach().float().cpu().numpy()
                  for k, row in enumerate(self.rows)}
        for i, st in self.optimizer.state_dict()["state"].items():
            for name, v in st.items():
                if isinstance(v, torch.Tensor):
                    arrays[f"opt/{i}/{name}"] = \
                        v.detach().float().cpu().numpy()
        np.savez(_npz_path(path), **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` file into this deployment
        (same partition and optimizer): the rows in place (captured
        graphs keep serving), the optimizer's state through its
        ``load_state_dict``."""
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
        shapes = [tuple(r.shape) for r in self.rows]
        got = [rows[k].shape if k in rows else None
               for k in range(len(self.rows))]
        if len(rows) != len(self.rows) or got != shapes:
            raise ValueError(f"checkpoint mismatch: rows {got} != the "
                             f"deployment's {shapes}")
        with torch.no_grad():
            for k, row in enumerate(self.rows):
                row.copy_(torch.from_numpy(rows[k]))
        sd = self.optimizer.state_dict()
        sd["state"] = state
        self.optimizer.load_state_dict(sd)
