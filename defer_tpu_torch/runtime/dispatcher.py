"""Dispatcher: the user-facing API — the port of ``defer_tpu.runtime.dispatcher``.

The reference's single entry point is ``run_defer``: queue in, queue out,
streaming until told to stop.  ``Defer(config).run_defer(graph, params,
cut_points, in_q, out_q)`` partitions the graph, builds the pipeline
engine on the configured device and serves from a daemon thread, with a
preflight probe, opportunistic chunk gathering, a resubmit log and a
watchdog that rebuilds a hung engine and replays what it had not emitted.
``build``, ``run``, ``stream`` and ``health_check`` are the batch and
generator forms.  ``generate``, ``logits`` and ``score`` serve causal
language models (``models/gpt.py``): generation on the pipelined decoder
(``runtime/decode.py``), scoring through the ring engine at a
power-of-two length bucket.  ``serve_endpoint`` is the network front
door: framed tensors in over TCP, through the native host staging ring
into the pipeline, replies out in each client's own order.

Over a mesh spread across ``torch.distributed`` processes every process
calls ``run_defer`` or ``serve_endpoint`` with the same arguments.  The
ring runs in lock-step, so one process decides each serve-loop step and
the others follow (:class:`_Lockstep`): the leader, the process holding
stage 0 of data line 0, alone reads the input queue, keeps the resubmit
log, binds the socket and runs the staging ring; every step it takes
(push, idle, stop, fail or reweight) with the others in one all-reduce,
which also tells it the fewest outputs any process has emitted, and it
deals a push's rows to the processes that inject them.  Each generation
of a deployment builds its ring and its steps on process groups of its
own (``parallel/mesh.py`` ``regroup``), destroyed when its thread ends
(``release``).  Within one process the same code runs, each step taken
alone.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import socket
import threading
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from ..graph.ir import LayerGraph
from ..obs import REGISTRY, tracer
from ..obs.events import emit as emit_event
from ..obs.postmortem import maybe_autopsy
from ..partition.partitioner import partition
from ..transport.replay import ReplayBuffer
from ..utils.config import DeferConfig, resolve_device
from ..parallel.mesh import current_process, regroup, release
from .decode import PipelinedDecoder
from .mpmd import MpmdPipeline
from .spmd import SpmdPipeline

#: sentinel a producer puts on the input queue to end the stream
END_OF_STREAM = None

#: the steps a serve loop's leader decides across processes (_Lockstep)
_IDLE, _PUSH, _STOP, _FAIL, _REWEIGHT = range(5)


def _host(outs: list[torch.Tensor]) -> list[np.ndarray]:
    """Outputs as float32 host arrays (waits for the device)."""
    return [o.float().cpu().numpy() for o in outs]


class _Abandoned(Exception):
    """A serving generation's thread leaves it: the watchdog has moved the
    deployment to a new generation (raised at a step every process of the
    generation takes, so all leave together)."""


class _Lockstep:
    """One serving generation's agreement over its ring.

    Across processes the ring runs in lock-step, so one process, the
    leader (``pipe.first_process``: stage 0 of data line 0), takes each
    serve-loop step and the others follow it.  A step (:meth:`step`) is
    one all-reduce (MAX) of six integers on the generation's group
    (``Mesh.world``): the leader's ``(operation, argument, dealt,
    generation)`` beside the followers' zeros, every process's
    ``-emitted`` and whether its generation was abandoned.  So every step
    also tells every process the fewest outputs any process has emitted
    (where a recovery's replay starts), and a generation's threads leave
    it together, at one step.  A push's argument is its ``n_real`` and
    ``dealt`` says whether it carries rows (:meth:`SpmdPipeline.deal`) or
    is a bubble push; a reweight's argument is its epoch.  A follower
    raises on the leader's ``fail`` and on another generation's step.

    Within one process the same object decides alone: the leader is this
    process and a step returns at once with its own values.  That is the
    one difference in what a caller sees: across processes every stream of
    ``run_defer`` ends with ``END_OF_STREAM`` (a follower's caller puts no
    END of its own to see the end by), within one process only a failed
    one does."""

    def __init__(self, pipe: SpmdPipeline, gen: int = 0):
        self.pipe, self.gen = pipe, gen
        self.across = pipe.mesh.spans_processes
        self.leader = pipe.first_process
        self.leads = not self.across or current_process() == self.leader
        if self.across:
            import torch.distributed as dist
            self._dist, self.group = dist, pipe.mesh.world
            self.device = (torch.device("cpu")
                           if dist.get_backend(self.group) == "gloo"
                           else pipe.device)

    def _all_reduce(self, values: list[int], op) -> list[int]:
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        self._dist.all_reduce(t, op=op, group=self.group)
        return t.tolist()

    def step(self, op: int = _IDLE, arg: int = 0, dealt: int = 0, *,
             emitted: int = 0, quit: bool = False):
        """One step, taken by every process: the leader's ``(op, arg,
        dealt)`` (a follower's are ignored), this process's ``emitted``
        outputs and whether it ``quit`` the generation.  Returns ``(op,
        arg, dealt, floor, quit)``: the leader's step, the fewest outputs
        any process had emitted, and whether any process quit."""
        if not self.across:
            return op, arg, dealt, emitted, quit
        mine = [op, arg, dealt, self.gen] if self.leads else [0, 0, 0, 0]
        op, arg, dealt, gen, floor, quit = self._all_reduce(
            mine + [-emitted, int(quit)], self._dist.ReduceOp.MAX)
        if gen != self.gen:
            raise RuntimeError(f"serve step of generation {gen} read by "
                               f"generation {self.gen}")
        if op == _FAIL and not self.leads:
            raise RuntimeError(
                f"the serving leader (process {self.leader}) failed; its "
                "handle holds the error")
        if op not in (_IDLE, _PUSH, _STOP, _FAIL, _REWEIGHT):
            raise RuntimeError(f"unknown serve step {op}")
        return op, arg, dealt, -floor, bool(quit)

    def pushes(self, step=None, reweights=None):
        """A follower's loop: the leader's steps until its stop, yielding
        each push as ``(dealt, n_real)``; idles are taken here and
        reweights installed (``reweights``, :class:`_Reweights`).
        ``step()`` takes one step (default :meth:`step`; the dispatcher
        arms its watchdog around it)."""
        step = step or self.step
        while True:
            op, arg, dealt = step()[:3]
            if op == _STOP:
                return
            if op == _REWEIGHT:
                reweights.install(arg)
            elif op == _PUSH:
                yield dealt, arg

    def share(self, obj):
        """The leader's picklable ``obj`` on every process."""
        if not self.across:
            return obj
        box = [obj]
        self._dist.broadcast_object_list(
            box, self.leader, group=self.group,
            device=None if self.device.type == "cpu" else self.device)
        return box[0]

    def stage(self, block: np.ndarray):
        """The leader's input block, checked before any process pushes:
        across processes staged on the device with every row, as
        :meth:`SpmdPipeline.deal` takes it (a bad input raises here);
        within one process as it is, for the push to stage."""
        if not self.across:
            return block
        return self.pipe.stage_inputs(block, every_row=True)

    def push(self, block, n_real: int, raw: bool = False):
        """The leader's push of a step: its staged block, dealt to the
        processes that inject rows (None: a bubble push)."""
        pipe = self.pipe
        if block is None:
            block = pipe._bubble_block()
        elif self.across:
            block = pipe.deal(block, self.leader)
        return pipe.push(block, n_real=n_real, raw=raw)

    def follow_push(self, dealt: int, n_real: int, raw: bool = False):
        """A follower's push of a step: the rows it injects, dealt by the
        leader, or the bubble block."""
        pipe = self.pipe
        xs = (pipe.deal(None, self.leader) if dealt
              else pipe._bubble_block())
        return pipe.push(xs, n_real=n_real, raw=raw)

    def preflight(self) -> None:
        """The bubble chunk (``warmup``); across processes first every
        process runs its stages alone and they agree whether all ran: a
        stage that cannot run fails every process, not only its own."""
        if self.across:
            err = None
            try:
                self.pipe.check_stages()
            except Exception as e:  # noqa: BLE001 — agreed on below
                err = e
            ok = self._all_reduce([int(err is None)],
                                  self._dist.ReduceOp.MIN)[0]
            if err is not None:
                raise err
            if not ok:
                raise RuntimeError(
                    "preflight: a stage of another process cannot run; "
                    "its handle holds the error")
        self.pipe.warmup()


class _Reweights:
    """``thread.reweight`` of an endpoint.  Within one process it swaps
    the weights at once (``SpmdPipeline.reweight``).  Across processes
    every process is handed the same params and packs its own stages'
    rows (a layout error raises in the caller), and every process installs
    epoch ``e`` at the step the leader names it, before the same push;
    ``hand`` returns once this process has installed them."""

    def __init__(self, lock: _Lockstep, wait_s: float, alive):
        self.pipe, self.across = lock.pipe, lock.across
        self.wait_s, self.alive = wait_s, alive
        self.cond = threading.Condition()
        self.rows: list = []
        self.applied = 0

    def hand(self, params) -> None:
        if not self.across:
            self.pipe.reweight(params)
            return
        rows = self.pipe.pack_weights(params)
        with self.cond:
            self.rows.append(rows)
            epoch = len(self.rows)
            while self.applied < epoch:
                if not self.alive():  # no step follows: install here
                    self.pipe.install_weights(rows)
                    self.applied = epoch
                    break
                self.cond.wait(0.05)

    def due(self) -> int:
        """The next epoch to install (0: none is waiting)."""
        with self.cond:
            return self.applied + 1 if len(self.rows) > self.applied else 0

    def install(self, epoch: int) -> None:
        deadline = time.monotonic() + self.wait_s
        with self.cond:
            while len(self.rows) < epoch:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"reweight epoch {epoch} was not handed to this "
                        f"process within {self.wait_s:.0f}s")
                self.cond.wait(0.05)
            self.pipe.install_weights(self.rows[epoch - 1])
            self.applied = epoch
            self.cond.notify_all()


class DeferHandle:
    """Handle to a running streaming deployment (returned by ``run_defer``)."""

    def __init__(self, thread: threading.Thread | None, pipeline,
                 stop_event: threading.Event):
        self._thread = thread
        self.pipeline = pipeline
        self._stop = stop_event
        #: exception that killed the serve thread, if any
        self.error: BaseException | None = None
        #: monotonic time the serve thread entered its current device
        #: dispatch, or None while idle (read by the watchdog)
        self._busy_since: float | None = None
        #: completed dispatches; the watchdog arms after the first one
        self._dispatches: int = 0
        #: slowest completed dispatch (seconds): scales the watchdog bound
        self._max_dispatch_s: float = 0.0
        #: serve-thread generation: bumped by the watchdog on recovery so a
        #: stale (wedged, later-unwedged) thread can never emit outputs
        self._gen: int = 0
        #: completed watchdog recoveries (rebuild + replay)
        self.recoveries: int = 0
        #: fed-but-not-yet-emitted real microbatch inputs, seq-stamped
        #: ("ack" = "output emitted by every process"): a recovery
        #: generation replays ``unacked()``.  Assigned by ``run_defer``.
        self._resubmit: ReplayBuffer | None = None
        #: next feed seq to stamp / outputs this process emitted, both
        #: counted over the deployment's generations
        self._fed: int = 0
        self._emitted: int = 0
        #: set when a peer process abandoned the generation (across
        #: processes): the watchdog then recovers at once
        self._peer_left: bool = False
        #: True once END_OF_STREAM was consumed from the input queue — a
        #: recovery generation must not wait for a second END
        self._end_seen: bool = False
        #: every serve thread started, one a generation (named
        #: ``defer-dispatcher-g<gen>``): an abandoned one may still be
        #: finishing its step; across processes it leaves at the next step
        #: its peers' abandoned threads take, or when a collective of its
        #: generation's groups times out (``initialize(timeout_s=)``)
        self.threads: list[threading.Thread] = []

    def stop(self):
        """Shut down after draining the pipe.  Across processes it takes
        effect where it is called on the leader; on a follower alone it
        does nothing (the follower follows the leader to its end)."""
        self._stop.set()

    @property
    def healthy(self) -> bool:
        """False once the serve thread died or was declared hung."""
        return self.error is None

    def join(self, timeout: float | None = None):
        """Wait for the serve thread; re-raises any error it died with.

        Raises as soon as ``error`` is set rather than waiting for the
        thread to exit: a thread the watchdog declared hung may never
        return."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.error is None and self._thread.is_alive():
            step = 0.25
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                step = min(step, left)
            self._thread.join(step)
        if self.error is not None:
            raise RuntimeError(
                "defer dispatcher thread failed") from self.error

    @property
    def metrics(self):
        return self.pipeline.metrics


class Defer:
    """One DEFER deployment on one device.

    The device is ``config.device``; ``None`` means the CUDA card, and the
    constructor raises when CUDA is absent (pass ``device="cpu"`` in the
    config to run on the CPU).  ``mesh`` (a one-card ``pipeline_mesh``)
    plays the part of the JAX ``Defer``'s mesh: the SPMD ring runs on it,
    MPMD places its stages over its devices, and ``generate``/``score``
    take their stage count from its stage axis.  Without a mesh the ring
    runs on the one-card mesh of ``config.data_parallel`` x stages x
    ``config.tensor_parallel``.  A mesh over several ``torch.distributed``
    processes (``multihost_pipeline_mesh``) runs every entry point through
    the ring across processes (``SpmdPipeline``; ``generate`` on the
    decoder across processes), each called by every process with the same
    arguments: ``build``, ``run``, ``stream``, ``logits`` and ``score``
    return the same values on every process; ``run_defer`` and
    ``serve_endpoint`` serve from the leader's queue or socket, one process
    deciding each step (see the module's docstring).  Only ``mode="mpmd"``
    raises there, before placing anything: it stays within one process by
    design (see :meth:`build`).
    """

    def __init__(self, config: DeferConfig | None = None, mesh=None):
        self.config = config or DeferConfig()
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import mesh_placement
            dev = mesh_placement(mesh, "Defer")[1]
            if self.config.device is not None and resolve_device(
                    self.config.device) != resolve_device(dev):
                raise ValueError(f"config.device {self.config.device!r} is "
                                 f"not the mesh's {dev}")
            self.device = resolve_device(dev)
        else:
            self.device = resolve_device(self.config.device)
        # engine caches (decoders, length-bucketed score pipelines): a
        # rebuild repacks the weights and, on the card, captures graphs
        # anew.  Values keep the (graph, params) refs alive so the id()
        # keys cannot be recycled.  A weight update must come as a NEW
        # params dict; leaves mutated in place are not detected.
        self._decoder_cache: dict[tuple, tuple] = {}
        self._score_cache: dict[tuple, tuple] = {}
        self._CACHE_MAX = 4

    def _cfg_cache_key(self) -> tuple:
        """Config fields that shape an engine: part of every engine-cache
        key, so a config changed between calls rebuilds."""
        c = self.config
        return (c.microbatch, c.chunk, str(c.compute_dtype),
                str(c.buffer_dtype), c.wire, c.mode, c.master_weights,
                c.data_parallel, c.tensor_parallel)

    def _one_process(self, entry: str, why: str) -> None:
        """Raise, naming why, where an entry point that runs within one
        process (the MPMD relay) is given a mesh over several."""
        if self._across:
            raise NotImplementedError(
                f"Defer.{entry} runs within one process; this mesh spans "
                f"processes: {why} (every entry point of the SPMD ring "
                "takes it)")

    @property
    def _across(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    def _default_num_stages(self) -> int:
        """Stage count from this deployment's mesh (1 when mesh-less), as
        the JAX ``Defer`` takes it for ``generate`` and ``score``."""
        from ..parallel.mesh import STAGE_AXIS
        if self.mesh is None:
            return 1
        if STAGE_AXIS not in self.mesh.shape:
            raise ValueError(
                f"mesh has no {STAGE_AXIS!r} axis; pass num_stages or a "
                "pipeline_mesh")
        return self.mesh.shape[STAGE_AXIS]

    def _cached(self, cache: dict, key: tuple, graph, params, make):
        hit = cache.get(key)
        if hit is not None and hit[0] is graph and hit[1] is params:
            return hit[2]
        engine = make()
        if len(cache) >= self._CACHE_MAX:
            cache.pop(next(iter(cache)))
        cache[key] = (graph, params, engine)
        return engine

    def build(self, graph: LayerGraph, params: dict[str, Any],
              cut_points: list[str] | None = None,
              num_stages: int | None = None):
        """Partition + build; returns the pipeline engine.  ``mode="mpmd"``
        over a mesh spanning processes raises: the MPMD relay is one
        controller's, as the JAX one places each stage with
        ``jax.device_put``, which reaches only this process's devices (by
        design: ROADMAP, "JAX modules with no port, by design")."""
        return self._build(graph, params, cut_points, num_stages)

    def _build(self, graph, params, cut_points, num_stages,
               regrouped: bool = False):
        """:meth:`build`; ``regrouped`` places an SPMD ring across
        processes on groups of its own (``regroup``: every process makes
        them, in one order), as each serving generation is placed."""
        cfg = self.config
        if cfg.mode == "mpmd":
            self._one_process("build(mode='mpmd')", "the MPMD relay places "
                              "every stage from one controller, as the JAX "
                              "one does; across processes it is not ported "
                              "by design (ROADMAP: JAX modules with no "
                              "port, by design)")
        stages = partition(graph, cut_points, num_stages=num_stages)
        if cfg.mode == "mpmd":
            if self.mesh is not None:
                placed = {"devices": list(self.mesh.devices.flat)}
            else:
                placed = {"device": self.device}
            return MpmdPipeline(stages, params, microbatch=cfg.microbatch,
                                compute_dtype=cfg.compute_dtype, **placed)
        if cfg.mode != "spmd":
            raise ValueError(f"mode must be 'spmd' or 'mpmd', got "
                             f"{cfg.mode!r}")
        mesh = self.mesh
        if regrouped and mesh is not None:
            mesh = regroup(mesh)
        return SpmdPipeline(
            stages, params, mesh=mesh, device=self.device,
            microbatch=cfg.microbatch, chunk=cfg.chunk,
            buffer_dtype=cfg.buffer_dtype,
            compute_dtype=cfg.compute_dtype,
            wire=cfg.wire,
            data_parallel=cfg.data_parallel,
            tensor_parallel=cfg.tensor_parallel,
            master_weights=cfg.master_weights,
        )

    def generate(self, graph, params, prompt_ids, max_new_tokens: int,
                 *, num_stages: int | None = None, max_len: int | None = None,
                 kv_cache: str = "buffer", weight_dtype: str | None = None,
                 **sample_kw) -> np.ndarray:
        """Pipelined autoregressive generation (decoder graphs).

        A :class:`~defer_tpu_torch.runtime.decode.PipelinedDecoder` on this
        deployment's device and config (microbatch, compute dtype), its
        blocks split over ``num_stages`` (default: the mesh's stage axis,
        or 1), cached across calls;
        decodes ``max_new_tokens`` past each prompt.  ``sample_kw`` passes
        through (temperature, top_k, seed, eos_id, token_chunk, prefill,
        on_tokens).  Over a mesh spanning processes every process calls it
        with the same arguments and gets the same tokens.
        """
        if num_stages is None:
            num_stages = self._default_num_stages()
        key = (id(graph), id(params), num_stages, max_len, kv_cache,
               weight_dtype, self._cfg_cache_key())
        dec = self._cached(self._decoder_cache, key, graph, params,
                           lambda: PipelinedDecoder(
                               graph, params, num_stages=num_stages,
                               max_len=max_len, device=self.device,
                               mesh=self.mesh,
                               microbatch=self.config.microbatch,
                               compute_dtype=self.config.compute_dtype,
                               kv_cache=kv_cache, weight_dtype=weight_dtype))
        t0 = time.perf_counter()
        out = dec.generate(np.asarray(prompt_ids), max_new_tokens,
                           **sample_kw)
        tr = tracer()
        if tr.enabled:
            tr.record("defer.generate", t0, time.perf_counter() - t0,
                      {"new_tokens": max_new_tokens})
        return out

    def logits(self, graph, params, ids, *, cut_points=None,
               num_stages: int | None = None) -> np.ndarray:
        """Full-sequence causal-LM logits [B, T, V] through the pipeline.

        ``ids``: [B, T] ints (B % microbatch == 0).  The graph is
        re-specced (same ops, same params) at the next power-of-two length
        >= T (at least 8, at most the graph's) and its pipeline cached per
        bucket; causal attention keeps the right padding from touching
        positions < T, so the ids are padded to the bucket and the real
        prefix is read.  Ids ride the float32 ring, exact below 2**24.
        The verification forward of speculative decoding and :meth:`score`
        both ride this.  Over a mesh spanning processes every process gets
        every row.
        """
        ids = np.asarray(ids)
        if ids.ndim != 2:
            raise ValueError("ids must be [B, T]")
        b, t = ids.shape
        mb = self.config.microbatch
        if b % mb or b == 0:
            raise ValueError(
                f"B={b} must be a non-zero multiple of microbatch={mb}")
        if cut_points is None and num_stages is None:
            num_stages = self._default_num_stages()
        t_model = graph.input_spec.shape[0]
        if t > t_model:
            raise ValueError(
                f"sequence length {t} exceeds the model's {t_model}")
        bucket = min(max(8, 1 << (max(t, 1) - 1).bit_length()), t_model)
        key = (id(graph), id(params), bucket, num_stages,
               tuple(cut_points) if cut_points else None,
               self._cfg_cache_key())
        pipe = self._cached(
            self._score_cache, key, graph, params,
            lambda: self.build(graph if bucket == t_model else
                               graph.with_input_shape((bucket,)),
                               params, cut_points, num_stages))
        padded = np.zeros((b, bucket), np.float32)
        padded[:, :t] = ids
        out = pipe.run(padded.reshape(b // mb, mb, bucket))
        return out.reshape(b, bucket, -1)[:, :t]

    def score(self, graph, params, ids, *, cut_points=None,
              num_stages: int | None = None):
        """Per-sequence log-likelihood of token ids under a causal LM.

        ``ids``: [B, T] ints (B % microbatch == 0).  Runs the causal graph
        through :meth:`logits` and sums the next-token log-probabilities
        (float32).  Returns ``(logprob [B], perplexity [B])``, the same on
        every process of a mesh spanning processes.
        """
        ids = np.asarray(ids)
        if ids.ndim != 2:
            raise ValueError("ids must be [B, T]")
        b, t = ids.shape
        logits = self.logits(graph, params, ids, cut_points=cut_points,
                             num_stages=num_stages)
        logp = torch.from_numpy(np.asarray(logits, np.float32)).log_softmax(
            dim=-1)
        tgt = torch.from_numpy(ids[:, 1:].astype(np.int64))
        pick = logp[:, :-1].gather(-1, tgt[..., None])[..., 0]
        total = pick.sum(dim=-1).numpy()
        ppl = np.exp(-total / (t - 1)) if t > 1 else np.ones(b)
        return total, ppl

    def health_check(self, graph, params, cut_points=None, num_stages=None):
        """Build-and-run probe of a deployment before serving traffic:
        builds the pipeline and pushes one all-bubble chunk through it.
        Raises nothing: failures come back in the report."""
        report: dict[str, Any] = {"ok": False, "stages": None,
                                  "mesh": None, "device": str(self.device),
                                  "error": None}
        try:
            pipe = self.build(graph, params, cut_points, num_stages)
            report["stages"] = len(pipe.stages)
            if getattr(pipe, "mesh", None) is not None:
                report["mesh"] = dict(pipe.mesh.shape)
            pipe.warmup()
            report["ok"] = True
        except Exception as e:  # noqa: BLE001 — report, don't raise
            report["error"] = e
        return report

    def run(self, graph, params, inputs, cut_points=None, num_stages=None):
        """One-shot batched inference over the pipeline:
        [M, microbatch, *in_shape] -> [M, microbatch, *out_shape] numpy."""
        pipe = self.build(graph, params, cut_points, num_stages)
        return pipe.run(inputs)

    def stream(self, graph, params, inputs: Iterable[np.ndarray],
               cut_points=None, num_stages=None) -> Iterator:
        """Generator streaming: yields one output (a device tensor
        [microbatch, *out_shape]) per input microbatch, in order."""
        pipe = self.build(graph, params, cut_points, num_stages)
        if isinstance(pipe, MpmdPipeline):
            for x in inputs:
                yield from pipe.push(np.asarray(x)[None])
            yield from pipe.flush()
            return
        pipe.reset()
        batch: list[np.ndarray] = []
        for x in inputs:
            batch.append(np.asarray(x))
            if len(batch) == pipe.chunk:
                yield from pipe.push(np.stack(batch))
                batch.clear()
        if batch:
            pad = [np.zeros_like(batch[0])] * (pipe.chunk - len(batch))
            yield from pipe.push(np.stack(batch + pad), n_real=len(batch))
        yield from pipe.flush()

    def serve_endpoint(self, graph, params, cut_points=None, *,
                       num_stages=None, host: str = "127.0.0.1",
                       port: int = 0, codec: str = "raw",
                       stall_timeout_s: float = 120.0,
                       max_clients: int = 1):
        """Network front door: accept framed tensors, stream them through
        the pipeline via the native staging ring, reply in order.

        This is the reference dispatcher's whole socket data plane
        (src/dispatcher.py:85-105) as one endpoint, grown past its
        ``listen(1)`` (reference src/node.py:84-85): up to ``max_clients``
        clients — concurrent or successive (reconnects after a client
        death) — share ONE pipeline (on the card, one captured graph).
        Each client's reader thread stages samples into the bounded native
        ring (``transport/staging.py``) under a per-client in-flight window
        (so one greedy client cannot starve the rest); sample provenance
        rides a FIFO owners queue that mirrors ring order, and the serve
        loop routes each emitted row back to its owner's connection —
        every client sees exactly its own results, in its own send order,
        as float32 frames under ``codec``.  A client that dies mid-stream
        is discarded (its in-flight rows are dropped on emergence) without
        disturbing the others.

        On the card the ring pops into two page-locked blocks in turn;
        each is copied to the card asynchronously on the serve thread's
        stream (the stream the chunk's graph replays on), converted to the
        ring's dtype there, and refilled only after its copy's event has
        completed.  Each chunk's real rows come back in one device-to-host
        copy.

        Returns ``(server_address, thread)``; the thread exits once
        ``max_clients`` connections have finished (END-drained and echoed,
        or died) — or when ``thread.stop()`` is called (an operator
        shutdown: stops accepting, drains in-flight rows, cuts any
        still-connected clients without an END so they fail loudly).
        ``thread.errors`` lists every client abort and endpoint failure;
        ``thread.reweight(params)`` swaps the serving weights in place;
        ``thread.pipeline`` is the serving engine (its ``metrics``).
        The registry counters ``endpoint.samples_in``/``samples_out`` count
        samples: ``microbatch`` per frame (the JAX package counts frames;
        the two agree at microbatch 1).

        Across processes every process calls it with the same arguments
        and gets the same address.  The leader (the process holding stage
        0 of data line 0) binds the socket and runs the staging ring, the
        acceptor, the readers and the serve loop, deciding each step; the
        other processes' threads follow it (:class:`_Lockstep`) and
        create no ring and no staging blocks.  ``thread.reweight(params)``
        is called on every process with the same params and installs them
        at the step the leader names; ``thread.stop()`` takes effect on
        the leader (on a follower it does nothing); the endpoint counters
        count on the leader only, the followers' stay 0; a follower's
        ``thread.errors`` holds the leader's failure, if it failed.
        """
        from ..transport.framed import (K_END, K_TENSOR, configure_socket,
                                        recv_frame, send_end, send_frame)
        from ..transport.staging import HostStagingRing

        pipe = self._build(graph, params, cut_points, num_stages,
                           regrouped=True)
        if isinstance(pipe, MpmdPipeline):
            raise ValueError("serve_endpoint requires spmd mode")
        pipe.warmup()  # on the card: captures the chunk's graph
        lock = _Lockstep(pipe)
        if not lock.leads:
            return lock.share(None), self._follow_endpoint(
                lock, stall_timeout_s)
        mb, buf, chunk = pipe.microbatch, pipe.buf_elems, pipe.chunk
        in_size = pipe.stages[0].in_spec.size
        n_slots = max(4 * chunk, 16)
        ring = HostStagingRing(mb * buf, n_slots=n_slots)
        srv = socket.create_server((host, port))
        address = lock.share(srv.getsockname())
        ep_in = REGISTRY.counter("endpoint.samples_in")
        ep_out = REGISTRY.counter("endpoint.samples_out")
        cuda = pipe.device.type == "cuda"

        #: endpoint-fatal errors (pipeline death) PLUS per-client aborts;
        #: a client whose stream errors is cut WITHOUT the END frame so it
        #: fails loudly (never a silently short result stream)
        errors: list[BaseException] = []

        class _Client:
            __slots__ = ("conn", "lock", "state", "alive", "draining",
                         "outstanding", "window")

            def __init__(self, conn):
                self.conn = conn
                self.lock = threading.Lock()    # serializes writes
                self.state = threading.Lock()   # guards the fields below
                self.alive = True
                self.draining = False
                self.outstanding = 0
                # fair-share cap on ring slots one client may occupy
                self.window = threading.Semaphore(
                    max(chunk, n_slots // (2 * max_clients)))

        owners: collections.deque[_Client] = collections.deque()
        push_lock = threading.Lock()  # makes (ring.push, owners.append) atomic
        finished = threading.Semaphore(0)  # one release per finished client
        clients: list[_Client] = []  # every accepted client, for teardown
        stop_ev = threading.Event()  # operator shutdown (thread.stop())

        def _finish(client: _Client, *, send_eos: bool):
            """Exactly-once client teardown; END echo only on clean drain."""
            with client.state:
                if not client.alive:
                    return
                client.alive = False
            try:
                if send_eos:
                    with client.lock:
                        send_end(client.conn)
            except OSError:
                pass
            client.conn.close()
            finished.release()

        def _maybe_drained(client: _Client):
            with client.state:
                done = (client.draining and client.outstanding == 0
                        and client.alive)
            if done:
                _finish(client, send_eos=True)

        def reader(client: _Client):
            conn = client.conn
            try:
                while True:
                    kind, value = recv_frame(conn)
                    if kind == K_END:
                        with client.state:
                            client.draining = True
                        _maybe_drained(client)
                        return
                    if kind != K_TENSOR:
                        raise ConnectionError(
                            f"unexpected frame kind {kind!r} on the "
                            f"endpoint's input stream")
                    if isinstance(value, torch.Tensor):  # a bfloat16 frame
                        value = value.float().numpy()
                    x = np.asarray(value, np.float32).reshape(mb, -1)
                    if x.shape[-1] != in_size:
                        raise ValueError(
                            f"sample size {x.shape[-1]} != stage-0 input "
                            f"size {in_size}")
                    if mb == 1:
                        row = x  # native zero-pad to buf_elems
                    else:
                        row = np.zeros((mb, buf), np.float32)
                        row[:, :in_size] = x
                    if not client.window.acquire(timeout=stall_timeout_s):
                        raise RuntimeError(
                            f"client window full for {stall_timeout_s:.0f}s "
                            f"— pipeline stalled; sample would be dropped")
                    # a full ring is normal backpressure (clients ahead of
                    # the pipeline); a ring still full after the stall
                    # timeout means the pipeline stopped draining — fail
                    # loudly, never silently drop the sample.  The owner
                    # entry is registered BEFORE the push (a pushed sample
                    # is instantly poppable — its owner must already be
                    # queued) and retracted on failure; push_lock holds are
                    # kept short (50 ms slices) so one backpressured client
                    # never serializes the others for the whole stall
                    # budget.
                    deadline = time.monotonic() + stall_timeout_s
                    while True:
                        with push_lock:
                            owners.append(client)
                            with client.state:
                                client.outstanding += 1
                            ok = ring.push(row, timeout_s=0.05)
                            if not ok:
                                owners.pop()  # ours: appends are lock-held
                                with client.state:
                                    client.outstanding -= 1
                        if ok:
                            ep_in.n += mb  # samples, not frames
                            break
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"staging ring full for "
                                f"{stall_timeout_s:.0f}s — pipeline "
                                f"stalled; sample would be dropped")
            except BaseException as e:  # noqa: BLE001 — client-fatal
                errors.append(e)
                _finish(client, send_eos=False)

        def acceptor():
            for _ in range(max_clients):
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return  # endpoint shut down
                configure_socket(conn)
                client = _Client(conn)
                clients.append(client)
                threading.Thread(target=reader, args=(client,),
                                 daemon=True,
                                 name="defer-endpoint-reader").start()

        def _deliver(row: np.ndarray, out_shape):
            client = owners.popleft()
            with client.state:
                client.outstanding -= 1
                alive = client.alive
            client.window.release()
            if alive:
                try:
                    with client.lock:
                        send_frame(client.conn, row.reshape(out_shape),
                                   codec=codec)
                except OSError as e:
                    errors.append(e)
                    _finish(client, send_eos=False)
                else:
                    ep_out.n += mb
                    _maybe_drained(client)

        def push(xs, got: int):
            lock.step(_PUSH, got, int(xs is not None))
            return lock.push(xs, got, raw=True)

        def serve_loop():
            out_shape = (mb,) + pipe.out_spec.shape
            # two staging blocks in turn; on the card page-locked, each
            # refilled only once the event after its copy has completed
            blocks = [torch.empty((chunk, mb * buf), dtype=torch.float32,
                                  pin_memory=cuda) for _ in range(2)]
            copied: list = [None, None]
            turn = 0
            done_clients = 0
            pipe.reset()
            while done_clients < max_clients or owners:
                if stop_ev.is_set() and not owners:
                    return  # operator stop: in-flight rows drained
                if epoch := rw.due():
                    lock.step(_REWEIGHT, epoch)
                    rw.install(epoch)
                while finished.acquire(blocking=False):
                    done_clients += 1
                if copied[turn] is not None:
                    copied[turn].synchronize()
                try:
                    got, block = ring.pop_block(chunk, timeout_s=0.25,
                                                out=blocks[turn])
                except TimeoutError:
                    if not owners:
                        lock.step(_IDLE)  # the followers' heartbeat
                        continue
                    # undelivered rows are inside the pipe and no new
                    # traffic is arriving: crank it with the cached
                    # device-resident bubble block (flush()'s recipe)
                    got, xs = 0, None
                else:
                    if block is None:
                        lock.step(_IDLE)
                        continue  # ring closed (teardown)
                    xs = block.view(chunk, mb, buf).to(
                        pipe.device, non_blocking=True).to(pipe.buffer_dtype)
                    if cuda:
                        copied[turn] = torch.cuda.Event()
                        copied[turn].record()
                    turn ^= 1
                slab, mask = push(xs, got)
                if slab is None:
                    continue
                real = np.flatnonzero(mask)
                if real.size == 0:
                    continue
                if real.size < len(mask):
                    # trickle traffic: gather real rows on the device so
                    # the host transfer never carries bubble padding
                    slab = slab[torch.as_tensor(real, device=slab.device)]
                # ONE device->host drain per chunk, then frame out
                for row in slab.float().cpu().numpy():
                    _deliver(row, out_shape)

        def serve():
            threading.Thread(target=acceptor, daemon=True,
                             name="defer-endpoint-accept").start()
            try:
                # the pipeline's device, and its current stream for the
                # input copies and the replays alike
                with (torch.cuda.device(pipe.device) if cuda
                      else contextlib.nullcontext()):
                    serve_loop()
                lock.step(_STOP)
            except BaseException as e:  # noqa: BLE001 — endpoint-fatal
                errors.append(e)
                with contextlib.suppress(Exception):
                    lock.step(_FAIL)
                raise
            finally:
                ring.close()
                srv.close()
                release(pipe.mesh)
                # endpoint-fatal exit: cut every live client WITHOUT an END
                # echo so remote peers fail loudly instead of blocking in
                # recv forever (normal exits find no one alive here)
                for c in clients:
                    _finish(c, send_eos=False)

        thread = threading.Thread(target=serve, daemon=True,
                                  name="defer-endpoint")
        thread.errors = errors  # inspectable post-join
        # live redeploy: swap weights under the serving pipeline with no
        # recapture and no client disruption (the chunk in flight finishes
        # under the weights it started with)
        rw = _Reweights(lock, stall_timeout_s, thread.is_alive)
        thread.reweight = rw.hand
        thread.pipeline = pipe

        def _stop():
            stop_ev.set()
            srv.close()  # unblocks the acceptor; serve loop exits after
            #              draining whatever rows are already in flight

        thread.stop = _stop
        thread.start()
        return address, thread

    @staticmethod
    def _follow_endpoint(lock: _Lockstep, wait_s: float) -> threading.Thread:
        """A follower's ``serve_endpoint`` thread: it takes the leader's
        steps until its stop (or its failure, which lands in
        ``thread.errors``)."""
        pipe = lock.pipe
        errors: list[BaseException] = []

        def follow():
            try:
                with (torch.cuda.device(pipe.device)
                      if pipe.device.type == "cuda"
                      else contextlib.nullcontext()):
                    pipe.reset()
                    for dealt, n_real in lock.pushes(reweights=rw):
                        lock.follow_push(dealt, n_real, raw=True)
            except BaseException as e:  # noqa: BLE001 — the leader's, or ours
                errors.append(e)
                raise
            finally:
                release(pipe.mesh)

        thread = threading.Thread(target=follow, daemon=True,
                                  name="defer-endpoint")
        rw = _Reweights(lock, wait_s, thread.is_alive)
        thread.errors = errors
        thread.reweight = rw.hand
        thread.pipeline = pipe
        thread.stop = threading.Event().set  # the leader's stop ends it
        thread.start()
        return thread

    def run_defer(self, graph, params, cut_points,
                  input_stream: queue.Queue, output_stream: queue.Queue,
                  *, num_stages=None) -> DeferHandle:
        """Queue-in/queue-out streaming service (the reference's entry
        point).  Returns at once with a handle; a daemon thread drains
        ``input_stream`` ([microbatch, *in_shape] arrays) and fills
        ``output_stream`` with float32 numpy outputs in input order.  Put
        ``END_OF_STREAM`` (None) on the input queue — or call
        ``handle.stop()`` — to shut down after draining the pipe.  On a
        failure the handle records the error and the output queue gets
        ``END_OF_STREAM``.

        Across processes every process calls it with the same arguments.
        The leader (the process holding stage 0 of data line 0) alone
        reads ``input_stream`` (a follower's is never read: an empty queue
        will do), keeps the resubmit log and decides each step; every
        process's ``output_stream`` gets every output once, in input
        order, and then ``END_OF_STREAM`` (:meth:`_Lockstep.close`), and
        every process's handle counts the same dispatches and inferences.
        ``handle.stop()`` takes effect on the leader.  The watchdog runs on
        every process, armed around its dispatches and around its waits
        for the leader's steps (the leader's idle waits are steps too): a
        wedge anywhere stalls every process, every watchdog fires, and each
        rebuilds its ring on new process groups.  The new generation starts
        where the process that emitted fewest outputs stopped: the leader
        replays its log from there, the followers follow the replay, and
        each process skips the outputs it already emitted.  A recovery
        makes those groups from the watchdog thread: no other thread may
        make groups while it runs."""
        across = self._across
        pipe = self._build(graph, params, cut_points, num_stages,
                           regrouped=across)
        stop = threading.Event()
        cfg = self.config
        disp_count = REGISTRY.counter("dispatcher.dispatches")
        disp_hist = REGISTRY.histogram("dispatcher.dispatch_s")
        # the resubmit window's bound: everything a pipeline can hold
        # fed-but-unemitted, with slack for the gather in progress (the
        # MPMD path never logs — its capacity is a placeholder)
        log_cap = 1 if isinstance(pipe, MpmdPipeline) \
            else 2 * (pipe.chunk + pipe.num_stages + 1)

        def _dispatch(gen, fn, *a, arm=True, **kw):
            # bracket device work so the watchdog can tell "waiting for
            # input" (fine) from "stuck in a dispatch" (dead pipeline).
            # arm=False exempts dispatches that may legitimately take long
            # (first use of a shape: library set-up, graph capture).  All
            # handle bookkeeping is generation-guarded: a wedged thread
            # that unwedges after a recovery must not clobber the live
            # generation's markers.
            t0 = time.monotonic()
            tp0 = time.perf_counter()
            if arm and handle._gen == gen:
                handle._busy_since = t0
            try:
                out = fn(*a, **kw)
            finally:
                if handle._gen == gen:
                    handle._busy_since = None
            if handle._gen == gen:
                handle._dispatches += 1
                handle._max_dispatch_s = max(handle._max_dispatch_s,
                                             time.monotonic() - t0)
            dt = time.monotonic() - t0
            disp_count.n += 1
            disp_hist.record(dt)
            tr = tracer()
            if tr.enabled:
                tr.record("dispatcher.dispatch", tp0, dt, {"gen": gen})
            return out

        def _armed(gen, fn, *a, **kw):
            # a wait for (or the taking of) a serve step across processes:
            # the watchdog sees it as busy, but it is no dispatch (within
            # one process a step waits for nothing)
            if not across:
                return fn(*a, **kw)
            if handle._gen == gen:
                handle._busy_since = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                if handle._gen == gen:
                    handle._busy_since = None

        def _live(gen) -> bool:
            return handle._gen == gen and handle.error is None

        def _step(gen, lock, *values):
            # one serve step, armed.  Every process also says how many
            # outputs it emitted (the leader's log keeps what any process
            # lacks) and whether its generation was abandoned: if one was,
            # every process leaves the generation at this same step
            op, arg, dealt, floor, quit = _armed(
                gen, lock.step, *values, emitted=handle._emitted,
                quit=not _live(gen))
            if quit:
                if _live(gen):
                    # a peer's watchdog abandoned it: this one recovers
                    # (or declares the deployment dead) now as well, armed
                    handle._busy_since = time.monotonic()
                    handle._peer_left = True
                    while _live(gen):
                        time.sleep(0.05)
                raise _Abandoned
            handle._resubmit.ack(floor)
            return op, arg, dealt, floor

        def _emitter(first: int):
            # a generation's outputs onto the stream: its first is the
            # deployment's output number ``first``, and those this process
            # emitted before (a recovery replays from the fewest any
            # process emitted) are skipped
            seq = first

            def emit(outs):
                nonlocal seq
                for o in outs:
                    if seq >= handle._emitted:
                        handle._emitted += 1
                        output_stream.put(o)
                    seq += 1
            return emit

        def _serve_inner(pipe, gen, t_rec):
            def live() -> bool:
                return _live(gen)

            if isinstance(pipe, MpmdPipeline):
                if cfg.preflight:
                    _dispatch(gen, pipe.run, np.zeros(
                        (1, pipe.microbatch) + pipe.in_spec.shape,
                        np.float32))
                    if not live():
                        return
                seen_shapes: set[tuple] = set()
                pipe.reset()
                while not stop.is_set() and live():
                    try:
                        x = input_stream.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    if x is END_OF_STREAM:
                        break
                    xa = np.asarray(x)
                    # a new shape's first dispatch may take library set-up
                    # time: don't let the watchdog mistake it for a hang
                    fresh = xa.shape not in seen_shapes
                    seen_shapes.add(xa.shape)
                    # copy to the host INSIDE the bracket: push only queues
                    # device work, and a wedged device would otherwise hang
                    # the copy with the watchdog disarmed
                    outs = _dispatch(gen, lambda: _host(pipe.push(xa[None])),
                                     arm=not fresh)
                    if not live():
                        return  # watchdog fired mid-dispatch
                    for o in outs:
                        output_stream.put(o)
                if not live():
                    return
                outs = _dispatch(gen, lambda: _host(pipe.flush()))
                if not live():
                    return
                for o in outs:
                    output_stream.put(o)
                return

            # ---- SPMD path: resubmit log + replay-aware input feed; each
            # step decided by the leader (_Lockstep).  A generation leaves
            # only at a step (_Abandoned): an abandoned thread skips its
            # outputs and, as the leader, reads no input ----
            lock = _Lockstep(pipe, gen)
            first = _step(gen, lock)[3]
            emit = _emitter(first)
            log = handle._resubmit
            # the leader's replay: every fed input some process has not
            # emitted (a follower's log is empty)
            pending = collections.deque(log.unacked())
            fresh = handle._fed  # seqs from here on are not in the log
            if t_rec is not None:
                emit_event("failover", hop="dispatcher", chan=gen,
                           addr="in-process", replayed=len(pending),
                           recovery_ms=round(
                               (time.perf_counter() - t_rec) * 1e3, 3))

            pipe.reset()
            if cfg.preflight:
                # serve the first real input from an already-validated
                # full-chunk program (on the card: an already-captured
                # graph).  arm=False: on a recovery generation _dispatches
                # is already > 0 and this dispatch would otherwise re-trip
                # the watchdog
                _dispatch(gen, lock.preflight, arm=False)
            if not lock.leads:
                # a follower: the leader's pushes; it reads no input
                for dealt, n_real in lock.pushes(lambda: _step(gen, lock)):
                    outs = _dispatch(gen, lambda: _host(
                        lock.follow_push(dealt, n_real)))
                    if live():
                        emit(outs)
                return finish(pipe, lock, gen, emit)

            def next_input(timeout: float):
                if pending:
                    return pending.popleft()
                if handle._end_seen:
                    # the caller's END was consumed by a previous (wedged)
                    # generation; never wait for a second one
                    raise queue.Empty
                x = input_stream.get(timeout=timeout)
                if x is END_OF_STREAM:
                    return x
                handle._fed += 1
                return handle._fed - 1, x

            done = False
            while not done and not stop.is_set() and live():
                if handle._end_seen and not pending:
                    break  # recovery after END: replay done, go flush
                batch: list = []
                try:
                    batch.append(next_input(0.05))
                except queue.Empty:
                    if handle._end_seen:
                        break
                    _step(gen, lock, _IDLE)  # the followers' heartbeat
                    continue
                if batch[0] is END_OF_STREAM:
                    handle._end_seen = True
                    break
                # opportunistically gather a fuller chunk (the reference's
                # in-flight window); don't stall waiting for stragglers
                while len(batch) < pipe.chunk:
                    try:
                        nxt = next_input(cfg.gather_timeout_s)
                    except queue.Empty:
                        break
                    if nxt is END_OF_STREAM:
                        handle._end_seen = True
                        done = True
                        break
                    batch.append(nxt)
                n_real = len(batch)
                xs = [x for _, x in batch]
                xs += [np.zeros_like(xs[0])] * (pipe.chunk - n_real)
                # across processes a bad input fails here, before any
                # process pushes: then every process fails with it
                try:
                    block = _armed(gen, lock.stage, np.stack(xs))
                except BaseException:
                    _step(gen, lock, _FAIL)
                    raise
                # record the fed microbatches BEFORE dispatch: if the
                # dispatch wedges, the recovery generation replays exactly
                # these (plus everything older some process has not
                # emitted)
                for q, x in batch:
                    if q < fresh:
                        continue  # a replay: still in the log
                    if log.depth() >= log.capacity:
                        # acks track emits, so this is a bug: raise instead
                        # of letting retain() block on it
                        raise RuntimeError(
                            f"resubmit log overflow ({log.depth()} >= "
                            f"{log.capacity})")
                    log.retain(q, x)
                _step(gen, lock, _PUSH, n_real, 1)
                outs = _dispatch(gen, lambda: _host(lock.push(block, n_real)))
                if live():
                    emit(outs)
            _step(gen, lock, _STOP)
            finish(pipe, lock, gen, emit)

        def finish(pipe, lock, gen, emit):
            # the drain, then one more step, which each process takes once
            # it has emitted every output: no stream ends while another
            # process still lacks some, and a stall before it keeps every
            # process armed in the generation, where a watchdog finds it
            outs = _dispatch(gen, lambda: _host(pipe.flush()))
            if _live(gen):
                emit(outs)
            _step(gen, lock)
            if lock.across:  # (see _Lockstep) and within one process, a
                output_stream.put(END_OF_STREAM)  # stream's END is its
                #                                   caller's

        def start_generation(pipe, gen, t_rec=None):
            def serve():
                try:
                    _serve_inner(pipe, gen, t_rec)
                except _Abandoned:
                    pass  # every process left this generation together
                except BaseException as e:  # surface errors instead of a
                    if _live(gen):          # silent dead thread and a
                        handle.error = e    # forever-blocked reader
                        output_stream.put(END_OF_STREAM)
                finally:
                    if not isinstance(pipe, MpmdPipeline):
                        release(pipe.mesh)

            t = threading.Thread(target=serve, daemon=True,
                                 name=f"defer-dispatcher-g{gen}")
            handle._thread = t
            handle.threads.append(t)
            handle.pipeline = pipe
            t.start()

        handle = DeferHandle(None, pipe, stop)
        handle._resubmit = ReplayBuffer(log_cap,
                                        gauge="dispatcher.replay_depth")
        start_generation(pipe, 0)

        if cfg.watchdog_s is not None:
            def watching() -> bool:
                if across:  # a follower's stop() does not end its part
                    return handle._thread.is_alive() and handle.error is None
                return not stop.is_set() and handle._thread.is_alive()

            def watch():
                while watching():
                    busy = handle._busy_since
                    # the bound scales with the slowest dispatch this
                    # deployment has completed, so a legitimately slow
                    # deployment raises its own threshold
                    wd = max(cfg.watchdog_s,
                             cfg.watchdog_scale * handle._max_dispatch_s)
                    # unarmed until one dispatch completed; across
                    # processes a peer's abandoned generation counts as a
                    # stall here too
                    if handle._dispatches > 0 and busy is not None and (
                            handle._peer_left
                            or time.monotonic() - busy > wd):
                        if (handle.recoveries < cfg.max_recoveries
                                and not isinstance(handle.pipeline,
                                                   MpmdPipeline)):
                            # RECOVER: abandon the wedged generation and
                            # rebuild the pipeline; the new generation
                            # replays what some process has not emitted
                            handle.recoveries += 1
                            handle._gen += 1
                            handle._busy_since = None
                            handle._peer_left = False
                            emit_event("watchdog", action="recover",
                                       gen=handle._gen,
                                       stalled_s=round(
                                           time.monotonic() - busy, 3))
                            t_rec = time.perf_counter()
                            try:
                                new_pipe = self._build(
                                    graph, params, cut_points, num_stages,
                                    regrouped=across)
                            except BaseException as e:  # noqa: BLE001
                                handle.error = e
                                stop.set()
                                output_stream.put(END_OF_STREAM)
                                return
                            start_generation(new_pipe, handle._gen, t_rec)
                            continue
                        # out of recoveries (or MPMD): a dead device
                        # surfaces instead of hanging forever
                        emit_event("watchdog", action="dead",
                                   gen=handle._gen,
                                   stalled_s=round(
                                       time.monotonic() - busy, 3))
                        # a deployment declared dead triggers a postmortem
                        # bundle from whatever journals exist (nothing
                        # unless this process journals)
                        maybe_autopsy("watchdog: deployment declared dead")
                        handle.error = TimeoutError(
                            "a peer process abandoned the deployment's "
                            "generation; deployment declared dead"
                            if handle._peer_left else
                            f"pipeline dispatch made no progress for "
                            f"{wd:.1f}s; deployment declared dead")
                        stop.set()  # serve loop exits; no outputs after
                        output_stream.put(END_OF_STREAM)  # the sentinel
                        return
                    time.sleep(min(0.25, wd / 4))

            threading.Thread(target=watch, daemon=True,
                             name="defer-watchdog").start()
        return handle
