"""Continuous-batching autoregressive decode: per-request KV state rides
through the pipeline stages; requests join and leave between steps.

The port of ``defer_tpu.serve.engine``.
:class:`~defer_tpu_torch.runtime.decode.PipelinedDecoder` decodes one
CLOSED batch: every sequence enters together, decodes in lockstep, and
exits together — a serving system driving it would pay head-of-line
blocking (a 512-token request holds a 5-token request's slot hostage)
and refill bubbles (the whole batch must drain before new prompts
enter).  This engine is continuous batching proper:

* The batch is ``width`` SLOTS.  Each slot holds one request's state —
  its prompt, its position, and its OWN KV cache rows in every stage's
  cache (``[blocks, width, kv_heads, max_len, head_dim]`` f32 per stage,
  grouped by the decoder's ``_split_blocks``).
* Between any two decode steps, finished requests leave (slot freed,
  tokens delivered) and waiting requests join (slot claimed, position
  0); the step itself never changes — one program per width serves every
  batch composition.
* A step is one token per slot: teacher-forced from the prompt while
  ``pos < prompt_len`` (prefill at decode rate — a joining request needs
  no separate prefill program), sampled past it.  Every block runs
  :meth:`~defer_tpu_torch.models.gpt.CausalTransformerBlock.decode` with
  one position per row (the JAX engine's ``vmap`` of single-row
  decodes): each row writes its own cache row at its own position and
  attends over its own positions.  No op reduces across rows and every
  shape is fixed by ``width``, so a row's output bytes are INDEPENDENT
  of who shares the batch — per-request outputs are byte-identical to
  the request run alone, the correctness bar continuous batching must
  meet.
* Sampling noise is keyed by ``(request seed, position)`` per row
  (:func:`~defer_tpu_torch.runtime.decode.gumbel_noise_rows`) —
  deterministic per request regardless of batch composition, slot or
  join step.  The draws cannot equal the JAX package's ``jax.random``
  ones; what holds is their distribution.
* Idle slots feed id 0 at position 0 and write their own cache row 0.
  That is harmless: a joining request writes row 0 at its first step,
  before any step reads it, and a recycled slot's stale rows past the
  new request's position are hidden by the mask.

On the card a step is one CUDA-graph replay (two graphs, greedy and
sampled, both captured when the engine is built, on the caller's
thread): the slot table fills page-locked host arrays, non-blocking
copies move them into the graph's static inputs, and one device-to-host
copy of ``width`` ids after the replay is the step's only sync.  The CPU
runs the same step eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..graph.ir import LayerGraph, tree_map
from ..graph.ops import take_rows
from ..models.gpt import CausalTransformerBlock, GptEmbedding
from ..obs import REGISTRY
from ..obs.events import emit as emit_event
from ..runtime.cuda_graph import capture
from ..runtime.decode import _sample_ids, _split_blocks
from ..utils.config import resolve_device
from .batcher import _stamp_popped

#: the step's inputs, one per slot: (name, dtype)
_INPUTS = (("ids", torch.int64), ("pos", torch.int64),
           ("seeds", torch.int64), ("temps", torch.float32))


@dataclasses.dataclass(eq=False)
class DecodeRequest:
    """One admitted generation request.

    Requests compare by identity: the front door finds a finished request
    in its client's list of live ones, and a field-wise ``==`` would
    compare prompts of different lengths as arrays (an error)."""

    prompt: np.ndarray                 #: [prompt_len] int token ids
    max_new_tokens: int
    tenant: str = "default"
    request_id: int = 0
    seed: int = 0
    temperature: float = 0.0
    #: called with the finished [prompt_len + new] int64 ids (or None on
    #: cancellation) from the engine's step thread
    on_done: Callable[[Any], None] | None = None
    queued_at: float = 0.0
    #: set by the front door when the client disconnects while this
    #: request is still queued — the engine loop must not join it
    cancelled: bool = False

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class _Slot:
    __slots__ = ("req", "pos", "out", "last_id", "cancelled")

    def __init__(self, req: DecodeRequest):
        self.req = req
        self.pos = 0               #: next position to feed
        self.out: list[int] = []   #: generated ids
        self.last_id = 0           #: last sampled id (input past prompt)
        self.cancelled = False


class ContinuousBatchEngine:
    """Step-wise decoder over ``width`` request slots.

    The engine is PASSIVE: callers (the front door's decode loop, or a
    test) drive it with :meth:`join` / :meth:`cancel` between calls to
    :meth:`step`.  All three must be called from one scheduling thread
    (the slot table is not locked against concurrent mutation; the
    front door owns that thread).

    ``device=None`` means the CUDA card (an error when CUDA is absent);
    pass ``device="cpu"`` to run the same steps eagerly on the CPU.  On
    the card ``cuda_graphs = False`` runs the step eagerly there, which
    is what a replay is checked against; ``captures``, ``capture_s`` and
    ``graph_pool_bytes`` describe the two graphs, as on
    ``PipelinedDecoder``.
    """

    def __init__(self, graph: LayerGraph, params: dict[str, Any], *,
                 num_stages: int, width: int,
                 max_len: int | None = None, top_k: int | None = None,
                 device: str | torch.device | None = None):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        nodes = graph.nodes
        for req in ("embeddings", "final_ln", "lm_head"):
            if req not in nodes:
                raise ValueError(
                    f"decode engine needs the gpt() node contract; "
                    f"missing {req!r} (models/gpt.py)")
        self.device = dev = resolve_device(device)
        self.graph = graph
        # f32 compute, as the JAX engine's
        self.params = tree_map(
            lambda v: v.detach().to(dev, torch.float32)
            if v.is_floating_point() else v.detach().to(dev), params)
        self.width = width
        self.num_stages = num_stages
        self.embed_op: GptEmbedding = nodes["embeddings"].op
        self.max_len = max_len or self.embed_op.max_len
        if self.max_len > self.embed_op.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the positional table "
                f"({self.embed_op.max_len})")
        block_names = [nm for nm in graph.topo_order
                       if nm.startswith("block_")]
        for nm in block_names:
            if not isinstance(nodes[nm].op, CausalTransformerBlock):
                raise TypeError(f"{nm} is not a CausalTransformerBlock")
        assign = _split_blocks(len(block_names), num_stages)
        #: the chain-partition structure: stage s owns these blocks (and
        #: their slice of every slot's KV state)
        self.stage_blocks = [[block_names[i] for i in idxs]
                             for idxs in assign]
        blk0 = nodes[block_names[0]].op
        self.d_model = nodes[block_names[0]].out_spec.shape[-1]
        self.kv_heads = blk0.kv_heads
        self.head_dim = self.d_model // blk0.num_heads
        self.top_k = top_k

        self._slots: list[_Slot | None] = [None] * width
        self._caches = self._init_caches()
        # the step's static inputs (the graphs read them) and their
        # page-locked host twins, filled by the slot table each step
        pin = dev.type == "cuda"
        self._host = {nm: torch.zeros(width, dtype=dt, pin_memory=pin)
                      for nm, dt in _INPUTS}
        self._host_np = {nm: t.numpy() for nm, t in self._host.items()}
        self._inputs = {nm: torch.zeros(width, dtype=dt, device=dev)
                        for nm, dt in _INPUTS}
        self._out = torch.zeros(width, dtype=torch.int64, device=dev)
        self._out_host = torch.zeros(width, dtype=torch.int64,
                                     pin_memory=pin)
        self._out_np = self._out_host.numpy()
        self._done = torch.cuda.Event() if pin else None
        self.steps = 0
        self._step_hist = REGISTRY.histogram("serve.decode.step_s")
        self._tok_count = REGISTRY.counter("serve.decode.tokens")
        # per-step phase decomposition: gather (host build of the per-slot
        # rows / teacher-forcing), dispatch (the non-blocking copies into
        # the static inputs), device (the replay's launch to the sampled
        # ids on the host: blocks, lm_head, sampling, the KV writes and
        # the one device-to-host copy), sync (reading the ids out of the
        # page-locked array), delivery (per-slot bookkeeping + on_done).
        # step_s stays the dispatch -> materialize total the serve stats
        # report.
        self._phase_hists = {
            name: REGISTRY.histogram(f"serve.decode.{name}_s")
            for name in ("gather", "dispatch", "device", "sync",
                         "delivery")}

        self.cuda_graphs = dev.type == "cuda"
        #: captured graphs by sampling mode (False: greedy, True: sampled)
        self._graphs: dict[bool, Any] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        if self.cuda_graphs:
            # both captures here, on the caller's thread: a capture error
            # raises from the constructor, never inside a serving loop
            for sample in (False, True):
                t0 = time.perf_counter()
                g = self._graphs[sample] = capture(
                    lambda s=sample: self._step_body(s), dev,
                    label="engine.step")
                self.capture_s += time.perf_counter() - t0
                self.captures += 1
                self.graph_pool_bytes += g.pool_bytes
            with torch.inference_mode():
                for c in self._caches:
                    c["k"].zero_()
                    c["v"].zero_()
                self._out.zero_()

    # -- state -------------------------------------------------------------

    def _init_caches(self):
        w, kv, ml, hd = (self.width, self.kv_heads, self.max_len,
                         self.head_dim)
        return [{nm: torch.zeros((len(blks), w, kv, ml, hd),
                                 dtype=torch.float32, device=self.device)
                 for nm in ("k", "v")}
                for blks in self.stage_blocks]

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def active(self) -> int:
        return self.width - self.free_slots()

    def join(self, req: DecodeRequest) -> bool:
        """Claim a free slot for ``req``; False when the batch is full.
        The request's KV rows start clean by construction: position p's
        cache row is written before any later position reads it, so a
        recycled slot needs no cache zeroing."""
        if req.prompt.size + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {req.prompt.size} + {req.max_new_tokens} new "
                f"tokens exceeds max_len={self.max_len}")
        for i, s in enumerate(self._slots):
            if s is None:
                self._slots[i] = _Slot(req)
                return True
        return False

    def cancel(self, req: DecodeRequest) -> bool:
        """Free ``req``'s slot immediately (client disconnected).  The
        slot is reusable at the next join; other slots' rows are
        untouched (row-independent step), so a mid-decode cancellation
        cannot perturb anyone else's output."""
        for i, s in enumerate(self._slots):
            if s is not None and s.req is req:
                s.cancelled = True
                self._slots[i] = None
                if req.on_done is not None:
                    req.on_done(None)
                return True
        return False

    # -- the step program --------------------------------------------------

    def _step_body(self, sample: bool) -> None:
        """One token for every slot, from the static inputs into
        ``self._out``; the caches are written in place.  The body a graph
        captures, and what the CPU runs eagerly."""
        nodes = self.graph.nodes
        p = self.params
        inp = self._inputs
        safe = inp["pos"].clamp(0, self.max_len - 1)
        emb = p["embeddings"]
        x = take_rows(emb["wte"], inp["ids"]) + emb["wpe"].index_select(
            0, safe)
        # ride the stage partition: stage s applies its blocks against
        # its slice of every slot's KV state
        for s, names in enumerate(self.stage_blocks):
            ks, vs = self._caches[s]["k"], self._caches[s]["v"]
            for l, nm in enumerate(names):
                x = nodes[nm].op.decode(p[nm], x, ks[l], vs[l], safe)[0]
        h = nodes["final_ln"].op.apply(p["final_ln"], x)
        logits = nodes["lm_head"].op.apply(p["lm_head"],
                                           h).to(torch.float32)
        ids = logits.argmax(dim=-1)
        if sample:
            temps = inp["temps"]
            drawn = _sample_ids(logits, temps[:, None], self.top_k,
                                inp["seeds"], safe)
            ids = torch.where(temps > 0, drawn, ids)
        self._out.copy_(ids)

    def _run(self, sample: bool) -> None:
        if self.cuda_graphs:
            self._graphs[sample].replay()
            return
        with torch.inference_mode():
            self._step_body(sample)

    # -- one decode step ---------------------------------------------------

    def step(self) -> list[tuple[DecodeRequest, np.ndarray]]:
        """Advance every active slot one token; returns requests that
        FINISHED this step as ``(request, [plen + new] ids)`` (their
        slots are already free).  No-op (empty list) with no active
        slots."""
        live = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return []
        ph = self._phase_hists
        t_gather = time.perf_counter()
        h = self._host_np
        ids, pos, seeds, temps = h["ids"], h["pos"], h["seeds"], h["temps"]
        # the previous step's sync waited for the copies out of these
        # arrays, so they are free to refill
        for a in (ids, pos, seeds, temps):
            a.fill(0)
        sample = False
        for i, s in live:
            plen = s.req.prompt.size
            ids[i] = s.req.prompt[s.pos] if s.pos < plen else s.last_id
            pos[i] = s.pos
            seeds[i] = s.req.seed & 0xFFFFFFFF
            temps[i] = s.req.temperature
            sample = sample or s.req.temperature > 0
        t0 = time.perf_counter()
        ph["gather"].record(t0 - t_gather)
        for nm, dst in self._inputs.items():
            dst.copy_(self._host[nm], non_blocking=True)
        t_disp = time.perf_counter()
        ph["dispatch"].record(t_disp - t0)
        self._run(sample)
        self._out_host.copy_(self._out, non_blocking=True)
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(self.device))
            self._done.synchronize()
        t_dev = time.perf_counter()
        ph["device"].record(t_dev - t_disp)
        next_ids = self._out_np.tolist()
        t_sync = time.perf_counter()
        ph["sync"].record(t_sync - t_dev)
        self._step_hist.record(t_sync - t0)
        self.steps += 1
        done: list[tuple[DecodeRequest, np.ndarray]] = []
        for i, s in live:
            plen = s.req.prompt.size
            tok = next_ids[i]
            # the step consumed position s.pos; the token it produced
            # sits at position s.pos + 1, generated iff past the prompt
            if s.pos + 1 >= plen:
                s.out.append(tok)
                s.last_id = tok
                self._tok_count.n += 1
            s.pos += 1
            if len(s.out) >= s.req.max_new_tokens:
                result = np.concatenate(
                    [s.req.prompt.astype(np.int64),
                     np.asarray(s.out, np.int64)])
                self._slots[i] = None
                done.append((s.req, result))
                if s.req.on_done is not None:
                    s.req.on_done(result)
        ph["delivery"].record(time.perf_counter() - t_sync)
        return done

    # -- convenience (tests, sequential baselines) -------------------------

    def run_all(self, requests, *, joiner=None, max_steps: int = 100_000
                ) -> dict[int, np.ndarray]:
        """Drive the engine until every request finished: join waiting
        requests whenever slots free up (continuous batching), step
        until drained.  ``joiner(engine, pending)`` can override join
        order/timing (tests use it to stagger joins).  Returns
        ``{request_id: ids}``."""
        pending = list(requests)
        results: dict[int, np.ndarray] = {}

        def default_joiner(eng, queue):
            while queue and eng.free_slots():
                if not eng.join(queue[0]):
                    break
                queue.pop(0)

        join = joiner or default_joiner
        for _ in range(max_steps):
            join(self, pending)
            if not pending and self.active() == 0:
                return results
            for req, ids in self.step():
                results[req.request_id] = ids
        raise RuntimeError(f"run_all did not drain in {max_steps} steps")


class EngineLoop(threading.Thread):
    """The front door's decode scheduling thread: joins admitted
    requests from a :class:`~defer_tpu_torch.serve.batcher.BatchFormer`
    into free slots between steps, steps while anything is active, parks
    on the queue otherwise.  Every replay runs on this thread."""

    def __init__(self, engine: ContinuousBatchEngine, former,
                 on_service=None):
        super().__init__(daemon=True, name="serve-decode-loop")
        self.engine = engine
        self.former = former
        self._halt = threading.Event()
        self.error: BaseException | None = None
        #: called with (per-unit seconds, units) after each step — feeds
        #: the admission controller's live service EWMA
        self._on_service = on_service
        #: cancellations queued from OTHER threads (client reader saw a
        #: disconnect); applied between steps on THIS thread — the slot
        #: table has exactly one mutating thread
        self._cancel_q: list = []
        self._cancel_lock = threading.Lock()

    def stop(self) -> None:
        self._halt.set()

    def request_cancel(self, req) -> None:
        """Thread-safe: free ``req``'s slot at the next step boundary."""
        with self._cancel_lock:
            self._cancel_q.append(req)

    def _apply_cancels(self) -> None:
        with self._cancel_lock:
            cancels, self._cancel_q = self._cancel_q, []
        for req in cancels:
            if self.engine.cancel(req):
                emit_event("decode_cancel", rid=req.request_id,
                           tenant=req.tenant)

    def run(self) -> None:
        eng = self.engine
        try:
            while not self._halt.is_set():
                self._apply_cancels()
                free = eng.free_slots()
                queue = self.former.queue
                for j in range(free):
                    # park on the queue only when idle; with work in
                    # flight just sweep whatever is already waiting
                    timeout = 0.05 if eng.active() == 0 and j == 0 else 0.0
                    item = queue.pop(timeout=timeout)
                    if item is None:
                        break
                    # this loop pops the admission queue directly (no
                    # BatchFormer.form), so the attribution boundary is
                    # stamped here
                    _stamp_popped(item)
                    if getattr(item[1], "cancelled", False):
                        continue  # client left while it queued
                    if eng.join(item[1]):
                        emit_event("decode_join",
                                   rid=item[1].request_id,
                                   tenant=item[1].tenant,
                                   step=eng.steps)
                if eng.active() == 0:
                    continue
                t0 = time.perf_counter()
                n = eng.active()
                eng.step()
                if self._on_service is not None and n > 0:
                    self._on_service((time.perf_counter() - t0) / n, n)
        except BaseException as e:  # noqa: BLE001 — surfaced by the door
            self.error = e
