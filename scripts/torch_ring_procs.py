"""The ring across processes: N ``torch.distributed`` workers run the
port's ``SpmdPipeline``, ``PipelinedDecoder``, ``Defer`` (its batch
entry points and its two services) and ``PipelineTrainer`` on meshes
spread over them, and the collectives over an axis that crosses them.

    python scripts/torch_ring_procs.py --procs 4 --device cpu --out /tmp/ring
    python scripts/torch_ring_procs.py --procs 4 --device cpu --out /tmp/dec \
        --cases decode
    python scripts/torch_ring_procs.py --procs 4 --device cpu --out /tmp/tr \
        --cases train
    python scripts/torch_ring_procs.py --procs 4 --device cpu --out /tmp/sv \
        --cases serve

The parent writes the weights and inputs once (``<out>/inputs.pt``:
:func:`make_inputs`'s seeded ones, or the caller's own); each worker maps
them, joins a gloo group on a free localhost port (``initialize`` with a
timeout, so a dead peer fails its neighbours), builds its preset's graphs,
runs the cases below on its share of each mesh, and writes its rows,
launch counts, boundary bytes and collective results to
``<out>/worker<i>.npz`` (arrays) with their scalars in the ``meta`` entry
(JSON).  The parent waits for all of them: when one exits non-zero or the
deadline passes it kills every worker and fails with that worker's stderr
tail, so no worker is left blocked in a receive; a worker whose probed
port was taken before it bound it makes the parent spawn them all again
on fresh ports.  gloo is the one backend: the workers share one device
(NCCL refuses two ranks on one card).

Cases (``preset`` sizes them: ``cpu`` the tiny graphs the CPU tests run,
``card`` the full-width graphs the chip smoke runs, one card shared by
every worker).  ``--cases`` picks the groups to run, ``ring`` (the first
five below), ``decode``, ``train`` and ``serve``; all four by default:

* ``resnet``: ResNet in 8 stages on a (stage 8) mesh, two stages per
  process (``multihost_pipeline_mesh(8, local_devices=[dev] * 2)``), both
  wires; ``Defer(mesh=).run`` and ``.stream`` of the int8 deployment;
  ``stage_latencies`` of this process's stages, and (``cpu``) the buffer
  ring reweighted with the seed-1 weights and run again;
* ``bert``: BERT on a (stage S) mesh, S / N stages per process, both wires;
* ``dp``: ResNet on a (data 2, stage S) mesh: each data line's ring on a
  sub-group of the processes;
* ``collectives``: ``psum``, ``ppermute``, ``all_gather`` and
  ``all_to_all`` over the stage axis of the resnet mesh (every process on
  one line) and of the dp mesh (each line on some processes), on
  integer-valued f32 (sums exact in any order);
* ``guards``: what stays within one process raises naming why
  (``mode="mpmd"``, by design); a mesh naming two devices in one process
  raises naming A15b; NCCL for several
  processes on one card raises naming gloo when a ring engine is placed
  (on the CPU, which has no NCCL, the same placement over a gloo group
  named NCCL whose ranks name one card);
* ``decode``: the decoder and the entry points that serve with it on a
  (stage S) mesh over the processes (:data:`DECODE_CASES`, run by
  :class:`DecodeRun`): ``PipelinedDecoder.generate`` greedy (with and
  without the fused prefill, at two ``token_chunk`` values), sampled,
  beam, int8 KV cache, W8A16 and ``eos_id`` with ``on_tokens``;
  ``Defer(mesh=).generate``, ``.logits`` and ``.score`` on both wires;
  ``speculative_generate`` over that ``Defer``.  ``cpu``: ``gpt_tiny`` in
  4 stages (one a process), an eight-block ``gpt_tiny`` in 8 (two a
  process), and greedy on (data 2, stage 2); ``card``: GPT-2 small in 12
  stages (three a process), ``Defer.generate`` with the prefill and
  ``Defer.score`` on both wires, each timed.  The CPU tests run the same
  cases in one process (``mesh=None``) as the reference;
* ``train``: ``PipelineTrainer`` on meshes over the processes
  (:data:`TRAIN`, run by :class:`TrainRun`): ``loss_and_grad``, SGD and
  Adam steps, ``accumulate_step``, the trained deployment's ``run``,
  ``trained_params`` and checkpoints saved across processes (one npz in
  the one-process layout, written by process 0) and from one process.
  ``cpu``: ``resnet_tiny`` in 8 stages (two a process) on both wires,
  ``gpt_tiny`` in 4 (one a process, ``attn_impl="xla"``) on both wires,
  and ``resnet_tiny`` in 4 stages on (data 2, stage 4), int8, each line's
  ring on two processes; ``card``: ResNet50/8, two stages a process,
  ``loss_and_grad`` and 3 Adam steps on the int8 wire and
  ``loss_and_grad`` on the buffer wire.  The CPU tests run the same cases
  in one process (``mesh=None``) as the reference;
* ``serve``: ``Defer.run_defer`` and ``Defer.serve_endpoint`` on a (stage
  S) mesh over the processes and ``run_defer`` on (data 2, stage S / 2)
  (:data:`SERVE_CASES`, run by :class:`ServeRun`): the queue service on
  both wires and in bf16, a bad input, a stage error, a failing
  preflight, a hung dispatch declared dead (wedged on the leader and on a
  follower), recovery replaying mid-stream and in the drain, ``stop()``
  on the leader and on a follower alone; the endpoint streaming in order,
  two concurrent clients, bf8 replies, a bf16 int8 deployment, an
  operator stop, a live reweight, a client death and reconnect, a
  stalled staging ring and a bad sample.  The leader (process 0) feeds
  the queue and runs the clients as threads.  ``cpu``: ``resnet_tiny`` in
  8 stages (two a process); ``card``: ResNet50/8 (two a process), the
  int8 queue service of 4a's 8 microbatches and two concurrent clients of
  4 frames each.  The CPU tests run the same cases in one process
  (``mesh=None``) as the reference.

Launch counts: on the card each kernel wrapper's own count
(``ops/launches.py``); on the CPU the calls of the dispatching functions
(``ops.quant.quantize_int8_blocks``, ``ops.flash_attention.flash_attention``),
which run the plain versions there.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SEED = 0

#: per preset: the graphs, their cuts or stage counts, the batch, the
#: wires of the dp case, and whether the resnet ring is reweighted with
#: the seed-1 weights and run again (a second seeded init of ResNet50 is
#: seconds a worker, so the card leaves it to the CPU tests)
PRESETS = {
    "cpu": {"resnet": ("resnet_tiny", {}, None, 8), "image": 32,
            "bert": ("bert_tiny", {}, None, 4),
            "dp_stages": 2, "dp_wires": ("buffer", "int8"), "reweight": True,
            "microbatch": 2, "chunk": 3, "frames": 6},
    "card": {"resnet": ("resnet50", {"image_size": 224},
                        "RESNET50_8STAGE_CUTS", 8), "image": 224,
             "bert": ("bert_base", {"seq_len": 128},
                      "BERT_BASE_12STAGE_CUTS", 12),
             "dp_stages": 4, "dp_wires": ("int8",), "reweight": False,
             "microbatch": 8, "chunk": 4, "frames": 8},
}
WIRES = ("buffer", "int8")
#: the groups of cases ``--cases`` picks from
CASE_GROUPS = ("ring", "decode", "train", "serve", "tp")
#: the guards and what each must name: the ROADMAP queue it waits for, or
#: that it stays so by design
GUARDS = {"mpmd": "by design", "two_devices": "A15b"}
#: per preset, the decoder cases' models (factory, keyword arguments), the
#: meshes (name -> (model, stages, data lines, draft model)) and the cases
#: each runs, the weights' microbatch and ring chunk, the prompts
#: ``[B, plen]``, the new tokens, the ids ``Defer.logits``/``score`` take
#: ``[B, T]``, the calls timed per case, and whether each process's
#: weight rows are kept for the tests
DECODE = {
    "cpu": {"models": {
        "gpt_tiny": ("gpt_tiny", {"seq_len": 24, "vocab": 97}),
        "gpt_tiny8": ("gpt", {"num_layers": 8, "hidden": 32, "heads": 2,
                              "seq_len": 24, "vocab": 97,
                              "name": "gpt_tiny8"}),
        "draft4": ("gpt", {"num_layers": 4, "hidden": 16, "heads": 2,
                           "seq_len": 24, "vocab": 97, "name": "draft4"}),
        "draft8": ("gpt", {"num_layers": 8, "hidden": 16, "heads": 2,
                           "seq_len": 24, "vocab": 97, "name": "draft8"})},
        "meshes": {"s4": ("gpt_tiny", 4, 1, "draft4"),
                   "s8": ("gpt_tiny8", 8, 1, "draft8"),
                   "dp": ("gpt_tiny", 2, 2, None)},
        "cases": {"s4": "all", "s8": "all", "dp": ("greedy",)},
        "microbatch": 2, "chunk": 4, "max_len": 24, "prompts": (16, 5),
        "new": 9, "score_ids": (4, 10), "timed": 1, "keep_rows": True},
    "card": {"models": {"gpt2_small": ("gpt2_small", {"seq_len": 256})},
             "meshes": {"s12": ("gpt2_small", 12, 1, None)},
             "cases": {"s12": ("defer_prefill", "score_buffer",
                               "score_int8")},
             "microbatch": 8, "chunk": 4, "max_len": 256,
             "prompts": (96, 32), "new": 8, "score_ids": (16, 32),
             "timed": 2, "keep_rows": False},
}
#: the decoder cases: (what runs, the engine's keyword arguments, the
#: call's); ``"eos": True`` stops at the greedy run's token at position
#: plen + 1 of row 0 and streams through ``on_tokens``
DECODE_CASES = {
    "greedy": ("decoder", {}, {}),
    "greedy_chunk2": ("decoder", {}, {"token_chunk": 2}),
    "prefill": ("decoder", {}, {"prefill": True}),
    "prefill_chunk2": ("decoder", {}, {"prefill": True, "token_chunk": 2}),
    "sampled": ("decoder", {}, {"temperature": 0.8, "top_k": 5, "seed": 1,
                                "token_chunk": 2}),
    "beam": ("decoder", {"beam_width": 2}, {}),
    "int8_kv": ("decoder", {"kv_cache": "int8"}, {}),
    "w8a16": ("decoder", {"weight_dtype": "int8"}, {}),
    "eos": ("decoder", {}, {"token_chunk": 2, "eos": True}),
    "defer_generate": ("defer", {}, {}),
    "defer_prefill": ("defer", {}, {"prefill": True}),
    "logits_buffer": ("logits", {"wire": "buffer"}, {}),
    "logits_int8": ("logits", {"wire": "int8"}, {}),
    "score_buffer": ("score", {"wire": "buffer"}, {}),
    "score_int8": ("score", {"wire": "int8"}, {}),
    "speculative": ("speculative", {}, {"gamma": 3}),
}
#: the cases a mesh runs when its preset says "all"
ALL_DECODE = tuple(c for c in DECODE_CASES if c != "defer_prefill")
#: the training cases (:class:`TrainRun`), in the order a run takes them
TRAIN_CASES = ("grad", "sgd", "adam", "accumulate", "ckpt_in")
#: per preset, the training runs' models (factory, keyword arguments, cut
#: list, loss: ``ce`` on the logits or ``lm`` on the next tokens), the
#: runs (name -> (model, stages, data lines, wire, cases)), the
#: microbatches of a chunk, the batch, the ring chunk of ``run``, each
#: model's optimizer steps and learning rates, and whether every process
#: keeps every stage's gradients and weights (else its own stages'
#: gradients and a digest of the weights)
TRAIN = {
    "cpu": {"models": {
        "resnet_tiny": ("resnet_tiny", {}, None, "ce"),
        "gpt_tiny": ("gpt_tiny", {"seq_len": 12, "vocab": 61}, None, "lm")},
        "runs": {"s8_buffer": ("resnet_tiny", 8, 1, "buffer", TRAIN_CASES),
                 "s8_int8": ("resnet_tiny", 8, 1, "int8", TRAIN_CASES),
                 "gpt_buffer": ("gpt_tiny", 4, 1, "buffer",
                                ("grad", "adam")),
                 "gpt_int8": ("gpt_tiny", 4, 1, "int8", ("grad", "adam")),
                 "dp_int8": ("resnet_tiny", 4, 2, "int8", ("grad",))},
        "m": 2, "microbatch": 2, "chunk": 2,
        "steps": {"resnet_tiny": 3, "gpt_tiny": 1},
        "lr": {"resnet_tiny": {"sgd": 1e-3, "adam": 1e-3,
                               "accumulate": 1e-3},
               "gpt_tiny": {"adam": 5e-3}},
        "keep_all": True},
    "card": {"models": {"resnet50": ("resnet50", {"image_size": 224},
                                     "RESNET50_8STAGE_CUTS", "ce")},
             "runs": {"s8_int8": ("resnet50", 8, 1, "int8", ("grad", "adam")),
                      "s8_buffer": ("resnet50", 8, 1, "buffer", ("grad",))},
             "m": 4, "microbatch": 8, "chunk": 4,
             "steps": {"resnet50": 2}, "lr": {"resnet50": {"adam": 1e-4}},
             "keep_all": False},
}
#: the collectives and the meshes they cross
COLLECTIVES = ("psum", "ppermute", "ppermute_partial", "all_gather",
               "all_gather_tiled", "all_to_all")
#: steady pushes timed per ring (a worker reports their median)
TIMED_PUSHES = 5


#: what a worker's stderr says when the port the parent probed was taken
#: before the worker bound it (the group's store failed to listen)
BIND_RACE_MARKS = ("EADDRINUSE", "Address already in use",
                   "address already in use")
#: spawns on fresh ports before a port lost that way fails the run
SPAWN_TRIES = 3


def free_port() -> int:
    """A localhost port free when probed: the probe binds port 0 and
    closes, so another process may take the port before a worker binds it
    (:func:`spawn` then spawns again on fresh ports)."""
    with socket.create_server(("127.0.0.1", 0)) as s:
        return s.getsockname()[1]


class _BindRace(RuntimeError):
    """A worker lost the port the parent probed before it bound it."""


def load(path: Path) -> dict:
    """A worker's npz: its arrays, and its scalars under ``"meta"``."""
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def make_inputs(preset: str, cases=CASE_GROUPS) -> dict:
    """The seeded weights (seed ``SEED``) and numpy inputs of ``preset``'s
    groups of ``cases``, as the chip smoke's phases 4a, 4b and 4g make
    them: what :func:`spawn` hands the workers.  ``ring``: ResNet's and
    BERT's; ``decode``: each decoder model's (drafts seed ``SEED + 1``),
    the prompts (seed ``SEED``) and the scored ids (seed ``SEED + 2``, the
    first ``T`` of 4g's rows on the card); ``serve``: the served model's
    and its frames (seed ``SEED``; the card's are ``ring``'s ResNet's)."""
    import torch

    from defer_tpu_torch import models

    cfg, out = PRESETS[preset], {}
    if "ring" in cases:
        s = cfg["image"]
        g, _, _ = _model(models, cfg["resnet"])
        out["resnet_params"] = g.init(torch.Generator().manual_seed(SEED))
        out["resnet_x"] = np.random.default_rng(SEED).standard_normal(
            (cfg["frames"], cfg["microbatch"], s, s, 3)).astype(np.float32)
    if "ring" in cases or "tp" in cases:
        g, _, _ = _model(models, cfg["bert"])
        vocab = g.nodes["embeddings"].op.vocab
        out["bert_params"] = g.init(torch.Generator().manual_seed(SEED))
        out["bert_ids"] = np.random.default_rng(SEED).integers(
            0, vocab, (cfg["frames"], cfg["microbatch"]) + g.input_spec.shape
        ).astype(np.float32)
    tc = TP[preset]
    decodes = ([DECODE[preset]] if "decode" in cases else []) + (
        [tc["decode"]] if "tp" in cases and "decode" in tc else [])
    for dc in decodes:
        graphs = decode_graphs(models, dc)
        for name, g in graphs.items():
            seed = SEED + 1 if name.startswith("draft") else SEED
            out[f"{name}_params"] = g.init(torch.Generator().manual_seed(
                seed))
        vocab = next(iter(graphs.values())).nodes["lm_head"].out_spec.shape[-1]
        out["gpt_prompts"] = np.random.default_rng(SEED).integers(
            0, vocab, dc["prompts"])
        b, t = dc["score_ids"]
        out["gpt_score_ids"] = np.random.default_rng(SEED + 2).integers(
            0, vocab, (b, max(t, 100)))[:, :t]
    trains = ([TRAIN[preset]] if "train" in cases else []) + (
        [tc["train"]] if "tp" in cases and "train" in tc else [])
    for tr in trains:
        for model, (factory, kw, _, _) in tr["models"].items():
            g, _, loss = train_graph(models, tr, model)
            same = cfg["bert"][:2] == (factory, kw) and "bert_params" in out
            # the ring's BERT, where it is the same graph: one copy
            out[f"train_{model}_params"] = (out["bert_params"] if same
                                            else g.init(torch.Generator()
                                                        .manual_seed(SEED)))
            out[f"train_{model}_x"], out[f"train_{model}_y"] = train_inputs(
                g, loss, tr["m"], tr["microbatch"])
    if "serve" in cases:
        sc = SERVE[preset]
        pkey, xkey = sc["inputs"]
        if pkey not in out:
            g, _, _ = _model(models, sc["model"])
            s = sc["image"]
            out[pkey] = g.init(torch.Generator().manual_seed(SEED))
            out[xkey] = np.random.default_rng(SEED).standard_normal(
                (sc["frames"], sc["microbatch"], s, s, 3)).astype(np.float32)
    return out


def train_inputs(g, loss: str, m: int, mb: int):
    """``(xs, ys)`` of a training chunk of ``m`` microbatches of ``mb``
    (seed ``SEED``): images and class targets (``ce``, as phase 4r makes
    them on the card), token ids as the f32 inputs and themselves as the
    targets (``lm``), or token ids and class targets (``cls``)."""
    rng = np.random.default_rng(SEED)
    shape = (m, mb) + tuple(g.input_spec.shape)
    classes = g.output_spec.shape[-1]
    if loss == "lm":
        ids = rng.integers(0, classes, shape)
        return ids.astype(np.float32), ids
    if loss == "cls":
        ids = rng.integers(0, g.nodes["embeddings"].op.vocab, shape)
        return ids.astype(np.float32), np.random.default_rng(
            SEED).integers(0, classes, (m, mb))
    xs = rng.standard_normal(shape).astype(np.float32)
    return xs, np.random.default_rng(SEED).integers(0, classes, (m, mb))


def spawn(procs: int, device: str, preset: str, out_dir, inputs: dict, *,
          cases=CASE_GROUPS, deadline_s: float = 120.0,
          timeout_s: float = 60.0, env: dict | None = None,
          go: str | None = None) -> list[dict]:
    """Write ``inputs`` (:func:`make_inputs`'s keys for ``cases``) to
    ``out_dir``, run ``procs`` workers on them and return every worker's
    results (:func:`load`).  A worker that exits non-zero, or the
    deadline, kills every worker and raises ``RuntimeError`` with the
    stderr tails; where a worker's stderr says its group's port was taken
    between the probe and its bind (:data:`BIND_RACE_MARKS`), the workers
    are spawned again on fresh ports, up to :data:`SPAWN_TRIES` spawns,
    each under its own deadline.  Build the kernels before spawning on the
    card: the workers load the built libraries.  With ``go`` (a path) each
    worker does its host work (imports, graphs, the inputs mapped), then
    waits for that file to exist before it forms a group or touches the
    device: a caller starts the host work early and lets the workers at
    the device later."""
    import torch

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in inputs.items()}, out / "inputs.pt")
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    for attempt in range(1, SPAWN_TRIES + 1):
        try:
            _spawn_once(procs, device, preset, out, cases, deadline_s,
                        timeout_s, env, go)
            break
        except _BindRace as e:
            if attempt == SPAWN_TRIES:
                raise RuntimeError(f"ring across processes failed: every "
                                   f"one of {SPAWN_TRIES} spawns lost a "
                                   f"port before binding it\n{e}") from None
    return [load(out / f"worker{i}.npz") for i in range(procs)]


def _spawn_once(procs, device, preset, out, cases, deadline_s, timeout_s,
                env, go=None) -> None:
    """One spawn on freshly probed ports: every worker exits 0, or every
    worker is killed and it raises (:class:`_BindRace` where a worker lost
    its port, else ``RuntimeError``), with the stderr tails."""
    port, nccl_port = free_port(), free_port()
    for i in range(procs):  # no results of an earlier spawn survive
        (out / f"worker{i}.npz").unlink(missing_ok=True)
    workers = []
    try:
        for i in range(procs):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
                   str(i), "--procs", str(procs), "--port", str(port),
                   "--nccl-port", str(nccl_port), "--device", device,
                   "--preset", preset, "--out", str(out),
                   "--timeout", str(timeout_s), "--cases", ",".join(cases)]
            if go is not None:
                cmd += ["--go", str(go)]
            err = out / f"worker{i}.err"
            with open(out / f"worker{i}.out", "w") as so, \
                    open(err, "w") as se:
                workers.append((subprocess.Popen(cmd, stdout=so, stderr=se,
                                                 env=env), err))
        failed = _wait(workers, deadline_s)
    finally:
        for p, _ in workers:
            if p.poll() is None:
                p.kill()
        for p, _ in workers:
            p.wait()
    if failed is None:
        return
    tails = [_tail(err) for _, err in workers]
    text = "\n".join(f"--- worker {i} stderr ---\n{t}"
                     for i, t in enumerate(tails))
    if any(m in t for t in tails for m in BIND_RACE_MARKS):
        raise _BindRace(f"ports {port}, {nccl_port}: {failed}\n{text}")
    raise RuntimeError(f"ring across processes failed: {failed}\n{text}")


def _wait(workers: list, deadline_s: float) -> str | None:
    """Poll until every worker exits 0 (None), one exits non-zero or the
    deadline passes (what went wrong)."""
    t0 = time.monotonic()
    while True:
        rcs = [p.poll() for p, _ in workers]
        bad = [i for i, rc in enumerate(rcs) if rc not in (None, 0)]
        if bad:
            return f"worker {bad[0]} exited {rcs[bad[0]]}"
        if all(rc == 0 for rc in rcs):
            return None
        if time.monotonic() - t0 > deadline_s:
            return (f"workers still running after {deadline_s:.0f} s (exit "
                    f"codes {rcs})")
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


class Counts:
    """Kernel launches: the wrappers' own counts on the card, the calls
    of the dispatching functions on the CPU (not those on ``meta``
    tensors: a graph's shape inference, which launches nothing)."""

    def __init__(self, device: str):
        from defer_tpu_torch.ops import flash_attention_cuda, quant_cuda
        self.kernels = [quant_cuda.KERNEL, flash_attention_cuda.KERNEL]
        self.cpu = device == "cpu"
        self.calls = {k.name: 0 for k in self.kernels}
        self._wrapped: list = []
        if self.cpu:
            self._wrap("defer_tpu_torch.ops.quant", "quantize_int8_blocks",
                       "quant_int8")
            self._wrap("defer_tpu_torch.ops.flash_attention",
                       "flash_attention", "flash_attention")

    def _wrap(self, module: str, attr: str, name: str) -> None:
        mod = sys.modules[module]
        fn = getattr(mod, attr)

        def counted(*a, **kw):
            if a[0].device.type != "meta":
                self.calls[name] += 1
            return fn(*a, **kw)

        setattr(mod, attr, counted)
        self._wrapped.append((mod, attr, fn))

    def close(self) -> None:
        """Put the wrapped functions back."""
        for mod, attr, fn in self._wrapped:
            setattr(mod, attr, fn)
        self._wrapped.clear()

    def zero(self) -> None:
        for k in self.kernels:
            k.zero()
        self.calls = dict.fromkeys(self.calls, 0)

    def read(self) -> dict:
        if self.cpu:
            return dict(self.calls)
        return {k.name: k.launches for k in self.kernels}


def _cuts(models, cuts):
    """A cut list: the name of one of ``models``' lists, a tuple of node
    names, or None."""
    if isinstance(cuts, str):
        return getattr(models, cuts)
    return list(cuts) if cuts else None


def _model(models, spec):
    factory, kw, cuts, stages = spec
    return getattr(models, factory)(**kw), _cuts(models, cuts), stages


def _sync(torch, device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def ring_case(torch, res, arrays, key, counts, stages, params, x, mesh, wire,
              cfg, device):
    """One pipeline run on the mesh, its launches zeroed just before and
    read just after; then ``TIMED_PUSHES`` steady pushes of a chunk, each
    timed (host clock, ending in a synchronize on the card; the ring
    filled by two pushes first), and their median kept."""
    from defer_tpu_torch import SpmdPipeline

    pipe = SpmdPipeline(stages, params, mesh=mesh,
                        microbatch=cfg["microbatch"], chunk=cfg["chunk"],
                        wire=wire)
    counts.zero()
    rows = pipe.run(x)
    _sync(torch, device)
    m = pipe.metrics
    res[key] = {"launches": counts.read(), "steps": m.steps,
                "boundary_bytes": m.boundary_bytes,
                "boundary_sends": m.boundary_sends,
                "captures": m.captures, "transport": pipe.hop_transport,
                "local_stages": list(pipe.local_stages),
                "buf_elems": pipe.buf_elems, "ring": list(pipe._a.shape)}
    arrays[f"{key}_rows"] = rows
    xs = pipe.stage_inputs(x[:cfg["chunk"]])
    res[key]["staged_rows"] = xs.shape[1]
    for _ in range(2):
        pipe.push(xs)
    _sync(torch, device)
    times = []
    for _ in range(TIMED_PUSHES):
        t0 = time.perf_counter()
        pipe.push(xs)
        _sync(torch, device)
        times.append(time.perf_counter() - t0)
    res[key]["push_s"] = float(np.median(times))
    res[key]["push_spread_s"] = max(times) - min(times)
    return pipe


def collectives(torch, mesh, axis: str, dev, arrays, key) -> None:
    """Every collective over ``axis`` on this process's ranks of its line:
    rank s of line d holds ``X[d, s]`` (integer-valued f32)."""
    from defer_tpu_torch.parallel import mesh as M

    d_ax = mesh.axis_names.index(axis)
    shape = mesh.devices.shape
    x = np.random.default_rng(SEED + 1).integers(
        -8, 8, shape + (8, 8)).astype(np.float32)
    me = M.current_process()
    mine = np.argwhere(mesh.processes == me)  # positions, in order
    xs = [torch.from_numpy(x[tuple(p)].copy()).to(dev) for p in mine]
    n = shape[d_ax]
    ring = [(i, (i + 1) % n) for i in range(n)]
    kw = {"mesh": mesh, "axis": axis}
    out = {"psum": M.psum(xs, **kw),
           "ppermute": M.ppermute(xs, ring, **kw),
           "ppermute_partial": M.ppermute(xs, [(0, 1)], **kw),
           "all_gather": M.all_gather(xs, 0, mesh=mesh, axis_name=axis),
           "all_gather_tiled": M.all_gather(xs, 0, True, mesh=mesh,
                                            axis_name=axis),
           "all_to_all": M.all_to_all(xs, 0, 1, **kw)}
    arrays[f"{key}_positions"] = mine
    for op, ys in out.items():
        arrays[f"{key}_{op}"] = np.stack([y.cpu().numpy() for y in ys])


def guards(torch, res, dev, cfg, g, params, mesh, pipe) -> None:
    """Each guard's message (empty when it did not raise)."""
    from defer_tpu_torch import Defer, DeferConfig, SpmdPipeline
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    n = mesh.shape["stage"]
    procs = int(mesh.processes.max()) + 1
    tries = {
        "mpmd": lambda: Defer(DeferConfig(mode="mpmd", device=dev),
                              mesh=mesh).build(g, params, num_stages=n),
        # raises before the stage count is read
        "two_devices": lambda: SpmdPipeline(
            pipe.stages, params,
            mesh=multihost_pipeline_mesh(2 * procs, local_devices=[
                "cuda:0", "cuda:1"]), microbatch=cfg["microbatch"]),
    }
    res["guards"] = {}
    for name, fn in tries.items():
        try:
            fn()
            res["guards"][name] = ""
        except NotImplementedError as e:
            res["guards"][name] = str(e)


def nccl_refusal(torch, D, args, stages, params, microbatch: int) -> str:
    """Several processes on one card under NCCL: placing a ring on them
    raises naming gloo (its message; empty when it did not raise).  The
    group forms and an ``SpmdPipeline`` of ``stages`` over every process is
    placed, each process's ring on the one device.  The CPU has no NCCL
    and no card: there the group is gloo's, named NCCL to the placement,
    and every rank's ring names one card."""
    from defer_tpu_torch import SpmdPipeline
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    dist = torch.distributed
    n = len(stages)

    def place():
        SpmdPipeline(stages, params, mesh=multihost_pipeline_mesh(
            n, local_devices=[args.device] * (n // args.procs)),
            microbatch=microbatch)

    try:
        if args.device != "cpu":
            D.initialize(f"127.0.0.1:{args.nccl_port}", args.procs,
                         args.worker, backend="nccl", timeout_s=args.timeout)
            place()
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{args.nccl_port}",
                world_size=args.procs, rank=args.worker)
            real = dist.get_backend, D.card_key
            dist.get_backend = lambda group=None: "nccl"
            D.card_key = lambda device=None: "host/one-card"
            try:
                place()
            finally:
                dist.get_backend, D.card_key = real
    except RuntimeError as e:
        return str(e)
    dist.destroy_process_group()
    D._initialized = False
    return ""


def prepare(torch, models, cfg, given) -> dict:
    """A worker's host work for the ``ring`` cases, before it touches the
    card or the group: the graphs and their stages (``dp``: ResNet's in
    ``dp_stages``), and the parent's weights and inputs."""
    from defer_tpu_torch import partition

    g, cuts, n = _model(models, cfg["resnet"])
    prep = {"resnet": (g, cuts, partition(g, cuts, num_stages=n),
                       given["resnet_params"], given["resnet_x"].numpy()),
            "dp": partition(g, num_stages=cfg["dp_stages"])}
    g, cuts, n = _model(models, cfg["bert"])
    prep["bert"] = (partition(g, cuts, num_stages=n), given["bert_params"],
                    given["bert_ids"].numpy())
    return prep


def ring_group(torch, res, arrays, counts, models, cfg, prep, dev, n_proc,
               mark) -> None:
    """The ``ring`` cases (see the module's docstring)."""
    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    mb = cfg["microbatch"]
    # resnet: 8 stages, two a process, both wires; Defer.run and .stream
    g, cuts, stages, params, x = prep.pop("resnet")
    n = len(stages)
    mesh = multihost_pipeline_mesh(n, local_devices=[dev] * (n // n_proc))
    pipes = {w: ring_case(torch, res, arrays, f"resnet_{w}", counts, stages,
                          params, x, mesh, w, cfg, dev)
             for w in WIRES}
    defer = Defer(DeferConfig(wire="int8", microbatch=mb,
                              chunk=cfg["chunk"], device=dev), mesh=mesh)
    arrays["defer_run_rows"] = defer.run(g, params, x, cut_points=cuts,
                                         num_stages=n)
    arrays["defer_stream_rows"] = np.stack([
        y.float().cpu().numpy() for y in defer.stream(
            g, params, list(x), cut_points=cuts, num_stages=n)])
    mark("resnet_rings")
    pipe = pipes["buffer"]
    res["stage_latencies"] = pipe.stage_latencies(iters=2)
    guards(torch, res, dev, cfg, g, params, mesh, pipe)
    if cfg["reweight"]:
        pipe.reweight(g.init(torch.Generator().manual_seed(SEED + 1)))
        arrays["reweight_rows"] = pipe.run(x)
    collectives(torch, mesh, "stage", dev, arrays, "line")
    del pipes, pipe, defer
    mark("resnet_checks")

    # dp: (data 2, stage S), each data line on a sub-group
    stages = prep.pop("dp")
    dmesh = multihost_pipeline_mesh(len(stages), 2, local_devices=[dev] * (
        2 * len(stages) // n_proc))
    for w in cfg["dp_wires"]:
        ring_case(torch, res, arrays, f"dp_{w}", counts, stages, params, x,
                  dmesh, w, cfg, dev)
    collectives(torch, dmesh, "stage", dev, arrays, "sub")
    del g, params, x
    mark("dp")

    # bert: S stages, S / N a process, both wires
    stages, params, ids = prep.pop("bert")
    bmesh = multihost_pipeline_mesh(len(stages), local_devices=[dev] * (
        len(stages) // n_proc))
    for w in WIRES:
        ring_case(torch, res, arrays, f"bert_{w}", counts, stages, params,
                  ids, bmesh, w, cfg, dev)
    mark("bert_rings")


# ---------------------------------------------------------------------------
# the decoder cases
# ---------------------------------------------------------------------------


def decode_graphs(models, dc) -> dict:
    """The decoder cases' graphs by name (``DECODE[preset]["models"]``)."""
    return {name: getattr(models, factory)(**kw)
            for name, (factory, kw) in dc["models"].items()}


def decode_cases(dc, key: str) -> tuple:
    cases = dc["cases"][key]
    return ALL_DECODE if cases == "all" else tuple(cases)


class DecodeRun:
    """The decoder cases of one of ``DECODE[preset]``'s meshes, on the
    given weights and inputs (:func:`make_inputs`'s keys) and graphs
    (:func:`decode_graphs`): the workers run them on ``mesh`` across
    processes; with ``mesh=None`` they run on the one-process engines in
    as many stages, the CPU tests' reference.
    Engines are built once per mesh and configuration and reused, as a
    server would; :meth:`case` runs one case."""

    def __init__(self, torch, models, dc, given, key, device, graphs,
                 mesh=None, tp: int = 1):
        self.torch, self.dc, self.device, self.mesh = torch, dc, device, mesh
        #: the model axis of a one-process reference's ``Defer`` (a mesh's
        #: own across processes)
        self.tp = tp
        model, self.n, _, draft = dc["meshes"][key]
        self.graph, self.params = graphs[model], given[f"{model}_params"]
        blocks = sum(nm.startswith("block_") for nm in self.graph.topo_order)
        self.cuts = models.gpt_stage_cuts(blocks, self.n)
        self.draft = None
        if draft is not None:
            dg = graphs[draft]
            self.draft = (dg, given[f"{draft}_params"], models.gpt_stage_cuts(
                sum(nm.startswith("block_") for nm in dg.topo_order),
                self.n))
        self.prompts = np.asarray(given["gpt_prompts"])
        self.ids = np.asarray(given["gpt_score_ids"])
        self._engines: dict = {}
        #: each case's first result (``tokens``, ``logits``, ...)
        self.results: dict = {}

    def _place(self) -> dict:
        return ({"device": self.device} if self.mesh is None
                else {"mesh": self.mesh})

    def decoder(self, **ctor):
        from defer_tpu_torch import PipelinedDecoder

        key = ("decoder",) + tuple(sorted(ctor.items()))
        if key not in self._engines:
            self._engines[key] = PipelinedDecoder(
                self.graph, self.params, num_stages=self.n,
                microbatch=self.dc["microbatch"],
                max_len=self.dc["max_len"], **self._place(), **ctor)
        return self._engines[key]

    def defer(self, wire: str = "buffer"):
        from defer_tpu_torch import Defer, DeferConfig

        key = ("defer", wire)
        if key not in self._engines:
            self._engines[key] = Defer(DeferConfig(
                microbatch=self.dc["microbatch"], chunk=self.dc["chunk"],
                wire=wire, device=self.device,
                tensor_parallel=self.tp if self.mesh is None else 1),
                mesh=self.mesh)
        return self._engines[key]

    def _stages(self) -> dict:
        """``num_stages`` for a call of ``Defer`` without a mesh."""
        return {"num_stages": self.n} if self.mesh is None else {}

    def _call(self, name: str):
        """``(fn, engine)``: the case's call and what runs it."""
        from defer_tpu_torch import speculative_generate

        kind, ctor, kw = DECODE_CASES[name]
        kw, new, mb = dict(kw), self.dc["new"], self.dc["microbatch"]
        if kind == "decoder":
            dec = self.decoder(**ctor)
            prompts = self.prompts
            if dec.beam_width > 1:
                prompts = prompts[:self.n * (mb // dec.beam_width)]
            if kw.pop("eos", False):
                kw["eos_id"] = self.eos_id()
                spans = self.results.setdefault(f"{name}_spans", [])
                kw["on_tokens"] = lambda lo, hi, t, rows: spans.append(
                    (lo, hi, rows[0], rows[1], t))
            return (lambda: {"tokens": dec.generate(prompts, new, **kw)},
                    dec)
        if kind == "defer":
            d = self.defer()
            return (lambda: {"tokens": d.generate(
                self.graph, self.params, self.prompts, new,
                max_len=self.dc["max_len"], **self._stages(), **kw)}, d)
        if kind in ("logits", "score"):
            d = self.defer(ctor["wire"])
            if kind == "logits":
                return (lambda: {"logits": d.logits(
                    self.graph, self.params, self.ids,
                    cut_points=self.cuts)}, d)
            return (lambda: dict(zip(("logprob", "perplexity"), d.score(
                self.graph, self.params, self.ids, cut_points=self.cuts))),
                d)
        d = self.defer()
        dg, dp, dcuts = self.draft

        def spec():
            out, stats = speculative_generate(
                d, self.graph, self.params, dg, dp, self.prompts[:2 * mb],
                new, cut_points=self.cuts, draft_cut_points=dcuts,
                return_stats=True, **kw)
            self.results["speculative_stats"] = stats
            return {"tokens": out}
        return spec, d

    def eos_id(self) -> int:
        """The greedy run's token at position plen + 1 of row 0."""
        return int(self.results["greedy"]["tokens"][0, self.prompts.shape[1]
                                                    + 1])

    def case(self, name: str, counts) -> tuple[dict, dict]:
        """Run case ``name`` ``DECODE[preset]["timed"]`` times, the kernel
        counts zeroed just before the first call and read just after it;
        returns its arrays (the first call's) and its scalars (the
        engine's for the first call: what crossed, ring steps)."""
        torch = self.torch
        fn, engine = self._call(name)
        kind = DECODE_CASES[name][0]
        times, meta = [], {}
        for i in range(self.dc["timed"]):
            if i == 0:
                before = self._engine_meta(engine, kind)
                counts.zero()
            _sync(torch, self.device)
            t0 = time.perf_counter()
            out = fn()
            _sync(torch, self.device)
            times.append(time.perf_counter() - t0)
            if i == 0:
                first, meta["launches"] = out, counts.read()
                meta.update(self._engine_meta(engine, kind))
                for k in ("boundary_bytes", "boundary_sends", "steps",
                          "allreduce_calls", "allreduce_bytes"):
                    if k in meta:
                        meta[k] -= before.get(k, 0)
        self.results[name] = first
        meta["seconds"] = times
        spans = self.results.pop(f"{name}_spans", None)
        arrays = {k: np.asarray(v) for k, v in first.items()}
        if spans is not None:
            meta["spans"] = [list(sp[:4]) for sp in spans]
            for i, sp in enumerate(spans):
                arrays[f"span{i}"] = sp[4]
        if name == "speculative":
            meta["stats"] = self.results.pop("speculative_stats")
        return arrays, meta

    @staticmethod
    def _engine_meta(engine, kind: str) -> dict:
        """What the engine that ran a case (a decoder, or the one a
        ``Defer`` built: its decoder or its score pipeline) reports."""
        if kind != "decoder":
            cache = (engine._decoder_cache if kind == "defer"
                     else engine._score_cache)
            if not cache:
                return {}
            engine = next(iter(cache.values()))[2]
        m = engine.metrics
        out = {"local_stages": list(engine.local_stages),
               "transport": engine.hop_transport,
               "boundary_bytes": m.boundary_bytes,
               "boundary_sends": m.boundary_sends,
               "allreduce_calls": m.allreduce_calls,
               "allreduce_bytes": m.allreduce_bytes}
        if hasattr(engine, "caches"):
            out.update(captures=engine.captures,
                       caches={k: len(v) for k, v in engine.caches.items()},
                       rows=len(engine._rows))
        else:
            out.update(captures=m.captures, steps=m.steps)
        return out

    def rows(self) -> dict:
        """This process's weight rows of the greedy decoder, by stage."""
        dec = self.decoder()
        return {f"row{s}": dec._rows[i][0].float().cpu().numpy()
                for i, s in enumerate(dec.local_stages)}


def decode_group(torch, res, arrays, counts, models, preset, given, dev,
                 n_proc, mark) -> None:
    """The ``decode`` cases on each of ``DECODE[preset]``'s meshes, spread
    over the ``n_proc`` processes: arrays ``dec_<mesh>_<case>__<name>``
    and scalars ``res["decode"][mesh][case]``."""
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    dc = DECODE[preset]
    graphs = decode_graphs(models, dc)
    res["decode"] = {}
    for key, (_, n, dp, _) in dc["meshes"].items():
        mesh = multihost_pipeline_mesh(n, dp, local_devices=[dev] * (
            n * dp // n_proc))
        run = DecodeRun(torch, models, dc, given, key, dev, graphs,
                        mesh=mesh)
        res["decode"][key] = {}
        for case in decode_cases(dc, key):
            got, meta = run.case(case, counts)
            res["decode"][key][case] = meta
            for k, v in got.items():
                arrays[f"dec_{key}_{case}__{k}"] = v
        if dc["keep_rows"]:
            for k, v in run.rows().items():
                arrays[f"dec_{key}_{k}"] = v
        del run
        mark(f"decode_{key}")


# ---------------------------------------------------------------------------
# the training cases
# ---------------------------------------------------------------------------


def train_graph(models, tc, model: str):
    """``(graph, cuts, loss)`` of one of ``TRAIN[preset]``'s (or a ``TP``
    preset's ``train``) models (a transformer's blocks on
    ``attn_impl="xla"``: the flash operator has no backward)."""
    from defer_tpu_torch.graph import with_attn_impl

    factory, kw, cuts, loss = tc["models"][model]
    g = getattr(models, factory)(**kw)
    if loss in ("lm", "cls"):
        g = with_attn_impl(g, "xla")
    return g, _cuts(models, cuts), loss


def train_loss(torch, kind: str):
    """The summed loss's per-microbatch term: cross-entropy of the logits
    (``ce``, and ``cls``: a class of token ids) or of each next token
    (``lm``, the ids as targets)."""
    F = torch.nn.functional
    if kind in ("ce", "cls"):
        return lambda logits, y: F.cross_entropy(logits.float(), y)
    return lambda logits, ids: F.cross_entropy(
        logits[:, :-1].float().flatten(0, 1), ids[:, 1:].long().flatten())


def params_digest(params) -> str:
    """A hash of a parameter dict's leaves (paths, dtypes and bytes, in
    path order): equal digests, equal weights."""
    import hashlib

    import torch

    from defer_tpu_torch.graph.ir import flatten_tree

    h = hashlib.sha256()
    flat = {f"{n}/{k}": v for n, sub in params.items()
            for k, v in flatten_tree(sub).items()}
    for k in sorted(flat):
        v = flat[k].detach().cpu().contiguous()
        h.update(f"{k}:{v.dtype}:{tuple(v.shape)}".encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _leaves(prefix: str, trees) -> dict:
    """``{prefix/node/path: array}`` of parameter dicts."""
    from defer_tpu_torch.graph.ir import flatten_tree

    return {f"{prefix}/{n}/{k}": v.float().numpy()
            for tree in trees for n, sub in tree.items()
            for k, v in flatten_tree(sub).items()}


class TrainRun:
    """The training cases of one of ``TRAIN[preset]``'s runs, on the given
    weights and inputs (:func:`make_inputs`'s keys): the workers run them
    on ``mesh`` across processes; with ``mesh=None`` they run the
    one-process trainer in as many stages and data lines, the CPU tests'
    reference.  One pipeline serves every case, reweighted with the
    initial weights before each; :meth:`case` runs one case.

    * ``grad``: one ``loss_and_grad``: the loss and every stage's gradient
      leaves (this process's stages only unless the preset keeps all);
    * ``sgd``, ``adam``: ``steps`` optimizer steps from the initial
      weights: the losses and ``trained_params``; ``adam`` saves a
      checkpoint before its last step (``ckpt_out``, where ``out`` is
      given) and then runs the trained deployment and a fresh pipeline of
      ``trained_params`` on the inputs;
    * ``accumulate``: one SGD ``accumulate_step`` over the chunk's two
      halves;
    * ``ckpt_in``: a one-process trainer (on process 0 across processes)
      takes ``steps - 1`` Adam steps and saves; this run's trainer loads
      the checkpoint and takes the last step.

    ``built`` (shared by the runs) holds each (model, stages)'s partition
    and loss, made by the first run that needs it."""

    def __init__(self, torch, models, tc, given, key, device, mesh=None,
                 out=None, built=None, tp: int = 1):
        from defer_tpu_torch import SpmdPipeline, partition

        self.torch, self.tc, self.device, self.mesh = torch, tc, device, mesh
        #: the model axis of the one-process reference (a mesh's own
        #: across processes)
        self.tp = tp
        self.out = None if out is None else Path(out)
        self.key = key
        model, n, self.dp, self.wire, self.cases = tc["runs"][key]
        # runs of one model in as many stages share its graph and stages
        built = {} if built is None else built
        if (model, n) not in built:
            g, cuts, loss = train_graph(models, tc, model)
            built[model, n] = (partition(g, cuts, num_stages=None if cuts
                                         else n), loss)
        self.stages, loss = built[model, n]
        self.params = given[f"train_{model}_params"]
        self.x = np.asarray(given[f"train_{model}_x"])
        self.y = np.asarray(given[f"train_{model}_y"])
        self.loss = train_loss(torch, loss)
        self.steps, self.lr = tc["steps"][model], tc["lr"][model]
        self.pipe_kw = dict(microbatch=tc["microbatch"], chunk=tc["chunk"],
                            wire=self.wire)
        self.pipe = SpmdPipeline(self.stages, self.params,
                                 **self._place(), **self.pipe_kw)

    def _place(self) -> dict:
        return ({"device": self.device, "data_parallel": self.dp,
                 "tensor_parallel": self.tp}
                if self.mesh is None else {"mesh": self.mesh})

    def trainer(self, opt: str | None = None, lr: float = 0.0, pipe=None):
        """A trainer of ``pipe`` (this run's, reweighted with the initial
        weights) with ``torch.optim`` ``opt`` at ``lr`` (None: the
        trainer's default)."""
        from defer_tpu_torch import PipelineTrainer

        if pipe is None:
            pipe = self.pipe
            pipe.reweight(self.params)
        cls = None if opt is None else getattr(self.torch.optim, opt)
        return PipelineTrainer(pipe, self.loss, optimizer=None if cls is None
                               else lambda rows: cls(rows, lr=lr))

    def _timed(self, fn):
        """``(fn(), seconds)``, the device synchronised."""
        _sync(self.torch, self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.torch, self.device)
        return out, time.perf_counter() - t0

    def _grads(self, t, grads) -> dict:
        trees = t.stage_grads(grads)
        if not self.tc["keep_all"]:
            trees = [trees[k] for k in self.pipe.local_stages]
        return _leaves("g", trees)

    def _trained(self, t, meta) -> tuple[dict, dict]:
        """``trained_params`` (the weights every process gathered) and
        their leaves where the preset keeps them; ``meta`` gets their
        digest and, under tensor parallelism, per local stage a digest of
        each of its rows' replicated leaves (equal copies, equal
        digests)."""
        import hashlib

        params = t.trained_params()
        meta["digest"] = params_digest(params)
        if self.pipe.tensor_parallel > 1:
            meta["tied"] = {str(k): [hashlib.sha256(
                row.detach()[t._tied[i]].cpu().numpy().tobytes()).hexdigest()
                for row in self.pipe.modules[i].rows]
                for i, k in enumerate(self.pipe.local_stages)}
        return params, (_leaves("p", [params]) if self.tc["keep_all"]
                        else {})

    def case(self, name: str, counts) -> tuple[dict, dict]:
        """Run case ``name``: its arrays and its scalars (the losses, the
        kernel counts zeroed just before its trainer's calls and read just
        after, what crossed in them, seconds)."""
        torch, x, y, steps = self.torch, self.x, self.y, self.steps
        m = self.pipe.metrics
        before = (m.boundary_bytes, m.boundary_sends, m.allreduce_calls)
        arrays, meta = {}, {}
        if name == "grad":
            t = self.trainer()
            counts.zero()
            (loss, grads), sec = self._timed(lambda: t.loss_and_grad(x, y))
            meta.update(loss=float(loss), launches=counts.read(),
                        seconds=[sec])
            arrays.update(self._grads(t, grads))
        elif name in ("sgd", "adam", "accumulate"):
            t = self.trainer("Adam" if name == "adam" else "SGD",
                             self.lr[name])
            counts.zero()
            if name == "accumulate":
                h = x.shape[0] // 2
                loss, sec = self._timed(lambda: t.accumulate_step(
                    [(x[:h], y[:h]), (x[h:], y[h:])]))
                losses, secs = [loss], [sec]
            else:
                losses, secs = [], []
                for i in range(steps):
                    if name == "adam" and i == steps - 1 and self.out:
                        t.save_checkpoint(
                            str(self.out / f"ckpt_out_{self.key}"))
                    loss, sec = self._timed(lambda: t.step(x, y))
                    losses.append(loss)
                    secs.append(sec)
            meta.update(losses=losses, launches=counts.read(), seconds=secs)
            params, got = self._trained(t, meta)
            arrays.update(got)
            if name == "adam":
                arrays.update(self._serve(params, counts, meta))
        elif name == "ckpt_in":
            t = self._loaded()
            counts.zero()
            loss, sec = self._timed(lambda: t.step(x, y))
            meta.update(losses=[loss], launches=counts.read(), seconds=[sec])
            arrays.update(self._trained(t, meta)[1])
        else:
            raise ValueError(f"no training case {name!r}")
        meta["boundary_bytes"] = m.boundary_bytes - before[0]
        meta["boundary_sends"] = m.boundary_sends - before[1]
        meta["allreduce_calls"] = m.allreduce_calls - before[2]
        meta["ranks"] = list(self.pipe.ranks)
        meta["transport"] = self.pipe.hop_transport
        meta["local_stages"] = list(self.pipe.local_stages)
        meta["buf_elems"] = self.pipe.buf_elems
        meta["ring_steps"] = x.shape[0] + len(self.stages) - 1
        return arrays, meta

    def _serve(self, params, counts, meta) -> dict:
        """The trained deployment's run, and a fresh pipeline's of its
        ``trained_params`` on the same placement."""
        from defer_tpu_torch import SpmdPipeline

        counts.zero()
        rows = self.pipe.run(self.x)
        meta["run_launches"] = counts.read()
        fresh = SpmdPipeline(self.stages, params, **self._place(),
                             **self.pipe_kw).run(self.x)
        return {"run_rows": rows, "fresh_rows": fresh}

    def _loaded(self):
        """A trainer of this run's pipeline that loaded a one-process
        trainer's checkpoint after ``steps - 1`` Adam steps (made on
        process 0 across processes)."""
        from defer_tpu_torch import SpmdPipeline
        from defer_tpu_torch.parallel.mesh import current_process

        torch, lr = self.torch, self.lr["adam"]
        path = str((self.out or Path(".")) / f"ckpt_in_{self.key}")
        if self.mesh is None or current_process() == 0:
            one = self.trainer("Adam", lr, pipe=SpmdPipeline(
                self.stages, self.params, device=self.device,
                data_parallel=self.dp,
                tensor_parallel=self.pipe.tensor_parallel, **self.pipe_kw))
            for _ in range(self.steps - 1):
                one.step(self.x, self.y)
            one.save_checkpoint(path)
            del one
        if self.mesh is not None:
            torch.distributed.barrier()
        t = self.trainer("Adam", lr)
        t.load_checkpoint(path)
        return t


def train_group(torch, res, arrays, counts, models, preset, given, dev,
                n_proc, out, mark, built: dict) -> None:
    """The ``train`` cases of each of ``TRAIN[preset]``'s runs, spread over
    the ``n_proc`` processes: arrays ``tr_<run>_<case>__<name>`` and
    scalars ``res["train"][run][case]``; ``built`` holds the stages
    already partitioned, by (model, stages) (:class:`TrainRun`)."""
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    tc = TRAIN[preset]
    res["train"] = {}
    # cuDNN's default weight-gradient kernels sum in a varying order, and
    # Adam turns a last-bit difference in a near-zero gradient into a step
    # of 2 lr: the card's one-process reference (the chip smoke's phase 4r
    # b) takes its steps on deterministic algorithms, and so do these
    torch.backends.cudnn.deterministic = True
    for key, (_, n, dp, _, cases) in tc["runs"].items():
        mesh = multihost_pipeline_mesh(n, dp, local_devices=[dev] * (
            n * dp // n_proc))
        run = TrainRun(torch, models, tc, given, key, dev, mesh=mesh,
                       out=out, built=built)
        res["train"][key] = {}
        for case in cases:
            got, meta = run.case(case, counts)
            res["train"][key][case] = meta
            for k, v in got.items():
                arrays[f"tr_{key}_{case}__{k}"] = v
        del run
        mark(f"train_{key}")


# ---------------------------------------------------------------------------
# the serving cases
# ---------------------------------------------------------------------------


#: per preset, the serving cases (:class:`ServeRun`): the model (factory,
#: keyword arguments, cut list, stages), the keys of its weights and
#: inputs ``[frames, microbatch, *in_shape]`` in the spawn's inputs, the
#: microbatch and ring chunk, the cases run, and the seconds any wait for
#: a stream, a client or a thread may take
SERVE = {
    "cpu": {"model": ("resnet_tiny", {}, None, 8),
            "inputs": ("serve_params", "serve_x"), "image": 32,
            "microbatch": 1, "chunk": 3, "frames": 8, "wait_s": 60.0},
    "card": {"model": ("resnet50", {"image_size": 224},
                       "RESNET50_8STAGE_CUTS", 8),
             "inputs": ("resnet_params", "resnet_x"), "image": 224,
             "microbatch": 8, "chunk": 4, "frames": 8, "wait_s": 120.0,
             "cases": ("queue_int8", "ep_pair_int8")},
}
#: the serving cases: (kind, the ``DeferConfig`` fields it sets, its
#: options).  ``queue`` cases run ``run_defer``, ``ep`` cases
#: ``serve_endpoint``; ``dp`` puts the ring on (data 2, stage S / 2);
#: ``wedge`` blocks one process's push, once: ``(process, k)`` its k-th
#: push that carries rows, ``(process, "drain")`` its first bubble push
#: after every frame was pushed; before the push runs, or with a third
#: item ``"after"`` once it has returned (its rows gathered on every
#: process, not yet emitted on this one); a wedge holds until every
#: process's stream has ended, or with ``early`` until the wedged
#: process's own has; ``peers_watchdog_s`` gives the other processes
#: another ``watchdog_s``
SERVE_CASES = {
    "queue_buffer": ("queue", {}, {}),
    "queue_int8": ("queue", {"wire": "int8"}, {}),
    "bf16_int8": ("queue", {"wire": "int8", "compute_dtype": "bfloat16"},
                  {"run": True}),
    "bad_input": ("queue", {}, {"bad": (8, 8, 3)}),
    "stage_error": ("queue", {}, {"bad": (7,)}),
    "preflight": ("queue", {}, {"bad_params": True}),
    "dead_leader": ("queue", {"watchdog_s": 1.0, "max_recoveries": 0},
                    {"wedge": (0, 2)}),
    "dead_follower": ("queue", {"watchdog_s": 1.0, "max_recoveries": 0},
                      {"wedge": (2, 2)}),
    "dead_peer_left": ("queue", {"watchdog_s": 1.0, "max_recoveries": 0},
                       {"wedge": (2, 2), "early": True,
                        "peers_watchdog_s": 60.0}),
    "recover_mid": ("queue", {"watchdog_s": 2.0, "gather_timeout_s": 0.01},
                    {"wedge": (0, 2)}),
    "recover_drain": ("queue", {"watchdog_s": 2.0,
                                "gather_timeout_s": 0.01},
                      {"wedge": (0, "drain")}),
    "recover_after_leader": ("queue", {"watchdog_s": 2.0,
                                       "gather_timeout_s": 0.01},
                             {"wedge": (0, 2, "after")}),
    "recover_after_follower": ("queue", {"watchdog_s": 2.0,
                                         "gather_timeout_s": 0.01},
                               {"wedge": (2, 2, "after")}),
    "recover_drain_after_leader": ("queue", {"watchdog_s": 2.0,
                                             "gather_timeout_s": 0.01},
                                   {"wedge": (0, "drain", "after")}),
    "recover_drain_after_follower": ("queue", {"watchdog_s": 2.0,
                                               "gather_timeout_s": 0.01},
                                     {"wedge": (2, "drain", "after")}),
    "stop_leader": ("queue", {}, {"stop": 0}),
    "stop_follower": ("queue", {}, {"stop": 2}),
    "dp_int8": ("queue", {"wire": "int8", "microbatch": 2}, {"dp": True}),
    "ep_order": ("ep", {}, {"clients": 1}),
    "ep_pair": ("ep", {}, {"clients": 2}),
    "ep_pair_int8": ("ep", {"wire": "int8"}, {"clients": 2}),
    "ep_bf8": ("ep", {"microbatch": 2}, {"clients": 1, "codec": "bf8"}),
    "ep_bf16": ("ep", {"wire": "int8", "compute_dtype": "bfloat16",
                       "buffer_dtype": "bfloat16"},
                {"clients": 1, "bf16": True, "run": True}),
    "ep_stop": ("ep", {}, {"clients": 1, "stop": True}),
    "ep_reweight": ("ep", {}, {"clients": 1, "reweight": True}),
    "ep_reconnect": ("ep", {}, {"clients": 1, "dead_client": True}),
    "ep_stall": ("ep", {"chunk": 2}, {"stall": True}),
    "ep_bad": ("ep", {"chunk": 2}, {"bad": (7,)}),
}
#: the cases whose rows the CPU tests hold to the one-process services
SERVE_REFERENCED = ("queue_buffer", "queue_int8", "bf16_int8", "dp_int8",
                    "ep_order", "ep_pair", "ep_pair_int8", "ep_bf8",
                    "ep_bf16", "ep_reweight", "ep_reconnect")


class _Wedge:
    """``pipe.push`` blocks, once, on the push ``hit(n_real)`` selects,
    until ``release`` is set: before the push runs (released, the
    abandoned generation finishes its step on its own groups), or with
    ``after`` once it has returned."""

    def __init__(self, pipe, hit, after: bool = False):
        self.release = threading.Event()
        self.entered = False
        real = pipe.push

        def push(xs, n_real=None, **kw):
            fire = not self.entered and hit(xs.shape[0] if n_real is None
                                            else n_real)
            if fire:
                self.entered = True
                if not after:
                    self.release.wait()
            out = real(xs, n_real=n_real, **kw)
            if fire and after:
                self.release.wait()
            return out

        pipe.push = push


def _wedge_hit(k, frames: int):
    """``hit`` of a wedge: the k-th push carrying rows, or (``"drain"``)
    the first bubble push after ``frames`` rows were pushed."""
    seen = {"pushes": 0, "rows": 0}

    def hit(n_real: int) -> bool:
        seen["rows"] += n_real
        if k == "drain":
            return n_real == 0 and seen["rows"] >= frames
        seen["pushes"] += n_real > 0
        return n_real > 0 and seen["pushes"] == k
    return hit


class ServeRun:
    """The serving cases of ``SERVE[preset]`` (:data:`SERVE_CASES`), on the
    given weights and inputs: the workers run them on ``meshes``
    (``{False: (stage S), True: (data 2, stage S / 2)}``) across
    processes; with ``meshes=None`` they run the one-process services in
    as many stages and data lines, the CPU tests' reference.  The leader
    (process 0, which holds stage 0 of data line 0 on both meshes) feeds
    the queue and runs the endpoint's clients, as threads; where no wedge
    waits, every frame and the END are queued before the service starts,
    so every push is a full chunk.  :meth:`case` runs one case."""

    def __init__(self, torch, models, sc, given, device, meshes=None,
                 tp: int = 1):
        from defer_tpu_torch.parallel.mesh import current_process

        self.torch, self.sc, self.device, self.meshes = (torch, sc, device,
                                                         meshes)
        #: the model axis of the one-process references (a mesh's own
        #: across processes)
        self.tp = tp
        factory, kw, cuts, self.n = sc["model"]
        self.graph = getattr(models, factory)(**kw)
        self.cuts = getattr(models, cuts) if cuts else None
        pkey, xkey = sc["inputs"]
        self.params = given[pkey]
        self.x = np.asarray(given[xkey], np.float32)
        self.across = meshes is not None
        self.me = current_process() if self.across else 0
        self.lead = self.me == 0

    def _defer(self, cfg: dict, dp: bool):
        from defer_tpu_torch import Defer, DeferConfig

        c = {"microbatch": self.sc["microbatch"], "chunk": self.sc["chunk"],
             "device": self.device, **cfg}
        if not self.across:
            return Defer(DeferConfig(data_parallel=2 if dp else 1,
                                     tensor_parallel=self.tp, **c))
        return Defer(DeferConfig(**c), mesh=self.meshes[dp])

    def _place(self, dp: bool) -> dict:
        """The stage count or cuts a call takes."""
        n = self.n // 2 if dp else self.n
        if self.cuts is not None and not dp:
            return {"cut_points": self.cuts}
        return {"cut_points": None, "num_stages": n}

    def frames(self, mb: int) -> list:
        """The inputs as frames of ``mb`` samples."""
        flat = self.x.reshape((-1,) + self.x.shape[2:])
        return list(flat.reshape((-1, mb) + flat.shape[1:]))

    def _barrier(self) -> None:
        if self.across:  # the default group: the services run on their own
            self.torch.distributed.barrier()

    def case(self, name: str, counts) -> tuple[dict, dict]:
        """Run case ``name``: its rows and its scalars (what each process
        saw: the end of its stream, its errors, its counters, its kernel
        launches zeroed just before the service starts and read after)."""
        from defer_tpu_torch.obs import REGISTRY
        from defer_tpu_torch.obs.events import recorder

        kind, cfg, opts = SERVE_CASES[name]
        if "peers_watchdog_s" in opts and self.me != opts["wedge"][0]:
            cfg = {**cfg, "watchdog_s": opts["peers_watchdog_s"]}
        mb = cfg.get("microbatch", self.sc["microbatch"])
        cursor = recorder().cursor()
        disp = REGISTRY.counter("dispatcher.dispatches")
        ep = [REGISTRY.counter(f"endpoint.samples_{d}") for d in ("in",
                                                                  "out")]
        before = (disp.n, ep[0].n, ep[1].n)
        d = self._defer(cfg, opts.get("dp", False))
        xs = self.frames(mb)
        counts.zero()
        t0 = time.perf_counter()
        arrays, meta = (self._queue if kind == "queue" else self._ep)(
            d, xs, opts)
        meta["seconds"] = time.perf_counter() - t0
        meta["launches"] = counts.read()
        meta["dispatches_registry"] = disp.n - before[0]
        meta["samples_in"] = ep[0].n - before[1]
        meta["samples_out"] = ep[1].n - before[2]
        _, evs = recorder().events_since(cursor)
        meta["events"] = [e["kind"] for e in evs]
        if opts.get("run"):
            inputs = np.stack(xs)
            if opts.get("bf16"):
                inputs = self.torch.from_numpy(inputs).to(
                    self.torch.bfloat16).float().numpy()
            arrays["run"] = d.run(self.graph, self.params, inputs,
                                  **self._place(opts.get("dp", False)))
        return arrays, meta

    # -- run_defer -----------------------------------------------------

    def _drain(self, out_q, n: int):
        """What a process's output queue held: its outputs, up to the END
        (across processes every stream ends with one; one process puts it
        only on a failure, before any output, so there ``n`` outputs end
        it too)."""
        import queue as Q

        from defer_tpu_torch import END_OF_STREAM

        outs = []
        while True:
            try:
                o = out_q.get(timeout=self.sc["wait_s"])
            except Q.Empty:
                return outs, False
            if o is END_OF_STREAM:
                return outs, True
            outs.append(o)
            if not self.across and len(outs) == n:
                return outs, False

    def _queue(self, d, xs, opts) -> tuple[dict, dict]:
        import queue as Q

        from defer_tpu_torch import END_OF_STREAM
        from defer_tpu_torch.graph.ir import tree_map

        torch = self.torch
        params = self.params
        if opts.get("bad_params"):  # every leaf one wider: stages fail
            params = tree_map(lambda v: torch.zeros(
                v.shape[:-1] + (v.shape[-1] + 1,)) if v.dim() else v, params)
        if "bad" in opts:
            xs = [np.zeros((xs[0].shape[0],) + opts["bad"], np.float32)]
        stop_at, wedge = opts.get("stop"), opts.get("wedge")
        if stop_at == 0:
            xs = xs[:len(xs) // 2]
        ending = not (opts.get("bad_params") or stop_at == 0)
        feed = list(xs) + ([END_OF_STREAM] if ending else [])
        in_q, out_q = Q.Queue(), Q.Queue()
        early = wedge is None and stop_at is None
        if self.lead and early:
            for x in feed:
                in_q.put(x)
        place = self._place(opts.get("dp", False))
        h = d.run_defer(self.graph, params, place.pop("cut_points"), in_q,
                        out_q, **place)
        w = None
        if wedge is not None and wedge[0] == self.me:
            w = _Wedge(h.pipeline, _wedge_hit(wedge[1], len(xs)),
                       after=wedge[2:] == ("after",))
        if stop_at and stop_at == self.me:
            h.stop()  # a follower alone: the stream goes on
        self._barrier()  # every wedge and stop in place before the feed
        if self.lead and not early:
            for x in feed:
                in_q.put(x)
        if stop_at == 0 and self.lead:
            deadline = time.monotonic() + self.sc["wait_s"]
            while h._fed < len(xs) and time.monotonic() < deadline:
                time.sleep(0.01)
            h.stop()
        outs, end = self._drain(out_q, len(xs))
        if w is not None and opts.get("early"):
            w.release.set()  # the others' watchdogs have not fired yet
        # a wedge holds until every process's stream has ended, as a real
        # one would: every watchdog has fired by then
        self._barrier()
        if w is not None:
            w.release.set()  # the abandoned generation finishes its step
        try:
            h.join(timeout=self.sc["wait_s"])
            joined = ""
        except RuntimeError as e:
            joined = f"{e}: {e.__cause__!r}"
        left = []
        for t in h.threads:
            t.join(timeout=self.sc["wait_s"])
            if t.is_alive():
                left.append(t.name)
        m = h.metrics
        meta = {"end": end, "joined": joined, "healthy": h.healthy,
                "error": type(h.error).__name__ if h.error else "",
                "recoveries": h.recoveries, "dispatches": h._dispatches,
                "inferences": m.inferences, "steps": m.steps,
                "pushes": m.chunk_calls, "outputs": len(outs),
                "threads_left": left, "wedged": bool(w and w.entered),
                "generations": len(h.threads),
                "boundary_bytes": m.boundary_bytes,
                "boundary_sends": m.boundary_sends,
                "allreduce_calls": m.allreduce_calls,
                "buf_elems": h.pipeline.buf_elems, "captures": m.captures,
                "local_stages": list(h.pipeline.local_stages)}
        return ({"rows": np.stack(outs)} if outs else {}), meta

    # -- serve_endpoint --------------------------------------------------

    def _ep(self, d, xs, opts) -> tuple[dict, dict]:
        from defer_tpu_torch.graph.ir import tree_map
        from defer_tpu_torch.transport.framed import TensorClient, send_frame
        from defer_tpu_torch.transport.staging import HostStagingRing

        torch, wait_s = self.torch, self.sc["wait_s"]
        clients = opts.get("clients", 1)
        max_clients = 4 if opts.get("stop") else (
            2 if opts.get("reweight") or opts.get("dead_client") else clients)
        real_push = HostStagingRing.push
        if opts.get("stall") and self.lead:  # a ring that never accepts
            HostStagingRing.push = lambda self, sample, timeout_s=30.0: False
        try:
            address, thread = d.serve_endpoint(
                self.graph, self.params, **self._place(False),
                codec=opts.get("codec", "raw"), max_clients=max_clients,
                stall_timeout_s=0.2 if opts.get("stall") else 120.0)
            out, meta = {}, {"address": list(address[:2]),
                             "client_errors": []}
            params2 = tree_map(lambda v: v * 1.5, self.params)

            def stream(key, frames):
                c = TensorClient(*address[:2], timeout_s=wait_s)
                try:
                    t0 = time.perf_counter()
                    got = c.infer_stream(frames)
                    meta[f"{key}_s"] = time.perf_counter() - t0
                    out[key] = np.stack(got)
                except (OSError, ConnectionError) as e:
                    meta["client_errors"].append(type(e).__name__)
                finally:
                    c.close()

            if self.lead:
                frames = list(xs)
                if opts.get("bf16"):
                    frames = [torch.from_numpy(x).to(torch.bfloat16)
                              for x in frames]
                if "bad" in opts:
                    stream("a", [np.zeros((1,) + opts["bad"], np.float32)])
                elif opts.get("stall"):
                    stream("a", frames[:2])
                elif opts.get("dead_client"):
                    raw = socket.create_connection(tuple(address[:2]))
                    send_frame(raw, frames[0])
                    send_frame(raw, frames[1])
                    raw.close()  # two frames, then no END
                    stream("a", frames[:5])
                elif opts.get("reweight"):
                    stream("a", frames[:3])
                    thread.reweight(params2)
                    stream("b", frames[:3])
                elif opts.get("stop"):
                    stream("a", frames[:3])
                else:
                    half = len(frames) // clients
                    ts = [threading.Thread(target=stream, args=(
                        "ab"[i], frames[i * half:(i + 1) * half]))
                        for i in range(clients)]
                    t0 = time.perf_counter()
                    for t in ts:
                        t.start()
                    for t in ts:
                        t.join(wait_s)
                    meta["clients_s"] = time.perf_counter() - t0
            elif opts.get("reweight"):
                thread.reweight(params2)  # installed at the leader's step
            if opts.get("stop"):
                thread.stop()  # the leader's ends every process's thread
            thread.join(wait_s)
        finally:
            HostStagingRing.push = real_push
        m = thread.pipeline.metrics
        meta.update(alive=thread.is_alive(),
                    errors=[type(e).__name__ for e in thread.errors],
                    inferences=m.inferences, steps=m.steps,
                    pushes=m.chunk_calls, boundary_bytes=m.boundary_bytes,
                    boundary_sends=m.boundary_sends,
                    allreduce_calls=m.allreduce_calls,
                    captures=m.captures, buf_elems=thread.pipeline.buf_elems,
                    local_stages=list(thread.pipeline.local_stages))
        return out, meta


def serve_group(torch, res, arrays, counts, models, preset, given, dev,
                n_proc, mark) -> None:
    """The ``serve`` cases of ``SERVE[preset]`` on its (stage S) mesh and
    (data 2, stage S / 2) mesh over the ``n_proc`` processes: arrays
    ``sv_<case>__<name>`` and scalars ``res["serve"][case]``."""
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    sc = SERVE[preset]
    n = sc["model"][3]
    meshes = {dp: multihost_pipeline_mesh(
        n // (2 if dp else 1), 2 if dp else 1,
        local_devices=[dev] * (n // n_proc)) for dp in (False, True)}
    run = ServeRun(torch, models, sc, given, dev, meshes=meshes)
    res["serve"] = {}
    for case in sc.get("cases", SERVE_CASES):
        got, meta = run.case(case, counts)
        res["serve"][case] = meta
        for k, v in got.items():
            arrays[f"sv_{case}__{k}"] = v
        mark(f"serve_{case}")
    del run


# ---------------------------------------------------------------------------
# tensor parallelism across the processes
# ---------------------------------------------------------------------------


#: per preset, the tensor-parallel cases: each runs on a (stage S, model T)
#: mesh from ``multihost_pipeline_mesh(S, tensor_parallel=T)``, one
#: position a process, so each model rank of a stage sits in a process of
#: its own.  ``ring`` (:class:`TpRun`): the model (factory, keyword
#: arguments, cut list, stages; the ring group's BERT and its weights and
#: ids) through ``SpmdPipeline``, ``Defer(mesh=).run`` and ``.stream`` on
#: each of ``wires``, each ring's weight rows kept where ``keep_rows``,
#: reweighted with the seed-1 weights where ``reweight``; ``decode``,
#: ``train`` and ``serve``: :class:`DecodeRun`'s, :class:`TrainRun`'s
#: and :class:`ServeRun`'s presets on that mesh, against the one-process
#: engines of the same extents (``defer`` False: the ring's ``Defer``
#: calls are left to the CPU tests; ``fn``: ``tensor_parallel_fn`` of the
#: whole graph on a (data, model T) mesh, :meth:`TpRun.fn`)
TP = {
    "cpu": {"tp": 2, "ring": ("bert_tiny", {}, None, 2), "wires": WIRES,
            "microbatch": 2, "chunk": 3, "reweight": True, "keep_rows": True,
            "fn": True,
            "decode": {**DECODE["cpu"],
                       "models": {"gpt_tiny": DECODE["cpu"]["models"][
                           "gpt_tiny"]},
                       "meshes": {"tp": ("gpt_tiny", 2, 1, None)},
                       "cases": {"tp": ("greedy", "prefill", "defer_generate",
                                        "defer_prefill", "logits_buffer",
                                        "logits_int8", "score_buffer",
                                        "score_int8")},
                       "keep_rows": False},
            "train": {"models": {"bert_tiny": ("bert_tiny", {}, None, "cls")},
                      "runs": {"tp_buffer": ("bert_tiny", 2, 1, "buffer",
                                             TRAIN_CASES),
                               "tp_int8": ("bert_tiny", 2, 1, "int8",
                                           ("grad", "sgd", "adam",
                                            "accumulate"))},
                      "m": 2, "microbatch": 2, "chunk": 2,
                      "steps": {"bert_tiny": 2},
                      "lr": {"bert_tiny": {"sgd": 5e-2, "adam": 1e-3,
                                           "accumulate": 5e-2}},
                      "keep_all": True},
            "serve": {"model": ("bert_tiny", {}, None, 2),
                      "inputs": ("bert_params", "bert_ids"),
                      "microbatch": 2, "chunk": 3, "frames": 6,
                      "wait_s": 60.0,
                      "cases": ("queue_buffer", "queue_int8", "ep_pair")}},
    # BERT-Base in 2 stages, the cut at block_5 (6 blocks a stage), on 4b's
    # weights and ids (its training stays with the CPU tests: the chip
    # smoke's phase 4t has no seconds for it)
    "card": {"tp": 2, "ring": ("bert_base", {"seq_len": 128}, ("block_5",),
                               2),
             "wires": WIRES, "microbatch": 8, "chunk": 4, "reweight": False,
             "keep_rows": False, "defer": False},
}


class TpRun:
    """The ``tp`` group's ring cases (:data:`TP`) on the given weights and
    ids (:func:`make_inputs`'s ``bert_params`` and ``bert_ids``): the
    workers run them on ``mesh``, a (stage S, model T) mesh across the
    processes; with ``mesh=None`` they run on the one-process ring of the
    same extents (``tensor_parallel=T``), the CPU tests' reference.
    :meth:`ring` runs one wire."""

    def __init__(self, torch, models, tc, given, device, mesh=None):
        from defer_tpu_torch import partition

        self.torch, self.tc, self.device, self.mesh = torch, tc, device, mesh
        self.graph, self.cuts, self.n = _model(models, tc["ring"])
        self.stages = partition(self.graph, self.cuts,
                                num_stages=None if self.cuts else self.n)
        self.params = given["bert_params"]
        self.x = np.asarray(given["bert_ids"], np.float32)
        self.kw = dict(microbatch=tc["microbatch"], chunk=tc["chunk"])

    def _place(self) -> dict:
        return ({"device": self.device, "tensor_parallel": self.tc["tp"]}
                if self.mesh is None else {"mesh": self.mesh})

    def ring(self, wire: str, counts) -> tuple[dict, dict]:
        """One ``SpmdPipeline.run`` on ``wire``, its launches zeroed just
        before and read just after, then (unless the preset's ``defer`` is
        False) ``Defer(mesh=).run`` and ``.stream`` of the same ids and its
        ``health_check``, ``stage_latencies``, and
        ``TIMED_PUSHES`` steady pushes of a chunk, each timed (the ring
        filled by one push first: a chunk is more steps than the stages;
        their median kept); on the buffer
        wire, where the preset says so, the ring reweighted with the
        seed-1 weights and run again."""
        from defer_tpu_torch import Defer, DeferConfig, SpmdPipeline

        torch, dev = self.torch, self.device
        pipe = SpmdPipeline(self.stages, self.params, **self._place(),
                            wire=wire, **self.kw)
        counts.zero()
        rows = pipe.run(self.x)
        _sync(torch, dev)
        m = pipe.metrics
        meta = {"launches": counts.read(), "steps": m.steps,
                "boundary_bytes": m.boundary_bytes,
                "boundary_sends": m.boundary_sends,
                "allreduce_calls": m.allreduce_calls,
                "allreduce_bytes": m.allreduce_bytes,
                "captures": m.captures, "transport": pipe.hop_transport,
                "local_stages": list(pipe.local_stages),
                "ranks": list(pipe.ranks), "buf_elems": pipe.buf_elems,
                "first_process": pipe.first_process,
                "row_numels": [[r.numel() for r in mod.rows]
                               for mod in pipe.modules]}
        arrays = {"rows": rows}
        if self.tc["keep_rows"]:
            for i, k in enumerate(pipe.local_stages):
                for j, r in enumerate(pipe.ranks):
                    # a copy: the reweight below writes the rows in place
                    arrays[f"w{k}_{r}"] = pipe.modules[i].rows[j].to(
                        "cpu", torch.float32, copy=True).numpy()
        if self.tc.get("defer", True):
            place = self._place()
            d = Defer(DeferConfig(
                wire=wire, device=dev,
                tensor_parallel=place.get("tensor_parallel", 1), **self.kw),
                mesh=self.mesh)
            cut = {"cut_points": self.cuts, "num_stages": self.n}
            arrays["defer_run"] = d.run(self.graph, self.params, self.x,
                                        **cut)
            arrays["defer_stream"] = np.stack([
                y.float().cpu().numpy() for y in d.stream(
                    self.graph, self.params, list(self.x), **cut)])
            rep = d.health_check(self.graph, self.params, **cut)
            meta["health"] = {"ok": rep["ok"], "mesh": rep["mesh"],
                              "error": repr(rep["error"])}
        meta["stage_latencies"] = pipe.stage_latencies(iters=2)
        xs = pipe.stage_inputs(self.x[:self.kw["chunk"]])
        pipe.push(xs)
        _sync(torch, dev)
        times, before = [], (m.allreduce_s, m.boundary_s)
        for _ in range(TIMED_PUSHES):
            t0 = time.perf_counter()
            pipe.push(xs)
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
        meta["push_s"] = float(np.median(times))
        meta["push_spread_s"] = max(times) - min(times)
        # a timed push's host seconds inside the all-reduces and inside
        # the hop's sends and receives (their mean over the pushes)
        meta["push_allreduce_s"] = (m.allreduce_s - before[0]) / TIMED_PUSHES
        meta["push_boundary_s"] = (m.boundary_s - before[1]) / TIMED_PUSHES
        if self.tc["reweight"] and wire == "buffer":
            pipe.reweight(self.graph.init(torch.Generator().manual_seed(
                SEED + 1)))
            arrays["reweight_rows"] = pipe.run(self.x)
        return arrays, meta


    def fn(self, n_proc: int) -> tuple[dict, dict]:
        """``shard_tp_params`` and ``tensor_parallel_fn`` of the whole graph
        on the first microbatch of ids: across the processes on a (data,
        model T) mesh of one position a process (each line's psums
        all-reduce over its T processes), or with ``mesh=None`` on the
        one-card ``tensor_parallel_mesh``."""
        from defer_tpu_torch.graph.ir import flatten_tree
        from defer_tpu_torch.parallel import (Mesh, shard_tp_params,
                                              tensor_parallel_fn,
                                              tensor_parallel_mesh)

        t = self.tc["tp"]
        if self.mesh is None:
            mesh = tensor_parallel_mesh(t, devices=[self.device] * t)
        else:
            mesh = Mesh([[self.device] * t] * (n_proc // t),
                        ("data", "model"),
                        processes=np.arange(n_proc).reshape(-1, t))
        shards = shard_tp_params(self.graph, self.params, t, mesh=mesh)
        x = self.torch.from_numpy(self.x[0]).to(self.device,
                                                self.torch.int32)
        with self.torch.inference_mode():
            y = tensor_parallel_fn(self.graph, mesh)(shards, x)
        lead = next(iter(flatten_tree(shards).values()))
        return {"out": y.float().cpu().numpy()}, {
            "shard_ranks": int(lead.shape[0])}


def tp_mesh(tc, n: int, dev, n_proc: int):
    """The (stage ``n``, model T) mesh over the processes, one position a
    process where ``n`` x T is their count."""
    from defer_tpu_torch.parallel import multihost_pipeline_mesh

    t = tc["tp"]
    return multihost_pipeline_mesh(n, tensor_parallel=t,
                                   local_devices=[dev] * (n * t // n_proc))


def tp_group(torch, res, arrays, counts, models, preset, given, dev, n_proc,
             out, mark) -> None:
    """The ``tp`` cases of ``TP[preset]`` on (stage S, model T) meshes over
    the ``n_proc`` processes: scalars ``res["tp"][what][case]`` (``what``:
    ``ring``, ``decode``, ``train``/<run>, ``serve``) and arrays
    ``tp_<what>_<case>__<name>``."""
    tc = TP[preset]
    res["tp"] = {"ring": {}}
    run = TpRun(torch, models, tc, given, dev,
                mesh=tp_mesh(tc, tc["ring"][3], dev, n_proc))
    if tc.get("fn"):
        got, res["tp"]["fn"] = run.fn(n_proc)
        for k, v in got.items():
            arrays[f"tp_fn__{k}"] = v
    for wire in tc["wires"]:
        got, meta = run.ring(wire, counts)
        res["tp"]["ring"][wire] = meta
        for k, v in got.items():
            arrays[f"tp_ring_{wire}__{k}"] = v
        mark(f"tp_ring_{wire}")
    del run
    if "decode" in tc:
        dc = tc["decode"]
        (key, (_, n, _, _)), = dc["meshes"].items()
        drun = DecodeRun(torch, models, dc, given, key, dev,
                         decode_graphs(models, dc),
                         mesh=tp_mesh(tc, n, dev, n_proc))
        res["tp"]["decode"] = {}
        for case in decode_cases(dc, key):
            got, meta = drun.case(case, counts)
            res["tp"]["decode"][case] = meta
            for k, v in got.items():
                arrays[f"tp_decode_{case}__{k}"] = v
        del drun
        mark("tp_decode")
    if "train" in tc:
        tr, built = tc["train"], {}
        res["tp"]["train"] = {}
        for key, (_, n, _, _, cases) in tr["runs"].items():
            trun = TrainRun(torch, models, tr, given, key, dev,
                            mesh=tp_mesh(tc, n, dev, n_proc), out=out,
                            built=built)
            res["tp"]["train"][key] = {}
            for case in cases:
                got, meta = trun.case(case, counts)
                res["tp"]["train"][key][case] = meta
                for k, v in got.items():
                    arrays[f"tp_train_{key}_{case}__{k}"] = v
            del trun
            mark(f"tp_train_{key}")
    if "serve" in tc:
        sc = tc["serve"]
        srun = ServeRun(torch, models, sc, given, dev, meshes={
            False: tp_mesh(tc, sc["model"][3], dev, n_proc)})
        res["tp"]["serve"] = {}
        for case in sc["cases"]:
            got, meta = srun.case(case, counts)
            res["tp"]["serve"][case] = meta
            for k, v in got.items():
                arrays[f"tp_serve_{case}__{k}"] = v
        del srun
        mark("tp_serve")


def worker(args) -> None:
    t0 = time.perf_counter()
    marks: dict = {}

    def mark(what: str) -> None:
        marks[what] = time.perf_counter() - t0

    import torch

    from defer_tpu_torch import models
    from defer_tpu_torch.parallel import distributed as D

    cfg = PRESETS[args.preset]
    cases = [c for c in args.cases.split(",") if c]
    dev = args.device
    torch.set_num_threads(1 if dev == "cpu" else 2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {"worker": args.worker, "procs": args.procs,
                 "device": dev, "preset": args.preset, "cases": cases,
                 "port": args.port, "seconds": marks}
    arrays: dict = {}
    mark("import")
    given = torch.load(Path(args.out) / "inputs.pt", mmap=True,
                       weights_only=True)
    prep = prepare(torch, models, cfg, given) if "ring" in cases else None
    # the training runs of the ring's ResNet in as many stages take its
    # graph's stages, built once
    built: dict = {}
    if prep is not None and "train" in cases:
        tc, spec = TRAIN[args.preset], cfg["resnet"]
        for model, (*same, loss) in tc["models"].items():
            if tuple(same) == spec[:3]:
                built[model, spec[3]] = (prep["resnet"][2], loss)
    mark("prepare")
    if args.go:
        # the host work is done: wait for the caller's go before the
        # group and the device (the parent's deadline bounds the wait)
        while not Path(args.go).exists():
            time.sleep(0.05)
        mark("go")
    if "ring" in cases:
        stages, params = prep["bert"][:2]
        res["nccl_refused"] = nccl_refusal(torch, D, args, stages, params,
                                           cfg["microbatch"])
        mark("nccl_refused")
    D.initialize(f"127.0.0.1:{args.port}", args.procs, args.worker,
                 backend="gloo", timeout_s=args.timeout)
    mark("gloo_group")
    counts = Counts(dev)
    if "ring" in cases:
        ring_group(torch, res, arrays, counts, models, cfg, prep, dev,
                   args.procs, mark)
    if "serve" in cases:
        serve_group(torch, res, arrays, counts, models, args.preset, given,
                    dev, args.procs, mark)
    if "decode" in cases:
        decode_group(torch, res, arrays, counts, models, args.preset, given,
                     dev, args.procs, mark)
    if "train" in cases:
        train_group(torch, res, arrays, counts, models, args.preset, given,
                    dev, args.procs, args.out, mark, built)
    if "tp" in cases:
        tp_group(torch, res, arrays, counts, models, args.preset, given, dev,
                 args.procs, args.out, mark)

    arrays["meta"] = np.array(json.dumps(res))
    np.savez(Path(args.out) / f"worker{args.worker}.npz", **arrays)
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="default: cpu on the CPU, card otherwise")
    ap.add_argument("--cases", default=",".join(CASE_GROUPS),
                    help="the groups of cases, comma-separated: "
                    + ", ".join(CASE_GROUPS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="seconds the parent waits for every worker")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="the process group's timeout, seconds")
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--nccl-port", type=int, default=None)
    ap.add_argument("--go", default=None,
                    help="a path: each worker waits for it to exist after "
                    "its host work, before the group and the device")
    args = ap.parse_args(argv)
    if args.preset is None:
        args.preset = "cpu" if args.device == "cpu" else "card"
    cases = tuple(c for c in args.cases.split(",") if c)
    if set(cases) - set(CASE_GROUPS):
        ap.error(f"--cases: choose from {', '.join(CASE_GROUPS)}")
    sys.path.insert(0, str(ROOT))
    if args.worker is not None:
        worker(args)
        return 0
    t0 = time.perf_counter()
    results = spawn(args.procs, args.device, args.preset, args.out,
                    make_inputs(args.preset, cases), cases=cases,
                    deadline_s=args.deadline, timeout_s=args.timeout)
    w0 = results[0]["meta"]
    print(json.dumps({"procs": args.procs, "device": args.device,
                      "seconds": time.perf_counter() - t0,
                      **{k: v for k, v in w0.items() if k.startswith((
                          "resnet", "bert", "dp", "decode", "train",
                          "serve", "tp"))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
