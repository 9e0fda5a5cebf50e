"""Port parity: tensor parallelism across ``torch.distributed`` processes.

One spawn of ``scripts/torch_ring_procs.py --cases tp`` (four gloo CPU
processes, a deadline of 120 s) runs every case of ``R.TP["cpu"]`` on a
(stage 2, model 2) mesh from ``multihost_pipeline_mesh(2,
tensor_parallel=2)``, one position a process: process 2s + r holds model
rank r of stage s, so each model line's psums all-reduce across two
processes and each rank's ring crosses to the same rank of the other
stage's process.  The tests read its results.  The workers map the
weights and inputs this process hands them: ``bert_tiny``'s JAX weights
carried over with ``params_from_jax`` (the ring, the trainer and the
services), ``gpt_tiny``'s seeded ones and the seeded ids of
``R.make_inputs``.

* Against the port's one-process engines on the one-card mesh of the same
  extents (``mesh=None``, ``tensor_parallel=2``): the ring's rows within
  1e-6 of max |out| (0 expected: two partials summed in either order are
  exact), the same on every process, and each process's weight rows rank
  r's rows of the one-process ``StageModule``; ``Defer.logits``/``score``
  within rtol 1e-5; the decoder's tokens equal; the trainer's losses
  (rtol 1e-6) and every gradient or weight leaf within 1e-6 of its max;
  the services' rows bit-equal.
* Against the JAX package on the conftest's CPU devices
  (``pipeline_mesh(2, 1, 2)``): the buffer ring within 1e-5 of max |out|
  and the int8 ring within one quant step, max |out| / 127
  (``tests/test_torch_pp_tp.py``); the buffer-wire trainer at
  ``tests/test_torch_training.py``'s bounds.
* What crosses: one quantizer call a process and int8 step, flash calls a
  process equal to its stage's blocks (one rank each) a step, a
  boundary's slot a step, and two all-reduces a block a step, each the
  ``[microbatch, seq, hidden]`` f32 activation.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline
from defer_tpu import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.graph.ir import LayerGraph as JaxLayerGraph
from defer_tpu.graph.ops import TransformerBlock as JaxTransformerBlock
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.runtime.training import PipelineTrainer as JaxTrainer
from defer_tpu_torch import models, params_from_jax, params_to_jax
from defer_tpu_torch.graph.ir import flatten_tree, unflatten_tree

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_ring_procs as R  # noqa: E402

torch.set_num_threads(1)

PROCS = 4
TC = R.TP["cpu"]
T = TC["tp"]
MB = TC["microbatch"]
#: the spawn's deadline (the other multi-process files' too)
DEADLINE_S = 120.0
#: against the one-process engines (the same f32 ops on the same rows)
ONE_REL = 1e-6
#: against JAX: tests/test_torch_pp_tp.py's rows, tests/test_torch_training.py's
#: training bounds
JAX_REL = 1e-5
LOSS_RTOL, GRAD_REL, SGD_REL, ADAM_LOSS_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
#: Defer.logits / score against the one-process Defer
SCORE_RTOL = 1e-5
DC = TC["decode"]
DECODE_CASES = list(DC["cases"]["tp"])
TOKENS = [c for c in DECODE_CASES if R.DECODE_CASES[c][0] in ("decoder",
                                                              "defer")]
SCORES = [c for c in DECODE_CASES if c not in TOKENS]
TR = TC["train"]
RUNS = list(TR["runs"])
TRAIN_CASES = [(run, case) for run in RUNS for case in TR["runs"][run][4]]
STEPPED = [c for c in TRAIN_CASES if c[1] != "grad"]
SC = TC["serve"]
SERVES = list(SC["cases"])


def _id(c):
    return f"{c[0]}-{c[1]}"


@pytest.fixture(scope="module")
def bert():
    """``bert_tiny``'s JAX weights (key 0) in both layouts."""
    jg = jax_models.bert_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    return jg, np_params, params_from_jax(models.bert_tiny(), np_params)


@pytest.fixture(scope="module")
def given(bert):
    """The spawn's inputs: the seeded ones, with BERT's weights the JAX
    package's (the ring's, the trainer's and the services')."""
    out = R.make_inputs("cpu", ("tp",))
    out["bert_params"] = bert[2]
    out["train_bert_tiny_params"] = bert[2]
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, given):
    out = tmp_path_factory.mktemp("tp")
    t0 = time.perf_counter()
    res = R.spawn(PROCS, "cpu", "cpu", out, given, cases=("tp",),
                  deadline_s=DEADLINE_S, timeout_s=60.0)
    return out, res, time.perf_counter() - t0


@pytest.fixture(scope="module")
def one(tmp_path_factory, given):
    """The one-process references, their kernel calls counted as the
    workers count theirs: per wire the ring's ``(arrays, meta)`` and its
    ``StageModule``s' rows, the decoder cases', each training run's and
    the services'."""
    out = tmp_path_factory.mktemp("one")
    counts = R.Counts("cpu")
    refs: dict = {"ring": {}, "rows": {}, "train": {}}
    try:
        run = R.TpRun(torch, models, TC, given, "cpu")
        for wire in TC["wires"]:
            refs["ring"][wire] = run.ring(wire, counts)
        from defer_tpu_torch import SpmdPipeline
        pipe = SpmdPipeline(run.stages, run.params, device="cpu",
                            tensor_parallel=T, **run.kw)
        refs["rows"] = {(k, r): row.float().numpy()
                        for k, mod in enumerate(pipe.modules)
                        for r, row in enumerate(mod.rows)}
        refs["tp1_numel"] = [m.row.numel() for m in SpmdPipeline(
            run.stages, run.params, device="cpu", **run.kw).modules]
        drun = R.DecodeRun(torch, models, DC, given, "tp", "cpu",
                           R.decode_graphs(models, DC), tp=T)
        refs["decode"] = {c: drun.case(c, counts) for c in DECODE_CASES}
        built: dict = {}
        for key in RUNS:
            tr = R.TrainRun(torch, models, TR, given, key, "cpu", out=out,
                            built=built, tp=T)
            refs["train"][key] = {case: tr.case(case, counts)
                                  for case in TR["runs"][key][4]}
        srun = R.ServeRun(torch, models, SC, given, "cpu", tp=T)
        refs["serve"] = {c: srun.case(c, counts) for c in SERVES}
    finally:
        counts.close()
    return out, refs


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _blocks(stage: int) -> int:
    g = models.bert_tiny()
    from defer_tpu_torch import partition
    st = partition(g, num_stages=TC["ring"][3])[stage]
    return sum(n.startswith("block_") for n in st.node_names)


def test_spawn_within_its_deadline(spawned):
    _, res, seconds = spawned
    assert len(res) == PROCS and seconds < DEADLINE_S, seconds
    assert [r["meta"]["worker"] for r in res] == list(range(PROCS))


@pytest.mark.parametrize("wire", R.WIRES)
def test_each_process_holds_one_rank_of_one_stage(spawned, wire):
    """Host-major with the model axis innermost: process 2s + r holds
    rank r of stage s, over gloo, eagerly; the leader is process 0."""
    _, res, _ = spawned
    for i, r in enumerate(res):
        m = r["meta"]["tp"]["ring"][wire]
        assert m["local_stages"] == [i // T] and m["ranks"] == [i % T]
        assert (m["transport"], m["captures"], m["first_process"]) == (
            "gloo", 0, 0)


@pytest.mark.parametrize("wire", R.WIRES)
def test_ring_rows_match_one_process(spawned, one, wire):
    """``SpmdPipeline.run``, ``Defer(mesh=).run`` and ``.stream``: the
    one-process ring's rows on every process."""
    _, res, _ = spawned
    want = one[1]["ring"][wire][0]["rows"]
    for r in res:
        for key in ("rows", "defer_run", "defer_stream"):
            got = r[f"tp_ring_{wire}__{key}"]
            assert got.shape == want.shape
            assert _rel(got, want) <= ONE_REL, (wire, key)
        np.testing.assert_array_equal(r[f"tp_ring_{wire}__rows"],
                                      res[0][f"tp_ring_{wire}__rows"])


@pytest.mark.parametrize("wire", R.WIRES)
def test_health_check_across_processes(spawned, wire):
    """``Defer(mesh=).health_check`` builds the tp ring and pushes a bubble
    chunk through it on every process."""
    _, res, _ = spawned
    for r in res:
        h = r["meta"]["tp"]["ring"][wire]["health"]
        assert h["ok"] and h["mesh"] == {"data": 1, "stage": 2, "model": T}, h


@pytest.mark.parametrize("wire", R.WIRES)
def test_ring_rows_match_jax(spawned, bert, given, wire):
    """The JAX ``SpmdPipeline`` on a (stage 2, model 2) mesh of the
    conftest's CPU devices: 1e-5 of max |out|, one quant step on the int8
    wire."""
    _, res, _ = spawned
    jg, np_params, _ = bert
    pipe = JaxSpmdPipeline(jax_partition(jg, num_stages=TC["ring"][3]),
                           np_params, mesh=jax_pipeline_mesh(2, 1, T),
                           microbatch=MB, chunk=TC["chunk"], wire=wire)
    want = np.asarray(pipe.run(np.asarray(given["bert_ids"], np.float32)))
    bound = JAX_REL if wire == "buffer" else 1 / 127
    assert _rel(res[0][f"tp_ring_{wire}__rows"], want) <= bound


def test_each_process_holds_its_ranks_rows(spawned, one):
    """A process holds rank r's row of its stage only: the one-process
    ``StageModule``'s rows[r], shorter than the unsharded stage's."""
    _, res, _ = spawned
    for i, r in enumerate(res):
        k, rank = i // T, i % T
        keys = [key for key in r if key.startswith("tp_ring_buffer__w")]
        assert keys == [f"tp_ring_buffer__w{k}_{rank}"]
        np.testing.assert_array_equal(r[keys[0]], one[1]["rows"][k, rank])
        numels = r["meta"]["tp"]["ring"]["buffer"]["row_numels"]
        assert len(numels) == 1 and len(numels[0]) == 1
        assert numels[0][0] < one[1]["tp1_numel"][k]


def test_tensor_parallel_fn_across_processes(spawned, given):
    """``shard_tp_params`` gives each process its rank's shard and
    ``tensor_parallel_fn`` runs the whole graph with its psums all-reduced
    over the processes of its model line: the one-card
    ``tensor_parallel_mesh``'s output within 1e-6 of max |out|, and the
    unsharded forward's within 2e-4 (``tests/test_torch_pp_tp.py``)."""
    _, res, _ = spawned
    run = R.TpRun(torch, models, TC, given, "cpu")
    want = run.fn(PROCS)[0]["out"]
    with torch.inference_mode():
        full = run.graph.apply(run.params, torch.from_numpy(
            run.x[0]).to(torch.int32)).numpy()
    for r in res:
        assert r["meta"]["tp"]["fn"]["shard_ranks"] == 1
        got = r["tp_fn__out"]
        assert _rel(got, want) <= ONE_REL
        np.testing.assert_allclose(got, full, rtol=2e-4, atol=2e-4)


def test_reweight_and_stage_latencies(spawned, one):
    """The seed-1 weights installed in place: the one-process ring's rows
    after the same reweight; ``stage_latencies`` times each process's
    stage."""
    _, res, _ = spawned
    want = one[1]["ring"]["buffer"][0]["reweight_rows"]
    for r in res:
        assert _rel(r["tp_ring_buffer__reweight_rows"], want) <= ONE_REL
        lats = r["meta"]["tp"]["ring"]["buffer"]["stage_latencies"]
        assert len(lats) == 1 and lats[0] > 0


@pytest.mark.parametrize("wire", R.WIRES)
def test_launches_per_process(spawned, one, wire):
    """A step launches one quantizer call a process on the int8 wire (the
    one process makes one too) and the flash kernel once a block of the
    process's stage, for its one rank (the one process: both ranks)."""
    _, res, _ = spawned
    ref = one[1]["ring"][wire][1]
    steps = ref["steps"]
    assert ref["launches"] == {
        "quant_int8": steps if wire == "int8" else 0,
        "flash_attention": T * (_blocks(0) + _blocks(1)) * steps}
    for i, r in enumerate(res):
        m = r["meta"]["tp"]["ring"][wire]
        assert m["steps"] == steps
        assert m["launches"] == {
            "quant_int8": steps if wire == "int8" else 0,
            "flash_attention": _blocks(i // T) * steps}


@pytest.mark.parametrize("wire", R.WIRES)
def test_boundary_and_allreduce_counts(spawned, wire):
    """A step sends the slot leaving the process once (int8: payload and
    scales) and all-reduces twice a block of its stage, each the
    ``[microbatch, seq, hidden]`` f32 activation; the one process crosses
    nothing."""
    _, res, _ = spawned
    g = models.bert_tiny()
    act = MB * int(np.prod(g.nodes["block_0"].out_spec.shape)) * 4
    for i, r in enumerate(res):
        m = r["meta"]["tp"]["ring"][wire]
        buf, steps = m["buf_elems"], m["steps"]
        slot = (MB * (buf + 4 * (buf // 256)) if wire == "int8"
                else MB * buf * 4)
        assert m["boundary_sends"] == steps
        assert m["boundary_bytes"] == steps * slot
        assert m["allreduce_calls"] == 2 * _blocks(i // T) * steps
        assert m["allreduce_bytes"] == m["allreduce_calls"] * act


def test_one_process_all_reduces_nothing(one):
    for wire in R.WIRES:
        m = one[1]["ring"][wire][1]
        assert (m["allreduce_calls"], m["boundary_bytes"]) == (0, 0)


# ---------------------------------------------------------------------------
# scoring and decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", TOKENS)
def test_tokens_equal_one_process(spawned, one, case):
    """The decoder reads the stage axis only: each block of model ranks
    decodes on its own ring, and every process returns the one-process
    decoder's tokens."""
    _, res, _ = spawned
    want = one[1]["decode"][case][0]["tokens"]
    for r in res:
        np.testing.assert_array_equal(r[f"tp_decode_{case}__tokens"], want)


@pytest.mark.parametrize("case", SCORES)
def test_logits_and_score_match_one_process(spawned, one, case):
    """``Defer(mesh=).logits``/``score`` through the tp ring: the
    one-process ``Defer``'s (``tensor_parallel=2``) within rtol 1e-5 on
    every process, and the tp ring's all-reduces made."""
    _, res, _ = spawned
    arrays, _ = one[1]["decode"][case]
    for r in res:
        for k, want in arrays.items():
            np.testing.assert_allclose(r[f"tp_decode_{case}__{k}"], want,
                                       rtol=SCORE_RTOL, atol=0)
        assert r["meta"]["tp"]["decode"][case]["allreduce_calls"] > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _arrays(r, run, case, kind):
    pre = f"tp_train_{run}_{case}__{kind}/"
    return {k[len(pre):]: r[k] for k in r if k.startswith(pre)}


def _close(got: dict, want: dict, rel: float, what) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        scale = max(float(np.abs(want[k]).max(initial=0.0)), 1e-12)
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= rel * scale, (what, k, err, scale)


def _close_adam(got: dict, want: dict, lr: float, steps: int, what) -> None:
    """Adam's bound: an element moves about lr a step whatever its
    gradient's size, so a near-zero gradient (a key bias's, which the
    softmax cancels) whose sign a summation order flips costs 2·lr a
    step.  Across processes each rank's copy of the activation is its
    own, so the cotangents reach a psum summed in another order than the
    one process sums them."""
    assert got.keys() == want.keys(), what
    for k in want:
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= 2 * lr * steps, (what, k, err)


@pytest.mark.parametrize("run", RUNS)
def test_loss_and_grad_match_one_process(spawned, one, run):
    """The loss enters the backward once over the model line: the
    one-process tp trainer's loss (rtol 1e-6) and unsharded gradients
    (within 1e-6 of each leaf's max |g|), the same on every process."""
    _, res, _ = spawned
    arrays, meta = one[1]["train"][run]["grad"]
    want = {k[2:]: v for k, v in arrays.items() if k.startswith("g/")}
    assert want
    for r in res:
        got = r["meta"]["tp"]["train"][run]["grad"]
        np.testing.assert_allclose(got["loss"], meta["loss"], rtol=ONE_REL)
        _close(_arrays(r, run, "grad", "g"), want, ONE_REL, run)


@pytest.mark.parametrize("run,case", STEPPED, ids=map(_id, STEPPED))
def test_trajectories_match_one_process(spawned, one, run, case):
    """SGD, Adam, accumulation and a checkpoint loaded across processes:
    the losses (rtol 1e-6) and ``trained_params`` of the one-process
    trainer (within 1e-6 of each leaf's max after SGD and accumulation,
    Adam's 2·lr a step after Adam), one digest on every process, and
    every replicated leaf's copies equal across the model ranks (their
    gradients summed over the line)."""
    _, res, _ = spawned
    ref = one[1]["train"][run]["adam" if case == "ckpt_in" else case]
    want = {k[2:]: v for k, v in ref[0].items() if k.startswith("p/")}
    losses = ref[1]["losses"][-1:] if case == "ckpt_in" else ref[1]["losses"]
    metas = [r["meta"]["tp"]["train"][run][case] for r in res]
    assert len({m["digest"] for m in metas}) == 1
    lr = TR["lr"]["bert_tiny"]
    for r, m in zip(res, metas):
        np.testing.assert_allclose(m["losses"], losses, rtol=ONE_REL)
        got = _arrays(r, run, case, "p")
        if case in ("adam", "ckpt_in"):
            _close_adam(got, want, lr["adam"], TR["steps"]["bert_tiny"],
                        (run, case))
        else:
            _close(got, want, ONE_REL, (run, case))
    for k in range(TR["runs"][run][1]):
        copies = [d for m in metas for d in m["tied"].get(str(k), [])]
        assert len(copies) == T and len(set(copies)) == 1, (k, copies)


def test_checkpoint_saved_across_processes_loads_in_one_process(
        spawned, one, given):
    """Process 0 wrote the one-process layout, gathered from every
    rank's process: the one-process checkpoint's keys and values, and a
    one-process trainer resumes from it onto the workers' last Adam
    step."""
    out, res, _ = spawned
    run = "tp_buffer"
    lr, steps = TR["lr"]["bert_tiny"]["adam"], TR["steps"]["bert_tiny"]
    with np.load(out / f"ckpt_out_{run}.npz") as z, \
            np.load(one[0] / f"ckpt_out_{run}.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        assert any(k.startswith("opt/") for k in z.files)
        # the rows after steps - 1 Adam steps, and the optimizer's state
        _close_adam({k: z[k] for k in z.files if k.startswith("w/")},
                    {k: w[k] for k in w.files if k.startswith("w/")}, lr,
                    steps - 1, run)
        _close({k: z[k] for k in z.files if k.startswith("opt/")},
               {k: w[k] for k in w.files if k.startswith("opt/")},
               ONE_REL, run)
    tr = R.TrainRun(torch, models, TR, given, run, "cpu", tp=T)
    t = tr.trainer("Adam", tr.lr["adam"])
    t.load_checkpoint(str(out / f"ckpt_out_{run}"))
    loss = t.step(tr.x, tr.y)
    adam = res[0]["meta"]["tp"]["train"][run]["adam"]
    np.testing.assert_allclose(loss, adam["losses"][-1], rtol=ONE_REL)
    got = R._leaves("p", [t.trained_params()])
    _close_adam({k[2:]: v for k, v in got.items()},
                _arrays(res[0], run, "adam", "p"), lr, steps, run)


@pytest.mark.parametrize("run", RUNS)
def test_training_crossings(spawned, one, run):
    """A ring step of training: one quantizer call a process on the int8
    wire (none in the recompute), the forward slot and the gradient slot
    across each boundary, and the all-reduces of the forward, the
    recompute and the backward (two a block each)."""
    _, res, _ = spawned
    _, n, _, wire, _ = TR["runs"][run]
    steps = TR["m"] + n - 1
    want = one[1]["train"][run]["grad"][1]
    assert want["launches"]["quant_int8"] == (steps if wire == "int8"
                                              else 0)
    for i, r in enumerate(res):
        m = r["meta"]["tp"]["train"][run]["grad"]
        assert m["launches"] == want["launches"]
        assert m["boundary_sends"] == 2 * steps
        assert m["allreduce_calls"] == 3 * 2 * _blocks(i // T) * steps


class JaxTp:
    """The buffer run's deployment in the JAX package, on a (stage 2,
    model 2) mesh: its trainers share one compiled chunk program."""

    def __init__(self, bert, given, run):
        import dataclasses
        jg, np_params, _ = bert
        nodes = {n: dataclasses.replace(node, op=dataclasses.replace(
            node.op, attn_impl="xla"))
            if isinstance(node.op, JaxTransformerBlock) else node
            for n, node in jg.nodes.items()}
        jg = JaxLayerGraph(jg.name, nodes, jg.input_name, jg.output_name,
                           jg.input_spec)
        _, n, _, wire, _ = TR["runs"][run]
        self.graph, _, _ = R.train_graph(models, TR, "bert_tiny")
        self.lr = TR["lr"]["bert_tiny"]
        self.steps = TR["steps"]["bert_tiny"]
        self.x = np.asarray(given["train_bert_tiny_x"])
        self.y = np.asarray(given["train_bert_tiny_y"])
        self.pipe = JaxSpmdPipeline(
            jax_partition(jg, num_stages=n), np_params,
            mesh=jax_pipeline_mesh(n, 1, T), microbatch=MB,
            chunk=TR["chunk"], wire=wire)
        self.w0 = self.pipe._w
        self.base = JaxTrainer(self.pipe, _jce)

    def trainer(self, opt):
        self.pipe._w = self.w0
        t = JaxTrainer(self.pipe, _jce, optimizer=opt)
        t._loss_grad_cache = self.base._loss_grad_cache
        return t

    def unsharded_grads(self) -> dict:
        """The loss and the gradient buffer [N, tp, Pmax] reassembled into
        the graph's parameters (``tp_unshard_params`` per stage)."""
        self.pipe._w = self.w0
        loss, g = self.base.loss_and_grad(self.x, self.y)
        g = np.asarray(g)
        out = {}
        for k, s in enumerate(self.pipe.stages):
            ranks = [jax.tree.unflatten(self.pipe._wtreedef[k], [
                g[k, r, off:off + size].reshape(shape)
                for off, size, shape, _ in self.pipe._wmeta[k]])
                for r in range(g.shape[1])]
            out.update(s.tp_unshard_params(ranks))
        return float(loss), _jax_flat(out)


def _jce(logits, labels):
    import jax.numpy as jnp
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _jax_flat(tree) -> dict:
    return {f"{n}/{k}": np.asarray(v, np.float32)
            for n, sub in tree.items() for k, v in flatten_tree(sub).items()}


def _port_to_jax(graph, flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node, path = key.split("/", 1)
        tree.setdefault(node, {})[path] = torch.from_numpy(v)
    return _jax_flat(params_to_jax(graph, {
        n: unflatten_tree(d) for n, d in tree.items()}))


@pytest.fixture(scope="module")
def jtp(bert, given):
    return JaxTp(bert, given, "tp_buffer")


def test_loss_and_grad_match_jax(spawned, jtp):
    """The buffer run against the JAX trainer on (stage 2, model 2): the
    loss (rtol 1e-5) and the unsharded gradients (1e-4 of max |g|)."""
    _, res, _ = spawned
    jl, want = jtp.unsharded_grads()
    got = res[0]["meta"]["tp"]["train"]["tp_buffer"]["grad"]
    np.testing.assert_allclose(got["loss"], jl, rtol=LOSS_RTOL)
    _close(_port_to_jax(jtp.graph, _arrays(res[0], "tp_buffer", "grad",
                                           "g")), want, GRAD_REL, "grad")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trajectories_match_jax(spawned, jtp, opt):
    """SGD (weights within 1e-5 of max |w|) and Adam (losses rtol 1e-4,
    weights within 2·lr a step) against the JAX trainer's steps."""
    _, res, _ = spawned
    lr = jtp.lr[opt]
    t = jtp.trainer(getattr(optax, opt)(lr))
    jl = [t.step(jtp.x, jtp.y) for _ in range(jtp.steps)]
    jp = _jax_flat(t.trained_params())
    got = res[0]["meta"]["tp"]["train"]["tp_buffer"][opt]
    rtol = LOSS_RTOL if opt == "sgd" else ADAM_LOSS_RTOL
    np.testing.assert_allclose(got["losses"], jl, rtol=rtol)
    flat = _port_to_jax(jtp.graph, _arrays(res[0], "tp_buffer", opt, "p"))
    if opt == "sgd":
        _close(flat, jp, SGD_REL, opt)
        return
    assert flat.keys() == jp.keys()
    for k in jp:
        err = float(np.abs(flat[k] - jp[k]).max(initial=0.0))
        assert err <= 2 * lr * jtp.steps, (k, err)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SERVES)
def test_services_bit_equal_one_process(spawned, one, case):
    """``run_defer`` on both wires and ``serve_endpoint`` with two
    clients: the one-process services' rows, bit for bit, every stream
    ended with ``END_OF_STREAM`` and no thread left behind."""
    _, res, _ = spawned
    arrays, _ = one[1]["serve"][case]
    kind = R.SERVE_CASES[case][0]
    for i, r in enumerate(res):
        m = r["meta"]["tp"]["serve"][case]
        if kind == "queue":
            assert m["end"] and m["healthy"] and not m["threads_left"], m
            np.testing.assert_array_equal(r[f"tp_serve_{case}__rows"],
                                          arrays["rows"])
        else:
            assert not m["alive"] and m["errors"] == [], m
            if i == 0:
                for key in ("a", "b"):
                    np.testing.assert_array_equal(
                        r[f"tp_serve_{case}__{key}"], arrays[key])
        assert m["allreduce_calls"] == 2 * _blocks(i // T) * m["steps"]


def test_the_leaders_counters_only_on_process_0(spawned):
    """The leader (stage 0, model rank 0) alone runs the socket: the
    endpoint's samples count there only; every process takes each
    dispatch of the queue service (one step of the lock-step loop)."""
    _, res, _ = spawned
    for case in SERVES:
        metas = [r["meta"]["tp"]["serve"][case] for r in res]
        if R.SERVE_CASES[case][0] == "queue":
            assert metas[0]["dispatches_registry"] > 0
            assert len({m["dispatches_registry"] for m in metas}) == 1
            assert all(m["samples_in"] == 0 for m in metas)
        else:
            assert metas[0]["samples_in"] == metas[0]["samples_out"] > 0
            assert all(m["samples_in"] == m["samples_out"] == 0
                       for m in metas[1:])
