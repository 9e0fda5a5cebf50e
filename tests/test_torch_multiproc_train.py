"""Port parity: pipeline training across ``torch.distributed`` processes.

One spawn of ``scripts/torch_ring_procs.py --cases train`` (four gloo CPU
processes, a deadline of 120 s) runs every training case of
``R.TRAIN["cpu"]``; the tests read its results.  The workers map the
seeded weights, inputs and targets this process builds and hands them
(``R.make_inputs``), so the same values go through:

* ``PipelineTrainer`` across processes: ``resnet_tiny`` in 8 stages on
  (stage 8), two a process, both wires (``loss_and_grad``, 3 SGD and 3
  Adam steps from the same weights, ``accumulate_step`` over the chunk's
  halves, the trained deployment's ``run``, ``trained_params``, a
  checkpoint saved across processes and one saved by a one-process
  trainer); ``gpt_tiny`` (``attn_impl="xla"``) in 4 stages on (stage 4),
  one a process, both wires (``loss_and_grad`` and one Adam step);
  ``resnet_tiny`` in 4 stages on (data 2, stage 4), int8, each line's ring
  on two processes (the gradient sum over the lines);
* the same cases on the port's one-process trainer (``R.TrainRun`` with
  ``mesh=None``, the same extents): losses rtol 1e-6 and each gradient or
  weight leaf within 1e-6 of its max (0 expected where no data-parallel sum
  reorders an addition), the same on every process; one quantizer call a
  process and ring step, as the one process makes (none in the
  recompute); a boundary's bytes a step the forward slot (int8: payload
  and scales) plus the backward gradient slot in f32;
* the JAX ``PipelineTrainer`` on the conftest's CPU mesh, the weights
  carried over with ``params_to_jax``, at ``tests/test_torch_training.py``'s
  bounds: loss rtol 1e-5, gradient leaves within 1e-4 of max |g|, SGD
  weights within 1e-5 of max |w| after 3 steps, Adam losses rtol 1e-4 and
  weights within 2·lr a step; the int8 wire at its ``INT8_*`` bounds
  (losses rtol 1e-3, gradient leaves within 1e-2 of max |g|; its Adam
  weights at Adam's bound, which holds whatever the gradients' size, and
  its one accumulated SGD update at SGD's; its weights after three SGD
  steps are held to the one-process trainer only).
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline
from defer_tpu import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.graph.ir import LayerGraph as JaxLayerGraph
from defer_tpu.graph.ops import TransformerBlock as JaxTransformerBlock
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.runtime.training import PipelineTrainer as JaxTrainer
from defer_tpu_torch import models, params_to_jax
from defer_tpu_torch.graph.ir import flatten_tree, unflatten_tree

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_ring_procs as R  # noqa: E402

torch.set_num_threads(1)

PROCS = 4
TC = R.TRAIN["cpu"]
MB = TC["microbatch"]
RUNS = list(TC["runs"])
#: (run, case) pairs the workers ran
CASES = [(run, case) for run in RUNS for case in TC["runs"][run][4]]
#: the optimizer trajectories
STEPPED = [c for c in CASES if c[1] != "grad"]
#: against the one-process trainer (f32, the same ops on the same rows)
ONE_REL = 1e-6
#: against JAX (tests/test_torch_training.py's bounds)
LOSS_RTOL, GRAD_REL, SGD_REL, ADAM_LOSS_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
INT8_LOSS_RTOL, INT8_GRAD_REL = 1e-3, 1e-2
#: the spawn's deadline (the other multi-process files' too)
DEADLINE_S = 120.0


def _id(c):
    return f"{c[0]}-{c[1]}"


@pytest.fixture(scope="module")
def given():
    return R.make_inputs("cpu", ("train",))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, given):
    out = tmp_path_factory.mktemp("train")
    t0 = time.perf_counter()
    res = R.spawn(PROCS, "cpu", "cpu", out, given, cases=("train",),
                  deadline_s=DEADLINE_S, timeout_s=60.0)
    return out, res, time.perf_counter() - t0


@pytest.fixture(scope="module")
def one(tmp_path_factory, given):
    """Per run and case: the one-process trainer's ``(arrays, meta)``,
    its kernel calls counted as the workers count theirs."""
    out = tmp_path_factory.mktemp("one")
    counts = R.Counts("cpu")
    built: dict = {}
    try:
        refs = {}
        for run in RUNS:
            tr = R.TrainRun(torch, models, TC, given, run, "cpu", out=out,
                            built=built)
            refs[run] = {case: tr.case(case, counts)
                         for case in TC["runs"][run][4]}
    finally:
        counts.close()
    return out, refs


def _arrays(r, run, case, kind):
    """A worker's ``kind`` leaves (``g`` gradients, ``p`` weights) of a
    case, by ``node/path``."""
    pre = f"tr_{run}_{case}__{kind}/"
    return {k[len(pre):]: r[k] for k in r if k.startswith(pre)}


def _close(got: dict, want: dict, rel: float, what: str) -> float:
    """Every leaf of ``got`` within ``rel`` of the leaf's max |want|;
    returns the worst fraction."""
    assert got.keys() == want.keys(), what
    worst = 0.0
    for k in want:
        scale = max(float(np.abs(want[k]).max(initial=0.0)), 1e-12)
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= rel * scale, (what, k, err, scale)
        worst = max(worst, err / scale)
    return worst


def test_spawn_within_its_deadline(spawned):
    _, res, seconds = spawned
    assert len(res) == PROCS and seconds < DEADLINE_S, seconds
    assert [r["meta"]["worker"] for r in res] == list(range(PROCS))


def test_the_workers_inputs_are_this_process_seeded_ones(given):
    """What the spawn hands the workers: each model's seed-0 weights and
    the seeded chunk (images and classes, or ids as inputs and
    targets)."""
    for model in TC["models"]:
        g, _, loss = R.train_graph(models, TC, model)
        p = g.init(torch.Generator().manual_seed(R.SEED))
        mine = given[f"train_{model}_params"]
        for k, v in flatten_tree(p).items():
            assert torch.equal(flatten_tree(mine)[k], v), (model, k)
        xs, ys = given[f"train_{model}_x"], given[f"train_{model}_y"]
        assert xs.shape == (TC["m"], MB) + tuple(g.input_spec.shape)
        assert ys.shape[:2] == (TC["m"], MB)
        if loss == "lm":
            np.testing.assert_array_equal(xs, ys.astype(np.float32))


# ---------------------------------------------------------------------------
# against the one-process trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", RUNS)
def test_loss_and_grad_match_one_process(spawned, one, run):
    """The same loss on every process, the one process's (rtol 1e-6), and
    every stage's gradient leaves within 1e-6 of its max |g| on every
    process (``stage_grads`` gathers each stage from its process)."""
    _, res, _ = spawned
    arrays, meta = one[1][run]["grad"]
    want = {k[2:]: v for k, v in arrays.items() if k.startswith("g/")}
    assert want
    for r in res:
        got = r["meta"]["train"][run]["grad"]
        np.testing.assert_allclose(got["loss"], meta["loss"], rtol=ONE_REL)
        _close(_arrays(r, run, "grad", "g"), want, ONE_REL, run)


@pytest.mark.parametrize("run,case", STEPPED, ids=map(_id, STEPPED))
def test_trajectories_match_one_process(spawned, one, run, case):
    """Optimizer steps from the same weights: the losses, the trained
    weights (``trained_params``, every stage on every process) and their
    digest the same on every process and the one process's.  A
    checkpoint of a one-process trainer loaded across processes
    (``ckpt_in``) takes the one-process Adam trajectory's last step."""
    _, res, _ = spawned
    ref = one[1][run]["adam" if case == "ckpt_in" else case]
    want = {k[2:]: v for k, v in ref[0].items() if k.startswith("p/")}
    losses = ref[1]["losses"][-1:] if case == "ckpt_in" else ref[1]["losses"]
    digests = {r["meta"]["train"][run][case]["digest"] for r in res}
    assert len(digests) == 1
    for r in res:
        got = r["meta"]["train"][run][case]
        np.testing.assert_allclose(got["losses"], losses, rtol=ONE_REL)
        _close(_arrays(r, run, case, "p"), want, ONE_REL, (run, case))


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if "ckpt_in" in TC["runs"][r][4]])
def test_checkpoint_saved_across_processes_loads_into_one_process(
        spawned, one, given, run):
    """Process 0 wrote the one-process layout: the same keys and values
    as the one-process trainer's checkpoint at the same step, and it
    resumes a one-process trainer onto the workers' last Adam step."""
    out, res, _ = spawned
    with np.load(out / f"ckpt_out_{run}.npz") as z, \
            np.load(one[0] / f"ckpt_out_{run}.npz") as w:
        assert sorted(z.files) == sorted(w.files)
        assert any(k.startswith("opt/") for k in z.files)
        _close({k: z[k] for k in z.files}, {k: w[k] for k in w.files},
               ONE_REL, run)
    tr = R.TrainRun(torch, models, TC, given, run, "cpu")
    t = tr.trainer("Adam", tr.lr["adam"])
    t.load_checkpoint(str(out / f"ckpt_out_{run}"))
    loss = t.step(tr.x, tr.y)
    adam = res[0]["meta"]["train"][run]["adam"]
    np.testing.assert_allclose(loss, adam["losses"][-1], rtol=ONE_REL)
    got = R._leaves("p", [t.trained_params()])
    _close({k[2:]: v for k, v in got.items()},
           _arrays(res[0], run, "adam", "p"), ONE_REL, run)


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if "adam" in TC["runs"][r][4]])
def test_trained_deployment_serves(spawned, one, run):
    """After Adam the same deployment serves the trained rows: its run
    equals a fresh pipeline of ``trained_params`` across processes and
    the one-process trained deployment's run."""
    _, res, _ = spawned
    want = one[1][run]["adam"][0]["run_rows"]
    scale = float(np.abs(want).max())
    for r in res:
        got = r[f"tr_{run}_adam__run_rows"]
        np.testing.assert_array_equal(got, r[f"tr_{run}_adam__fresh_rows"])
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= ONE_REL * scale


@pytest.mark.parametrize("run", RUNS)
def test_quantizer_calls_and_boundary_bytes(spawned, one, run):
    """Per process and ring step one quantizer call over its slots (the
    recompute reruns no hop), as the one process makes, none on the
    buffer wire, no flash; one send a step each way per process: the
    forward slot (int8: one byte a value and an f32 scale per 256) and
    the backward gradient slot in f32, the rows of its data line."""
    _, res, _ = spawned
    _, n, dp, wire, _ = TC["runs"][run]
    want = one[1][run]["grad"][1]
    steps = TC["m"] + n - 1
    assert want["ring_steps"] == steps
    assert want["launches"] == {"quant_int8": steps if wire == "int8"
                                else 0, "flash_attention": 0}
    rows = MB // dp
    for r in res:
        meta = r["meta"]["train"][run]["grad"]
        buf = meta["buf_elems"]
        fwd = (rows * (buf + 4 * (buf // 256)) if wire == "int8"
               else rows * buf * 4)
        assert meta["launches"] == want["launches"]
        assert meta["transport"] == "gloo"
        assert meta["boundary_sends"] == 2 * steps
        assert meta["boundary_bytes"] == steps * (fwd + rows * buf * 4)
    for case in TC["runs"][run][4]:
        if case in ("sgd", "adam", "accumulate", "ckpt_in"):
            got = [r["meta"]["train"][run][case]["launches"] for r in res]
            assert got == [one[1][run][case][1]["launches"]] * PROCS, case


@pytest.mark.parametrize("run", RUNS)
def test_each_process_trains_its_block(spawned, run):
    """Host-major: process i holds consecutive stages of consecutive data
    lines; on (data 2, stage 4) data line 0 lies on processes 0 and 1."""
    _, res, _ = spawned
    _, n, dp, _, _ = TC["runs"][run]
    per = n * dp // PROCS
    for i, r in enumerate(res):
        first = (i * per) % n
        assert r["meta"]["train"][run]["grad"]["local_stages"] == list(
            range(first, first + per))


# ---------------------------------------------------------------------------
# against the JAX trainer
# ---------------------------------------------------------------------------


def _jax_xla(g):
    """A JAX graph with every attention block on ``attn_impl="xla"``."""
    import dataclasses
    nodes = {n: dataclasses.replace(node, op=dataclasses.replace(
        node.op, attn_impl="xla"))
        if isinstance(node.op, JaxTransformerBlock) else node
        for n, node in g.nodes.items()}
    return JaxLayerGraph(g.name, nodes, g.input_name, g.output_name,
                         g.input_spec)


def _jce(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _jlm(logits, ids):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    tgt = ids[:, 1:].astype(jnp.int32)
    pick = jnp.take_along_axis(logp[:, :-1], tgt[..., None], -1)[..., 0]
    return -jnp.mean(pick)


class JaxRun:
    """One run's deployment in the JAX package: its trainers share one
    compiled chunk program."""

    def __init__(self, given, run):
        model, n, dp, wire, _ = TC["runs"][run]
        factory, kw, _, loss = TC["models"][model]
        self.graph, _, _ = R.train_graph(models, TC, model)
        jg = getattr(jax_models, factory)(**kw)
        if loss == "lm":
            jg = _jax_xla(jg)
        self.lr = TC["lr"][model]
        self.steps = TC["steps"][model]
        self.x = np.asarray(given[f"train_{model}_x"])
        self.y = np.asarray(given[f"train_{model}_y"])
        self.jloss = _jlm if loss == "lm" else _jce
        self.pipe = JaxSpmdPipeline(
            jax_partition(jg, num_stages=n),
            params_to_jax(self.graph, given[f"train_{model}_params"]),
            mesh=jax_pipeline_mesh(n, dp), microbatch=MB,
            chunk=TC["chunk"], wire=wire)
        self.w0 = self.pipe._w
        self.base = JaxTrainer(self.pipe, self.jloss)

    def trainer(self, opt):
        self.pipe._w = self.w0
        t = JaxTrainer(self.pipe, self.jloss, optimizer=opt)
        t._loss_grad_cache = self.base._loss_grad_cache
        return t

    def grads(self, xs=None, ys=None):
        self.pipe._w = self.w0
        loss, g = self.base.loss_and_grad(
            self.x if xs is None else xs, self.y if ys is None else ys)
        return float(loss), g


@pytest.fixture(scope="module")
def jruns(given):
    return {}


def _jrun(jruns, given, run):
    if run not in jruns:
        jruns[run] = JaxRun(given, run)
    return jruns[run]


def _jax_flat(tree) -> dict:
    return {f"{n}/{k}": np.asarray(v, np.float32)
            for n, sub in tree.items() for k, v in flatten_tree(sub).items()}


def _port_to_jax(graph, flat: dict) -> dict:
    """A worker's ``node/path`` leaves in the JAX layout."""
    tree: dict = {}
    for key, v in flat.items():
        node, path = key.split("/", 1)
        tree.setdefault(node, {})[path] = torch.from_numpy(v)
    return _jax_flat(params_to_jax(graph, {
        n: unflatten_tree(d) for n, d in tree.items()}))


def _bounds(run):
    return ((INT8_LOSS_RTOL, INT8_GRAD_REL) if TC["runs"][run][3] == "int8"
            else (LOSS_RTOL, GRAD_REL))


@pytest.mark.parametrize("run", RUNS)
def test_loss_and_grad_match_jax(spawned, jruns, given, run):
    _, res, _ = spawned
    jr = _jrun(jruns, given, run)
    jl, jg = jr.grads()
    want = _jax_flat({k: v for d in jr.base.stage_grads(jg)
                      for k, v in d.items()})
    loss_rtol, grad_rel = _bounds(run)
    r = res[0]
    np.testing.assert_allclose(r["meta"]["train"][run]["grad"]["loss"], jl,
                               rtol=loss_rtol)
    _close(_port_to_jax(jr.graph, _arrays(r, run, "grad", "g")), want,
           grad_rel, run)


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if "sgd" in TC["runs"][r][4]])
def test_sgd_trajectory_matches_jax(spawned, jruns, given, run):
    """Three SGD steps: the losses, and on the buffer wire the weights.
    On the int8 wire a value that an upstream summation order moves
    across a rounding boundary shifts by a quant step, and three updates
    carry that into the weights beyond SGD's bound (2.4e-2 of a leaf's
    max |w| here; ``tests/test_torch_training.py`` holds no int8
    trajectory's weights to JAX either): the int8 weights are held to the
    one-process trainer's above."""
    _, res, _ = spawned
    jr = _jrun(jruns, given, run)
    t = jr.trainer(optax.sgd(jr.lr["sgd"]))
    jl = [t.step(jr.x, jr.y) for _ in range(jr.steps)]
    jp = _jax_flat(t.trained_params())
    loss_rtol, _ = _bounds(run)
    got = res[0]["meta"]["train"][run]["sgd"]
    np.testing.assert_allclose(got["losses"], jl, rtol=loss_rtol)
    if TC["runs"][run][3] == "buffer":
        _close(_port_to_jax(jr.graph, _arrays(res[0], run, "sgd", "p")), jp,
               SGD_REL, run)


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if "adam" in TC["runs"][r][4]])
def test_adam_trajectory_matches_jax(spawned, jruns, given, run):
    """Adam moves an element by about lr whatever its gradient's size, so
    a near-zero gradient whose sign differs between the packages costs
    2·lr a step: the weights' bound holds on either wire."""
    _, res, _ = spawned
    jr = _jrun(jruns, given, run)
    lr = jr.lr["adam"]
    t = jr.trainer(optax.adam(lr))
    jl = [t.step(jr.x, jr.y) for _ in range(jr.steps)]
    jp = _jax_flat(t.trained_params())
    loss_rtol = max(_bounds(run)[0], ADAM_LOSS_RTOL)
    got = res[0]["meta"]["train"][run]["adam"]
    np.testing.assert_allclose(got["losses"], jl, rtol=loss_rtol)
    flat = _port_to_jax(jr.graph, _arrays(res[0], run, "adam", "p"))
    assert flat.keys() == jp.keys()
    for k in jp:
        err = float(np.abs(flat[k] - jp[k]).max(initial=0.0))
        assert err <= 2 * lr * jr.steps, (run, k, err)


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if "accumulate" in TC["runs"][r][4]])
def test_accumulate_step_matches_jax(spawned, jruns, given, run):
    """One SGD update on the two halves' summed gradients: the summed
    loss and the weights against JAX's two summed chunk gradients."""
    _, res, _ = spawned
    jr = _jrun(jruns, given, run)
    h = jr.x.shape[0] // 2
    jloss, jgrad = 0.0, None
    for xs, ys in ((jr.x[:h], jr.y[:h]), (jr.x[h:], jr.y[h:])):
        loss, g = jr.grads(xs, ys)
        jloss += loss
        jgrad = g if jgrad is None else jgrad + g
    jr.pipe._w = jr.w0 - jr.lr["accumulate"] * jgrad
    want = _jax_flat(jr.base.trained_params())
    jr.pipe._w = jr.w0
    loss_rtol, _ = _bounds(run)
    got = res[0]["meta"]["train"][run]["accumulate"]
    np.testing.assert_allclose(got["losses"][0], jloss, rtol=loss_rtol)
    _close(_port_to_jax(jr.graph, _arrays(res[0], run, "accumulate", "p")),
           want, SGD_REL, run)
