"""Port parity: ``PipelineTrainer`` against the JAX package's trainer.

The same graph, the JAX weights carried over with ``params_from_jax`` and
the same numpy inputs go through the JAX ``PipelineTrainer`` (on the
8-device CPU mesh, optax ``sgd``/``adam``) and through the port's (on the
CPU, ``torch.optim.SGD``/``Adam``).  The pp scenarios of
``tests/test_training.py`` and ``tests/test_gpt_training.py`` are mirrored.
Each JAX chunk program is compiled once per module fixture and shared by
the trainers of that fixture (they share one deployment).

Tolerances, with their reasons:

* loss: rtol 1e-5 (f32, the same ops; only summation order differs);
* each gradient leaf within 1e-4 of the leaf's max |g| (after
  ``params_to_jax``, which is linear: the HWIO transposes apply to
  gradients);
* SGD weights within 1e-5 of the leaf's max |w| after 3 steps;
* Adam: losses rtol 1e-4, weights within 2·lr per step — Adam moves an
  element by about lr whatever its gradient's size, so a near-zero
  gradient whose sign differs between the packages can cost 2·lr;
* ``wire="int8"`` against JAX: see ``INT8_*`` below;
* bf16 compute (master weights) against JAX: see ``BF16_*`` below.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline, pipeline_mesh
from defer_tpu.graph.ir import LayerGraph as JaxLayerGraph
from defer_tpu.graph.ops import TransformerBlock as JaxTransformerBlock
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.runtime.training import PipelineTrainer as JaxTrainer
from defer_tpu_torch import (Defer, DeferConfig, PipelineTrainer,
                             PipelinedDecoder, SpmdPipeline, models,
                             params_from_jax, params_to_jax, partition)
from defer_tpu_torch.graph import with_attn_impl
from defer_tpu_torch.graph.ir import flatten_tree, tree_map
from defer_tpu_torch.ops import quant
from defer_tpu_torch.ops.quant import quantized_ring_hop, ste_ring_hop

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
SGD_REL = 1e-5
ADAM_LOSS_RTOL = 1e-4
#: int8 wire, port against JAX.  The quantizers are bit-equal, but an f32
#: summation-order difference upstream can move a value across a rounding
#: boundary, which shifts it by one int8 step (1/127 of its block's max).
#: At resnet_tiny's widths one such step moves the loss by well under
#: 1e-3 of it and a gradient leaf by under 1e-2 of its max |g|.
INT8_LOSS_RTOL = 1e-3
INT8_GRAD_REL = 1e-2
#: bf16 compute, port against JAX: each package rounds every op's output
#: to bf16 (8 bits of mantissa, 2**-8 = 0.4%), in its own order of
#: operations, so the two trajectories agree to a few bf16 ulps
BF16_LOSS_RTOL = 2e-2


def _jloss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _loss(logits, labels):
    return F.cross_entropy(logits.float(), labels)


def _jlm_loss(logits, ids):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    tgt = ids[:, 1:].astype(jnp.int32)
    pick = jnp.take_along_axis(logp[:, :-1], tgt[..., None], -1)[..., 0]
    return -jnp.mean(pick)


def _lm_loss(logits, ids):
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           ids[:, 1:].long().flatten())


def _jax_xla(g):
    """A JAX graph with every attention block on ``attn_impl="xla"``."""
    nodes = {n: dataclasses.replace(node, op=dataclasses.replace(
        node.op, attn_impl="xla"))
        if isinstance(node.op, JaxTransformerBlock) else node
        for n, node in g.nodes.items()}
    return JaxLayerGraph(g.name, nodes, g.input_name, g.output_name,
                         g.input_spec)


def _flat(tree) -> dict:
    return {f"{n}/{k}": np.asarray(v, np.float32)
            for n, sub in tree.items() for k, v in flatten_tree(sub).items()}


def _merge(dicts) -> dict:
    out = {}
    for d in dicts:
        out.update(d)
    return out


def _close_rel(got: dict, want: dict, rel: float, what: str):
    """Every leaf of ``got`` within ``rel`` of the leaf's max |want|."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max(initial=0.0)), 1e-12)
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= rel * scale, (what, k, err, scale)


def _close_abs(got: dict, want: dict, atol: float, what: str):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= atol, (what, k, err)


class Pair:
    """One model deployed in both packages at the same cuts and sizes.

    ``jpipe``'s chunk program is compiled by ``jt``; every JAX trainer made
    by :meth:`jax_trainer` shares it (same deployment, same shapes)."""

    def __init__(self, jg, tg, key, num_stages=None, cuts=None,
                 microbatch=1, wire="buffer", jloss=_jloss, loss=_loss,
                 **pipe_kw):
        self.jg, self.tg = jg, tg
        self.np_params = jax.tree.map(np.asarray,
                                      jax.jit(jg.init)(jax.random.key(key)))
        self.params = params_from_jax(tg, self.np_params)
        self.jstages = jax_partition(jg, cuts, num_stages=num_stages)
        self.stages = partition(tg, cuts, num_stages=num_stages)
        n = len(self.stages)
        jkw = dict(pipe_kw)
        if "compute_dtype" in jkw:
            jkw["compute_dtype"] = jnp.dtype(jkw["compute_dtype"])
        self.jpipe = JaxSpmdPipeline(self.jstages, self.np_params,
                                     mesh=pipeline_mesh(n),
                                     microbatch=microbatch, chunk=2,
                                     wire=wire, **jkw)
        self.kw = dict(device="cpu", microbatch=microbatch, chunk=2,
                       wire=wire, **pipe_kw)
        self.jloss, self.loss = jloss, loss
        self.jt = JaxTrainer(self.jpipe, jloss)
        self.w0 = self.jpipe._w

    def jax_trainer(self, opt):
        t = JaxTrainer(self.jpipe, self.jloss, optimizer=opt)
        t._loss_grad_cache = self.jt._loss_grad_cache
        self.jpipe._w = self.w0
        return t

    def jax_steps(self, opt, xs, ys, steps):
        """A JAX trajectory from the initial weights: the losses and the
        trained parameters."""
        t = self.jax_trainer(opt)
        losses = [t.step(xs, ys) for _ in range(steps)]
        params = t.trained_params()
        self.jpipe._w = self.w0
        return losses, params

    def jax_grads(self, xs, ys):
        self.jpipe._w = self.w0
        loss, g = self.jt.loss_and_grad(xs, ys)
        return float(loss), _merge(self.jt.stage_grads(g))

    def pipe(self, **kw):
        return SpmdPipeline(self.stages, self.params, **{**self.kw, **kw})

    def trainer(self, opt=None, **kw):
        return PipelineTrainer(self.pipe(**kw), self.loss, optimizer=opt)


def _grads_jax_layout(pair, trainer, grads):
    return params_to_jax(pair.tg, _merge(trainer.stage_grads(grads)))


def _single_program(tg, params, xs, ys, loss_fn, dtype=torch.int32):
    """Loss and gradients of the summed per-microbatch loss through the
    whole graph (torch autograd), in the JAX layout."""
    p = tree_map(lambda v: v.detach().clone().requires_grad_(
        v.is_floating_point()), params)
    tot = 0.0
    for i in range(xs.shape[0]):
        x = torch.from_numpy(xs[i])
        if not tg.input_spec.dtype.is_floating_point:
            x = x.to(dtype)
        tot = tot + loss_fn(tg.apply(p, x), torch.as_tensor(ys[i]))
    leaves = [(n, k, v) for n, sub in p.items()
              for k, v in flatten_tree(sub).items() if v.requires_grad]
    gs = torch.autograd.grad(tot, [v for _, _, v in leaves])
    out: dict = {}
    for (n, k, _), g in zip(leaves, gs):
        out.setdefault(n, {})[k] = g
    # unflatten the ``/``-joined paths of nested leaves
    from defer_tpu_torch.graph.ir import unflatten_tree
    return float(tot.detach()), params_to_jax(
        tg, {n: unflatten_tree(d) for n, d in out.items()})


def _images(rng, m, mb, size=32):
    return rng.standard_normal((m, mb, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def r4():
    """resnet_tiny in 4 stages at microbatch 2: the gradient check."""
    pair = Pair(jax_models.resnet_tiny(), models.resnet_tiny(), 0,
                num_stages=4, microbatch=2)
    rng = np.random.default_rng(0)
    pair.xs, pair.ys = _images(rng, 3, 2), rng.integers(0, 10, (3, 2))
    pair.jl, pair.jg_ = pair.jax_grads(pair.xs, pair.ys)
    return pair


@pytest.fixture(scope="module")
def r2():
    """resnet_tiny in 2 stages at microbatch 1, chunks of 2 microbatches:
    the optimizer trajectories, accumulation and checkpoints."""
    pair = Pair(jax_models.resnet_tiny(), models.resnet_tiny(), 0,
                num_stages=2)
    rng = np.random.default_rng(1)
    pair.xs, pair.ys = _images(rng, 4, 1), rng.integers(0, 10, (4, 1))
    return pair


# ------------------------------------------------------------- gradients


def test_pipeline_grads_match_jax_and_single_program(r4):
    t = r4.trainer()
    loss, grads = t.loss_and_grad(r4.xs, r4.ys)
    assert [tuple(g.shape) for g in grads] == [tuple(r.shape)
                                               for r in t.rows]
    got = _grads_jax_layout(r4, t, grads)
    np.testing.assert_allclose(float(loss), r4.jl, rtol=LOSS_RTOL)
    _close_rel(got, r4.jg_, GRAD_REL, "port vs JAX trainer")
    ref_l, ref_g = _single_program(r4.tg, r4.params, r4.xs, r4.ys, _loss)
    np.testing.assert_allclose(float(loss), ref_l, rtol=LOSS_RTOL)
    _close_rel(got, ref_g, GRAD_REL, "port vs single program")


def test_loss_fn_only_sees_real_steps(r4):
    """A loss that is not finite on the bubbles' zero padding must not
    poison the chunk: it is called on the M real microbatches only."""
    seen = []

    def loss(logits, y):
        seen.append(y.clone())
        return _loss(logits, y)

    t = PipelineTrainer(r4.pipe(), loss)
    t.loss_and_grad(r4.xs, r4.ys)
    assert len(seen) == 3
    for j, y in enumerate(seen):
        assert torch.equal(y, torch.as_tensor(r4.ys[j]))


def test_schedule_rejects_mismatched_targets(r4):
    t = r4.trainer()
    for xs, ys in ((r4.xs, r4.ys[:2]), (r4.xs[:0], r4.ys[:0])):
        with pytest.raises(ValueError, match="targets"):
            t.loss_and_grad(xs, ys)
    with pytest.raises(ValueError, match="microbatch"):
        t.loss_and_grad(r4.xs[:, :1], r4.ys[:, :1])


# ------------------------------------------------------ optimizer steps


def test_sgd_trajectory_matches_jax(r2):
    xs, ys = r2.xs[:2], r2.ys[:2]
    jl, jp = r2.jax_steps(optax.sgd(0.05), xs, ys, 3)
    t = r2.trainer(lambda rows: torch.optim.SGD(rows, lr=0.05))
    losses = [t.step(xs, ys) for _ in range(3)]
    np.testing.assert_allclose(losses, jl, rtol=LOSS_RTOL)
    _close_rel(params_to_jax(r2.tg, t.trained_params()), jp, SGD_REL,
               "sgd weights")


def test_default_optimizer_is_sgd_1e_2(r2):
    xs, ys = r2.xs[:2], r2.ys[:2]
    jl, jp = r2.jax_steps(optax.sgd(1e-2), xs, ys, 1)
    t = r2.trainer()
    assert isinstance(t.optimizer, torch.optim.SGD)
    assert t.optimizer.param_groups[0]["lr"] == 1e-2
    np.testing.assert_allclose(t.step(xs, ys), jl[0], rtol=LOSS_RTOL)
    _close_rel(params_to_jax(r2.tg, t.trained_params()), jp, SGD_REL,
               "default sgd weights")


def test_adam_loss_falls_and_matches_jax(r2):
    """Overfitting fixed samples with Adam: the tail sits below the start,
    in both packages, on the same trajectory."""
    xs, ys = r2.xs[:2], r2.ys[:2]
    lr, steps = 1e-3, 8
    jl, jp = r2.jax_steps(optax.adam(lr), xs, ys, steps)
    t = r2.trainer(lambda rows: torch.optim.Adam(rows, lr=lr))
    losses = [t.step(xs, ys) for _ in range(steps)]
    assert min(losses[-3:]) < losses[0], losses
    np.testing.assert_allclose(losses, jl, rtol=ADAM_LOSS_RTOL)
    _close_abs(params_to_jax(r2.tg, t.trained_params()), jp,
               2 * lr * steps, "adam weights")


def test_accumulate_step_equals_one_big_chunk(r2):
    """Two chunks then one update == the update on the concatenated chunk
    (the loss sums per microbatch) == JAX's two summed chunk gradients."""
    lr = 1e-2
    sgd = lambda rows: torch.optim.SGD(rows, lr=lr)  # noqa: E731
    halves = [(r2.xs[:2], r2.ys[:2]), (r2.xs[2:], r2.ys[2:])]
    t_acc = r2.trainer(sgd)
    loss_acc = t_acc.accumulate_step(halves)
    t_one = r2.trainer(sgd)
    loss_one = t_one.step(r2.xs, r2.ys)
    np.testing.assert_allclose(loss_acc, loss_one, rtol=LOSS_RTOL)
    for a, b in zip(t_acc.rows, t_one.rows):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    # JAX: the same two chunks' gradients summed, then one sgd update
    jloss, jgrad = 0.0, None
    for xs, ys in halves:
        r2.jpipe._w = r2.w0
        l, g = r2.jt.loss_and_grad(xs, ys)
        jloss += float(l)
        jgrad = g if jgrad is None else jgrad + g
    np.testing.assert_allclose(loss_acc, jloss, rtol=LOSS_RTOL)
    r2.jpipe._w = r2.w0 - lr * jgrad
    want = r2.jt.trained_params()
    r2.jpipe._w = r2.w0
    _close_rel(params_to_jax(r2.tg, t_acc.trained_params()), want, SGD_REL,
               "accumulated sgd weights")
    with pytest.raises(ValueError, match="at least one batch"):
        t_acc.accumulate_step([])


# ------------------------------------------------------- serve and export


def test_trained_weights_serve_inference(r2):
    """After training, the SAME pipeline (the same rows, updated in place)
    serves: its run equals a fresh deployment of ``trained_params`` and the
    whole graph on those weights; ``reweight`` still works on rows that
    require grad."""
    xs, ys = r2.xs[:2], r2.ys[:2]
    t = r2.trainer(lambda rows: torch.optim.SGD(rows, lr=0.05))
    pipe = t.pipe
    before = pipe.run(xs)
    t.step(xs, ys)
    out = pipe.run(xs)
    assert out.shape == (2, 1, 10) and np.isfinite(out).all()
    assert np.abs(out - before).max() > 0  # the rows did change
    trained = t.trained_params()
    fresh = SpmdPipeline(r2.stages, trained, **r2.kw).run(xs)
    np.testing.assert_allclose(out, fresh, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        ref = np.stack([r2.tg.apply(trained, torch.from_numpy(x)).numpy()
                        for x in xs])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    pipe.reweight(r2.params)
    np.testing.assert_allclose(pipe.run(xs), before, rtol=1e-6, atol=1e-6)
    assert all(r.requires_grad for r in t.rows)


def test_trained_params_roundtrip(r2):
    """``trained_params`` is the standard parameter dict: before a step it
    equals the deployed parameters exactly, it is a copy (a later step
    does not move it), and it keeps each leaf's dtype."""
    t = r2.trainer()
    p0 = t.trained_params()
    assert p0.keys() == r2.params.keys()
    want = _flat(r2.params)
    for _ in range(2):  # before the step, and after it: a copy
        got = _flat(p0)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        t.step(r2.xs[:2], r2.ys[:2])
    for n, sub in t.trained_params().items():
        for k, v in flatten_tree(sub).items():
            assert v.dtype == flatten_tree(r2.params[n])[k].dtype
            assert v.is_contiguous()


# ------------------------------------------------------------ checkpoints


def test_checkpoint_resume_matches_uninterrupted(r2, tmp_path):
    """Resumed training walks the uninterrupted trajectory (rows and Adam
    moments restored), which is JAX's."""
    xs, ys = r2.xs[:2], r2.ys[:2]
    adam = lambda rows: torch.optim.Adam(rows, lr=1e-3)  # noqa: E731
    jl, _ = r2.jax_steps(optax.adam(1e-3), xs, ys, 3)
    ref = r2.trainer(adam)
    ref_losses = [ref.step(xs, ys) for _ in range(3)]
    np.testing.assert_allclose(ref_losses, jl, rtol=ADAM_LOSS_RTOL)

    t1 = r2.trainer(adam)
    t1.step(xs, ys)
    t1.step(xs, ys)
    ckpt = str(tmp_path / "train_ckpt")
    t1.save_checkpoint(ckpt)
    t2 = r2.trainer(adam)
    t2.load_checkpoint(ckpt)
    np.testing.assert_allclose(t2.step(xs, ys), ref_losses[2],
                               rtol=LOSS_RTOL)
    for a, b in zip(t2.rows, ref.rows):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_before_first_step_restores(r2, tmp_path):
    """A save before any step holds no optimizer state (torch's Adam makes
    it at the first update) and restores all the same."""
    xs, ys = r2.xs[:2], r2.ys[:2]
    adam = lambda rows: torch.optim.Adam(rows, lr=1e-3)  # noqa: E731
    t = r2.trainer(adam)
    ckpt = str(tmp_path / "fresh")
    t.save_checkpoint(ckpt)
    t2 = r2.trainer(adam)
    t2.load_checkpoint(ckpt)
    loss = t2.step(xs, ys)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, t.step(xs, ys), rtol=LOSS_RTOL)


def test_checkpoint_mismatch_raises(r2, r4, tmp_path):
    ckpt = str(tmp_path / "r4.npz")
    r4.trainer().save_checkpoint(ckpt)
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        r2.trainer().load_checkpoint(ckpt)


# --------------------------------------------------------------- int8 wire


def test_ste_hop_forward_is_the_inference_hop_backward_rolls_back():
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((3, 2, 512)).astype(
        np.float32)).requires_grad_(True)
    out = ste_ring_hop(y, torch.float32)
    with torch.no_grad():
        assert torch.equal(out, quantized_ring_hop(y, torch.float32))
    g = torch.from_numpy(rng.standard_normal((3, 2, 512)).astype(
        np.float32))
    (gy,) = torch.autograd.grad(out, y, g)
    assert torch.equal(gy, torch.roll(g, -1, 0))


@pytest.fixture(scope="module")
def r2_int8():
    pair = Pair(jax_models.resnet_tiny(), models.resnet_tiny(), 0,
                num_stages=2, wire="int8")
    rng = np.random.default_rng(11)
    pair.xs, pair.ys = _images(rng, 2, 1), rng.integers(0, 10, (2, 1))
    pair.jl, pair.jg_ = pair.jax_grads(pair.xs, pair.ys)
    return pair


def test_int8_wire_grads_match_jax(r2_int8, monkeypatch):
    """The straight-through hop against the JAX trainer's custom_vjp; the
    quantizer runs once per step of the chunk (T = M + N - 1), the
    recompute reruns no hop."""
    calls = []
    plain = quant.quantize_int8_blocks

    def counting(x):
        calls.append(tuple(x.shape))
        return plain(x)

    monkeypatch.setattr(quant, "quantize_int8_blocks", counting)
    t = r2_int8.trainer()
    loss, grads = t.loss_and_grad(r2_int8.xs, r2_int8.ys)
    assert len(calls) == 2 + 2 - 1
    np.testing.assert_allclose(float(loss), r2_int8.jl,
                               rtol=INT8_LOSS_RTOL)
    _close_rel(_grads_jax_layout(r2_int8, t, grads), r2_int8.jg_,
               INT8_GRAD_REL, "int8 port vs JAX")


def test_int8_wire_trains_straight_through(r2_int8):
    """The int8 loss tracks the buffer-wire loss within quantization
    error, the gradients point the same way, and Adam lowers the
    quantized deployment's loss (the JAX package's bounds)."""
    p = r2_int8
    tq = p.trainer(lambda rows: torch.optim.Adam(rows, lr=1e-3))
    tb = p.trainer(wire="buffer")
    lq, gq = tq.loss_and_grad(p.xs, p.ys)
    lb, gb = tb.loss_and_grad(p.xs, p.ys)
    assert abs(float(lq) - float(lb)) / abs(float(lb)) < 0.05
    a = torch.cat([g.flatten() for g in gq])
    b = torch.cat([g.flatten() for g in gb])
    cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
    assert cos > 0.98, cos
    losses = [tq.step(p.xs, p.ys) for _ in range(6)]
    assert min(losses[-2:]) < losses[0], losses


# --------------------------------------------------------- master weights


@pytest.fixture(scope="module")
def master():
    pair = Pair(jax_models.resnet_tiny(), models.resnet_tiny(), 0,
                num_stages=2, compute_dtype="bfloat16", master_weights=True)
    rng = np.random.default_rng(12)
    pair.xs, pair.ys = _images(rng, 2, 1), rng.integers(0, 10, (2, 1))
    return pair


def test_master_weights_mixed_precision_training(master):
    """bf16 compute on float32 master rows: the rows stay float32, the
    trajectory follows JAX's, and a fresh master-bf16 deployment serves
    what a plain bf16 one serves (both compute with the same bf16
    weights; it would miss by bf16 rounding if master mode computed in
    float32)."""
    m = master
    lr = 1e-3
    jl, _ = m.jax_steps(optax.sgd(lr), m.xs, m.ys, 3)
    t = m.trainer(lambda rows: torch.optim.SGD(rows, lr=lr))
    assert t.pipe.weight_dtype == torch.float32
    assert all(r.dtype == torch.float32 for r in t.rows)
    losses = [t.step(m.xs, m.ys) for _ in range(3)]
    assert all(r.dtype == torch.float32 for r in t.rows)
    np.testing.assert_allclose(losses, jl, rtol=BF16_LOSS_RTOL)
    f32 = m.trainer(lambda rows: torch.optim.SGD(rows, lr=lr),
                    compute_dtype=None, master_weights=False)
    lf = [f32.step(m.xs, m.ys) for _ in range(3)]
    assert abs(losses[-1] - lf[-1]) / abs(lf[-1]) < 0.05

    out_m = m.pipe().run(m.xs)
    out_bf = m.pipe(master_weights=False).run(m.xs)
    np.testing.assert_allclose(out_m, out_bf, rtol=1e-6, atol=1e-6)


def test_master_weights_through_defer(master):
    """``DeferConfig(master_weights=True)`` builds the master deployment,
    also on a pp x dp and a pp x tp mesh, whose rows equal the plain
    master deployment's."""
    m = master
    cfg = dict(device="cpu", microbatch=1, chunk=2,
               compute_dtype="bfloat16")
    d = Defer(DeferConfig(master_weights=True, **cfg))
    pipe = d.build(m.tg, m.params, num_stages=2)
    assert pipe.master_weights and all(
        mod.row.dtype == torch.float32 for mod in pipe.modules)
    out = d.run(m.tg, m.params, m.xs, num_stages=2)
    want = Defer(DeferConfig(**cfg)).run(m.tg, m.params, m.xs, num_stages=2)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    for kw in (dict(data_parallel=1), dict(tensor_parallel=1)):
        d = Defer(DeferConfig(master_weights=True, **cfg, **kw))
        pipe = d.build(m.tg, m.params, num_stages=2)
        assert pipe.master_weights and all(
            r.dtype == torch.float32 for mod in pipe.modules
            for r in mod.rows)
        assert pipe.mesh.shape == {"data": 1, "stage": 2}


def test_master_weights_on_a_data_and_model_mesh():
    """Master rows on pp x dp (microbatch 2 split in two) and pp x tp
    (bert_tiny's 2 heads over 2 ranks): bf16 compute on float32 rows,
    rows equal to the master deployment without the mesh."""
    g = models.bert_tiny()
    p = g.init(torch.Generator().manual_seed(2))
    ids = np.random.default_rng(5).integers(0, 90, (2, 2, 16)).astype(
        np.float32)
    cfg = dict(device="cpu", microbatch=2, chunk=2,
               compute_dtype="bfloat16", master_weights=True)
    want = Defer(DeferConfig(**cfg)).run(g, p, ids, num_stages=2)
    for kw in (dict(data_parallel=2), dict(tensor_parallel=2)):
        pipe = Defer(DeferConfig(**cfg, **kw)).build(g, p, num_stages=2)
        assert all(r.dtype == torch.float32 for mod in pipe.modules
                   for r in mod.rows)
        out = pipe.run(ids)
        if "data_parallel" in kw:
            np.testing.assert_array_equal(out, want)
        else:
            # bf16 partial products summed by the psums round where the
            # whole products do not (0.4% a rounding), through 4 blocks
            err = float(np.abs(out - want).max())
            assert err <= 5e-2 * float(np.abs(want).max()), err


# ------------------------------------------------- pp x dp and pp x tp


def _jax_unsharded_grads(jpipe, g) -> dict:
    """A JAX pp x tp gradient buffer [N, tp, Pmax] reassembled into the
    graph's parameters (``tp_unshard_params`` per stage; the replicated
    leaves hold the tied sum on every rank)."""
    g = np.asarray(g)
    out = {}
    for k, s in enumerate(jpipe.stages):
        ranks = [jax.tree.unflatten(jpipe._wtreedef[k], [
            g[k, r, off:off + size].reshape(shape)
            for off, size, shape, _ in jpipe._wmeta[k]])
            for r in range(g.shape[1])]
        out.update(s.tp_unshard_params(ranks))
    return out


def test_training_with_data_parallel_matches_jax():
    """pp x dp (``tests/test_training.py::test_training_with_data_
    parallel``): the loss of each dp shard's half of the microbatch,
    averaged over the shards, and its gradients, against the JAX trainer
    on a (data 2, stage 2) mesh and against the whole graph."""
    jg, tg = jax_models.resnet_tiny(), models.resnet_tiny()
    np_params = jax.tree.map(np.asarray,
                             jax.jit(jg.init)(jax.random.key(0)))
    params = params_from_jax(tg, np_params)
    rng = np.random.default_rng(3)
    xs = _images(rng, 2, 2)
    ys = rng.integers(0, 10, (2, 2))
    jpipe = JaxSpmdPipeline(jax_partition(jg, num_stages=2), np_params,
                            mesh=pipeline_mesh(2, data_parallel=2),
                            microbatch=2, chunk=2)
    jt = JaxTrainer(jpipe, _jloss)
    jl, jgrads = jt.loss_and_grad(xs, ys)
    pipe = SpmdPipeline(partition(tg, num_stages=2), params, device="cpu",
                        microbatch=2, chunk=2, data_parallel=2)
    t = PipelineTrainer(pipe, _loss)
    loss, grads = t.loss_and_grad(xs, ys)
    got = params_to_jax(tg, _merge(t.stage_grads(grads)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _close_rel(got, _merge(jt.stage_grads(jgrads)), GRAD_REL,
               "pp x dp port vs JAX")
    # the whole graph, each shard's loss halved: a mean loss keeps its
    # per-sample scale whatever the dp factor
    ref_l, ref_g = _single_program(
        tg, params, xs.reshape(4, 1, 32, 32, 3), ys.reshape(4, 1),
        lambda out, y: _loss(out, y) / 2)
    np.testing.assert_allclose(float(loss), ref_l, rtol=LOSS_RTOL)
    _close_rel(got, ref_g, GRAD_REL, "pp x dp port vs single program")


@pytest.fixture(scope="module")
def bert_tp():
    """bert_tiny (``attn_impl="xla"``) in 2 stages over 2 tensor-parallel
    ranks, microbatch 1 — ``tests/test_training.py``'s tp scenario — and
    the JAX trainer's loss, unsharded gradients and one-SGD-step weights
    on a (stage 2, model 2) mesh."""
    jg = _jax_xla(jax_models.bert_tiny())
    tg = with_attn_impl(models.bert_tiny(), "xla")
    np_params = jax.tree.map(np.asarray,
                             jax.jit(jg.init)(jax.random.key(6)))
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 90, (2, 1, 16)).astype(np.float32)
    ys = rng.integers(0, 2, (2, 1))
    jpipe = JaxSpmdPipeline(jax_partition(jg, num_stages=2), np_params,
                            mesh=pipeline_mesh(2, tensor_parallel=2),
                            microbatch=1, chunk=3)
    jt = JaxTrainer(jpipe, _jloss, optimizer=optax.sgd(0.05))
    jl, jgrads = jt.loss_and_grad(xs, ys)
    jt.step(xs, ys)
    return dict(tg=tg, params=params_from_jax(tg, np_params), xs=xs, ys=ys,
                jl=float(jl), jg=_jax_unsharded_grads(jpipe, jgrads),
                jw=jt.trained_params())


def _tp_trainer(bt, opt=None):
    pipe = SpmdPipeline(partition(bt["tg"], num_stages=2), bt["params"],
                        device="cpu", microbatch=1, chunk=3,
                        tensor_parallel=2)
    return PipelineTrainer(pipe, _loss, optimizer=opt)


def test_training_with_tensor_parallel_matches_jax(bert_tp):
    """pp x tp: the loss, the unsharded gradients (a replicated leaf's
    copies summed) and the weights after one SGD step against the JAX
    trainer, the gradients also against the whole graph."""
    bt = bert_tp
    t = _tp_trainer(bt, lambda rows: torch.optim.SGD(rows, lr=0.05))
    assert len(t.rows) == 4  # 2 stages x 2 ranks
    loss, grads = t.loss_and_grad(bt["xs"], bt["ys"])
    got = params_to_jax(bt["tg"], _merge(t.stage_grads(grads)))
    np.testing.assert_allclose(float(loss), bt["jl"], rtol=LOSS_RTOL)
    _close_rel(got, bt["jg"], GRAD_REL, "pp x tp port vs JAX")
    ref_l, ref_g = _single_program(bt["tg"], bt["params"], bt["xs"],
                                   bt["ys"], _loss)
    np.testing.assert_allclose(float(loss), ref_l, rtol=LOSS_RTOL)
    _close_rel(got, ref_g, GRAD_REL, "pp x tp port vs single program")
    # every rank's copy of a replicated leaf got the same (summed) grad
    for k, mod in enumerate(t.pipe.modules):
        g0, g1 = grads[t._spans[k]]
        for (off, size, _, _), rep in zip(mod.meta, mod.replicated):
            if rep:
                assert torch.equal(g0[off:off + size], g1[off:off + size])
    t.step(bt["xs"], bt["ys"])
    _close_rel(params_to_jax(bt["tg"], t.trained_params()), bt["jw"],
               SGD_REL, "pp x tp weights after one SGD step")


def test_trained_params_roundtrip_tensor_parallel(bert_tp, tmp_path):
    """Under pp x tp ``trained_params`` inverts the sharding exactly
    before training; after a step a fresh UNSHARDED deployment of the
    exported weights serves the trained tp deployment's rows (the JAX
    test's 2e-4), and a checkpoint of the per-rank rows resumes to the
    same next loss."""
    bt = bert_tp
    t = _tp_trainer(bt, lambda rows: torch.optim.Adam(rows, lr=1e-3))
    exported = flatten_tree(t.trained_params())
    for k, v in flatten_tree(bt["params"]).items():
        assert torch.equal(exported[k], v), k
    t.step(bt["xs"], bt["ys"])
    fresh = SpmdPipeline(partition(bt["tg"], num_stages=2),
                         t.trained_params(), device="cpu", microbatch=1,
                         chunk=3)
    np.testing.assert_allclose(fresh.run(bt["xs"]), t.pipe.run(bt["xs"]),
                               rtol=2e-4, atol=2e-4)
    ckpt = str(tmp_path / "tp.npz")
    t.save_checkpoint(ckpt)
    t2 = _tp_trainer(bt, lambda rows: torch.optim.Adam(rows, lr=1e-3))
    t2.load_checkpoint(ckpt)
    np.testing.assert_allclose(t2.step(bt["xs"], bt["ys"]),
                               t.step(bt["xs"], bt["ys"]), rtol=1e-6)


# ------------------------------------------------------------ the families


@pytest.mark.parametrize("family", ["vgg_tiny", "bert_tiny"])
def test_family_grads_match_jax_and_single_program(family):
    """Every model family trains through the pipeline: VGG, and BERT whose
    token ids ride the float32 buffer (its blocks on ``attn_impl="xla"``
    in both packages; the embedding gather's gradient reaches the
    table)."""
    jg, tg = getattr(jax_models, family)(), getattr(models, family)()
    if family == "bert_tiny":
        jg, tg = _jax_xla(jg), with_attn_impl(tg, "xla")
    pair = Pair(jg, tg, 13, num_stages=2)
    rng = np.random.default_rng(14)
    shape = (2, 1) + tuple(pair.jpipe.in_spec.shape)
    if family == "bert_tiny":
        xs = rng.integers(0, 90, shape).astype(np.float32)
    else:
        xs = rng.standard_normal(shape).astype(np.float32)
    ys = rng.integers(0, pair.jpipe.out_spec.shape[-1], (2, 1))
    jl, jgr = pair.jax_grads(xs, ys)
    t = pair.trainer()
    loss, grads = t.loss_and_grad(xs, ys)
    got = _grads_jax_layout(pair, t, grads)
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
    _close_rel(got, jgr, GRAD_REL, f"{family} port vs JAX")
    ref_l, ref_g = _single_program(tg, pair.params, xs, ys, _loss)
    np.testing.assert_allclose(float(loss), ref_l, rtol=LOSS_RTOL)
    _close_rel(got, ref_g, GRAD_REL, f"{family} port vs single program")


def test_flash_attention_gradient_raises_naming_xla():
    """The flash operator has no backward (the JAX kernel has none): a
    gradient through it raises, on the CPU too, and names the way out."""
    tg = models.bert_tiny()
    pipe = SpmdPipeline(partition(tg, num_stages=2),
                        tg.init(torch.Generator().manual_seed(0)),
                        device="cpu")
    t = PipelineTrainer(pipe, _loss)
    xs = np.zeros((1, 1, 16), np.float32)
    with pytest.raises(RuntimeError, match='attn_impl="xla"'):
        t.loss_and_grad(xs, np.zeros((1, 1), np.int64))
    # without grad the operator still serves
    assert np.isfinite(pipe.run(xs)).all()
    # and the xla blocks of the same graph train
    xla = SpmdPipeline(partition(with_attn_impl(tg, "xla"), num_stages=2),
                       tg.init(torch.Generator().manual_seed(0)),
                       device="cpu")
    loss, _ = PipelineTrainer(xla, _loss).loss_and_grad(
        xs, np.zeros((1, 1), np.int64))
    assert np.isfinite(float(loss))


def test_with_attn_impl_keeps_the_graph():
    tg = models.gpt_tiny()
    xla = with_attn_impl(tg, "xla")
    assert xla.name == tg.name and list(xla.nodes) == list(tg.nodes)
    assert {n.op.attn_impl for n in xla.nodes.values()
            if hasattr(n.op, "attn_impl")} == {"xla"}
    assert {n.op.attn_impl for n in tg.nodes.values()
            if hasattr(n.op, "attn_impl")} == {"auto"}
    with pytest.raises(ValueError, match="attn_impl"):
        with_attn_impl(tg, "sdpa")


# ------------------------------------------------------------------- GPT

VOCAB, SEQ = 61, 12


@pytest.fixture(scope="module")
def gpt():
    jg = _jax_xla(jax_models.gpt_tiny(seq_len=SEQ, vocab=VOCAB))
    tg = with_attn_impl(models.gpt_tiny(seq_len=SEQ, vocab=VOCAB), "xla")
    cuts = models.gpt_stage_cuts(4, 4)
    pair = Pair(jg, tg, 1, cuts=cuts, microbatch=2, jloss=_jlm_loss,
                loss=_lm_loss)
    pair.ids = np.random.default_rng(0).integers(0, VOCAB, (6, 2, SEQ))
    return pair


def test_gpt_trains_like_jax_and_deploys_to_decoder(gpt):
    """A causal LM trains through the ring on JAX's trajectory (Adam), and
    its trained weights serve the decoder: greedy next tokens equal the
    trained graph's argmax."""
    lr, steps = 5e-3, 8
    xs = gpt.ids.astype(np.float32)  # ids ride the f32 buffer exactly
    jl, jp = gpt.jax_steps(optax.adam(lr), xs, gpt.ids, steps)
    t = gpt.trainer(lambda rows: torch.optim.Adam(rows, lr=lr))
    losses = [t.step(xs, gpt.ids) for _ in range(steps)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all(), losses
    np.testing.assert_allclose(losses, jl, rtol=ADAM_LOSS_RTOL)
    trained = t.trained_params()
    _close_abs(params_to_jax(gpt.tg, trained), jp, 2 * lr * steps,
               "gpt adam weights")

    dec = PipelinedDecoder(gpt.tg, trained, num_stages=2, microbatch=2,
                           max_len=SEQ, device="cpu")
    toks = dec.generate(gpt.ids[0, :, :4].astype(np.int32),
                        max_new_tokens=4)
    assert toks.shape == (2, 8)
    with torch.no_grad():
        logits = gpt.tg.apply(trained, torch.from_numpy(
            toks[:, :4].astype(np.int32)))
    np.testing.assert_array_equal(toks[:, 4],
                                  logits[:, -1].float().argmax(-1).numpy())
