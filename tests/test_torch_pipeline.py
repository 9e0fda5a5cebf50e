"""Port parity: ``SpmdPipeline``, ``MpmdPipeline`` and ``Defer`` against JAX.

resnet_tiny, the JAX package's weights carried over with
``params_from_jax``, and the same numpy inputs through the JAX
``SpmdPipeline.run`` (on the 8-device CPU mesh) and through the port on
the CPU, for N in {2, 4} stages and two (chunk, microbatch) pairs.

Tolerances, with their reasons:

* ``wire="buffer"``: port == JAX to 1e-5 of max |logit|.  The f32 values
  cross every hop unchanged; only the convolutions' summation order
  differs.
* ``wire="int8"``: each package is held to the reference's own bounds
  against the full-precision forward (``tests/test_quant_wire.py``): max
  error < 0.15, MSE < 1e-3, top-1 equal.  Port against JAX: at most one
  quant step of the output block, max |logit| / 127.  The quantizers are
  bit-equal, but an f32 summation-order difference upstream can move a
  value across a rounding boundary, which shifts it by one quant step of
  its block; a flip at the wrap hop moves a logit by exactly that much,
  and a flip at an earlier hop is damped by the stages after it.
"""

import json

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline, pipeline_mesh
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu_torch import (Defer, DeferConfig, MpmdPipeline, SpmdPipeline,
                             models, params_from_jax, partition)

torch.set_num_threads(1)

CASES = [(n, chunk, mb) for n in (2, 4) for chunk, mb in ((4, 1), (3, 2))]


@pytest.fixture(scope="module")
def tiny():
    jg = jax_models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = models.resnet_tiny()
    return jg, np_params, tg, params_from_jax(tg, np_params)


def _inputs(mb, m=5, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (m, mb, 32, 32, 3)).astype(np.float32)


def _forward(jg, np_params, x):
    fn = jax.jit(jg.apply)
    return np.stack([np.asarray(fn(np_params, xi)) for xi in x])


@pytest.mark.parametrize("wire", ["buffer", "int8"])
@pytest.mark.parametrize("n,chunk,mb", CASES)
def test_spmd_and_defer_run_match_jax(tiny, n, chunk, mb, wire):
    jg, np_params, tg, params = tiny
    x = _inputs(mb)
    jpipe = JaxSpmdPipeline(jax_partition(jg, num_stages=n), np_params,
                            mesh=pipeline_mesh(n), microbatch=mb,
                            chunk=chunk, wire=wire)
    jout = jpipe.run(x)
    pipe = SpmdPipeline(partition(tg, num_stages=n), params, device="cpu",
                        microbatch=mb, chunk=chunk, wire=wire)
    out = pipe.run(x)
    assert out.shape == jout.shape == (5, mb, 10)
    assert pipe.buf_elems == jpipe.buf_elems
    assert pipe.hop_utilization == jpipe.hop_utilization
    for field in ("inferences", "steps", "chunk_calls",
                  "buffer_bytes_per_hop"):
        assert getattr(pipe.metrics, field) == getattr(jpipe.metrics, field)
    assert pipe.metrics.as_dict().keys() == jpipe.metrics.as_dict().keys()
    # the user entry point builds the same engine
    dout = Defer(DeferConfig(device="cpu", microbatch=mb, chunk=chunk,
                             wire=wire)).run(tg, params, x, num_stages=n)
    np.testing.assert_array_equal(dout, out)

    scale = np.abs(jout).max()
    if wire == "buffer":
        assert np.abs(out - jout).max() <= 1e-5 * scale
        return
    ref = _forward(jg, np_params, x)
    for o in (out, jout):
        assert np.abs(o - ref).max() < 0.15
        assert np.square(o - ref).mean() < 1e-3
        assert (o.argmax(-1) == ref.argmax(-1)).all()
    assert np.abs(out - jout).max() <= scale / 127


@pytest.mark.parametrize("wire", ["buffer", "int8"])
def test_bf16_transfer_buffer_matches_jax(tiny, wire):
    """``buffer_dtype=bfloat16``: every hop rounds to bf16 (and, under the
    int8 wire, quantizes bf16).  Port == JAX to one bf16 rounding step of
    max |logit| (2**-8 of it): a summation-order difference can move a
    value across a bf16 rounding boundary."""
    jg, np_params, tg, params = tiny
    x = _inputs(2)
    jout = JaxSpmdPipeline(jax_partition(jg, num_stages=4), np_params,
                           mesh=pipeline_mesh(4), microbatch=2, chunk=3,
                           wire=wire, buffer_dtype=jax.numpy.bfloat16).run(x)
    out = Defer(DeferConfig(device="cpu", microbatch=2, chunk=3, wire=wire,
                            buffer_dtype="bfloat16")).run(
        tg, params, x, num_stages=4)
    assert np.abs(out - jout).max() <= np.abs(jout).max() * 2.0 ** -8
    ref = _forward(jg, np_params, x)
    assert np.abs(out - ref).max() < 0.15
    assert (out.argmax(-1) == ref.argmax(-1)).all()


def test_mpmd_matches_spmd_and_forward(tiny):
    jg, np_params, tg, params = tiny
    x = _inputs(2, m=6, seed=3)
    stages = partition(tg, num_stages=4)
    spmd = SpmdPipeline(stages, params, device="cpu", microbatch=2, chunk=4)
    mpmd = MpmdPipeline(stages, params, device="cpu", microbatch=2)
    s_out, m_out = spmd.run(x), mpmd.run(x)
    ref = _forward(jg, np_params, x)
    assert np.abs(m_out - s_out).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(m_out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert mpmd.metrics.inferences == spmd.metrics.inferences == 12
    assert mpmd.metrics.steps == 6
    dout = Defer(DeferConfig(device="cpu", microbatch=2, mode="mpmd")).run(
        tg, params, x, num_stages=4)
    np.testing.assert_array_equal(dout, m_out)


def test_streaming_contract(tiny):
    """push / flush / raw slabs / staged blocks / stream, as in the
    reference: outputs in feed order, bubbles dropped, counts exact."""
    _, _, tg, params = tiny
    x = _inputs(1, m=7, seed=4)
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        microbatch=1, chunk=3)
    want = pipe.run(x)

    pipe.reset()
    got = pipe.push(x[:3])                 # 3 steps, 4 stages: none out yet
    assert got == []
    slab, mask = pipe.push(pipe.stage_inputs(x[3:6]), raw=True)
    assert mask.tolist() == [True, True, True]
    np.testing.assert_array_equal(slab.numpy(), want[:3])
    staged = pipe.stage_inputs(np.concatenate([x[6:], np.zeros_like(x[:2])]))
    got = pipe.push(staged.numpy(), n_real=1, staged=True)
    got += pipe.flush()
    np.testing.assert_array_equal(torch.stack(got).numpy(), want[3:])
    assert pipe.metrics.inferences == 7 + 7   # run() + the manual pushes

    streamed = list(Defer(DeferConfig(device="cpu", chunk=3)).stream(
        tg, params, iter(x), num_stages=4))
    np.testing.assert_array_equal(torch.stack(streamed).numpy(), want)
    streamed = list(Defer(DeferConfig(device="cpu", mode="mpmd")).stream(
        tg, params, iter(x), num_stages=4))
    assert np.abs(torch.stack(streamed).numpy() - want).max() < 1e-4

    with pytest.raises(ValueError, match="stage-0 input"):
        pipe.push(np.zeros((3, 1, 8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="staged block"):
        pipe.push(np.zeros((3, 1, 5), np.float32), staged=True)
    with pytest.raises(ValueError, match="microbatch"):
        pipe.run(np.zeros((2, 2, 32, 32, 3), np.float32))


def test_tracing_and_registry(tiny, tmp_path):
    """Each push records one span when tracing is on, and the deployment's
    counters and push histogram appear in the process registry."""
    from defer_tpu_torch.obs import REGISTRY, enable_tracing, tracer

    _, _, tg, params = tiny
    stages = partition(tg, num_stages=2)
    pipe = SpmdPipeline(stages, params, device="cpu", chunk=2)
    mpmd = MpmdPipeline(stages, params, device="cpu")
    tr = tracer()
    tr.clear()
    enable_tracing()
    try:
        pipe.run(_inputs(1, m=3))
        mpmd.run(_inputs(1, m=2))
    finally:
        tr.enabled = False
    names = [s["name"] for s in tr.spans]
    assert names.count("spmd.push") == pipe.metrics.chunk_calls == 3
    assert names.count("mpmd.push") == mpmd.metrics.chunk_calls == 1
    tr.export_chrome(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e["ph"] == "X" for e in events) == len(names)
    tr.clear()

    snap = REGISTRY.snapshot()
    p = pipe.metrics.prefix
    assert snap[f"{p}.steps"] == pipe.metrics.steps == 6
    assert snap[f"{p}.inferences"] == 3
    assert snap[f"{p}.push_latency_s"]["count"] == 3
    assert snap[f"{p}.hop1.bytes"] == 6 * pipe.metrics.buffer_bytes_per_hop


def test_health_check_and_warmup(tiny):
    _, _, tg, params = tiny
    d = Defer(DeferConfig(device="cpu", chunk=2, wire="int8"))
    rep = d.health_check(tg, params, num_stages=2)
    assert rep["ok"] and rep["stages"] == 2 and rep["error"] is None
    rep = d.health_check(tg, params, ["conv2d_2"])  # not a single-tensor cut
    assert not rep["ok"] and isinstance(rep["error"], ValueError)
    rep = Defer(DeferConfig(device="cpu", mode="mpmd")).health_check(
        tg, params, num_stages=2)
    assert rep["ok"]


def test_entry_points_default_to_cuda(tiny):
    """No device means the CUDA card: without CUDA the entry points raise
    a clear error instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid here")
    _, _, tg, params = tiny
    stages = partition(tg, num_stages=2)
    for make in (lambda: Defer(), lambda: Defer(DeferConfig(wire="int8")),
                 lambda: SpmdPipeline(stages, params),
                 lambda: MpmdPipeline(stages, params),
                 lambda: Defer(DeferConfig(device="cuda"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_unported_options_raise(tiny):
    """``compute_dtype="float16"`` and a mesh over distinct devices (the
    multi-card ring, ROADMAP A15b) raise; ``data_parallel`` and
    ``tensor_parallel`` run on the one-card mesh: dp equal to the plain
    pipeline, tp within 1e-5 of max |logit| (its head is a row-parallel
    ``Dense``, two partial products summed in another order)."""
    _, _, tg, params = tiny
    stages = partition(tg, num_stages=2)
    x = _inputs(2, m=3)
    want = SpmdPipeline(stages, params, device="cpu", microbatch=2,
                        chunk=2).run(x)
    for kw in (dict(data_parallel=2), dict(tensor_parallel=2)):
        got = SpmdPipeline(stages, params, device="cpu", microbatch=2,
                           chunk=2, **kw).run(x)
        err = np.abs(got - want).max()
        assert err <= (1e-5 * np.abs(want).max() if "tensor_parallel" in kw
                       else 0), (kw, err)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        SpmdPipeline(stages, params, device="cpu", compute_dtype="float16")
    from defer_tpu_torch.parallel import pipeline_mesh as torch_mesh
    with pytest.raises(NotImplementedError, match="A15b"):
        SpmdPipeline(stages, params,
                     mesh=torch_mesh(2, devices=["cuda:0", "cuda:1"]))
    with pytest.raises(ValueError, match="wire"):
        SpmdPipeline(stages, params, device="cpu", wire="zfp")
    with pytest.raises(ValueError, match="mode"):
        Defer(DeferConfig(device="cpu", mode="ring")).build(
            tg, params, num_stages=2)
