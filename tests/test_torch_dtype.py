"""Port parity under ``compute_dtype=bfloat16``, and the flat weight rows.

``resnet_tiny`` and ``bert_tiny`` with the JAX package's weights
(``params_from_jax``) and the same numpy inputs through the JAX
``SpmdPipeline``/``MpmdPipeline`` (8-device CPU mesh) and the port on the
CPU.  Both engines hold bf16 weights in their flat rows, cast each stage's
floating input to bf16 and compute in it; BERT's token ids stay integer,
so its embeddings read the bf16 table and every block runs in bf16.

Tolerances, with their reasons:

* op by op, each op fed the same bf16 input: within 4 bf16 ulps of the
  op's max |output| (measured: every ResNet op bit-equal; BERT's
  embeddings 1 ulp, its blocks 2).  XLA on the CPU keeps a fused chain of
  bf16 elementwise ops in f32 and rounds once, PyTorch rounds after each
  op, and the port's attention is the f32-internal flash path where the
  JAX package's CPU path is its bf16 einsum-softmax.
* pipelines: port against JAX within 2e-2 of max |output|, or within the
  JAX engine's own bf16 error against its f32 run where that is larger.
  ResNet takes the 2e-2 (measured: bit-equal on both wires).  BERT does
  not: those
  op-level differences accumulate over its blocks like any bf16 rounding,
  to 3.3e-2 (buffer) and 4.7e-2 (int8) of max |output|, while JAX's own
  bf16 run is 4.2e-2 and 6.9e-2 off its f32 run; the RMS difference stays
  below 2e-2 (measured 0.9e-2 and 1.4e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline, pipeline_mesh
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.runtime.mpmd import MpmdPipeline as JaxMpmdPipeline
from defer_tpu_torch import (Defer, DeferConfig, MpmdPipeline, SpmdPipeline,
                             models, params_from_jax, partition)
from defer_tpu_torch.graph import ops
from defer_tpu_torch.graph.ir import GraphBuilder, tree_map

torch.set_num_threads(1)

BF16_REL = 2e-2


def _model(name):
    jg = getattr(jax_models, name)()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = getattr(models, name)()
    return jg, np_params, tg, params_from_jax(tg, np_params)


@pytest.fixture(scope="module")
def resnet():
    return _model("resnet_tiny")


@pytest.fixture(scope="module")
def bert():
    return _model("bert_tiny")


def _inputs(name, m, mb, seed=7):
    rng = np.random.default_rng(seed)
    if name == "bert":
        return rng.integers(0, 100, (m, mb, 16)).astype(np.float32)
    return rng.standard_normal((m, mb, 32, 32, 3)).astype(np.float32)


def _bits_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at max |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_bf16_ops_match_jax_node_by_node(request, name):
    """Every node in bf16 on the same bf16 input (the JAX node's input)."""
    jg, np_params, tg, params = request.getfixturevalue(name)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                      np_params)
    tp = tree_map(lambda v: v.to(torch.bfloat16), params)
    x = _inputs(name, 1, 2)[0]
    x = (jnp.asarray(x, jnp.int32) if name == "bert"
         else jnp.asarray(x).astype(jnp.bfloat16))
    cache = {jg.input_name: x}
    for node in jg.topo_order:
        ins = [cache[i] for i in jg.nodes[node].inputs]
        want = jax.jit(jg.nodes[node].op.apply)(jp.get(node), *ins)
        got = tg.nodes[node].op.apply(tp.get(node), *(
            torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v))
            for v in ins))
        assert got.dtype == torch.bfloat16, node
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 4 * _bits_ulp(want), (node, err / _bits_ulp(want))
        cache[node] = jnp.asarray(want).astype(jnp.bfloat16)


@pytest.mark.parametrize("wire", ["buffer", "int8"])
@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_bf16_spmd_matches_jax(request, name, wire):
    jg, np_params, tg, params = request.getfixturevalue(name)
    x = _inputs(name, 5, 2)
    kw = dict(microbatch=2, chunk=3, wire=wire)
    jstages = jax_partition(jg, num_stages=4)
    jout = JaxSpmdPipeline(jstages, np_params, mesh=pipeline_mesh(4),
                           compute_dtype=jnp.bfloat16, **kw).run(x)
    jf32 = JaxSpmdPipeline(jstages, np_params, mesh=pipeline_mesh(4),
                           **kw).run(x)
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        compute_dtype="bfloat16", **kw)
    assert pipe.weight_dtype == torch.bfloat16
    assert all(m.row.dtype == torch.bfloat16 for m in pipe.modules)
    out = pipe.run(x)
    assert out.shape == jout.shape and np.isfinite(out).all()
    scale = np.abs(jout).max()
    bound = max(BF16_REL * scale, np.abs(jout - jf32).max())
    assert np.abs(out - jout).max() <= bound
    assert np.sqrt(np.square(out - jout).mean()) <= BF16_REL * scale
    # the user entry point builds the same engine
    dout = Defer(DeferConfig(device="cpu", compute_dtype="bfloat16",
                             **kw)).run(tg, params, x, num_stages=4)
    np.testing.assert_array_equal(dout, out)


def test_bf16_compute_with_bf16_buffer_matches_jax(resnet):
    """bf16 compute on a bf16 ring (the ResNet50 bf16 deployment's
    layout).  Measured: bit-equal."""
    jg, np_params, tg, params = resnet
    x = _inputs("resnet", 4, 2, seed=3)
    kw = dict(microbatch=2, chunk=2, wire="int8")
    jout = JaxSpmdPipeline(jax_partition(jg, num_stages=4), np_params,
                           mesh=pipeline_mesh(4), compute_dtype=jnp.bfloat16,
                           buffer_dtype=jnp.bfloat16, **kw).run(x)
    out = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                       compute_dtype="bfloat16", buffer_dtype="bfloat16",
                       **kw).run(x)
    assert np.abs(out - jout).max() <= BF16_REL * np.abs(jout).max()


def _jax_row_leaves(jpipe, k):
    """Stage k's leaves cut from the JAX engine's packed row."""
    row = np.asarray(jpipe._w)[k]
    return [row[off:off + size].reshape(shape)
            for off, size, shape, _ in jpipe._wmeta[k]]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_flat_rows_equal_jax_rows(request, name, dtype):
    """Each leaf of each stage's flat row, read back through its view,
    equals the JAX package's packed row leaf by leaf (bit for bit; conv
    kernels after HWIO -> OIHW), in the same leaf order."""
    jg, np_params, tg, params = request.getfixturevalue(name)
    cd = None if dtype == "float32" else dtype
    jpipe = JaxSpmdPipeline(jax_partition(jg, num_stages=4), np_params,
                            mesh=pipeline_mesh(4),
                            compute_dtype=None if cd is None
                            else jnp.bfloat16)
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        compute_dtype=cd)
    for k, module in enumerate(pipe.modules):
        assert module.row.dtype == getattr(torch, dtype)
        jleaves = _jax_row_leaves(jpipe, k)
        jpaths = [tuple(p.key for p in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(
                      jpipe.stages[k].select_params(np_params))[0]]
        assert list(module.paths) == jpaths
        assert len(module.leaves) == len(jleaves) > 0
        for leaf, jleaf in zip(module.leaves, jleaves):
            if leaf.dim() == 4:
                jleaf = jleaf.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                # the view cuDNN reads: OIHW with channels_last strides
                assert leaf.is_contiguous(memory_format=torch.channels_last)
            got = leaf.contiguous()
            got = (got.view(torch.int16) if got.dtype == torch.bfloat16
                   else got).numpy()
            np.testing.assert_array_equal(_bits(np.ascontiguousarray(got)),
                                          _bits(np.ascontiguousarray(jleaf)))
            # every leaf view starts at least 16-byte aligned
            assert leaf.data_ptr() % 16 == 0


def test_int_param_leaf_guard():
    """Integer param leaves must survive the weight row exactly or fail
    loudly, as in the JAX engine (``test_int_param_leaf_guard``)."""
    b = GraphBuilder("toy_embed")
    x = b.input((4,), torch.int32)
    e = b.add(ops.Embedding(vocab=300, features=8), x, name="embed")
    b.add(ops.Dense(4), e, name="head")
    g = b.build()
    params = g.init(torch.Generator().manual_seed(0))
    # graft an int32 leaf that cannot survive a bf16 row (301 rounds)
    steps = torch.tensor([1, 301, 7], dtype=torch.int32)
    params["embed"] = dict(params["embed"], steps=steps)
    stages = partition(g, ["embed"])
    with pytest.raises(ValueError, match="non-float param leaf"):
        SpmdPipeline(stages, params, device="cpu", compute_dtype="bfloat16")
    # exact in the f32 row -> accepted, and read back in its own dtype
    pipe = SpmdPipeline(stages, params, device="cpu")
    got = pipe.modules[0].params()["embed"]["steps"]
    assert got.dtype == torch.int32 and torch.equal(got, steps)
    ids = np.arange(8, dtype=np.float32).reshape(2, 1, 4)
    assert pipe.run(ids).shape == (2, 1, 4, 4)


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_bf16_mpmd_matches_jax_mpmd(request, name):
    """The MPMD oracle keeps f32 weights and casts only a floating input,
    as the JAX package does — so BERT (integer ids in) runs all in f32
    there, while ResNet runs in bf16.  Port against JAX MPMD: within
    2e-2 of max |output| (measured: resnet bit-equal; bert 1.5e-6)."""
    jg, np_params, tg, params = request.getfixturevalue(name)
    x = _inputs(name, 3, 2, seed=5)
    jstages = jax_partition(jg, num_stages=4)
    jout = np.asarray(JaxMpmdPipeline(jstages, np_params, microbatch=2,
                                      compute_dtype=jnp.bfloat16).run(x),
                      np.float32)
    stages = partition(tg, num_stages=4)
    out = MpmdPipeline(stages, params, device="cpu", microbatch=2,
                       compute_dtype="bfloat16").run(x)
    assert np.abs(out - jout).max() <= BF16_REL * np.abs(jout).max()
    f32 = MpmdPipeline(stages, params, device="cpu", microbatch=2).run(x)
    if name == "bert":
        np.testing.assert_array_equal(out, f32)  # ids in: no cast at all
    else:
        assert not np.array_equal(out, f32)


def test_stage_latencies_of_the_deployed_rows(resnet):
    """``stage_latencies`` times each deployed stage (bf16 rows here) on a
    bubble slot, fills the metrics, and counts no kernel launch."""
    from defer_tpu_torch.ops.launches import counted_kernels

    _, _, tg, params = resnet
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        compute_dtype="bfloat16")
    before = [k.snapshot() for k in counted_kernels()]
    lats = pipe.stage_latencies(iters=2)
    assert len(lats) == 4 and all(t > 0 for t in lats)
    assert pipe.metrics.stage_latency_s == lats
    assert [h.count for h in pipe.metrics.stage_hists] == [1, 1, 1, 1]
    assert len(pipe.metrics.duty_cycle) == 4
    assert "stage_latency_percentiles_ms" in pipe.metrics.as_dict()
    assert [k.snapshot() for k in counted_kernels()] == before
