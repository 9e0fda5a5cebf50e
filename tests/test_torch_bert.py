"""Port parity: the BERT path of ``defer_tpu_torch`` against JAX.

Graph structure (``bert_tiny``, ``bert_base``), nested parameters carried
over with ``params_from_jax``, the transformer ops, the ``bert_tiny``
forward, and ``SpmdPipeline`` / ``MpmdPipeline`` / ``Defer.run`` on
``bert_tiny`` in four stages against the JAX package's ``SpmdPipeline``
on the CPU mesh.  Token ids enter the pipelines as float32, as they ride
the transfer buffer.

Tolerances, with their reasons:

* ops and forward: 1e-5 of the output's max magnitude.  Matmuls, means
  and softmax sum in another order than XLA's; attention on the port's
  CPU path is ``flash_attention_plain`` where the JAX package's CPU path
  is its plain einsum-softmax (``attn_impl="auto"`` off the TPU).
* pipelines, as ``tests/test_torch_pipeline.py``: ``wire="buffer"`` to
  1e-5 of max |output|; ``wire="int8"`` each package within the
  reference's bounds of the forward (max error < 0.15, MSE < 1e-3) and
  the port within one quant step of the output block (max |output| /
  127) of JAX — an f32 summation-order difference upstream can move a
  value across a rounding boundary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from defer_tpu import SpmdPipeline as JaxSpmdPipeline, pipeline_mesh
from defer_tpu.graph import analysis as jax_analysis
from defer_tpu.graph import ir as jax_ir
from defer_tpu.graph import ops as jax_ops
import defer_tpu.models as jax_models
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.partition.stage import buffer_footprint as jax_footprint
from defer_tpu_torch import (Defer, DeferConfig, MpmdPipeline, SpmdPipeline,
                             models, params_from_jax, partition)
from defer_tpu_torch.graph import analysis, ir, ops
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.partition import buffer_footprint
from defer_tpu_torch.partition.stage import StageModule

torch.set_num_threads(1)

FWD_RTOL = 1e-5


def _spec(s):
    return (s.shape, str(s.dtype).replace("torch.", ""))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jg = jax_models.bert_tiny()
    np_params = _np(jax.jit(jg.init)(jax.random.key(0)))
    tg = models.bert_tiny()
    return jg, np_params, tg, params_from_jax(tg, np_params)


def _ids(m, mb, seq=16, vocab=100, seed=7):
    return np.random.default_rng(seed).integers(
        0, vocab, (m, mb, seq)).astype(np.int32)


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_graph_structure_equal(size):
    jg = getattr(jax_models, f"bert_{size}")()
    tg = getattr(models, f"bert_{size}")()
    assert (tg.name, tg.topo_order) == (jg.name, jg.topo_order)
    assert tg.topo_order[0] == "embeddings" and tg.output_name == "pooler"
    assert _spec(tg.input_spec) == _spec(jg.input_spec) == (
        (jg.input_spec.shape[0],), "int32")
    for name in jg.topo_order:
        tn, jn = tg.nodes[name], jg.nodes[name]
        assert type(tn.op).__name__ == type(jn.op).__name__, name
        assert tn.inputs == jn.inputs, name
        assert _spec(tn.out_spec) == _spec(jn.out_spec), name
        assert (tree_map(lambda s: s.shape, tn.param_spec)
                == jax.tree.map(lambda s: tuple(s.shape), jn.param_spec)), name
        assert (analysis.node_flops(tg, name)
                == jax_analysis.node_flops(jg, name)), name
    assert analysis.total_flops(tg) == jax_analysis.total_flops(jg)
    assert (analysis.valid_cut_points(tg)
            == jax_analysis.valid_cut_points(jg))


def test_bert_base_12stage_cuts_and_partition():
    tg, jg = models.bert_base(), jax_models.bert_base()
    cuts = models.BERT_BASE_12STAGE_CUTS
    assert cuts == jax_models.BERT_BASE_12STAGE_CUTS
    assert set(cuts) <= set(analysis.valid_cut_points(tg))
    ts, js = partition(tg, cuts), jax_partition(jg, cuts)
    assert len(ts) == 12
    for t, j in zip(ts, js):
        assert (t.node_names, t.input_name, t.output_name) == \
            (j.node_names, j.input_name, j.output_name)
        assert _spec(t.in_spec) == _spec(j.in_spec)
        assert _spec(t.out_spec) == _spec(j.out_spec)
    assert ts[0].node_names == ("embeddings", "block_0")
    assert ts[-1].node_names == ("block_11", "pooler")
    for wire in ("buffer", "int8"):
        assert (buffer_footprint(ts, microbatch=8, wire=wire)
                == jax_footprint(js, microbatch=8, wire=wire))
    # the ring of the BERT-Base main path: one [128, 768] block per slot
    assert buffer_footprint(ts, wire="int8")["buf_elems"] == 128 * 768
    assert (analysis.auto_cut_points(tg, 12)
            == jax_analysis.auto_cut_points(jg, 12))


def test_params_from_jax_nested(tiny):
    jg, np_params, tg, params = tiny
    blk = params["block_1"]
    assert set(blk) == {"ln1", "qkv", "proj", "ln2", "fc1", "fc2"}
    # dense weights cross unchanged, as [d, f] for x @ w
    np.testing.assert_array_equal(blk["qkv"]["w"].numpy(),
                                  np_params["block_1"]["qkv"]["w"])
    assert tuple(blk["qkv"]["w"].shape) == (32, 96)
    np.testing.assert_array_equal(params["embeddings"]["ln"]["scale"].numpy(),
                                  np_params["embeddings"]["ln"]["scale"])
    # a stage module keeps each leaf, by key path, as a frozen view into
    # its one flat row, and hands its stage the nested dict back
    mod = StageModule(partition(tg, num_stages=4)[1], params, "cpu")
    nodes = {path[0] for path in mod.paths}
    assert nodes and all({(n, "qkv", "w"), (n, "ln1", "scale")}
                         <= set(mod.paths) for n in nodes)
    row = mod.row.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == row for v in mod.leaves)
    assert not any(v.requires_grad for v in mod.leaves)
    assert not any(True for _ in mod.parameters())
    tree = mod.params()
    np.testing.assert_array_equal(tree["block_1"]["qkv"]["w"].numpy(),
                                  np_params["block_1"]["qkv"]["w"])

    bad = dict(np_params, block_0=dict(np_params["block_0"]))
    bad["block_0"]["qkv"] = {"w": np_params["block_0"]["qkv"]["w"]}
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(tg, bad)
    bad["block_0"]["qkv"] = {"w": np_params["block_0"]["qkv"]["w"][:, :5],
                             "b": np_params["block_0"]["qkv"]["b"]}
    with pytest.raises(ValueError, match="qkv/w"):
        params_from_jax(tg, bad)


def _one_op_graph(ir_mod, op, shape, dtype):
    b = ir_mod.GraphBuilder("one")
    b.add(op, b.input(shape, dtype))
    return b.build()


@pytest.mark.parametrize("make,shape", [
    (lambda m: m.LayerNorm(), (6, 16)),
    (lambda m: m.LayerNorm(eps=1e-12), (16,)),
    (lambda m: m.Embedding(50, 12), (9,)),
    (lambda m: m.Activation("gelu"), (5, 7)),
    (lambda m: m.TransformerBlock(2, attn_impl="xla"), (12, 32)),
    (lambda m: m.TransformerBlock(2, attn_impl="flash"), (12, 32)),
    (lambda m: m.TransformerBlock(4, norm="post", ln_eps=1e-12,
                                  attn_impl="xla"), (10, 32)),
    (lambda m: m.TransformerBlock(4, norm="post", ln_eps=1e-12,
                                  attn_impl="flash"), (10, 32)),
    (lambda m: m.TransformerBlock(2, mlp_ratio=2), (7, 16)),
], ids=["ln", "ln_eps", "embedding", "gelu_tanh", "pre_xla", "pre_flash",
        "post_xla", "post_flash", "pre_auto_mlp2"])
def test_op_matches_jax(make, shape):
    """Each op on the same inputs and carried-over parameters; every leaf
    is perturbed so LayerNorm scales and biases are not the identity."""
    ids = isinstance(make(jax_ops), jax_ops.Embedding)
    jg = _one_op_graph(jax_ir, make(jax_ops), shape,
                       jnp.int32 if ids else jnp.float32)
    tg = _one_op_graph(ir, make(ops), shape,
                       torch.int32 if ids else torch.float32)
    assert _spec(tg.output_spec) == _spec(jg.output_spec)
    (name,) = jg.topo_order
    assert ((tg.nodes[name].param_spec is None)
            == (jg.nodes[name].param_spec is None))
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        _np(jg.init(jax.random.key(1))))
    if ids:
        x = rng.integers(0, 50, (3,) + shape).astype(np.int32)
    else:
        x = rng.standard_normal((3,) + shape).astype(np.float32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    out = tg.apply(params_from_jax(tg, np_params), torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= FWD_RTOL * np.abs(ref).max()


def test_transformer_block_apply_with_kv_and_bad_options():
    b = ir.GraphBuilder("one")
    b.add(ops.TransformerBlock(2), b.input((6, 16)), name="blk")
    g = b.build()
    p = g.init(torch.Generator().manual_seed(0))["blk"]
    x = torch.randn(2, 6, 16)
    out, k, v = g.nodes["blk"].op.apply_with_kv(p, x)
    assert torch.equal(out, g.apply({"blk": p}, x))
    assert k.shape == v.shape == (2, 6, 16)
    with pytest.raises(ValueError, match="norm"):
        ops.TransformerBlock(2, norm="mid")
    with pytest.raises(ValueError, match="attn_impl"):
        ops.TransformerBlock(2, attn_impl="sdpa").apply(p, x)


def test_tiny_forward_matches_jax(tiny):
    jg, np_params, tg, params = tiny
    x = _ids(1, 3)[0]
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    out = tg.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 32)
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()
    # each stage's function, fed the same boundary tensor, matches
    h = x
    for ts, js in zip(partition(tg, num_stages=4),
                      jax_partition(jg, num_stages=4)):
        ref = np.asarray(js.fn(js.select_params(np_params), h))
        got = ts.fn(ts.select_params(params), torch.tensor(h)).numpy()
        assert np.abs(got - ref).max() <= FWD_RTOL * np.abs(ref).max()
        h = ref


def _forward(jg, np_params, x):
    fn = jax.jit(jg.apply)
    return np.stack([np.asarray(fn(np_params, xi.astype(np.int32)))
                     for xi in x])


@pytest.mark.parametrize("wire", ["buffer", "int8"])
def test_pipelines_match_jax(tiny, wire):
    jg, np_params, tg, params = tiny
    x = _ids(5, 2).astype(np.float32)  # ids ride the f32 buffer exactly
    jpipe = JaxSpmdPipeline(jax_partition(jg, num_stages=4), np_params,
                            mesh=pipeline_mesh(4), microbatch=2, chunk=3,
                            wire=wire)
    jout = jpipe.run(x)
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        microbatch=2, chunk=3, wire=wire)
    out = pipe.run(x)
    assert out.shape == jout.shape == (5, 2, 32)
    assert pipe.buf_elems == jpipe.buf_elems
    assert pipe.hop_utilization == jpipe.hop_utilization
    for field in ("inferences", "steps", "chunk_calls",
                  "buffer_bytes_per_hop"):
        assert getattr(pipe.metrics, field) == getattr(jpipe.metrics, field)
    dout = Defer(DeferConfig(device="cpu", microbatch=2, chunk=3,
                             wire=wire)).run(tg, params, x, num_stages=4)
    np.testing.assert_array_equal(dout, out)

    scale = np.abs(jout).max()
    ref = _forward(jg, np_params, x)
    if wire == "buffer":
        assert np.abs(out - jout).max() <= 1e-5 * scale
        mpmd = MpmdPipeline(partition(tg, num_stages=4), params,
                            device="cpu", microbatch=2).run(x)
        assert np.abs(mpmd - ref).max() <= 1e-5 * np.abs(ref).max()
        return
    for o in (out, jout):
        assert np.abs(o - ref).max() < 0.15
        assert np.square(o - ref).mean() < 1e-3
    assert np.abs(out - jout).max() <= scale / 127
