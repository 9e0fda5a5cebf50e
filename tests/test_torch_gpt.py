"""Port parity: the GPT model family of ``defer_tpu_torch`` against JAX.

The graphs (``gpt_tiny``, GQA, ``gpt_small``, ``gpt2_small``) node for
node; ``CausalTransformerBlock.apply`` on both attention paths (the JAX
flash kernel in Pallas interpret mode); one ``decode`` step with a buffer
cache, an int8 cache and GQA; ``quantize_row`` against the jitted JAX one;
the W8A16 rows (``quantize_leaves``/``unpack_quant_leaves``);
``LayerGraph.with_input_shape``; and the embedding lookups' index rule.
Weights cross with ``params_from_jax``.

Tolerances: 1e-5 of the output's max magnitude for float paths (matmuls,
means and softmax sum in another order than XLA's; the port's CPU flash
path is ``flash_attention_plain``).  Host-side and elementwise integer
results — ``quantize_row`` on the same input, the W8A16 rows and scales,
embedding ids — are bit-equal; int8 cache rows written by a decode step
are within one step (their input is a matmul).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import defer_tpu.models as jax_models
from defer_tpu.graph import analysis as jax_analysis
from defer_tpu.graph import ir as jax_ir
from defer_tpu.graph import ops as jax_ops
from defer_tpu.models.bert import BertEmbedding as JaxBertEmbedding
from defer_tpu.models.gpt import CausalTransformerBlock as JaxCausalBlock
from defer_tpu.models.gpt import GptEmbedding as JaxGptEmbedding
from defer_tpu.runtime import flatbuf as jax_flatbuf
from defer_tpu_torch import models, params_from_jax
from defer_tpu_torch.graph import analysis, ir, ops
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.models.bert import BertEmbedding
from defer_tpu_torch.models.gpt import CausalTransformerBlock, GptEmbedding
from defer_tpu_torch.runtime import flatbuf

torch.set_num_threads(1)

RTOL = 1e-5


def _spec(s):
    return (s.shape, str(s.dtype).replace("torch.", ""))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(jg, key=1):
    """JAX params with every leaf moved off its init value (LayerNorm
    scales and biases not the identity)."""
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        _np(jg.init(jax.random.key(key))))


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("make", [
    lambda m: m.gpt_tiny(seq_len=24),
    lambda m: m.gpt_tiny(seq_len=24, kv_heads=1),
    lambda m: m.gpt_small(seq_len=64),
    lambda m: m.gpt2_small(seq_len=32),
], ids=["tiny", "tiny_gqa", "small", "gpt2_small"])
def test_graph_structure_equal(make):
    jg, tg = make(jax_models), make(models)
    assert (tg.name, tg.topo_order) == (jg.name, jg.topo_order)
    assert _spec(tg.input_spec) == _spec(jg.input_spec)
    for name in jg.topo_order:
        tn, jn = tg.nodes[name], jg.nodes[name]
        assert type(tn.op).__name__ == type(jn.op).__name__, name
        assert tn.inputs == jn.inputs, name
        assert _spec(tn.out_spec) == _spec(jn.out_spec), name
        assert (tree_map(lambda s: s.shape, tn.param_spec)
                == jax.tree.map(lambda s: tuple(s.shape), jn.param_spec)), name
        assert (analysis.node_flops(tg, name)
                == jax_analysis.node_flops(jg, name)), name
    assert (analysis.valid_cut_points(tg)
            == jax_analysis.valid_cut_points(jg))
    for nl, ns in ((12, 12), (12, 4), (4, 3), (4, 1)):
        assert (models.gpt_stage_cuts(nl, ns)
                == jax_models.gpt_stage_cuts(nl, ns))
    with pytest.raises(ValueError, match="stages"):
        models.gpt_stage_cuts(4, 5)


def test_gpt2_small_geometry_and_gqa_params():
    g = models.gpt2_small(seq_len=256)
    blocks = [n for n in g.topo_order if n.startswith("block_")]
    assert len(blocks) == 12 and g.nodes["block_0"].op.ln_eps == 1e-5
    assert g.nodes["final_ln"].op.eps == 1e-5
    assert g.nodes["lm_head"].out_spec.shape == (256, 50257)
    # GQA narrows qkv to d + 2*kv*hd columns, in the port as in JAX
    blk = CausalTransformerBlock(4, num_kv_heads=2)
    p = blk.init(torch.Generator().manual_seed(0), (ir.ShapeSpec((6, 32)),))
    assert tuple(p["qkv"]["w"].shape) == (32, 32 + 2 * 2 * 8)
    assert tuple(p["qkv"]["b"].shape) == (32 + 2 * 2 * 8,)
    with pytest.raises(ValueError, match="divisible"):
        CausalTransformerBlock(4, num_kv_heads=3).init(
            None, (ir.ShapeSpec((6, 32)),))


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_params_from_jax_carries_gpt(kv_heads):
    jg = jax_models.gpt_tiny(seq_len=24, kv_heads=kv_heads)
    tg = models.gpt_tiny(seq_len=24, kv_heads=kv_heads)
    np_params = _np(jg.init(jax.random.key(3)))
    params = params_from_jax(tg, np_params)
    for path in (("embeddings", "wte"), ("embeddings", "wpe"),
                 ("block_2", "qkv", "w"), ("block_2", "qkv", "b"),
                 ("lm_head", "w")):
        got, want = params, np_params
        for k in path:
            got, want = got[k], want[k]
        np.testing.assert_array_equal(got.numpy(), want)
    cols = 32 + 2 * (kv_heads or 2) * 16
    assert tuple(params["block_0"]["qkv"]["w"].shape) == (32, cols)
    ids = np.random.default_rng(0).integers(0, 97, (2, 24)).astype(np.int32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, ids))
    _close(tg.apply(params, torch.from_numpy(ids)), ref)


def _block_graph(mod, op, t=12, d=32):
    b = mod.GraphBuilder("one")
    b.add(op, b.input((t, d)), name="blk")
    return b.build()


@pytest.mark.parametrize("heads,kv", [(2, None), (4, 2), (4, 1)])
@pytest.mark.parametrize("jax_impl,port_impl", [
    ("xla", "xla"), ("flash", "flash"), ("xla", "auto")])
def test_causal_block_apply_matches_jax(heads, kv, jax_impl, port_impl):
    """The full-sequence causal forward, on both attention paths: JAX's
    Pallas kernel in interpret mode (``flash``) or its masked einsum, and
    the port's plain flash version or its masked einsum."""
    jg = _block_graph(jax_ir, JaxCausalBlock(
        heads, num_kv_heads=kv, attn_impl=jax_impl))
    tg = _block_graph(ir, CausalTransformerBlock(
        heads, num_kv_heads=kv, attn_impl=port_impl))
    np_params = _perturbed(jg)
    x = np.random.default_rng(1).standard_normal((3, 12, 32)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    _close(tg.apply(params_from_jax(tg, np_params), torch.from_numpy(x)), ref)
    # the future never leaks: changing the last position leaves the others
    x2 = x.copy()
    x2[:, -1] += 1.0
    a = tg.apply(params_from_jax(tg, np_params), torch.from_numpy(x))
    b = tg.apply(params_from_jax(tg, np_params), torch.from_numpy(x2))
    assert torch.equal(a[:, :-1], b[:, :-1])


def test_apply_with_kv_matches_jax():
    jop = JaxCausalBlock(4, num_kv_heads=2, attn_impl="xla")
    top = CausalTransformerBlock(4, num_kv_heads=2)
    jg, tg = _block_graph(jax_ir, jop), _block_graph(ir, top)
    np_params = _perturbed(jg)
    x = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    want = jax.jit(jop.apply_with_kv)(np_params["blk"], x)
    got = top.apply_with_kv(params_from_jax(tg, np_params)["blk"],
                            torch.from_numpy(x))
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    assert tuple(got[1].shape) == (2, 12, 2 * 8)


def _decode_case(heads, kv, int8, steps=5, seed=0):
    """Both packages' block on the same params, run `steps` decode steps
    from the same (random) caches; returns the per-step outputs and the
    final caches of each."""
    jop = JaxCausalBlock(heads, num_kv_heads=kv)
    top = CausalTransformerBlock(heads, num_kv_heads=kv)
    jg = _block_graph(jax_ir, jop)
    np_params = _perturbed(jg)["blk"]
    tp = params_from_jax(_block_graph(ir, top), {"blk": np_params})["blk"]
    rng = np.random.default_rng(seed)
    b, d, length = 3, 32, 9
    kvh, hd = kv or heads, d // heads
    xs = rng.standard_normal((steps, b, d)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, (b, kvh, length, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, kvh, length, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (b, kvh, length)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (b, kvh, length)).astype(np.float32)
        jstate, tstate = [kc, vc, ks, vs], [torch.from_numpy(a.copy())
                                            for a in (kc, vc, ks, vs)]
    else:
        kc = rng.standard_normal((b, kvh, length, hd)).astype(np.float32)
        vc = rng.standard_normal((b, kvh, length, hd)).astype(np.float32)
        jstate, tstate = [kc, vc], [torch.from_numpy(a.copy())
                                    for a in (kc, vc)]
    step = jax.jit(lambda p, x, c, pos: jop.decode(p, x, *c[:2], pos,
                                                   *c[2:]))
    outs = []
    for i in range(steps):
        pos = 2 + i
        jy, *jstate = step(np_params, xs[i], jstate, pos)
        ty, *tstate = top.decode(tp, torch.from_numpy(xs[i]), *tstate[:2],
                                 pos, *tstate[2:])
        outs.append((ty, jy))
    return outs, jstate, tstate


@pytest.mark.parametrize("heads,kv,int8", [
    (2, None, False), (4, 2, False), (4, 1, True), (2, None, True)],
    ids=["mha", "gqa", "mqa_int8", "mha_int8"])
def test_decode_step_matches_jax(heads, kv, int8):
    """Five decode steps from random caches (positions 2..6; rows past the
    position are garbage the mask must hide): outputs and float caches
    within 1e-5; int8 rows within one step and their scales within 1e-5
    (the K/V projections may differ in the last bit)."""
    outs, jstate, tstate = _decode_case(heads, kv, int8)
    for ty, jy in outs:
        _close(ty, jy)
    for t_, j_ in zip(tstate, jstate):
        j_ = np.asarray(j_)
        if int8:
            # one f32 rounding upstream may move a value across a
            # rounding boundary: allow one int8 step, and 1e-5 on scales
            diff = np.abs(t_.numpy().astype(np.float64) - j_)
            assert diff.max() <= (1 if j_.dtype == np.int8 else
                                  RTOL * np.abs(j_).max())
        else:
            _close(t_, j_)


def test_decode_equals_full_sequence_apply():
    """The one-token steps from an empty cache reproduce the causal
    full-sequence forward position by position (port only)."""
    top = CausalTransformerBlock(2)
    p = top.init(torch.Generator().manual_seed(0), (ir.ShapeSpec((6, 32)),))
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(1))
    full = top.apply(p, x)
    kc, vc = torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 16)
    for t in range(6):
        y, kc, vc = top.decode(p, x[:, t], kc, vc, torch.tensor(t))
        assert (y - full[:, t]).abs().max() <= 2e-5 * full.abs().max()


def test_quantize_row_bit_equal_to_jitted_jax():
    """The compiled JAX reference multiplies by f32(1/127) (ROADMAP C):
    the port is bit-equal to ``jax.jit(quantize_row)``, ties and zero rows
    included."""
    rng = np.random.default_rng(0)
    row = (rng.standard_normal((3, 2, 7, 16))
           * np.exp(3 * rng.standard_normal((3, 2, 7, 1)))).astype(np.float32)
    row[0, 0, 0] = 0.0
    row[0, 0, 1] = np.arange(-7.5, 8.5, 1.0) * (127 / 7.5)  # exact ties
    jq, js = jax.jit(JaxCausalBlock.quantize_row)(row)
    tq, ts = CausalTransformerBlock.quantize_row(torch.from_numpy(row))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (3, 2, 7)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


def test_quantize_leaves_bit_equal_and_unpack():
    """W8A16 rows: each leaf's int8 values at the port's aligned offset
    equal the JAX row's values for that leaf; the scale rows are equal
    bit for bit; 0-, 1- and 2-D leaves; dequantization equals JAX's."""
    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal(()).astype(np.float32),
              rng.standard_normal((5,)).astype(np.float32),
              np.zeros((3,), np.float32),
              (rng.standard_normal((7, 70)) * 3).astype(np.float32),
              rng.standard_normal((2, 3, 4)).astype(np.float32)]
    tleaves = [torch.from_numpy(a) for a in leaves]
    meta = flatbuf.leaf_meta(tleaves)
    q_row, s_row, smeta = flatbuf.quantize_leaves(tleaves, meta)
    jq, js, jsmeta = jax_flatbuf.quantize_leaves(leaves)
    jmeta = jax_flatbuf.leaf_meta(leaves)
    assert q_row.dtype == torch.int8 and smeta == jsmeta
    np.testing.assert_array_equal(s_row.numpy().view(np.int32),
                                  js.view(np.int32))
    for (off, n, _, _), (joff, jn, _, _) in zip(meta, jmeta):
        assert off % flatbuf.ALIGN == 0
        np.testing.assert_array_equal(q_row[off:off + n].numpy(),
                                      jq[joff:joff + jn])
    treedef = jax.tree.structure(list(range(len(leaves))))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = flatbuf.unpack_quant_leaves(q_row, s_row, meta, smeta, dtype)
        want = jax.jit(lambda q, s: jax_flatbuf.unpack_quant_leaves(
            q, s, jmeta, jsmeta, treedef, jdt))(jq, js)
        for g_, w_ in zip(got, want):
            assert g_.dtype == dtype
            np.testing.assert_array_equal(g_.float().numpy(),
                                          np.asarray(w_, np.float32))


@pytest.mark.parametrize("make,t", [
    (lambda m: m.gpt_tiny(seq_len=24), 8),
    (lambda m: m.gpt_tiny(seq_len=24, kv_heads=1), 16),
    (lambda m: m.bert_tiny(), 8)], ids=["gpt8", "gqa16", "bert8"])
def test_with_input_shape_matches_jax(make, t):
    jg = make(jax_models).with_input_shape((t,))
    tg0 = make(models)
    tg = tg0.with_input_shape((t,))
    assert _spec(tg.input_spec) == _spec(jg.input_spec)
    for name in jg.topo_order:
        assert _spec(tg.nodes[name].out_spec) == \
            _spec(jg.nodes[name].out_spec), name
        assert tg.nodes[name].op is tg0.nodes[name].op
        assert tg.nodes[name].param_spec is tg0.nodes[name].param_spec
    # the original graph's parameters serve the re-specced one
    params = tg0.init(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 90, (2, t), generator=torch.Generator())
    assert tuple(tg.apply(params, ids).shape) == (2,) + tg.output_spec.shape


def test_embedding_index_rule_matches_jax():
    """Out-of-range ids wrap once when negative, then clamp — in every
    lookup of the port (``Embedding``, ``BertEmbedding``,
    ``GptEmbedding.apply`` and ``embed_at``), as in the JAX package."""
    vocab, f, t = 11, 4, 5
    ids = np.array([[-vocab - 3, -1, 0, vocab, vocab + 5]], np.int32)
    assert ops.take_rows(torch.arange(5.0)[:, None],
                         torch.tensor([-1, 7, 2]))[:, 0].tolist() == \
        [4.0, 4.0, 2.0]
    cases = [(jax_ops.Embedding(vocab, f), ops.Embedding(vocab, f)),
             (JaxBertEmbedding(vocab, f, t), BertEmbedding(vocab, f, t)),
             (JaxGptEmbedding(vocab, f, t), GptEmbedding(vocab, f, t))]
    for jop, top in cases:
        b = jax_ir.GraphBuilder("e")
        b.add(jop, b.input((t,), jnp.int32), name="e")
        np_params = _perturbed(b.build())
        tb = ir.GraphBuilder("e")
        tb.add(top, tb.input((t,), torch.int32), name="e")
        tg = tb.build()
        params = params_from_jax(tg, np_params)["e"]
        want = np.asarray(jax.jit(jop.apply)(np_params["e"], ids))
        got = top.apply(params, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    jop, top = cases[2]
    b = jax_ir.GraphBuilder("e")
    b.add(jop, b.input((t,), jnp.int32), name="e")
    np_params = _perturbed(b.build())["e"]
    tparams = {k: torch.from_numpy(v) for k, v in np_params.items()}
    for pos in (0, 3, t + 2):
        want = np.asarray(jax.jit(jop.embed_at)(np_params, ids[0], pos))
        got = top.embed_at(tparams, torch.from_numpy(ids[0]),
                           torch.tensor(pos))
        np.testing.assert_array_equal(got.numpy(), want)
