"""Port parity: tensor parallelism against the JAX package.

The scenarios of ``tests/test_tensor_parallel.py``: the JAX
``tensor_parallel_fn`` runs on the conftest's 8 virtual CPU devices, the
port's on a one-device CPU mesh (``devices=["cpu"] * tp``), both on the
JAX package's weights (``params_from_jax``) and the same numpy inputs.

Tolerances, with their reasons:

* shards (``shard_tp_params``, ``tp_shard``): bit-equal to JAX's — the
  same slices of the same f32 values;
* port against JAX: 1e-5 of max |out| (the same f32 ops, summed in
  another order), on one case of each parametrized test (each JAX mesh
  compiles its own program);
* sharded against the full forward: the JAX tests' own bounds (rtol and
  atol 1e-5 for the MLP, 2e-4 for the transformer graphs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from defer_tpu import GraphBuilder as JaxGraphBuilder
from defer_tpu import shard_tp_params as jax_shard_tp_params
from defer_tpu import tensor_parallel_fn as jax_tp_fn
from defer_tpu.graph.ops import Activation as JaxActivation
from defer_tpu.graph.ops import Dense as JaxDense
from defer_tpu.models import bert_tiny as jax_bert_tiny
from defer_tpu.models.gpt import gpt as jax_gpt
from defer_tpu.parallel.tensor import tensor_parallel_mesh as jax_tp_mesh
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.graph.ir import GraphBuilder, ShapeSpec, flatten_tree
from defer_tpu_torch.graph.ops import Activation, Dense
from defer_tpu_torch.models import bert_tiny
from defer_tpu_torch.models.gpt import CausalTransformerBlock, gpt
from defer_tpu_torch.parallel import (shard_tp_params, tensor_parallel_fn,
                                      tensor_parallel_mesh)

torch.set_num_threads(1)

PORT_REL = 1e-5


def _mlp(builder, dense, act, d=16, h=64, out=8):
    b = builder("mlp")
    x = b.input((d,))
    x = b.add(dense(h), x)
    x = b.add(act("relu"), x)
    x = b.add(dense(out), x)
    return b.build()


def _pair(jg, tg, key):
    np_params = jax.tree.map(np.asarray, jg.init(jax.random.key(key)))
    return np_params, params_from_jax(tg, np_params)


def _port_tp(tg, params, tp, x):
    mesh = tensor_parallel_mesh(tp, devices=["cpu"] * tp)
    stk = shard_tp_params(tg, params, tp, mesh=mesh)
    return tensor_parallel_fn(tg, mesh)(stk, torch.as_tensor(x)).numpy()


def _jax_tp(jg, np_params, tp, x):
    mesh = jax_tp_mesh(tp)
    stk = jax_shard_tp_params(jg, np_params, tp, mesh=mesh)
    return np.asarray(jax_tp_fn(jg, mesh)(stk, jnp.asarray(x)))


def _near(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_dense_tp_matches_full_and_jax(tp):
    jg = _mlp(JaxGraphBuilder, JaxDense, JaxActivation)
    tg = _mlp(GraphBuilder, Dense, Activation)
    np_params, params = _pair(jg, tg, 0)
    x = np.random.default_rng(1).normal(size=(3, 16)).astype(np.float32)
    out = _port_tp(tg, params, tp, x)
    ref = tg.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if tp == 4:  # the JAX programs compile slowly: held to JAX at tp=4
        _near(out, _jax_tp(jg, np_params, tp, x), PORT_REL, "port vs JAX")


def test_bert_tp_matches_full_and_jax():
    tp = 2
    jg, tg = jax_bert_tiny(), bert_tiny()
    np_params, params = _pair(jg, tg, 0)
    ids = (np.arange(2 * 16).reshape(2, 16) % 100).astype(np.int32)
    out = _port_tp(tg, params, tp, ids)
    ref = tg.apply(params, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    _near(out, _jax_tp(jg, np_params, tp, ids), PORT_REL, "port vs JAX")


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_bit_equal_to_jax(tp):
    """Every node's stacked shards, as numpy, equal JAX's bit for bit."""
    jg, tg = jax_bert_tiny(), bert_tiny()
    np_params, params = _pair(jg, tg, 3)
    if tp == 4:  # bert_tiny has 2 heads: shard the MLP graph instead
        jg = _mlp(JaxGraphBuilder, JaxDense, JaxActivation)
        tg = _mlp(GraphBuilder, Dense, Activation)
        np_params, params = _pair(jg, tg, 3)
    want = jax_shard_tp_params(jg, np_params, tp)
    got = shard_tp_params(tg, params, tp)
    assert want.keys() == got.keys()
    for name in want:
        w = {k: np.asarray(v) for k, v in flatten_tree(want[name]).items()}
        g = {k: v.numpy() for k, v in flatten_tree(got[name]).items()}
        assert w.keys() == g.keys(), name
        for k in w:
            assert g[k].shape[0] == tp
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}/{k}")


def test_tp_weight_shards_are_disjoint():
    """Each rank holds 1/tp of every sharded matrix."""
    tg = bert_tiny()
    params = tg.init(torch.Generator().manual_seed(0))
    tp = 2
    blk = tg.nodes["block_0"].op.tp_shard(params["block_0"], tp, 0)
    full = params["block_0"]
    assert blk["qkv"]["w"].shape[1] * tp == full["qkv"]["w"].shape[1]
    assert blk["proj"]["w"].shape[0] * tp == full["proj"]["w"].shape[0]
    assert blk["fc1"]["w"].shape[1] * tp == full["fc1"]["w"].shape[1]
    assert blk["fc2"]["w"].shape[0] * tp == full["fc2"]["w"].shape[0]


def test_tp_indivisible_heads_raises():
    tg = bert_tiny()  # 2 heads
    params = tg.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        tg.nodes["block_0"].op.tp_shard(params["block_0"], 3, 0)


@pytest.mark.parametrize("tp,kv", [(2, 2), (2, 4), (4, 4)])
def test_gpt_gqa_tp_matches_full_and_jax(tp, kv):
    """GQA causal blocks: each rank holds whole query groups (nh/tp query
    heads, kv/tp KV heads)."""
    name = f"gqa_tp{tp}_kv{kv}"
    jg = jax_gpt(2, 32, 8, 12, vocab=64, kv_heads=kv, name=name)
    tg = gpt(2, 32, 8, 12, vocab=64, kv_heads=kv, name=name)
    np_params, params = _pair(jg, tg, 5)
    ids = (np.arange(2 * 12).reshape(2, 12) % 64).astype(np.int32)
    out = _port_tp(tg, params, tp, ids)
    ref = tg.apply(params, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    if (tp, kv) == (2, 4):  # held to JAX on one GQA case (compile time)
        _near(out, _jax_tp(jg, np_params, tp, ids), PORT_REL, "port vs JAX")


def test_gpt_gqa_tp_indivisible_kv_raises():
    tg = gpt(1, 32, 4, 8, vocab=32, kv_heads=2, name="gqa_bad_tp")
    params = tg.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        tg.nodes["block_0"].op.tp_shard(params["block_0"], 4, 0)


@pytest.mark.parametrize("kv,tp", [(2, 2), (4, 2), (8, 2), (4, 4)])
def test_tp_unshard_inverts_tp_shard(kv, tp):
    """Reassembling all ranks' shards reproduces every leaf bit for bit
    (MHA at kv == 8 and GQA)."""
    blk = CausalTransformerBlock(8, num_kv_heads=kv)
    p = blk.init(torch.Generator().manual_seed(4), (ShapeSpec((6, 32)),))
    back = blk.tp_unshard([blk.tp_shard(p, tp, r) for r in range(tp)])
    want, got = flatten_tree(p), flatten_tree(back)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    d = Dense(8)
    w = {"w": torch.randn(16, 8), "b": torch.randn(8)}
    back = d.tp_unshard([d.tp_shard(w, tp, r) for r in range(tp)])
    assert torch.equal(back["w"], w["w"]) and torch.equal(back["b"], w["b"])
