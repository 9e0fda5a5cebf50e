"""Port parity: expert parallelism against the JAX package.

The scenarios of ``tests/test_expert_parallel.py``: the JAX
``expert_parallel_fn`` over an ``expert`` mesh of the conftest's 8
virtual CPU devices, the port's over a one-device CPU mesh, on the JAX
package's ``MoE`` weights (``params_from_jax``) and the same numpy
tokens.

Tolerances: against the dense ``MoE.apply`` the JAX test's 1e-5 (rtol
and atol) while no token overflows; port against JAX within 1e-5 of max
|out| (at 4 ranks and in the capacity-1 case); the stacked shards
bit-equal to JAX's ``shard_moe_params``; a dropped token's output equal
to its input exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from defer_tpu.graph.ir import GraphBuilder as JaxGraphBuilder
from defer_tpu.graph.ops import MoE as JaxMoE
from defer_tpu.parallel.expert import (
    expert_parallel_fn as jax_ep_fn,
    expert_parallel_mesh as jax_ep_mesh,
    shard_moe_params as jax_shard_moe)
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.graph.ir import GraphBuilder, flatten_tree
from defer_tpu_torch.graph.ops import MoE
from defer_tpu_torch.parallel import (expert_parallel_fn,
                                      expert_parallel_mesh,
                                      shard_moe_params)

torch.set_num_threads(1)

PORT_REL = 1e-5


def _moe(e=8, d=16, h=32):
    graphs = []
    for builder, op in ((JaxGraphBuilder, JaxMoE(num_experts=e, hidden=h)),
                        (GraphBuilder, MoE(num_experts=e, hidden=h))):
        b = builder("moe")
        b.add(op, b.input((4, d)), name="moe")
        graphs.append(b.build())
    jg, tg = graphs
    np_params = jax.tree.map(np.asarray, jg.init(jax.random.key(0)))
    params = params_from_jax(tg, np_params)
    return (jg.nodes["moe"].op, np_params["moe"], tg.nodes["moe"].op,
            params["moe"])


def _mesh(ep):
    return expert_parallel_mesh(ep, devices=["cpu"] * ep)


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_ep_matches_dense_and_jax(ep):
    jop, jp, op, p = _moe()
    x = np.random.default_rng(0).normal(size=(8, 4, 16)).astype(np.float32)
    tx = torch.from_numpy(x)
    ref = op.apply(p, tx).numpy()
    mesh = _mesh(ep)
    # generous capacity: no token dropped -> exact parity
    out = expert_parallel_fn(op, mesh, capacity_factor=float(ep))(
        shard_moe_params(op, p, ep, mesh=mesh), tx).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if ep != 4:  # the JAX programs compile slowly: held to JAX at 4 ranks
        return
    jmesh = jax_ep_mesh(ep)
    want = np.asarray(jax_ep_fn(jop, jmesh, capacity_factor=float(ep))(
        jax_shard_moe(jop, jp, ep, mesh=jmesh), jnp.asarray(x)))
    assert float(np.abs(out - want).max()) <= PORT_REL * float(
        np.abs(want).max())


def test_ep_capacity_drops_fall_back_to_residual():
    """With capacity 1 per rank, overflow tokens keep only the residual
    (switch-style dropping), exactly; the kept ones equal the dense
    result; and the port drops the same tokens as JAX."""
    jop, jp, op, p = _moe(e=2)
    x = np.random.default_rng(1).normal(size=(2, 4, 16)).astype(np.float32)
    tx = torch.from_numpy(x)
    mesh = _mesh(2)
    out = expert_parallel_fn(op, mesh, tokens_per_device=2,
                             capacity_factor=1.0)(
        shard_moe_params(op, p, 2, mesh=mesh), tx).numpy()
    ref = op.apply(p, tx).numpy()
    dropped = (out == x).all(axis=-1)
    assert dropped.any()  # capacity 1 must actually drop something
    assert np.isclose(out, ref, atol=1e-5).all(axis=-1)[~dropped].all()
    jmesh = jax_ep_mesh(2)
    want = np.asarray(jax_ep_fn(jop, jmesh, tokens_per_device=2,
                                capacity_factor=1.0)(
        jax_shard_moe(jop, jp, 2, mesh=jmesh), jnp.asarray(x)))
    np.testing.assert_array_equal(dropped, np.isclose(
        want, x, atol=1e-5).all(axis=-1))
    assert float(np.abs(out - want).max()) <= PORT_REL * float(
        np.abs(want).max())


def test_moe_params_shards_bit_equal_to_jax():
    jop, jp, op, p = _moe(e=8)
    got = shard_moe_params(op, p, 4)
    assert got["fc1"]["w"].shape == (4, 2, 16, 32)
    torch.testing.assert_close(got["gate"][0], got["gate"][1], rtol=0,
                               atol=0)
    want = {k: np.asarray(v) for k, v in flatten_tree(
        jax_shard_moe(jop, jp, 4)).items()}
    for k, v in flatten_tree(got).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        shard_moe_params(op, p, 3)


def test_expert_fn_matches_jax():
    jop, jp, op, p = _moe(e=4)
    x = np.random.default_rng(2).normal(size=(3, 5, 16)).astype(np.float32)
    fn = jax.jit(jop.expert_fn)  # one compile for every expert id
    for e in range(4):
        want = np.asarray(fn(jp, jnp.asarray(x), jnp.asarray(e)))
        got = op.expert_fn(p, torch.from_numpy(x), e).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
