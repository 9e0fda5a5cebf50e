"""Port parity: ring attention against the JAX package.

The scenarios of ``tests/test_ring_attention.py``: the JAX
``sequence_parallel_attention`` shards the sequence over a ``seq`` mesh of
the conftest's 8 virtual CPU devices, the port's over a one-device CPU
mesh, on the same numpy q/k/v.

Tolerances: against the port's ``full_attention`` the JAX test's 2e-5
(rtol and atol), at every ring size; port against JAX within 1e-5 of max
|out| (the same f32 online softmax, summed in another order), at 8 ranks
causal (each JAX call compiles its own program).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from defer_tpu.parallel.ring_attention import (
    full_attention as jax_full_attention,
    sequence_parallel_attention as jax_sp_attention)
from defer_tpu_torch.parallel import (Mesh, full_attention, ring_attention,
                                      sequence_parallel_attention)

torch.set_num_threads(1)

PORT_REL = 1e-5


def _mesh(n):
    return Mesh(["cpu"] * n, ("seq",))


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _near(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("n,causal", [(2, False), (4, False), (8, False),
                                      (4, True), (8, True)])
def test_ring_matches_full_and_jax(n, causal):
    q, k, v = _qkv((2, 3, 8 * n, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = full_attention(tq, tk, tv, causal=causal).numpy()
    out = sequence_parallel_attention(tq, tk, tv, _mesh(n),
                                      causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    if (n, causal) != (8, True):  # each JAX call compiles (6-7 s here):
        return                      # held to JAX on the widest case
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    want = np.asarray(jax_sp_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jmesh, causal=causal))
    _near(out, want, PORT_REL, "port vs JAX ring")
    _near(ref, np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)),
        PORT_REL, "port vs JAX full_attention")


def test_ring_long_context_memory_shape():
    """Uniform inputs: the output equals v everywhere; each rank's score
    block is Tl x Tl."""
    n = 8
    b, h, t, d = 1, 2, 16 * n, 8
    q = torch.ones((b, h, t, d))
    out = sequence_parallel_attention(q, q, q, _mesh(n))
    assert out.shape == (b, h, t, d)
    np.testing.assert_allclose(out.numpy(), np.ones((b, h, t, d)),
                               rtol=1e-5)
    shards = list(q.chunk(n, dim=2))
    assert all(s.shape[2] == t // n for s in ring_attention(
        shards, shards, shards))


def test_causal_first_token_attends_self_only():
    n = 4
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 4 * n, 8), 1))
    out = sequence_parallel_attention(q, k, v, _mesh(n), causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-5, atol=1e-5)
