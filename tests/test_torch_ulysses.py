"""Port parity: Ulysses (all_to_all) sequence parallelism against the JAX
package.

The scenarios of ``tests/test_ulysses.py``: the JAX
``sequence_parallel_attention_ulysses`` over a ``seq`` mesh of the
conftest's 8 virtual CPU devices, the port's over a one-device CPU mesh,
on the same numpy q/k/v.

Tolerances: against ``full_attention`` the JAX test's 1e-5 (rtol and
atol) at every size, against the ring its 1e-4; port against JAX within
1e-5 of max |out| at 8 ranks, causal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from defer_tpu.parallel.ulysses import (
    sequence_parallel_attention_ulysses as jax_ulysses)
from defer_tpu_torch.parallel import (Mesh, full_attention,
                                      sequence_parallel_attention,
                                      sequence_parallel_attention_ulysses)

torch.set_num_threads(1)

PORT_REL = 1e-5


def _qkv(b=1, h=8, t=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _mesh(n):
    return Mesh(["cpu"] * n, ("seq",))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ulysses_matches_full_and_jax(n, causal):
    q, k, v = _qkv()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = full_attention(tq, tk, tv, causal=causal).numpy()
    out = sequence_parallel_attention_ulysses(tq, tk, tv, _mesh(n),
                                              causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if (n, causal) != (8, True):  # each JAX call compiles: held to JAX
        return                      # on the widest case
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    want = np.asarray(jax_ulysses(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jmesh, causal=causal))
    scale = float(np.abs(want).max())
    assert float(np.abs(out - want).max()) <= PORT_REL * scale


def test_ulysses_matches_ring():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(seed=3))
    mesh = _mesh(4)
    a = sequence_parallel_attention_ulysses(tq, tk, tv, mesh, causal=True)
    b = sequence_parallel_attention(tq, tk, tv, mesh, causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_ulysses_head_divisibility():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(h=6))
    with pytest.raises(ValueError, match="divisible"):
        sequence_parallel_attention_ulysses(tq, tk, tv, _mesh(4))
