"""Port parity: the port's meshes and collectives against the JAX package.

``defer_tpu_torch.parallel.mesh`` lays out the JAX package's (data,
stage[, model]) meshes and runs ``shard_map``'s collectives as functions
over per-rank tensors.  Each collective is held to the JAX collective
under ``shard_map`` on the conftest's 8 virtual CPU devices, with the same
numpy inputs, exactly (they move and add the same f32 values; the sums
run in the same rank order).  Autograd passes through them: the gradient
of a psum reaches every rank's input once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from defer_tpu.parallel.mesh import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.utils.compat import shard_map
from defer_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)


def _jax_collective(fn, x: np.ndarray, n: int) -> np.ndarray:
    """``fn`` under shard_map over a 1-d ``"i"`` mesh of ``n`` devices,
    ``x`` [n, ...] split on its leading axis (one block per rank)."""
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("i",))
    f = shard_map(lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("i"),
                  out_specs=P("i"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _ranks(x: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(a.copy()) for a in x]


@pytest.mark.parametrize("dp,n,tp", [(1, 4, 1), (2, 2, 1), (1, 2, 2),
                                     (2, 2, 2)])
def test_pipeline_mesh_matches_jax_layout(dp, n, tp):
    """The same axes, shape and position order as JAX's mesh: position
    (d, s, m) holds the devices' list entry d*S*M + s*M + m."""
    jm = jax_pipeline_mesh(n, dp, tp)
    devs = [torch.device("cpu", i) for i in range(8)]
    tm = M.pipeline_mesh(n, dp, tp, devices=devs)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == jm.axis_names
    assert tm.size == jm.devices.size
    want = np.vectorize(lambda d: d.id)(jm.devices)
    got = np.vectorize(lambda d: d.index)(tm.devices)
    np.testing.assert_array_equal(got, want)


def test_pipeline_mesh_too_few_devices_and_one_card():
    with pytest.raises(ValueError, match="available"):
        M.pipeline_mesh(4, 2, devices=["cpu"] * 7)
    if not torch.cuda.is_available():
        # devices=None means every visible card: none here
        with pytest.raises(ValueError, match="only 0 available"):
            M.pipeline_mesh(2)
    mesh = M.one_card_mesh("cpu", 4, 2, 2)
    assert mesh.shape == {"data": 2, "stage": 4, "model": 2}
    assert M.mesh_placement(mesh, "x")[1] == torch.device("cpu")
    assert M.stage_axis_size(mesh) == 4


def test_mesh_over_distinct_devices_raises_naming_a15b():
    mesh = M.pipeline_mesh(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="A15b"):
        M.mesh_placement(mesh, "SpmdPipeline")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_psum_and_pmean_match_jax(n):
    x = np.random.default_rng(n).standard_normal((n, 3, 5)).astype(
        np.float32)
    want = _jax_collective(lambda a: lax.psum(a, "i"), x, n)
    got = M.psum(_ranks(x))
    assert len(got) == n
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    want = _jax_collective(lambda a: lax.pmean(a, "i"), x, n)
    for r, g in enumerate(M.pmean(_ranks(x))):
        np.testing.assert_allclose(g.numpy(), want[r], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ppermute_matches_jax(n):
    x = np.random.default_rng(1).standard_normal((n, 4)).astype(np.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    want = _jax_collective(lambda a: lax.ppermute(a, "i", perm), x, n)
    got = M.ppermute(_ranks(x), perm)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    # a rank no pair sends to gets zeros, as in JAX
    part = [(0, 1)]
    want = _jax_collective(lambda a: lax.ppermute(a, "i", part), x, n)
    got = M.ppermute(_ranks(x), part)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("n,split,concat", [(2, 1, 2), (4, 1, 2), (4, 2, 1),
                                            (4, 0, 0), (8, 0, 0)])
def test_all_to_all_matches_jax(n, split, concat):
    x = np.random.default_rng(2).standard_normal((n, 8, 8, 16)).astype(
        np.float32)
    want = _jax_collective(lambda a: lax.all_to_all(
        a, "i", split_axis=split, concat_axis=concat, tiled=True), x, n)
    got = M.all_to_all(_ranks(x), split_axis=split, concat_axis=concat)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_matches_jax(tiled):
    n = 4
    x = np.random.default_rng(3).standard_normal((n, 2, 3)).astype(
        np.float32)
    want = _jax_collective(lambda a: lax.all_gather(
        a, "i", axis=0, tiled=tiled), x, n)
    got = M.all_gather(_ranks(x), axis=0, tiled=tiled)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_psum_autograd_counts_each_rank_once():
    """d/dx_r of sum_r' w_r' . psum(x)_r' = sum_r' w_r': every rank's
    input gets the summed cotangent of all ranks' uses, once."""
    rng = np.random.default_rng(4)
    xs = [torch.tensor(rng.standard_normal(5), dtype=torch.float32,
                       requires_grad=True) for _ in range(3)]
    ws = [torch.tensor(rng.standard_normal(5), dtype=torch.float32)
          for _ in range(3)]
    out = sum((w * s).sum() for w, s in zip(ws, M.psum(xs)))
    grads = torch.autograd.grad(out, xs)
    want = (ws[0] + ws[1] + ws[2]).numpy()
    for g in grads:
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6)
    # ppermute and all_to_all route cotangents back along their moves
    y = torch.stack(M.ppermute(xs, [(0, 1), (1, 2), (2, 0)]))
    (g0,) = torch.autograd.grad((y * torch.arange(3.0)[:, None]).sum(),
                                [xs[0]])
    np.testing.assert_array_equal(g0.numpy(), np.ones(5, np.float32))
