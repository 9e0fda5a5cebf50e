"""Port parity: pipeline x tensor (x data) parallelism against the JAX
package.

The scenarios of ``tests/test_pp_tp.py``: the JAX ``SpmdPipeline`` on a
(data, stage, model) mesh of the conftest's 8 virtual CPU devices, the
port's on the one-card CPU mesh of the same extents, both on the JAX
package's ``bert_tiny`` weights (``params_from_jax``) and the same ids.
Also the port's mesh entry points: ``mesh=`` on ``SpmdPipeline``,
``Defer``, ``PipelinedDecoder`` and ``MpmdPipeline(devices=)``, and the
refusal of a mesh over distinct devices (ROADMAP A15b).

Tolerances, with their reasons:

* rows against the full forward: the JAX test's 2e-4 (rtol and atol);
* port against JAX: 1e-5 of max |out| (the same f32 ops in another
  order); int8 wire: one quant step of the output block, max |out| / 127
  (an upstream summation-order difference can move a value across a
  rounding boundary).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from defer_tpu import SpmdPipeline as JaxSpmdPipeline
from defer_tpu import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.models import bert_tiny as jax_bert_tiny
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu_torch import (Defer, DeferConfig, MpmdPipeline,
                             PipelinedDecoder, SpmdPipeline, models,
                             params_from_jax, partition)
from defer_tpu_torch.parallel import pipeline_mesh

torch.set_num_threads(1)

PORT_REL = 1e-5


@pytest.fixture(scope="module")
def bert():
    jg, tg = jax_bert_tiny(), models.bert_tiny()
    np_params = jax.tree.map(np.asarray, jg.init(jax.random.key(0)))
    params = params_from_jax(tg, np_params)
    ids = (np.arange(3 * 2 * 16).reshape(3, 2, 16) % 100).astype(np.int32)
    fwd = jax.jit(jg.apply)
    ref = np.stack([np.asarray(fwd(np_params, jnp.asarray(b)))
                    for b in ids])
    return jg, tg, np_params, params, ids, ref


def _jax_rows(bert, dp, tp, wire="buffer"):
    jg, _, np_params, _, ids, _ = bert
    pipe = JaxSpmdPipeline(jax_partition(jg, num_stages=2), np_params,
                           mesh=jax_pipeline_mesh(2, dp, tp), microbatch=2,
                           chunk=3, wire=wire)
    return pipe.run(ids.astype(np.float32))


def _near(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (2, 1)])
def test_pp_tp_dp_matches_full_and_jax(bert, dp, tp):
    _, tg, _, params, ids, ref = bert
    stages = partition(tg, num_stages=2)
    mesh = pipeline_mesh(2, dp, tp, devices=["cpu"] * (2 * dp * tp))
    pipe = SpmdPipeline(stages, params, mesh=mesh, microbatch=2, chunk=3)
    assert (pipe.data_parallel, pipe.tensor_parallel) == (dp, tp)
    assert all(m.tp == tp and len(m.rows) == tp for m in pipe.modules)
    out = pipe.run(ids.astype(np.float32))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    _near(out, _jax_rows(bert, dp, tp), PORT_REL, "port vs JAX")
    # the same pipeline from the extents alone
    again = SpmdPipeline(stages, params, device="cpu", microbatch=2,
                         chunk=3, data_parallel=dp, tensor_parallel=tp)
    assert again.mesh.shape == mesh.shape
    np.testing.assert_array_equal(again.run(ids.astype(np.float32)), out)


def test_pp_tp_int8_wire_matches_jax(bert):
    _, tg, _, params, ids, _ = bert
    pipe = SpmdPipeline(partition(tg, num_stages=2), params, device="cpu",
                        microbatch=2, chunk=3, wire="int8",
                        tensor_parallel=2)
    out = pipe.run(ids.astype(np.float32))
    _near(out, _jax_rows(bert, 1, 2, wire="int8"), 1 / 127,
          "port vs JAX, int8 wire")


def test_defer_api_tensor_parallel(bert):
    _, tg, _, params, ids, ref = bert
    defer = Defer(DeferConfig(device="cpu", microbatch=2, chunk=3,
                              tensor_parallel=2))
    out = defer.run(tg, params, ids.astype(np.float32), num_stages=4)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    rep = defer.health_check(tg, params, num_stages=4)
    assert rep["ok"] and rep["mesh"] == {"data": 1, "stage": 4, "model": 2}
    # Defer(mesh=): the mesh's extents rule, and equal SpmdPipeline's rows
    mesh = pipeline_mesh(2, 2, 2, devices=["cpu"] * 8)
    dm = Defer(DeferConfig(microbatch=2, chunk=3), mesh=mesh)
    rows = dm.run(tg, params, ids.astype(np.float32), num_stages=2)
    pipe = SpmdPipeline(partition(tg, num_stages=2), params, mesh=mesh,
                        microbatch=2, chunk=3)
    np.testing.assert_array_equal(rows, pipe.run(ids.astype(np.float32)))


def test_tp_weight_rows_are_sharded(bert):
    """Under TP each (stage, rank) row is shorter than the tp=1 row: the
    counterpart of the JAX ``test_tp_weight_buffer_is_sharded``."""
    _, tg, _, params, _, _ = bert
    stages = partition(tg, num_stages=2)
    p1 = SpmdPipeline(stages, params, device="cpu", microbatch=2)
    p2 = SpmdPipeline(stages, params, device="cpu", microbatch=2,
                      tensor_parallel=2)
    for m1, m2 in zip(p1.modules, p2.modules):
        assert len(m2.rows) == 2
        assert all(r.numel() < m1.row.numel() for r in m2.rows)
    # a replicated leaf (LayerNorm) is whole on every rank, a sharded one
    # (qkv) is not
    m = p2.modules[1]
    flags = dict(zip(m.paths, m.replicated))
    assert flags[("block_2", "ln1", "scale")]
    assert not flags[("block_2", "qkv", "w")]


def test_mesh_errors_and_distinct_devices(bert):
    _, tg, _, params, _, _ = bert
    stages = partition(tg, num_stages=2)
    with pytest.raises(ValueError, match="divide"):
        SpmdPipeline(stages, params, device="cpu", microbatch=3,
                     data_parallel=2)
    with pytest.raises(ValueError, match="stage axis"):
        SpmdPipeline(stages, params, microbatch=2,
                     mesh=pipeline_mesh(4, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="model axis"):
        SpmdPipeline(stages, params, microbatch=2, tensor_parallel=4,
                     mesh=pipeline_mesh(2, 1, 2, devices=["cpu"] * 4))
    far = pipeline_mesh(2, devices=["cuda:0", "cuda:1"])
    for make in (lambda: SpmdPipeline(stages, params, mesh=far),
                 lambda: Defer(DeferConfig(), mesh=far),
                 lambda: PipelinedDecoder(models.gpt_tiny(seq_len=16),
                                          None, num_stages=2, mesh=far)):
        with pytest.raises(NotImplementedError, match="A15b"):
            make()


def test_decoder_and_mpmd_on_a_mesh():
    """``PipelinedDecoder(mesh=)`` reads the stage axis only and matches
    ``device=``; ``MpmdPipeline(devices=[dev] * 8)`` places its stages
    round-robin on the one card and matches ``device=``."""
    g = models.gpt_tiny(seq_len=16)
    p = g.init(torch.Generator().manual_seed(1))
    prompt = np.random.default_rng(2).integers(0, 97, (4, 5))
    mesh = pipeline_mesh(2, 1, 2, devices=["cpu"] * 4)
    a = PipelinedDecoder(g, p, num_stages=2, microbatch=2, max_len=16,
                         mesh=mesh).generate(prompt, 4)
    b = PipelinedDecoder(g, p, num_stages=2, microbatch=2, max_len=16,
                         device="cpu").generate(prompt, 4)
    np.testing.assert_array_equal(a, b)
    d = Defer(DeferConfig(microbatch=2), mesh=mesh)
    np.testing.assert_array_equal(d.generate(g, p, prompt, 4), b)

    rt = models.resnet_tiny()
    rp = rt.init(torch.Generator().manual_seed(0))
    stages = partition(rt, num_stages=2)
    x = np.random.default_rng(3).standard_normal(
        (3, 1, 32, 32, 3)).astype(np.float32)
    mp = MpmdPipeline(stages, rp, devices=["cpu"] * 8)
    assert mp.devices == [torch.device("cpu")] * 2
    np.testing.assert_array_equal(
        mp.run(x), MpmdPipeline(stages, rp, device="cpu").run(x))
    with pytest.raises(ValueError, match="not both"):
        MpmdPipeline(stages, rp, device="cpu", devices=["cpu"])
    dm = Defer(DeferConfig(mode="mpmd"), mesh=pipeline_mesh(
        2, devices=["cpu"] * 2))
    np.testing.assert_array_equal(dm.run(rt, rp, x, num_stages=2),
                                  mp.run(x))
