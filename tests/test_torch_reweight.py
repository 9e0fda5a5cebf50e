"""``SpmdPipeline.reweight``: new weights into the live flat rows, in place.

Mirrors ``tests/test_spmd_pipeline.py::test_reweight_live_pipeline`` on
the port: resnet_tiny in four stages, the JAX package's weights carried
over, outputs held against the JAX forward (to 2e-4, as that test holds
the JAX engine).  Then the layout errors — a changed shape, dtype or tree
— each raise before anything is copied, so the deployed rows stay as they
were.
"""

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu_torch import SpmdPipeline, models, params_from_jax, partition
from defer_tpu_torch.graph.ir import tree_map

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jg = jax_models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = models.resnet_tiny()
    return jg, np_params, tg, params_from_jax(tg, np_params)


def _reference(jg, np_params, x):
    fn = jax.jit(jg.apply)
    return np.stack([np.asarray(fn(np_params, xi)) for xi in x])


def _inputs():
    return np.random.default_rng(9).standard_normal(
        (4, 2, 32, 32, 3)).astype(np.float32)


def test_reweight_live_pipeline(tiny):
    jg, np_params, tg, params = tiny
    pipe = SpmdPipeline(partition(tg, num_stages=4), params, device="cpu",
                        microbatch=2, chunk=4)
    x = _inputs()
    np.testing.assert_allclose(pipe.run(x), _reference(jg, np_params, x),
                               rtol=2e-4, atol=2e-4)
    rows = [m.row for m in pipe.modules]
    ptrs = [r.data_ptr() for r in rows]

    np_params2 = jax.tree.map(lambda a: a * 1.25, np_params)
    pipe.reweight(params_from_jax(tg, np_params2))
    np.testing.assert_allclose(pipe.run(x), _reference(jg, np_params2, x),
                               rtol=2e-4, atol=2e-4)
    # in place: the same row tensors, at the same addresses
    assert [m.row for m in pipe.modules] == rows
    assert [m.row.data_ptr() for m in pipe.modules] == ptrs
    assert pipe.metrics.captures == 0  # the CPU runs no graph

    # pushing the originals back restores the original outputs
    pipe.reweight(params)
    np.testing.assert_allclose(pipe.run(x), _reference(jg, np_params, x),
                               rtol=2e-4, atol=2e-4)


def test_reweight_bf16_rows(tiny):
    """Under ``compute_dtype=bfloat16`` the new weights land in the bf16
    rows: the result equals a pipeline built on them."""
    _, _, tg, params = tiny
    stages = partition(tg, num_stages=4)
    kw = dict(device="cpu", microbatch=2, chunk=4, compute_dtype="bfloat16",
              wire="int8")
    params2 = tree_map(lambda v: v * 0.5, params)
    pipe = SpmdPipeline(stages, params, **kw)
    x = _inputs()
    pipe.run(x)
    pipe.reweight(params2)
    np.testing.assert_array_equal(pipe.run(x),
                                  SpmdPipeline(stages, params2, **kw).run(x))


def _bad_shape(params, node):
    bad = dict(params)
    bad[node] = tree_map(lambda v: torch.zeros(3, 3), params[node])
    return bad


def _bad_dtype(params, node):
    bad = dict(params)
    bad[node] = tree_map(lambda v: v.double(), params[node])
    return bad


def _extra_leaf(params, node):
    bad = dict(params)
    bad[node] = dict(params[node], extra=torch.zeros(2))
    return bad


def _missing_leaf(params, node):
    bad = dict(params)
    leaves = dict(params[node])
    leaves.pop(next(iter(leaves)))
    bad[node] = leaves
    return bad


@pytest.mark.parametrize("make,match", [
    (_bad_shape, "leaves"), (_bad_dtype, "leaves"),
    (_extra_leaf, "tree structure"), (_missing_leaf, "tree structure")])
def test_reweight_layout_errors_leave_rows_untouched(tiny, make, match):
    """A bad leaf in the LAST stage: every stage is checked before any row
    is copied, so no stage's deployed row changes."""
    _, _, tg, params = tiny
    stages = partition(tg, num_stages=4)
    pipe = SpmdPipeline(stages, params, device="cpu", microbatch=2, chunk=4)
    last = stages[-1].node_names
    node = next(n for n in last if n in params)
    bad = make(tree_map(lambda v: v * 2.0, params), node)
    before = [m.row.clone() for m in pipe.modules]
    with pytest.raises(ValueError, match=match) as e:
        pipe.reweight(bad)
    assert "reweight" in str(e.value)
    for m, row in zip(pipe.modules, before):
        assert torch.equal(m.row, row)
