"""Port parity: ``fold_batchnorm`` against the JAX package's.

The same graph, the same weights and the same randomized BatchNorm
statistics go through both packages' folds.  The fold runs in float64 and
casts to float32 in both, and the port's OIHW (and ``[c, 1, k, k]``
depthwise) kernels are the JAX package's HWIO ones transposed, so the
folded leaves must be bit-equal to the JAX fold carried across with
``params_from_jax`` — on ``resnet_tiny`` (conv) and ``mobilenet_tiny``
(conv and depthwise).  The folded forward stays within 2e-4 (rtol and
atol) of the unfolded one, the JAX test's tolerance (folding reassociates
the affine map in float32).
"""

import numpy as np
import pytest
import torch

import jax

from defer_tpu.graph.optimize import fold_batchnorm as jax_fold
import defer_tpu.models as jax_models
from defer_tpu_torch import (Defer, DeferConfig, fold_batchnorm, models,
                             params_from_jax)
from defer_tpu_torch.graph import ir, ops
from defer_tpu_torch.graph.ir import tree_map

torch.set_num_threads(1)


def _randomized_bn(graph, np_params, seed):
    """Non-trivial running statistics (as tests/test_optimize.py), numpy."""
    rng = np.random.default_rng(seed)
    out = dict(np_params)
    for name, node in graph.nodes.items():
        if type(node.op).__name__ == "BatchNorm":
            c = np.shape(np_params[name]["mean"])[0]
            out[name] = {k: v.astype(np.float32) for k, v in {
                "scale": rng.uniform(0.5, 1.5, c),
                "bias": rng.normal(0, 0.2, c),
                "mean": rng.normal(0, 0.5, c),
                "var": rng.uniform(0.5, 2.0, c)}.items()}
    return out


def _pair(family, seed=0):
    """(port graph, port params, JAX graph, JAX numpy params) with the same
    randomized BatchNorm statistics."""
    jg = getattr(jax_models, family)()
    np_params = _randomized_bn(jg, jax.tree.map(
        np.asarray, jax.jit(jg.init)(jax.random.key(seed))), seed + 1)
    tg = getattr(models, family)()
    return tg, params_from_jax(tg, np_params), jg, np_params


def _n_bn(graph):
    return sum(type(n.op).__name__ == "BatchNorm"
               for n in graph.nodes.values())


@pytest.mark.parametrize("family", ["resnet_tiny", "mobilenet_tiny"])
def test_fold_bit_equal_to_jax(family):
    tg, params, jg, np_params = _pair(family)
    fg, fp, n = fold_batchnorm(tg, params)
    jfg, jfp, jn = jax_fold(jg, np_params)
    assert n == jn > 0 and _n_bn(fg) == _n_bn(tg) - n
    assert fg.name == jfg.name == f"{family}+bnfold"
    assert (fg.topo_order, fg.output_name) == (jfg.topo_order,
                                               jfg.output_name)
    for name in jfg.topo_order:
        assert fg.nodes[name].inputs == jfg.nodes[name].inputs, name
        assert (getattr(fg.nodes[name].op, "use_bias", None)
                == getattr(jfg.nodes[name].op, "use_bias", None)), name
    carried = params_from_jax(fg, jax.tree.map(np.asarray, jfp))
    assert set(carried) == set(fp)
    depthwise = 0
    for name, leaves in carried.items():
        depthwise += isinstance(fg.nodes[name].op, ops.DepthwiseConv2D)
        for k, v in leaves.items():
            assert v.dtype == fp[name][k].dtype == torch.float32
            assert torch.equal(fp[name][k], v), (name, k)
    assert depthwise == (17 if family == "mobilenet_tiny" else 0)


@pytest.mark.parametrize("family", ["resnet_tiny", "mobilenet_tiny"])
def test_fold_preserves_outputs_and_inputs(family):
    tg, params, _, _ = _pair(family, seed=3)
    before = tree_map(lambda t: t.clone(), params)
    fg, fp, n = fold_batchnorm(tg, params)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2,) + tg.input_spec.shape).astype(np.float32))
    ref = tg.apply(params, x).numpy()
    got = fg.apply(fp, x).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    # the inputs are untouched: graph nodes and every parameter value
    assert _n_bn(tg) > 0 and not tg.name.endswith("+bnfold")
    assert set(params) == set(before)
    for name in before:
        for k, v in before[name].items():
            assert torch.equal(params[name][k], v), (name, k)


def test_folded_graph_runs_in_pipeline():
    tg, params, _, _ = _pair("resnet_tiny", seed=4)
    fg, fp, n = fold_batchnorm(tg, params)
    assert n > 0
    x = np.random.default_rng(5).standard_normal(
        (3, 1) + tg.input_spec.shape).astype(np.float32)
    got = Defer(DeferConfig(device="cpu", microbatch=1, chunk=4)).run(
        fg, fp, x, num_stages=4)
    ref = np.stack([tg.apply(params, torch.from_numpy(xi)).numpy()
                    for xi in x])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_fold_noop_without_bn():
    g = models.gpt_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    g2, p2, n = fold_batchnorm(g, p)
    assert n == 0 and g2 is g and p2 is p


def test_fold_skips_shared_and_output_convs():
    """A conv whose output has a second consumer, or is the graph output,
    keeps its BatchNorm — in both packages, on the same graph."""
    from defer_tpu.graph import ir as jax_ir
    from defer_tpu.graph import ops as jax_ops

    def build(ir_mod, ops_mod):
        b = ir_mod.GraphBuilder("shared")
        x = b.input((6, 6, 3))
        c0 = b.add(ops_mod.Conv2D(4, 3), x, name="c0")
        bn0 = b.add(ops_mod.BatchNorm(), c0, name="bn0")
        b.add(ops_mod.Add(), [bn0, c0], name="add")   # c0 has 2 consumers
        c1 = b.add(ops_mod.DepthwiseConv2D(3), "add", name="c1")
        b.add(ops_mod.BatchNorm(), c1, name="bn1")     # folds
        c2 = b.add(ops_mod.Conv2D(4, 1), "bn1", name="c2")
        b.add(ops_mod.BatchNorm(), c2, name="bn2")     # folds
        return b.build()

    jg, tg = build(jax_ir, jax_ops), build(ir, ops)
    np_params = _randomized_bn(jg, jax.tree.map(
        np.asarray, jg.init(jax.random.key(0))), 9)
    params = params_from_jax(tg, np_params)
    fg, fp, n = fold_batchnorm(tg, params)
    jfg, jfp, jn = jax_fold(jg, np_params)
    assert n == jn == 2
    assert fg.topo_order == jfg.topo_order == ["c0", "bn0", "add", "c1",
                                               "c2"]
    assert fg.nodes["c2"].inputs == ("c1",) and fg.output_name == "c2"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 6, 3)).astype(np.float32))
    np.testing.assert_allclose(fg.apply(fp, x).numpy(),
                               tg.apply(params, x).numpy(),
                               rtol=2e-4, atol=2e-4)
    # a conv that IS the graph output keeps the bn that reads it
    b = ir.GraphBuilder("out")
    b.add(ops.Conv2D(4, 3), b.input((6, 6, 3)), name="c")
    b.add(ops.BatchNorm(), "c", name="bn")
    g = b.build(output="c")
    assert fold_batchnorm(g, g.init(torch.Generator().manual_seed(0)))[2] \
        == 0
