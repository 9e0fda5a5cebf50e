"""Port parity: the rest of the BASELINE model zoo and the MoE families.

VGG, Inception (both graphs), MobileNetV2 and the MoE transformers of
``defer_tpu_torch.models`` against the JAX package's: graph structure node
for node (names, input edges, out specs, parameter shapes, FLOPs, cut
points), the forward from weights carried over with ``params_from_jax``,
and ``Defer.run`` on both wires against the JAX ``SpmdPipeline`` at the
stage counts of ``tests/test_models.py``.  ``to_dot``/``summary`` must be
string-equal.  Full-size forwards are ``slow``.

Tolerances, with their reasons:

* forward: 1e-5 of the output's max magnitude (convolutions, matmuls and
  pooling sums run in another order than XLA's).  MoE routes must be
  equal: a flipped top-1 route would be absorbed by no tolerance.
* ``wire="buffer"`` pipelines: 1e-5 of max |output|, as the forward.
* ``wire="int8"`` pipelines: each package within the reference's bounds
  of the forward (max error < 0.15, MSE < 1e-3, as
  ``tests/test_torch_pipeline.py``), and the port within two quant steps
  of the output block (2 max |output| / 127) of JAX — an f32 summation
  order difference upstream can move a value across a rounding boundary,
  which later hops carry on.
"""

import numpy as np
import pytest
import torch

import jax

from defer_tpu import SpmdPipeline as JaxSpmdPipeline, pipeline_mesh
from defer_tpu.graph import viz as jax_viz
import defer_tpu.models as jax_models
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.partition.stage import buffer_footprint as jax_footprint
from defer_tpu_torch import Defer, DeferConfig, models, params_from_jax
from defer_tpu_torch.graph import analysis, viz
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.graph.ops import MoE
from defer_tpu_torch.partition import buffer_footprint, partition
from test_torch_graph import _assert_same_structure

torch.set_num_threads(1)

FWD_RTOL = 1e-5

#: family -> (per-sample input shape, stages as in tests/test_models.py;
#: the MoE families at moe_stage_cuts(2))
TINY = {
    "vgg_tiny": ((32, 32, 3), 4),
    "inception_tiny": ((75, 75, 3), 6),
    "mobilenet_tiny": ((32, 32, 3), 2),
    "moe_tiny": ((16,), 2),
    "moe_branched_tiny": ((16,), 2),
}


def _jax_shapes(tree):
    return jax.tree.map(lambda s: tuple(s.shape), tree)


def _cuts(family, tg):
    n = TINY[family][1]
    if family.startswith("moe"):
        return models.moe_stage_cuts(n)
    return analysis.auto_cut_points(tg, n)


@pytest.fixture(scope="module", params=list(TINY))
def tiny(request):
    """(family, port graph, JAX graph, JAX params as numpy, port params)."""
    fam = request.param
    jg = getattr(jax_models, fam)()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = getattr(models, fam)()
    return fam, tg, jg, np_params, params_from_jax(tg, np_params)


def _inputs(family, m, mb, seed):
    shape = TINY[family][0]
    rng = np.random.default_rng(seed)
    if family.startswith("moe"):
        return rng.integers(0, 100, (m, mb) + shape).astype(np.int32)
    return rng.standard_normal((m, mb) + shape).astype(np.float32)


def test_tiny_structure_equal(tiny):
    fam, tg, jg, np_params, params = tiny
    _assert_same_structure(tg, jg)
    # every parameter crossed (params_from_jax checks each leaf's shape
    # against the port's graph); depthwise kernels came in as [c, 1, k, k]
    assert set(params) == set(np_params)
    for name, node in tg.nodes.items():
        if type(node.op).__name__ == "DepthwiseConv2D":
            k, _, _, c = np_params[name]["w"].shape
            assert tuple(params[name]["w"].shape) == (c, 1, k, k)
            np.testing.assert_array_equal(
                params[name]["w"].numpy(),
                np_params[name]["w"].transpose(3, 2, 0, 1))


def test_tiny_forward_matches_jax(tiny):
    fam, tg, jg, np_params, params = tiny
    x = _inputs(fam, 1, 3, seed=1)[0]
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    out = tg.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()
    if fam == "moe_tiny":
        # the routes of every MoE layer, fed the same block output
        for name, node in tg.nodes.items():
            if isinstance(node.op, MoE):
                h = np.array(jax.jit(
                    lambda p, x, n=name: jg.apply(p, x, upto=jg.nodes[
                        n].inputs[0]))(np_params, x))
                jeid, _ = jg.nodes[name].op.route(np_params[name], h)
                teid, _ = node.op.route(params[name], torch.from_numpy(h))
                np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))


@pytest.mark.parametrize("wire", ["buffer", "int8"])
def test_tiny_pipeline_matches_jax(tiny, wire):
    """``Defer.run`` against the JAX ``SpmdPipeline`` on the same cuts."""
    fam, tg, jg, np_params, params = tiny
    cuts = _cuts(fam, tg)
    n = len(cuts) + 1
    x = _inputs(fam, 3, 1, seed=0)
    xf = x.astype(np.float32)  # token ids ride the f32 buffer exactly
    jpipe = JaxSpmdPipeline(jax_partition(jg, cuts), np_params,
                            mesh=pipeline_mesh(n), microbatch=1, chunk=4,
                            wire=wire)
    jout = jpipe.run(xf)
    out = Defer(DeferConfig(device="cpu", microbatch=1, chunk=4,
                            wire=wire)).run(tg, params, xf, cut_points=cuts)
    assert out.shape == jout.shape
    fn = jax.jit(jg.apply)
    ref = np.stack([np.asarray(fn(np_params, xi)) for xi in x])
    scale = np.abs(ref).max()
    if wire == "buffer":
        assert np.abs(out - ref).max() <= FWD_RTOL * scale
        assert np.abs(out - jout).max() <= FWD_RTOL * scale
        return
    for o in (out, jout):
        assert np.abs(o - ref).max() < 0.15
        assert np.square(o - ref).mean() < 1e-3
    assert np.abs(out - jout).max() <= 2 * scale / 127


def test_inception_cuts_are_block_boundaries_only():
    """Nothing inside an inception block is a valid cut: the port offers
    the stem nodes, the ``mixed_k`` concats and the head's pool, as JAX
    does."""
    for tg in (models.inception_tiny(), models.inception_v3()):
        cuts = analysis.valid_cut_points(tg)
        mixed = [c for c in cuts if c.startswith("mixed_")]
        assert mixed == [f"mixed_{i}" for i in range(11)]
        stem = cuts[:cuts.index("mixed_0")]
        assert "stem_pool" in stem and "stem_pool2" in stem
        assert set(cuts) - set(stem) == set(mixed) | {"avg_pool"}


@pytest.mark.parametrize("name,cuts_name,int8_buf", [
    ("vgg19", "VGG19_4STAGE_CUTS", 56 * 56 * 128),
    ("inception_v3", "INCEPTION_6STAGE_CUTS", 353024),
    ("mobilenet_v2", "MOBILENETV2_2STAGE_CUTS", 224 * 224 * 3),
])
def test_full_size_graphs_equal(name, cuts_name, int8_buf):
    """The full-size graphs (meta tensors, no compute) equal JAX's node
    for node; the advertised cuts are valid and partition alike; the int8
    ring each chip-smoke path quantizes has the stated width (InceptionV3's
    mixed_2, 35*35*288 = 352800 values, padded to 256-value blocks)."""
    tg, jg = getattr(models, name)(), getattr(jax_models, name)()
    _assert_same_structure(tg, jg)
    for n in jg.topo_order:
        if jg.nodes[n].param_spec is not None:
            t = tree_map(lambda s: s.shape, tg.nodes[n].param_spec)
            j = _jax_shapes(jg.nodes[n].param_spec)
            if type(tg.nodes[n].op).__name__ in ("Conv2D",
                                                  "DepthwiseConv2D"):
                j = dict(j, w=tuple(j["w"][i] for i in (3, 2, 0, 1)))
            assert t == j, n
    cuts = getattr(models, cuts_name)
    assert cuts == getattr(jax_models, cuts_name)
    assert set(cuts) <= set(analysis.valid_cut_points(tg))
    ts, js = partition(tg, cuts), jax_partition(jg, cuts)
    assert len(ts) == len(cuts) + 1
    for t, j in zip(ts, js):
        assert (t.node_names, t.input_name, t.output_name) == \
            (j.node_names, j.input_name, j.output_name)
    for wire in ("buffer", "int8"):
        assert (buffer_footprint(ts, microbatch=8, wire=wire)
                == jax_footprint(js, microbatch=8, wire=wire))
    assert buffer_footprint(ts, wire="int8")["buf_elems"] == int8_buf


@pytest.mark.parametrize("name", ["resnet_tiny", "inception_tiny"])
def test_viz_strings_equal(name):
    tg, jg = getattr(models, name)(), getattr(jax_models, name)()
    assert viz.summary(tg) == jax_viz.summary(jg)
    assert viz.to_dot(tg) == jax_viz.to_dot(jg)
    stage_of = {nm: s.index for s in partition(tg, num_stages=3)
                for nm in s.node_names}
    assert viz.to_dot(tg, stage_of) == jax_viz.to_dot(jg, stage_of)


@pytest.mark.slow
@pytest.mark.parametrize("name,size", [
    ("resnet50", 224), ("vgg19", 224), ("inception_v3", 299),
    ("mobilenet_v2", 224)])
def test_full_size_forward_matches_jax(name, size):
    """Seeded weights from the JAX package, one image, f32: the port's
    forward within 1e-5 of max |logit| of JAX's."""
    jg, tg = getattr(jax_models, name)(), getattr(models, name)()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    x = np.random.default_rng(0).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    with torch.inference_mode():
        out = tg.apply(params_from_jax(tg, np_params),
                       torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 1000)
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()
