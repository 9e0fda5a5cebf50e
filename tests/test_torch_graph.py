"""Port parity: graph IR, ResNet models, analysis and partitioning.

The port's graphs must equal the JAX package's node for node (names, input
edges, out specs, FLOPs, cut points, stage boundaries, transfer-buffer
geometry), and the forward from weights carried over with
``params_from_jax`` must match ``LayerGraph.apply`` in float32.  Forward
tolerance: 1e-5 of the output's max magnitude — the convolutions sum in
another order than XLA's, which moves float32 results in the last bits.
"""

import numpy as np
import pytest
import torch

import jax

from defer_tpu.graph import analysis as jax_analysis
from defer_tpu.graph import ir as jax_ir
from defer_tpu.graph import ops as jax_ops
import defer_tpu.models as jax_models
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.partition.stage import buffer_footprint as jax_footprint
from defer_tpu_torch import params_from_jax
from defer_tpu_torch.graph import analysis, ir, ops
from defer_tpu_torch import models
from defer_tpu_torch.partition import buffer_footprint, partition
from defer_tpu_torch.utils.convert import params_to_device

torch.set_num_threads(1)

FWD_RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    """(port graph, JAX graph, JAX params as numpy) for resnet_tiny."""
    jg = jax_models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    return models.resnet_tiny(), jg, np_params


@pytest.fixture(scope="module")
def r50():
    return models.resnet50(), jax_models.resnet50()


def _spec(s):
    return (s.shape, str(s.dtype).replace("torch.", ""))


def _assert_same_structure(tg, jg):
    assert tg.name == jg.name
    assert tg.topo_order == jg.topo_order
    assert (tg.input_name, tg.output_name) == (jg.input_name, jg.output_name)
    assert _spec(tg.input_spec) == _spec(jg.input_spec)
    for name in jg.topo_order:
        tn, jn = tg.nodes[name], jg.nodes[name]
        assert type(tn.op).__name__ == type(jn.op).__name__, name
        assert tn.inputs == jn.inputs, name
        assert _spec(tn.out_spec) == _spec(jn.out_spec), name
        assert (tn.param_spec is None) == (jn.param_spec is None), name
        assert (analysis.node_flops(tg, name)
                == jax_analysis.node_flops(jg, name)), name
    assert analysis.total_flops(tg) == jax_analysis.total_flops(jg)
    assert (analysis.valid_cut_points(tg)
            == jax_analysis.valid_cut_points(jg))


def _assert_same_stages(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        assert (t.index, t.name, t.node_names, t.input_name,
                t.output_name) == (j.index, j.name, j.node_names,
                                   j.input_name, j.output_name)
        assert _spec(t.in_spec) == _spec(j.in_spec)
        assert _spec(t.out_spec) == _spec(j.out_spec)


def test_tiny_graph_structure_equal(tiny):
    tg, jg, _ = tiny
    _assert_same_structure(tg, jg)


@pytest.mark.parametrize("num_stages", [2, 4, 8])
def test_tiny_partition_equal(tiny, num_stages):
    tg, jg, _ = tiny
    assert (analysis.auto_cut_points(tg, num_stages)
            == jax_analysis.auto_cut_points(jg, num_stages))
    costs = {n: float(i % 7) for i, n in enumerate(jg.topo_order)}
    assert (analysis.auto_cut_points(tg, num_stages, costs)
            == jax_analysis.auto_cut_points(jg, num_stages, costs))
    ts, js = partition(tg, num_stages=num_stages), \
        jax_partition(jg, num_stages=num_stages)
    _assert_same_stages(ts, js)
    for wire in ("buffer", "int8"):
        assert (buffer_footprint(ts, microbatch=2, wire=wire)
                == jax_footprint(js, microbatch=2, wire=wire))
    cuts = [s.output_name for s in ts[:-1]]
    assert (analysis.max_activation_elems(tg, cuts)
            == jax_analysis.max_activation_elems(jg, cuts))
    assert (analysis.max_activation_bytes(tg, cuts, batch=3)
            == jax_analysis.max_activation_bytes(jg, cuts, batch=3))


def _one_op_graph(ir_mod, op, shape, n_inputs=1):
    b = ir_mod.GraphBuilder("one")
    x = b.input(shape)
    b.add(op, [x] * n_inputs)
    return b.build()


#: (op name, per-sample input shape, constructor args[, inputs]).  SAME
#: is XLA's rule: even sizes at stride 2, even kernels and (1, 7) kernels
#: pad asymmetrically (one more row or column after the data)
OP_CASES = [
    ("Conv2D", (9, 9, 4), (6, 3, 2, (1, 1))),        # odd size, stride 2
    ("Conv2D", (8, 8, 4), (5, 1, 1, "VALID", False)),
    ("Conv2D", (9, 9, 4), (6, 3)),                   # SAME, stride 1
    ("Conv2D", (9, 9, 4), (6, 3, 2)),                # SAME, odd, stride 2
    ("Conv2D", (8, 8, 4), (6, 3, 2)),                # SAME (0, 1), stride 2
    ("Conv2D", (8, 8, 4), (5, 2, 1)),                # SAME, even kernel
    ("Conv2D", (9, 9, 4), (5, 4, 2)),                # SAME (1, 2)
    ("Conv2D", (7, 9, 4), (6, (1, 7))),              # SAME (1, 7) kernel
    ("Conv2D", (9, 9, 4), (6, (7, 1), 1, "same")),   # lowercase, as lax
    ("Conv2D", (8, 8, 4), (6, 3, 2, "SAME", True, 2)),  # grouped
    ("DepthwiseConv2D", (9, 9, 6), (3,)),            # SAME, stride 1
    ("DepthwiseConv2D", (8, 8, 6), (3, 2)),          # SAME (0, 1)
    ("DepthwiseConv2D", (9, 9, 6), (3, 2, (1, 1))),  # MobileNetV2's form
    ("DepthwiseConv2D", (8, 8, 6), (3, 1, "VALID", True)),
    ("BatchNorm", (5, 5, 6), ()),
    ("MaxPool", (9, 9, 3), (3, 2, (1, 1))),           # -inf padding
    ("MaxPool", (8, 8, 3), (2,)),
    ("MaxPool", (8, 8, 3), (3, 2, "SAME")),           # -inf pad (0, 1)
    ("MaxPool", (9, 9, 3), (3, 1, "SAME")),
    ("AvgPool", (8, 8, 3), (3, 2, "SAME", True)),     # / 9 everywhere
    ("AvgPool", (8, 8, 3), (3, 2, "SAME", False)),    # / valid count
    ("AvgPool", (9, 9, 3), (3, 1, "SAME", False)),
    ("AvgPool", (9, 9, 3), (3, 1, "SAME", True)),     # InceptionV3's pool
    ("AvgPool", (8, 8, 3), (2,)),
    ("GlobalAvgPool", (4, 4, 6), ()),
    ("ZeroPad2D", (5, 6, 3), (2,)),
    ("Concat", (4, 4, 3), (), 3),                     # channel axis
    ("Concat", (4, 5, 3), (1,), 2),
    ("Flatten", (4, 5, 3), ()),
    ("Tile", (4, 3), (3,)),
    ("Cast", (4, 3), ("bfloat16",)),
    ("ReduceMean", (4, 5, 3), (1,)),
    ("Dense", (12,), (7,)),
    ("Activation", (4, 4, 3), ("relu",)),
    ("Activation", (4, 4, 3), ("relu6",)),
    ("Activation", (4, 4, 3), ("gelu",)),
    ("Activation", (4, 4, 3), ("swish",)),
    ("Activation", (4, 7), ("softmax",)),
    ("Activation", (4, 4, 3), ("tanh",)),
    ("MoE", (12, 16), (4, 32)),
    ("ExpertBranch", (12, 16), (4, 1, 32)),
]


@pytest.mark.parametrize("name,shape,args,n_inputs",
                         [c if len(c) == 4 else c + (1,) for c in OP_CASES])
def test_op_matches_jax(name, shape, args, n_inputs):
    """Each ported op on the same inputs and carried-over parameters.  The
    inputs are shifted negative so max-pool padding must be -inf (zero
    padding would win at the border); activations see inputs of scale 4
    so ReLU6 clamps; BatchNorm gets random statistics."""
    jg = _one_op_graph(jax_ir, getattr(jax_ops, name)(*args), shape,
                       n_inputs)
    tg = _one_op_graph(ir, getattr(ops, name)(*args), shape, n_inputs)
    assert (tg.topo_order, _spec(tg.output_spec)) == \
        (jg.topo_order, _spec(jg.output_spec))
    (node,) = jg.topo_order
    assert analysis.node_flops(tg, node) == jax_analysis.node_flops(jg, node)
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(np.asarray, jg.init(jax.random.key(1)))
    if name == "BatchNorm":
        c = shape[-1]
        np_params = {n: {"scale": rng.standard_normal(c), "bias":
                         rng.standard_normal(c), "mean":
                         rng.standard_normal(c), "var":
                         rng.uniform(0.5, 2.0, c)} for n in np_params}
        np_params = jax.tree.map(lambda a: a.astype(np.float32), np_params)
    if name in ("MoE", "ExpertBranch"):
        # a wider gate spreads the routes over the experts
        for p in np_params.values():
            p["gate"] = p["gate"] * 50.0
    if name == "Activation":
        x = 4.0 * rng.standard_normal((2,) + shape)
    else:
        x = rng.standard_normal((2,) + shape) - 3.0
    x = x.astype(np.float32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, x)).astype(np.float32)
    out = tg.apply(params_from_jax(tg, np_params), torch.from_numpy(x))
    assert out.shape == ref.shape
    out = out.float().numpy()
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()


def test_moe_routes_match_jax():
    """Top-1 routes are equal, not absorbed by the output tolerance; the
    smallest top-2 gate-logit gap says how near a tie the inputs came."""
    rng = np.random.default_rng(3)
    jop, top = jax_ops.MoE(4, 32), ops.MoE(4, 32)
    gate = (rng.standard_normal((16, 4)) * 0.5).astype(np.float32)
    x = rng.standard_normal((3, 12, 16)).astype(np.float32)
    jeid, jpe = jax.jit(jop.route)({"gate": gate}, x)
    teid, tpe = top.route({"gate": torch.from_numpy(gate)},
                          torch.from_numpy(x))
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-6)
    top2 = np.sort(x @ gate, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    print(f"smallest top-2 gate logit gap {gap:.3g}")
    assert len(np.unique(np.asarray(jeid))) > 1
    # a tie goes to the first expert in both
    tie = np.zeros((1, 2, 16), np.float32)
    eq = np.zeros((16, 4), np.float32)
    assert int(top.route({"gate": torch.from_numpy(eq)},
                         torch.from_numpy(tie))[0][0, 0]) == 0 == \
        int(jax.jit(jop.route)({"gate": eq}, tie)[0][0, 0])


def test_unported_variants_raise():
    """The port raises ValueError where the JAX package does: an unknown
    activation kind (at shape inference) and an unknown padding mode."""
    for ir_mod, ops_mod in ((jax_ir, jax_ops), (ir, ops)):
        with pytest.raises(ValueError):
            _one_op_graph(ir_mod, ops_mod.Activation("selu"), (8, 8, 3))
    with pytest.raises(ValueError, match="padding"):
        _one_op_graph(ir, ops.Conv2D(4, 3, 1, "FULL"), (8, 8, 3))


def test_tiny_forward_matches_jax(tiny):
    tg, jg, np_params = tiny
    params = params_from_jax(tg, np_params)
    x = np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jg.apply)(np_params, x))
    out = tg.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()
    # channels_last weights (the device layout) give the same forward
    out_cl = tg.apply(params_to_device(params, "cpu"),
                      torch.from_numpy(x)).numpy()
    assert np.abs(out_cl - ref).max() <= FWD_RTOL * np.abs(ref).max()


def test_tiny_stage_fns_match_jax(tiny):
    """Each stage's function, fed the same boundary tensor, matches."""
    tg, jg, np_params = tiny
    params = params_from_jax(tg, np_params)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    for ts, js in zip(partition(tg, num_stages=4),
                      jax_partition(jg, num_stages=4)):
        ref = np.asarray(js.fn(js.select_params(np_params), x))
        out = ts.fn(ts.select_params(params), torch.tensor(x)).numpy()
        assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()
        x = ref


def test_resnet50_structure_and_8stage_partition_equal(r50):
    tg, jg = r50
    _assert_same_structure(tg, jg)
    ts = partition(tg, models.RESNET50_8STAGE_CUTS)
    js = jax_partition(jg, jax_models.RESNET50_8STAGE_CUTS)
    assert models.RESNET50_8STAGE_CUTS == jax_models.RESNET50_8STAGE_CUTS
    _assert_same_stages(ts, js)
    for wire in ("buffer", "int8"):
        assert (buffer_footprint(ts, microbatch=8, wire=wire)
                == jax_footprint(js, microbatch=8, wire=wire))
    # the int8 ring the main path quantizes every step: add_2's 56*56*256
    assert buffer_footprint(ts, wire="int8")["buf_elems"] == 802816
    assert (analysis.auto_cut_points(tg, 8)
            == jax_analysis.auto_cut_points(jg, 8))


def test_init_is_seeded_and_shaped(tiny):
    tg, _, np_params = tiny
    p1 = tg.init(torch.Generator().manual_seed(3))
    p2 = tg.init(torch.Generator().manual_seed(3))
    assert set(p1) == set(np_params)
    for name, leaves in p1.items():
        for k, v in leaves.items():
            assert torch.equal(v, p2[name][k])
            assert tuple(v.shape) == tg.nodes[name].param_spec[k].shape
    # conv weights are OIHW in the port, HWIO in the JAX package
    assert tuple(p1["conv2d"]["w"].shape) == np_params["conv2d"]["w"].shape[::-1][
        :2] + np_params["conv2d"]["w"].shape[:2]


def test_params_from_jax_rejects_mismatches(tiny):
    tg, _, np_params = tiny
    bad = dict(np_params)
    bad.pop("conv2d")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tg, bad)
    bad = dict(np_params, conv2d={"w": np_params["conv2d"]["w"][:1]})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tg, bad)


def test_partition_rejects_bad_cuts_and_unported_planner(tiny):
    tg, _, _ = tiny
    # a conv inside a residual block: two tensors cross the boundary
    with pytest.raises(ValueError, match="single-tensor"):
        partition(tg, ["conv2d_2"])
    with pytest.raises(ValueError, match="not a node"):
        partition(tg, ["nope"])
    with pytest.raises(ValueError, match="topological"):
        partition(tg, ["add_1", "add"])
    # the comm-aware planner: the JAX package's cuts (both detect no card
    # off the GPU and rank against the same fallback row)
    got = [s.output_name for s in partition(tg, num_stages=4,
                                            objective="bottleneck")]
    want = [s.output_name for s in jax_partition(
        jax_models.resnet_tiny(), num_stages=4, objective="bottleneck")]
    assert got == want and len(got) == 4
