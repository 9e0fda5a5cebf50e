"""Port parity: ``defer_tpu_torch.utils.pretrained`` against the JAX package.

The scenarios of ``tests/test_pretrained.py``.  For each family (ResNet,
VGG19, MobileNetV2, InceptionV3, BERT, GPT-2) one random state dict in the
standard layout (torchvision names for the CNNs, Hugging Face names for
BERT and GPT-2), made from a numpy seed, is written to a file and loaded by
the JAX loader and by the port's.  The port's parameters must be
bit-equal to ``params_from_jax`` of the JAX loader's, and the port's
forward on them within 1e-5 of max |output| of the JAX forward (the
forward parity bound of ``tests/test_torch_zoo.py``: the same weights,
summed in another order).  The mapping tables must address every leaf of
the full-size ResNet50 and InceptionV3, and the ``.pt``, ``.npz``, flat
and ``.safetensors`` containers load.

One divergence by design: a ``.pt`` holding bfloat16 tensors loads in the
port (widened to float32, exact), where the JAX package's ``.numpy()``
raises ``TypeError``.
"""

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu.models.gpt import gpt as jax_gpt
from defer_tpu.models.mobilenet import mobilenet_v2 as jax_mobilenet_v2
from defer_tpu.models.resnet import resnet as jax_resnet
from defer_tpu.models.vgg import VGG19_CFG, vgg as jax_vgg
from defer_tpu.utils import pretrained as jp
from defer_tpu.utils.checkpoint import save_params as jax_save_params
from defer_tpu_torch import models, params_from_jax, save_params
from defer_tpu_torch.graph.ir import flatten_tree
from defer_tpu_torch.models.gpt import gpt
from defer_tpu_torch.models.mobilenet import mobilenet_v2
from defer_tpu_torch.models.resnet import resnet
from defer_tpu_torch.models.vgg import vgg
from defer_tpu_torch.utils import pretrained as tp
from defer_tpu_torch.utils.convert import jax_param_spec

torch.set_num_threads(1)

FWD_RTOL = 1e-5
DEPTHS = (1, 1)  # two bottleneck blocks: projection + identity paths


def _expected(jg):
    return jax.eval_shape(lambda: jg.init(jax.random.key(0)))


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _source_shapes(tf_name, want):
    """Shapes of the source tensor(s) a transform turns into ``want``."""
    if tf_name == "_conv_t":
        return [(want[3], want[2], want[0], want[1])]
    if tf_name in ("_fc_t", "_fc1_t"):
        return [(want[1], want[0])]
    if tf_name == "_crop_rows":
        return [(want[0] + 8, want[1])]  # checkpoints ship longer tables
    if tf_name == "_fuse_qkv":
        return [(want[1] // 3, want[0])] * 3
    if tf_name == "_fuse_qkv_bias":
        return [(want[0] // 3,)] * 3
    if tf_name == "_fold_pos_tt":
        return [(want[0] + 8, want[1]), (2, want[1])]
    assert tf_name == "_ident", tf_name
    return [want]


def _random_sd(mapping, expected, seed):
    """A random standard-layout state dict for ``mapping`` whose
    transformed shapes are ``expected`` (the JAX package's shapes)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for (node, leaf), (src, tf) in mapping.items():
        srcs = src if isinstance(src, tuple) else (src,)
        if tf.__name__ == "_zero_rows" or all(k in sd for k in srcs):
            continue  # GPT-2's tied head: its source is wte
        want = np.shape(_leaf(expected[node], leaf))
        for k, shp in zip(srcs, _source_shapes(tf.__name__, want)):
            v = rng.standard_normal(shp) * 0.1
            if k.endswith("running_var"):
                v = np.abs(v) + 0.5
            sd[k] = v.astype(np.float32)
    return sd


def _assert_bit_equal(port, want):
    assert port.keys() == want.keys()
    for node in want:
        fa, fb = flatten_tree(port[node]), flatten_tree(want[node])
        assert fa.keys() == fb.keys(), node
        for k in fa:
            a, b = fa[k], fb[k]
            assert a.dtype == b.dtype and a.shape == b.shape, (node, k)
            assert torch.equal(a.contiguous().view(torch.int32),
                               b.contiguous().view(torch.int32)), (node, k)


def _forwards_agree(jg, np_params, tg, params, x):
    ref = np.asarray(jax.jit(jg.apply)(np_params, x), np.float32)
    with torch.inference_mode():
        out = tg.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= FWD_RTOL * np.abs(ref).max()


def _images(size, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)


def _ids(t, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (2, t)).astype(
        np.int32)


#: family -> (JAX graph, port graph, JAX mapping, loader call, input);
#: the loader call takes (module, path, graph)
FAMILIES = {
    "resnet": (
        lambda: jax_resnet(list(DEPTHS), width=8, num_classes=10,
                           image_size=32, name="resnet_small"),
        lambda: resnet(list(DEPTHS), width=8, num_classes=10,
                       image_size=32, name="resnet_small"),
        lambda g: jp.resnet50_torch_mapping(DEPTHS),
        lambda m, p, g: m.load_pretrained_resnet50(p, g, DEPTHS),
        lambda: _images(32)),
    "vgg19": (
        lambda: jax_vgg(VGG19_CFG, num_classes=10, image_size=32,
                        fc_width=32, name="vgg19"),
        lambda: vgg(VGG19_CFG, num_classes=10, image_size=32, fc_width=32,
                    name="vgg19"),
        lambda g: jp.vgg_torch_mapping(VGG19_CFG, (1, 1, 512)),
        lambda m, p, g: m.load_pretrained("vgg19", p, g),
        lambda: _images(32)),
    "mobilenet_v2": (
        lambda: jax_mobilenet_v2(num_classes=10, image_size=32,
                                 width_mult=0.25, name="mnv2"),
        lambda: mobilenet_v2(num_classes=10, image_size=32,
                             width_mult=0.25, name="mnv2"),
        lambda g: jp.mobilenet_v2_torch_mapping(),
        lambda m, p, g: m.load_pretrained("mobilenet_v2", p, g),
        lambda: _images(32)),
    "bert": (
        lambda: jax_models.bert(2, 32, 2, 16, vocab=50),
        lambda: models.bert(2, 32, 2, 16, vocab=50),
        lambda g: jp.bert_torch_mapping(2, max_len=16),
        lambda m, p, g: m.load_pretrained("bert_base", p, g),
        lambda: _ids(16, 50)),
    "gpt2": (
        lambda: jax_gpt(2, 32, 2, 12, vocab=64, ln_eps=1e-5),
        lambda: gpt(2, 32, 2, 12, vocab=64, ln_eps=1e-5),
        lambda g: jp.gpt2_torch_mapping(2, 12),
        lambda m, p, g: m.load_pretrained("gpt2", p, g),
        lambda: _ids(12, 64)),
}

#: HF task-model saves prefix their keys; the loaders strip the prefix
PREFIX = {"bert": "bert.", "gpt2": "transformer."}


def _write(sd, path, container):
    if container == "npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loader_equals_params_from_jax_of_jax_loader(tmp_path, family):
    make_jax, make_port, mapping, load, inputs = FAMILIES[family]
    jg, tg = make_jax(), make_port()
    expected = _expected(jg)
    sd = _random_sd(mapping(jg), expected, seed=len(family))
    sd = {PREFIX.get(family, "") + k: v for k, v in sd.items()}
    container = "pt" if family in ("resnet", "bert") else "npz"
    path = str(tmp_path / f"ckpt.{container}")
    _write(sd, path, container)
    np_params = load(jp, path, jg)
    params = load(tp, path, tg)
    _assert_bit_equal(params, params_from_jax(tg, np_params))
    _forwards_agree(jg, np_params, tg, params, inputs())


def test_param_spec_in_jax_layout_equals_jax_shapes():
    for family, (make_jax, make_port, *_) in FAMILIES.items():
        expected = jax.tree.map(lambda s: tuple(s.shape), _expected(
            make_jax()))
        got = {node: {k: v.shape for k, v in flatten_tree(sub).items()}
               for node, sub in jax_param_spec(make_port()).items()}
        want = {node: {k: v for k, v in flatten_tree(sub).items()}
                for node, sub in expected.items()}
        assert got == want, family


def _torch_vgg_logits(sd, cfg, x_nhwc):
    """Independent NCHW forward of a torchvision-layout VGG state dict."""
    import torch.nn.functional as F

    def tt(k):
        return torch.from_numpy(sd[k]).double()

    t = torch.from_numpy(x_nhwc).double().permute(0, 3, 1, 2)
    i = 0
    for v in cfg:
        if v == "M":
            t = F.max_pool2d(t, 2, 2)
            i += 1
        else:
            t = F.relu(F.conv2d(t, tt(f"features.{i}.weight"),
                                tt(f"features.{i}.bias"), padding=1))
            i += 2
    t = t.flatten(1)  # torch flattens C, H, W
    t = F.relu(F.linear(t, tt("classifier.0.weight"),
                        tt("classifier.0.bias")))
    t = F.relu(F.linear(t, tt("classifier.3.weight"),
                        tt("classifier.3.bias")))
    return F.linear(t, tt("classifier.6.weight"),
                    tt("classifier.6.bias")).numpy()


def test_vgg_first_fc_reorders_a_rectangular_flatten():
    """``_fc1_t`` on a graph whose pre-flatten h, w and c all differ (a
    16x24 input through three pools: 2x3x16), so no wrong order passes by
    symmetry: the port's converted parameters are bit-equal to the JAX
    package's conversion of the same file (against the same JAX-layout
    shapes), and the port's forward equals an independent NCHW forward of
    the state dict (1e-4, as the JAX package's VGG logit test)."""
    from defer_tpu_torch.graph.ir import GraphBuilder
    from defer_tpu_torch.graph.ops import (Activation, Conv2D, Dense,
                                           Flatten, MaxPool)

    cfg = [8, "M", 16, "M", 16, "M"]
    # models.vgg's graph, node for node, on a 16x24 input
    b = GraphBuilder("vgg_rect")
    x = b.input((16, 24, 3), torch.float32)
    block, i = 1, 1
    for v in cfg:
        if v == "M":
            x = b.add(MaxPool(2, 2), x, name=f"pool{block}")
            block, i = block + 1, 1
        else:
            x = b.add(Conv2D(v, 3), x, name=f"conv{block}_{i}")
            x = b.add(Activation("relu"), x, name=f"relu{block}_{i}")
            i += 1
    x = b.add(Flatten(), x, name="flatten")
    for name, width in (("fc1", 32), ("fc2", 32), ("predictions", 10)):
        x = b.add(Dense(width), x, name=name)
        if name != "predictions":
            x = b.add(Activation("relu"), x, name=f"{name}_relu")
    tg = b.build()
    spatial = tg.out_spec(tg.nodes["flatten"].inputs[0]).shape
    assert spatial == (2, 3, 16)
    expected = jax_param_spec(tg)
    sd = _random_sd(jp.vgg_torch_mapping(cfg, spatial), expected, seed=5)
    np_params = jp.convert_state_dict(jp.vgg_torch_mapping(cfg, spatial), sd,
                                      expected, "VGG")
    params = params_from_jax(tg, tp.convert_state_dict(
        tp.vgg_torch_mapping(cfg, spatial), sd, expected, "VGG"))
    _assert_bit_equal(params, params_from_jax(tg, np_params))
    x = np.random.default_rng(3).standard_normal((2, 16, 24, 3)).astype(
        np.float32)
    with torch.inference_mode():
        ours = tg.apply(params, torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(ours, _torch_vgg_logits(sd, cfg, x),
                               rtol=1e-4, atol=1e-4)


def test_inception_v3_loader_bit_equal(tmp_path):
    """InceptionV3's 94 conv/BatchNorm pairs and fc through both loaders
    (an ignored aux head in the file); leaves bit-equal (its forward
    parity is ``tests/test_torch_zoo.py``'s)."""
    jg = jax_models.inception_v3(num_classes=10, image_size=75)
    tg = models.inception_v3(num_classes=10, image_size=75)
    sd = _random_sd(jp.inception_v3_torch_mapping(), _expected(jg), seed=11)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1),
                                                 np.float32)
    path = str(tmp_path / "iv3.npz")
    np.savez(path, **sd)
    np_params = jp.load_pretrained("inception_v3", path, jg)
    params = tp.load_pretrained("inception_v3", path, tg)
    _assert_bit_equal(params, params_from_jax(tg, np_params))


@pytest.mark.parametrize("model,make,count", [
    ("resnet50", models.resnet50, 53 + 53 * 4 + 2),
    ("inception_v3", models.inception_v3, 94 + 94 * 4 + 2)])
def test_full_size_mapping_covers_every_leaf(model, make, count):
    """The torchvision mapping addresses exactly the parametric leaves of
    the full-size graph's ``param_spec`` (no init is run)."""
    spec = jax_param_spec(make())
    mapping = (tp.resnet50_torch_mapping() if model == "resnet50"
               else tp.inception_v3_torch_mapping())
    parametric = {(node, leaf) for node, sub in spec.items()
                  for leaf in flatten_tree(sub)}
    assert set(mapping) == parametric
    assert len({src for src, _ in mapping.values()}) == count


def test_flat_layout_files_of_both_packages_load(tmp_path):
    """``save_params`` files (either package's) go through the loaders'
    flat-layout branch."""
    jg, tg = FAMILIES["resnet"][0](), FAMILIES["resnet"][1]()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(3)))
    jax_save_params(str(tmp_path / "jax.npz"), np_params)
    got = tp.load_pretrained_resnet50(str(tmp_path / "jax.npz"), tg, DEPTHS)
    _assert_bit_equal(got, params_from_jax(tg, np_params))
    params = tg.init(torch.Generator().manual_seed(4))
    save_params(str(tmp_path / "port.npz"), params, tg)
    again = tp.load_pretrained_resnet50(str(tmp_path / "port.npz"), tg,
                                        DEPTHS)
    _assert_bit_equal(again, params)


def test_safetensors_container(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    jg, tg = FAMILIES["gpt2"][0](), FAMILIES["gpt2"][1]()
    sd = _random_sd(jp.gpt2_torch_mapping(2, 12), _expected(jg), seed=9)
    path = str(tmp_path / "gpt2.safetensors")
    st.save_file(sd, path)
    _assert_bit_equal(tp.load_pretrained("gpt2", path, tg),
                      params_from_jax(tg, jp.load_pretrained("gpt2", path,
                                                             jg)))


def test_bf16_pt_widens_where_jax_raises(tmp_path):
    """Divergence by design (ROADMAP C): the JAX package's ``.numpy()``
    raises on a bfloat16 tensor; the port widens it to float32, exactly."""
    jg, tg = FAMILIES["resnet"][0](), FAMILIES["resnet"][1]()
    sd = _random_sd(jp.resnet50_torch_mapping(DEPTHS), _expected(jg), seed=6)
    path = str(tmp_path / "bf16.pt")
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in sd.items()}, path)
    with pytest.raises(TypeError):
        jp.load_pretrained_resnet50(path, jg, DEPTHS)
    params = tp.load_pretrained_resnet50(path, tg, DEPTHS)
    widened = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
               for k, v in sd.items()}
    np_params = jp.convert_resnet50_state_dict(widened, _expected(jg),
                                               DEPTHS)
    _assert_bit_equal(params, params_from_jax(tg, np_params))


def test_loud_failures_match_jax(tmp_path):
    jg, tg = FAMILIES["resnet"][0](), FAMILIES["resnet"][1]()
    expected = _expected(jg)
    sd = _random_sd(jp.resnet50_torch_mapping(DEPTHS), expected, seed=7)
    for bad, match in (({k: v for k, v in sd.items()
                         if k != "conv1.weight"}, "missing"),
                       (dict(sd, **{"fc.weight": np.zeros((7, 7),
                                                          np.float32)}),
                        "mismatch")):
        with pytest.raises(ValueError, match=match):
            jp.convert_resnet50_state_dict(bad, expected, DEPTHS)
        with pytest.raises(ValueError, match=match):
            tp.convert_resnet50_state_dict(bad, jax_param_spec(tg), DEPTHS)
    for mod, g in ((jp, jg), (tp, tg)):
        with pytest.raises(ValueError, match="no pretrained loader"):
            mod.load_pretrained("alexnet", "x.npz", g)
        with pytest.raises(ValueError, match="unsupported checkpoint"):
            mod.load_pretrained_resnet50(str(tmp_path / "x.h5"), g, DEPTHS)
    assert sorted(tp.PRETRAINED_LOADERS) == sorted(jp.PRETRAINED_LOADERS)
    # a mapping that misses a parametric node: params_from_jax refuses it
    partial = {k: v for k, v in tp.resnet50_torch_mapping(DEPTHS).items()
               if k[0] != "predictions"}
    out = tp.convert_state_dict(partial, sd, jax_param_spec(tg), "ResNet")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tg, out)
