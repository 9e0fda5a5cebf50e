"""Port parity: ``defer_tpu_torch.utils.checkpoint`` against the JAX package.

The scenarios of the JAX package's checkpoint tests (``tests/test_utils.py``)
plus the cross-package ones: an ``.npz`` written by either package loads in
the other, leaf for leaf and bit for bit (the port writes the JAX layout),
for ``resnet_tiny`` (conv kernels change layout), ``bert_tiny`` and
``gpt_tiny`` (nested leaves such as ``block_0/qkv/w``).

Tolerance: a model's forward on loaded parameters against its forward on
the parameters that were saved, in the same package, within 1e-6 of max
|output| (the same values, so 0 is expected).  Leaves are compared bit for
bit.
"""

import os

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu.utils.checkpoint import load_params as jax_load_params
from defer_tpu.utils.checkpoint import save_params as jax_save_params
from defer_tpu_torch import (load_params, load_params_pt, models,
                             params_from_jax, params_to_jax, save_params,
                             save_params_pt)
from defer_tpu_torch.graph.ir import flatten_tree, tree_map

torch.set_num_threads(1)

REL = 1e-6

#: family -> a per-sample input maker (numpy, seeded)
FAMILIES = {
    "resnet_tiny": lambda rng: rng.standard_normal(
        (2, 32, 32, 3)).astype(np.float32),
    "bert_tiny": lambda rng: rng.integers(0, 100, (2, 16)).astype(np.int32),
    "gpt_tiny": lambda rng: rng.integers(0, 97, (2, 16)).astype(np.int32),
}


def _jax_params(name, key=0):
    jg = getattr(jax_models, name)()
    return jg, jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(key)))


def _leaves_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = (np.ascontiguousarray(
            v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in (fa[k], fb[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def _port_forward(tg, params, x):
    with torch.inference_mode():
        return tg.apply(params, torch.from_numpy(x)).numpy()


def test_npz_roundtrip_and_suffixless_path(tmp_path):
    tg = models.resnet_tiny()
    params = tg.init(torch.Generator().manual_seed(0))
    base = os.path.join(tmp_path, "ckpt")  # no .npz suffix
    save_params(base, params, tg)
    assert os.path.exists(base + ".npz")
    again = load_params(base, tg)
    assert again.keys() == params.keys()
    for node in params:
        _leaves_equal(again[node], params[node])
    # the file holds the JAX layout: the stem conv is HWIO
    with np.load(base + ".npz") as z:
        assert z["conv2d/w"].shape == (7, 7, 3, 8)
        np.testing.assert_array_equal(
            z["conv2d/w"], params["conv2d"]["w"].numpy().transpose(2, 3, 1, 0))


def test_pt_roundtrip_keeps_layout_and_dtype(tmp_path):
    tg = models.bert_tiny()
    params = tg.init(torch.Generator().manual_seed(1))
    params["block_0"]["qkv"]["w"] = params["block_0"]["qkv"]["w"].to(
        torch.bfloat16)
    path = str(tmp_path / "ckpt.pt")
    save_params_pt(path, params)
    stored = torch.load(path, weights_only=True)
    assert "block_0/qkv/w" in stored
    again = load_params_pt(path, tg)
    assert again["block_0"]["qkv"]["w"].dtype == torch.bfloat16
    for node in params:
        _leaves_equal(tree_map(lambda v: v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v,
                               again[node]),
                      tree_map(lambda v: v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v,
                               params[node]))


def test_params_to_jax_inverts_params_from_jax():
    tg = models.mobilenet_tiny()  # Conv2D and DepthwiseConv2D leaves
    _, np_params = _jax_params("mobilenet_tiny")
    back = params_to_jax(tg, params_from_jax(tg, np_params))
    assert back.keys() == np_params.keys()
    for node in np_params:
        _leaves_equal(back[node], np_params[node])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_file_loads_in_port(tmp_path, family):
    jg, np_params = _jax_params(family)
    tg = getattr(models, family)()
    path = str(tmp_path / "jax.npz")
    jax_save_params(path, np_params)
    loaded = load_params(path, tg)
    want = params_from_jax(tg, np_params)
    for node in want:
        _leaves_equal(loaded[node], want[node])
    x = FAMILIES[family](np.random.default_rng(3))
    _close(_port_forward(tg, loaded, x), _port_forward(tg, want, x))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_file_loads_in_jax(tmp_path, family):
    jg, _ = _jax_params(family)
    tg = getattr(models, family)()
    params = tg.init(torch.Generator().manual_seed(2))
    path = str(tmp_path / "port.npz")
    save_params(path, params, tg)
    like = jax.eval_shape(lambda: jg.init(jax.random.key(0)))
    loaded = jax_load_params(path, like)
    want = params_to_jax(tg, params)
    for node in want:
        _leaves_equal(jax.tree.map(np.asarray, loaded[node]), want[node])
    x = FAMILIES[family](np.random.default_rng(4))
    fwd = jax.jit(jg.apply)
    _close(fwd(loaded, x), fwd(want, x))


def test_missing_extra_and_wrong_shape_raise(tmp_path):
    tg = models.resnet_tiny()
    params = tg.init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.npz")
    save_params(path, params, tg)
    with np.load(path) as z:
        stored = dict(z)
    for name, mutate, match in (
            ("missing", lambda d: d.pop("conv2d/w"), "mismatch: missing"),
            ("extra", lambda d: d.update(stray=np.zeros(1)), "extra"),
            ("shape", lambda d: d.update({"predictions/b": np.zeros(3)}),
             "has shape")):
        d = dict(stored)
        mutate(d)
        bad = str(tmp_path / f"{name}.npz")
        np.savez(bad, **d)
        with pytest.raises(ValueError, match=match):
            load_params(bad, tg)
        # the JAX package raises on the same file, with the same message
        jg, _ = _jax_params("resnet_tiny")
        with pytest.raises(ValueError, match=match):
            jax_load_params(bad, jax.eval_shape(
                lambda: jg.init(jax.random.key(0))))
    # .pt: the same checks against param_spec
    pt = str(tmp_path / "ckpt.pt")
    save_params_pt(pt, params)
    stored = torch.load(pt, weights_only=True)
    stored.pop("conv2d/w")
    torch.save(stored, pt)
    with pytest.raises(ValueError, match="missing"):
        load_params_pt(pt, tg)
    # a model of another width refuses the file
    with pytest.raises(ValueError):
        load_params(path, models.resnet(
            [1, 1], width=16, num_classes=10, image_size=32))
