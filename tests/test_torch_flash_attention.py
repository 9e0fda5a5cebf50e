"""Port parity: ``defer_tpu_torch.ops.flash_attention`` against JAX.

The same numpy inputs (N(0,1), seeded) go through the JAX package's
``flash_attention`` — its Pallas kernel in interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs it — and through the port's
``flash_attention`` (which takes ``flash_attention_plain`` for a CPU
tensor), on every case of that file plus a row with no live key and the
BERT-Base head shape.

Tolerances, with their reasons:

* float32: 1e-6 absolute (measured 2.4e-7).  Both compute in float32;
  the Pallas kernel streams key blocks with an online softmax, the plain
  version takes one masked softmax over all keys, so sums run in other
  orders.
* bfloat16: one bf16 ulp of the JAX output, plus the float32 tolerance:
  both widen to float32, compute, and round once to bf16, so their f32
  results (1e-6 apart) can round to neighbouring bf16 values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from defer_tpu.ops import flash_attention as jax_flash
from defer_tpu_torch.ops import _build
from defer_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from defer_tpu_torch.ops.flash_attention_cuda import (KERNEL,
                                                      flash_attention_cuda)

torch.set_num_threads(1)

F32_TOL = 1e-6


def _inputs(b, h, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


def _bf16_ulp(x):
    a = np.maximum(np.abs(x.astype(np.float32)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


# (b, h, tq, tk, d, causal, block_q, block_k): the cases of
# tests/test_flash_attention.py, a row with no live key, BERT-Base heads
CASES = [
    (2, 3, 64, 64, 16, False, 128, 128),
    (1, 2, 100, 100, 24, True, 128, 128),   # not a block multiple
    (2, 2, 37, 53, 8, False, 128, 128),     # Tq != Tk
    (1, 1, 130, 130, 64, True, 128, 128),   # a second q block
    (1, 2, 32, 96, 16, False, 32, 32),      # several K blocks
    (1, 1, 16, 16, 8, True, 128, 128),      # causal masking
    (1, 2, 1, 48, 16, True, 128, 128),      # decode: the whole prefix
    (1, 2, 5, 48, 16, True, 128, 128),      # chunked decode
    (1, 2, 5, 3, 16, True, 128, 128),       # rows 0, 1 see no key
    (2, 12, 128, 64, 64, False, 128, 128),  # BERT-Base heads
]


@pytest.mark.parametrize("b,h,tq,tk,d,causal,bq,bk", CASES)
def test_matches_jax_f32(b, h, tq, tk, d, causal, bq, bk):
    q, k, v = _inputs(b, h, tq, tk, d)
    ref = np.asarray(jax_flash(q, k, v, causal=causal, block_q=bq,
                               block_k=bk))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_attention_plain(tq_, tk_, tv_, causal=causal).numpy()
    out = flash_attention(tq_, tk_, tv_, causal=causal, block_q=bq,
                          block_k=bk).numpy()
    assert out.shape == ref.shape == (b, h, tq, d)
    np.testing.assert_array_equal(out, plain)  # a CPU tensor: the plain path
    assert np.abs(out - ref).max() <= F32_TOL
    if tq > tk and causal:  # rows i < tq - tk see no key: exactly 0
        assert not out[:, :, :tq - tk].any()
        assert not ref[:, :, :tq - tk].any()
        assert out[:, :, tq - tk:].all()


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_bf16(causal):
    q, k, v = _inputs(1, 2, 64, 64, 32, seed=3)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash(qb, kb, vb, causal=causal), np.float32)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out = flash_attention(*tb, causal=causal)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    assert (np.abs(out - ref) <= _bf16_ulp(ref) + F32_TOL).all()


def test_causal_masks_future():
    """Output at position t does not depend on keys/values after t."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 16, 16, 8, seed=2))
    out1 = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] += 7.0
    v2[:, :, -1] -= 3.0
    out2 = flash_attention(q, k2, v2, causal=True)
    assert torch.equal(out1[:, :, :-1], out2[:, :, :-1])
    assert not torch.allclose(out1[:, :, -1], out2[:, :, -1])


def test_meta_gives_shapes_only():
    q = torch.empty(2, 3, 5, 16, device="meta")
    k = torch.empty(2, 3, 7, 16, device="meta")
    out = flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta" and out.shape == (2, 3, 5, 16)
    out = flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                          k.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16


class _OnDevice:
    """Shape-only stand-in for a tensor on a device this build lacks."""

    def __init__(self, shape, kind):
        self.shape = torch.Size(shape)
        self.device = torch.device(kind)

    def dim(self):
        return len(self.shape)


def test_other_devices_and_bad_arguments_raise():
    x = _OnDevice((1, 2, 4, 8), "xpu")
    with pytest.raises(ValueError, match="no implementation"):
        flash_attention(x, x, x)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 6, 8))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, k[..., :4], v)
    with pytest.raises(ValueError, match="B, H, T, D"):
        flash_attention(q[0], k[0], v[0])
    for bad in (0, -4, 2.0, None):
        with pytest.raises(ValueError, match="block_q"):
            flash_attention(q, k, v, block_q=bad)
    with pytest.raises(ValueError, match="block_k"):
        flash_attention(q, k, v, block_k=0)
    # the tile sizes never change a result
    np.testing.assert_array_equal(
        flash_attention(q, k, v, block_q=8, block_k=16).numpy(),
        flash_attention(q, k, v).numpy())


def test_cuda_wrapper_refuses_cpu_tensors_without_building(monkeypatch):
    def no_nvcc():
        raise AssertionError("the kernel must not be built for a refusal")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 4, 4, 8))
    before = KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert KERNEL.launches == before and KERNEL._fn is None


def test_flash_timeline_marks_match_the_kernel(monkeypatch):
    """The timeline tool reads the mark slots the kernel source declares,
    and refuses to run without a card before building anything."""
    import re

    from defer_tpu_torch.ops import flash_timeline

    src = (_build.CSRC / "flash_attention.cu").read_text()
    marks = re.search(r"kMarks = (\d+), kMarkTiles = (\d+);", src)
    assert marks and (int(marks[1]), int(marks[2])) == (
        flash_timeline.MARKS, flash_timeline.MARK_TILES)
    names = flash_timeline.phase_names()
    assert max(names) < flash_timeline.MARKS
    assert names[3 + 5 * (flash_timeline.MARK_TILES - 1) + 4] == "tile 10 P V"
    assert max(i for i in names if names[i].startswith("tile")) < 60

    def no_nvcc():
        raise AssertionError("nothing may be built without a card")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        flash_timeline.main([])
    assert exit_info.value.code != 0
