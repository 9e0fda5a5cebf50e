"""Port parity: the int8 wire quantizer of ``defer_tpu_torch`` against JAX.

The same numpy inputs go through the port's plain quantizer (what a CPU
tensor takes, and what the CUDA kernel is held to on the card) and through
both JAX paths — the jnp reference and the Pallas kernel in interpret mode,
both compiled as the JAX pipeline runs them.  Payload ``q`` and scales
``s`` must be bit-equal: the math is the same (scale = amax * f32(1/127),
IEEE division x / scale, round half to even), so no tolerance is stated.
The eager jnp path divides amax / 127 exactly instead; that 1-ulp scale
difference is pinned by its own test (ROADMAP.md queue C).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from defer_tpu.ops.quant import quantize_int8_blocks as jax_quant
from defer_tpu.ops.quant import dequantize_int8_blocks as jax_dequant
from defer_tpu.ops.quant_pallas import quantize_int8_blocks_pallas
from defer_tpu_torch.ops import quant
from defer_tpu_torch.ops.quant_cuda import KERNEL, quantize_int8_blocks_cuda

torch.set_num_threads(1)

#: the jnp reference compiled, as the JAX pipeline runs it under jit
_jax_quant_jit = jax.jit(functools.partial(jax_quant, use_pallas=False))


def _both_jax(x_np, dtype=jnp.float32):
    x = jnp.asarray(x_np, dtype)
    qr, sr = _jax_quant_jit(x)
    qp, sp = quantize_int8_blocks_pallas(x, interpret=True)
    return [(np.asarray(qr), np.asarray(sr)), (np.asarray(qp), np.asarray(sp))]


def _assert_bit_equal(x_np, dtype=torch.float32):
    """Port quantizer == both JAX paths, bit for bit, on ``x_np``."""
    qt, st = quant.quantize_int8_blocks(torch.from_numpy(x_np).to(dtype))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for qj, sj in _both_jax(x_np, jdt):
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy().view(np.int32),
                                      sj.view(np.int32))


@pytest.mark.parametrize("shape", [(4, 2048), (2, 3, 512), (1, 256)])
def test_quant_bit_equal_random(shape):
    rng = np.random.default_rng(0)
    for _ in range(50):
        # per-block magnitudes spread over decades, like real activations
        mag = np.exp(3.0 * rng.standard_normal(shape[:-1] + (shape[-1] // 256,
                                                             1)))
        x = rng.standard_normal(shape[:-1] + (shape[-1] // 256, 256)) * mag
        _assert_bit_equal(x.reshape(shape).astype(np.float32))


def test_quant_bit_equal_zeros_and_nonfinite():
    _assert_bit_equal(np.zeros((2, 512), np.float32))
    x = np.linspace(-3, 3, 4 * 256, dtype=np.float32).reshape(4, 256)
    x[0, :3] = [np.inf, -np.inf, np.nan]
    x[1] = np.inf          # a block with nothing finite: scale 1, q 0
    x[2, ::2] = np.nan
    x[3, 0] = -0.0
    _assert_bit_equal(x)
    q, s = quant.quantize_int8_blocks(torch.from_numpy(x))
    assert s[1].item() == 1.0 and (q[1] == 0).all()


def test_quant_bit_equal_exact_ties():
    """x/scale = k + 0.5 exactly: half to even, in both directions."""
    k = np.arange(-126, 127, dtype=np.float32)           # 253 values
    ties = np.concatenate([[127.0], k + 0.5, [-126.5, 0.5]]).astype(np.float32)
    assert ties.size == 256
    for pow2 in (1.0, 0.125, 4.0):                        # scale = pow2
        _assert_bit_equal((ties * pow2).reshape(1, 256))
    q, _ = quant.quantize_int8_blocks(torch.from_numpy(ties).reshape(1, 256))
    # 0.5 -> 0, 1.5 -> 2, -0.5 -> 0, -1.5 -> -2 (round half to even)
    got = dict(zip(ties[1:-2].tolist(), q[0, 1:-2].tolist()))
    assert (got[0.5], got[1.5], got[-0.5], got[-1.5]) == (0, 2, 0, -2)


def test_quant_bit_equal_bf16():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 1024)) * 7).astype(np.float32)
    # keep only bf16-representable values so both frameworks start from
    # the very same bf16 tensor
    x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    x[0, :2] = [np.inf, np.nan]
    _assert_bit_equal(x, torch.bfloat16)


def test_quant_eager_reference_scale_within_one_ulp():
    """The one place the JAX reference disagrees with itself: run eagerly,
    ``amax / 127.0`` is an exact division; compiled (jit, Pallas), XLA
    turns it into ``amax * f32(1/127)``, which the port follows.  The
    scales then differ by at most 1 ulp, on a few percent of blocks, and
    the payloads agree."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((256, 256))
         * np.exp(3 * rng.standard_normal((256, 1)))).astype(np.float32)
    qt, st = quant.quantize_int8_blocks(torch.from_numpy(x))
    qe, se = (np.asarray(a) for a in jax_quant(jnp.asarray(x),
                                                 use_pallas=False))
    np.testing.assert_array_equal(qt.numpy(), qe)
    ulps = np.abs(st.numpy().view(np.int32) - se.view(np.int32))
    assert ulps.max() == 1 and 0 < ulps.mean() < 0.1
    exact = (np.abs(x).max(-1).astype(np.float64) / 127).astype(np.float32)
    np.testing.assert_array_equal(se[:, 0], exact)


def test_dequant_equal_and_ragged_raises():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 512)).astype(np.float32) * 9
    qt, st = quant.quantize_int8_blocks(torch.from_numpy(x))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        yt = quant.dequantize_int8_blocks(qt, st, dtype).float().numpy()
        yj = np.asarray(jax_dequant(jnp.asarray(qt.numpy()),
                                    jnp.asarray(st.numpy()), jdt),
                        np.float32)
        np.testing.assert_array_equal(yt, yj)
    with pytest.raises(ValueError, match="multiple"):
        quant.quantize_int8_blocks(torch.zeros(2, 257))
    with pytest.raises(ValueError, match="multiple"):
        quant.quantize_int8_blocks_plain(torch.zeros(2, 100))


def test_ring_hop_rotates_one_slot():
    """Slot k's dequantized output arrives at slot k+1; the last wraps."""
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((3, 2, 512)).astype(np.float32))
    out = quant.quantized_ring_hop(y, torch.float32)
    per_slot = [quant.dequantize_int8_blocks(*quant.quantize_int8_blocks(y[k]))
                for k in range(3)]
    for k in range(3):
        assert torch.equal(out[(k + 1) % 3], per_slot[k])


def test_cuda_wrapper_refuses_cpu_tensors_without_launching():
    """The kernel wrapper never quietly runs the plain version: a CPU
    tensor is an error, and nothing is counted as launched."""
    before = KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        quantize_int8_blocks_cuda(torch.zeros(1, 256))
    with pytest.raises(ValueError, match="no implementation"):
        quant.quantize_int8_blocks(torch.zeros(1, 256, device="meta"))
    assert KERNEL.launches == before
