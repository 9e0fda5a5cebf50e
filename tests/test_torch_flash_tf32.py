"""The error budget of the flash-attention kernel's TF32 split, on the CPU.

``csrc/flash_attention.cu`` runs both products of attention on the tensor
cores in TF32 (10 explicit mantissa bits).  For float32 inputs it splits
each operand x into ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)`` and
sums three products, ``lo·hi + hi·lo + hi·hi``; for bfloat16 inputs (exact
in TF32) it takes one product for ``S = Q Kᵀ`` and two for ``P V`` (only P
is split).  These tests emulate that arithmetic in float32 on the CPU —
every product of two TF32 values is exact in float32 — and hold it to
``flash_attention_plain``, the version the kernel is held to on the card:

* the split itself: both halves are TF32 values, and ``hi + lo`` keeps x
  to one float32 ulp (``x - hi`` is exact but may need 12 significant bits,
  one more than TF32 has, so ``lo`` can round its last one);
* three terms are within the kernel's 1e-5 tolerance, and one term is not
  (which is why the kernel splits);
* for bfloat16 inputs, one term for S and two for P V are within one bf16
  ulp of the plain output plus 1e-5, and one term for P V is not within
  1e-5 before rounding.

CPU only, no JAX.  ``rna_tf32`` lives here: the package's main path never
rounds to TF32 on the host.
"""

import numpy as np
import pytest
import torch

from defer_tpu_torch.ops.flash_attention import (L_FLOOR,
                                                 flash_attention_plain,
                                                 softmax_scale)

torch.set_num_threads(1)

#: the kernel's float32 tolerance against the plain version (chip_smoke.py
#: FLASH_F32_TOL, tests/test_torch_cuda.py)
TOL = 1e-5

# (b, h, tq, tk, d, causal): the cases of tests/test_torch_flash_attention.py
# (repeated here so that this file needs no JAX) plus the BERT-Base shape
CASES = [
    (2, 3, 64, 64, 16, False),
    (1, 2, 100, 100, 24, True),
    (2, 2, 37, 53, 8, False),
    (1, 1, 130, 130, 64, True),
    (1, 2, 32, 96, 16, False),
    (1, 1, 16, 16, 8, True),
    (1, 2, 1, 48, 16, True),
    (1, 2, 5, 48, 16, True),
    (1, 2, 5, 3, 16, True),
    (2, 12, 128, 64, 64, False),
    (8, 12, 128, 128, 64, False),
]
BERT = (8, 12, 128, 128, 64, False)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32, to nearest with ties away from zero: add half
    a TF32 ulp (0x1000) to the bits and clear the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the kernel forms it: 1 term hi·hi (both already TF32), 2
    terms lo·b + hi·b (only a is split), 3 terms lo·hi + hi·lo + hi·hi,
    the small terms first."""
    a_hi, a_lo = split(a)
    if terms == 1:
        return rna_tf32(a) @ rna_tf32(b)
    if terms == 2:
        return a_lo @ b + a_hi @ b
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def attention_tf32(q, k, v, causal, s_terms, pv_terms):
    """The kernel's arithmetic in float32: S in ``s_terms`` TF32 products,
    scaled and masked in f32, softmax with the 1e-20 floor, P V in
    ``pv_terms`` products, divided by the row sums."""
    q, k, v = (x.float() for x in (q, k, v))
    t_q, t_k = q.shape[2], k.shape[2]
    s = product(q, k.transpose(-1, -2), s_terms) * softmax_scale(q.shape[-1])
    if causal:
        q_pos = torch.arange(t_q)[:, None] + (t_k - t_q)
        s = s.masked_fill(q_pos < torch.arange(t_k), -float("inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == -float("inf"), 0.0, m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    return product(p, v, pv_terms) / l


def _inputs(b, h, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


def _bf16_ulp(x):
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def test_split_halves_are_tf32_and_keep_x():
    rng = np.random.default_rng(0)
    f32 = np.finfo(np.float32)
    edge = np.array([
        0.0, -0.0, 1.0, -1.0, f32.tiny, -f32.tiny, f32.smallest_subnormal,
        np.float32(f32.max) / 4, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),  # ties
        1 + 2.0 ** -11 - 2.0 ** -23,       # x - hi needs 12 bits
        1 + 2.0 ** -12, 1 - 2.0 ** -24, 3.0 * 2.0 ** -130,
    ], dtype=np.float32)
    rand = (rng.standard_normal(100_000)
            * np.exp2(rng.integers(-60, 60, 100_000))).astype(np.float32)
    x = torch.from_numpy(np.concatenate([edge, rand]))
    hi, lo = split(x)
    for half in (hi, lo):  # both TF32 values: the low 13 bits clear
        assert not (half.view(torch.int32) & 0x1FFF).any()
    # hi is x to nearest TF32, ties away from zero
    ulp_tf32 = torch.exp2(torch.floor(torch.log2(x.abs().double())) - 10)
    ulp_tf32 = ulp_tf32.clamp_min(2.0 ** -136)  # subnormals: bit 13
    assert ((x.double() - hi.double()).abs() <= ulp_tf32 / 2).all()
    assert hi[8].item() == np.float32(1 + 2.0 ** -10)
    assert hi[9].item() == -np.float32(1 + 2.0 ** -10)
    # x - hi is exact in f32, and hi + lo keeps x to one f32 ulp of x
    assert torch.equal(hi.double() + (x - hi).double(), x.double())
    ulp = torch.from_numpy(np.spacing(np.abs(x.numpy()))).double()
    assert ((hi.double() + lo.double() - x.double()).abs() <= ulp).all()
    # exact whenever x - hi fits in TF32 (e.g. every x with <= 22 bits)
    fits = rna_tf32(x - hi) == (x - hi)
    assert torch.equal((hi.double() + lo.double())[fits], x.double()[fits])
    assert not fits[10]  # the 12-bit residual rounds its last bit
    x22 = torch.from_numpy(
        (rand.view(np.int32) & ~np.int32(3)).view(np.float32))
    h22, l22 = split(x22)
    assert torch.equal(h22.double() + l22.double(), x22.double())


@pytest.mark.parametrize("b,h,tq,tk,d,causal", CASES)
def test_three_terms_within_kernel_tolerance(b, h, tq, tk, d, causal):
    q, k, v = _inputs(b, h, tq, tk, d)
    ref = flash_attention_plain(q, k, v, causal=causal)
    out = attention_tf32(q, k, v, causal, 3, 3)
    assert (out - ref).abs().max().item() <= TOL
    if causal and tq > tk:  # rows that see no key stay exactly 0
        assert not out[:, :, :tq - tk].any()


def test_one_term_misses_tolerance_at_bert_shape():
    q, k, v = _inputs(*BERT[:5])
    ref = flash_attention_plain(q, k, v)
    one = (attention_tf32(q, k, v, False, 1, 1) - ref).abs().max().item()
    three = (attention_tf32(q, k, v, False, 3, 3) - ref).abs().max().item()
    assert one > 10 * TOL      # about 7e-4: why the kernel splits
    assert three < one / 100


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_one_term_s_two_term_pv(causal):
    b, h, tq, tk, d = BERT[:5]
    q, k, v = (x.to(torch.bfloat16) for x in _inputs(b, h, tq, tk, d, seed=1))
    ref = flash_attention_plain(q, k, v, causal=causal)
    f32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    out = attention_tf32(q, k, v, causal, 1, 2)
    assert (out - f32).abs().max().item() <= TOL
    assert ((out.to(torch.bfloat16).float() - ref.float()).abs()
            <= _bf16_ulp(ref) + TOL).all()
    # one term for P V would not be: P is f32, not TF32
    one = attention_tf32(q, k, v, causal, 1, 1)
    assert (one - f32).abs().max().item() > TOL
