"""The port's CUDA kernels on the card (marker ``gpu``; skipped without CUDA).

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held bit-equal to its plain PyTorch version on the same CUDA
tensors (the CPU parity tests hold the plain version to the JAX package).
"""

import math

import pytest
import torch

from defer_tpu_torch.ops import quant
from defer_tpu_torch.ops.quant_cuda import KERNEL, quantize_int8_blocks_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _assert_kernel_equals_plain(x):
    before = KERNEL.launches
    qk, sk = quantize_int8_blocks_cuda(x)
    qp, sp = quant.quantize_int8_blocks_plain(x)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert torch.equal(qk, qp)
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2048), (2, 3, 512), (1, 256),
                                   (8, 1, 802816), (3, 7, 256)])
def test_quant_kernel_bit_equal_to_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    n = shape[-1] // 256
    mag = torch.exp(3 * torch.randn(shape[:-1] + (n, 1), generator=g,
                                    device=cuda))
    x = torch.randn(shape[:-1] + (n, 256), generator=g, device=cuda) * mag
    _assert_kernel_equals_plain(x.reshape(shape).to(dtype))


def test_quant_kernel_edge_blocks(cuda):
    x = torch.zeros(4, 256, device=cuda)
    x[1, :3] = torch.tensor([math.inf, -math.inf, math.nan])
    x[1, 3:] = torch.linspace(-2, 2, 253)
    x[2] = math.nan
    x[3, 0] = 127.0
    x[3, 1:] = (torch.arange(-126, 129, device=cuda)[:255] - 0.5).clamp(
        -126.5, 126.5)
    for dtype in (torch.float32, torch.bfloat16):
        _assert_kernel_equals_plain(x.to(dtype))
    _assert_kernel_equals_plain(x[3:] / 8)


def test_quant_kernel_dispatch_and_refusals(cuda):
    x = torch.randn(2, 512, device=cuda)
    before = KERNEL.launches
    quant.quantize_int8_blocks(x)  # a CUDA tensor goes to the kernel
    assert KERNEL.launches == before + 1
    with pytest.raises(TypeError, match="dtype"):
        quantize_int8_blocks_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8_blocks_cuda(torch.randn(512, 2, device=cuda).t())
    with pytest.raises(ValueError, match="aligned"):
        quantize_int8_blocks_cuda(torch.randn(520, device=cuda)[1:257])
    with pytest.raises(ValueError, match="multiple"):
        quantize_int8_blocks_cuda(torch.randn(2, 300, device=cuda))
    assert KERNEL.launches == before + 1


def test_int8_pipeline_on_card_launches_once_per_step(cuda):
    """The ring engine on the card goes through the kernel once per step,
    and agrees with the same pipeline on the CPU (plain quantizer) to one
    quant step of the output block (cuDNN and the CPU sum convolutions in
    different orders, which can move a value across a rounding boundary)."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, models, partition

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal(
        (5, 2, 32, 32, 3)).astype(np.float32)
    stages = partition(g, num_stages=4)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = SpmdPipeline(stages, params, device=dev, microbatch=2,
                            chunk=3, wire="int8")
        before = KERNEL.launches
        outs[str(dev)] = pipe.run(x)
        launched = KERNEL.launches - before
        assert launched == (pipe.metrics.steps if dev == cuda else 0)
    cpu, gpu = outs["cpu"], outs[str(cuda)]
    assert np.abs(gpu - cpu).max() <= np.abs(cpu).max() / 127
    assert (gpu.argmax(-1) == cpu.argmax(-1)).all()
