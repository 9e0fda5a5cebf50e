"""Hand-written Hopper kernel for block-scale int8 wire quantization.

The counterpart of ``defer_tpu/ops/quant_pallas.py``: the CUDA C++ kernel
in ``csrc/quant_int8.cu`` (its header says what bounds it and how the
design responds), built for ``sm_90a`` by ``ops/_build.py`` at first use
and called through ctypes.  The wrapper checks device, dtype, shape,
contiguity and alignment, allocates the outputs, launches on PyTorch's
current stream, raises on a launch error, and counts its launches in
``KERNEL.launches`` — so a run can show that its path went through the
kernel.  Nothing here runs at import: the CPU tests import this module.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quant import BLOCK

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class QuantInt8Kernel:
    """``csrc/quant_int8.cu``: its library, entry point and launch count."""

    name = "quant_int8"
    source = "quant_int8.cu"

    def __init__(self):
        #: kernel launches made by this process (reset it to 0 to count a run)
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self) -> None:
        """Build (if needed) and bind the library; idempotent."""
        if self._fn is not None:
            return
        lib = _build.load(self.source)
        fn = lib.defer_quant_int8
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.defer_quant_int8_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, x: torch.Tensor):
        if x.device.type != "cuda":
            raise ValueError(f"{self.name}: needs a CUDA tensor, got one on "
                             f"{x.device}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{self.name}: dtype {x.dtype} not supported "
                            f"(float32 or bfloat16)")
        if x.dim() == 0 or x.shape[-1] % BLOCK:
            raise ValueError(f"{self.name}: last dim {tuple(x.shape)[-1:]} "
                             f"not a multiple of {BLOCK}")
        if not x.is_contiguous():
            raise ValueError(f"{self.name}: input must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{self.name}: input must be 16-byte aligned")
        *lead, n = x.shape
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty((*lead, n // BLOCK), dtype=torch.float32,
                        device=x.device)
        nblocks = x.numel() // BLOCK
        if nblocks == 0:
            return q, s
        self.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = self._fn(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                            nblocks, _DTYPE_CODE[x.dtype], stream)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        self.launches += 1
        return q, s


#: the process's one instance (its ``launches`` is the count a run reads)
KERNEL = QuantInt8Kernel()


def quantize_int8_blocks_cuda(x: torch.Tensor):
    """[..., L] f32/bf16 CUDA tensor -> ([..., L] int8, [..., L/256] f32),
    bit-equal to ``quant.quantize_int8_blocks_plain``."""
    return KERNEL(x)
