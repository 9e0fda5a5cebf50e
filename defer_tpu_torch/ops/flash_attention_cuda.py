"""Hand-written Hopper kernel for exact softmax attention (flash attention).

The counterpart of ``_attn_kernel`` in ``defer_tpu/ops/flash_attention.py``:
the CUDA C++ kernel in ``csrc/flash_attention.cu`` (its header says what
bounds it and how the design responds), built for ``sm_90a`` by
``ops/_build.py`` at first use and called through ctypes.  The wrapper
checks device, dtype, shape and layout, allocates the output, launches on
PyTorch's current stream, raises on a launch error, and counts its
launches in ``KERNEL.launches`` (and by dtype) — so a run can show that
its path went through the kernel; under a CUDA graph the ring engine keeps
the count (``ops/launches.py``).  Nothing here runs at import: the CPU
tests import this module.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _check, softmax_scale
from .launches import LaunchCounter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim the kernel takes (it pads D to 64 or 128)
MAX_HEAD_DIM = 128


class FlashAttentionKernel(LaunchCounter):
    """``csrc/flash_attention.cu``: its library, entry point and launch
    count."""

    name = "flash_attention"
    source = "flash_attention.cu"

    def __init__(self, defines: tuple[str, ...] = ()):
        super().__init__()
        #: macros the source is built with (``flash_timeline.py`` adds one)
        self.defines = defines
        self.lib = None
        self._fn = None
        self._err = None

    def load(self) -> None:
        """Build (if needed) and bind the library; idempotent."""
        if self._fn is not None:
            return
        lib = _build.load(self.source, self.defines)
        fn = lib.defer_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.defer_flash_attention_error
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self.lib, self._fn, self._err = lib, fn, err

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = False) -> torch.Tensor:
        for t in (q, k, v):
            if t.device.type != "cuda":
                raise ValueError(f"{self.name}: needs CUDA tensors, got one "
                                 f"on {t.device}")
        _check(q, k, v)
        if q.dtype not in _DTYPE_CODE:
            raise TypeError(f"{self.name}: dtype {q.dtype} not supported "
                            f"(float32 or bfloat16)")
        if not q.dtype == k.dtype == v.dtype:
            raise TypeError(f"{self.name}: q, k, v dtypes differ "
                            f"({q.dtype}, {k.dtype}, {v.dtype})")
        b, h, t_q, d = q.shape
        t_k = k.shape[2]
        if d > MAX_HEAD_DIM:
            raise ValueError(f"{self.name}: head dim {d} above the kernel's "
                             f"limit of {MAX_HEAD_DIM} (ROADMAP queue B)")
        if max(b * h, t_q, t_k) >= 2 ** 31:
            raise ValueError(f"{self.name}: B*H, Tq and Tk must each be "
                             f"below 2**31")
        for t in (q, k, v):
            if t.stride(3) != 1 and t.shape[3] > 1:
                raise ValueError(f"{self.name}: the head dim must be "
                                 f"contiguous (stride {t.stride()})")
        o = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
        if o.numel() == 0:
            return o
        self.load()
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = self._fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), *strides, b, h, t_q, t_k, d,
                            softmax_scale(d), int(causal),
                            _DTYPE_CODE[q.dtype], stream)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        self.count(q.dtype)
        return o


#: the process's one instance (its ``launches`` is the count a run reads)
KERNEL = FlashAttentionKernel()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False) -> torch.Tensor:
    """[B,H,Tq,D] x [B,H,Tk,D] CUDA tensors -> [B,H,Tq,D] in q's dtype,
    equal to ``flash_attention.flash_attention_plain`` up to f32 rounding."""
    return KERNEL(q, k, v, causal)
