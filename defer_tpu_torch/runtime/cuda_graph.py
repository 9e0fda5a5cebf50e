"""One CUDA-graph capture, taken the same way by both engines.

The ring engine (``runtime/spmd.py``) captures a chunk of pipeline steps,
the decoder (``runtime/decode.py``) one token per group and its fused
prefill.  Each capture runs an eager warm-up pass first, on a side stream,
so that library set-up (kernel loading, ``cudaFuncSetAttribute``, cuBLAS
and cuDNN handles) happens outside the capture.  Neither pass counts as
kernel launches: both count apart from the process's counts, so other
threads' launches meanwhile still count, and the capture's launches become
the graph's own count, added at each replay (``ops/launches.py``).  The
stage nodes capture beside each other's work (``utils/export.py``).  Each capture is one
run-time compilation to the profiling plane (``obs/profile.py``
``record_compile``, labelled by the caller).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..obs.profile import record_compile
from ..ops.launches import LaunchCounter, counted_apart, counted_kernels


@dataclasses.dataclass
class CapturedGraph:
    graph: Any
    #: (kernel, launches) one replay makes
    launches: list
    #: device memory the capture reserved for the graph's pool
    pool_bytes: int

    def replay(self) -> None:
        self.graph.replay()
        for kernel, delta in self.launches:
            kernel.add(delta)


@torch.inference_mode()
def capture(fn: Callable[[], None], device: torch.device,
            warmup: Callable[[], None] | None = None, *,
            label: str = "") -> CapturedGraph:
    """Run ``warmup`` (default ``fn``) once eagerly on a side stream, then
    capture ``fn``.  The caller owns whatever state the warm-up wrote.
    ``label`` names the capture in its ``recompile`` event."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with counted_apart(), torch.cuda.stream(side):
        (warmup or fn)()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with counted_apart() as counted, torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        fn()
    pool = torch.cuda.memory_reserved(device) - reserved
    launches = [(k, counted.get(k, LaunchCounter()).snapshot())
                for k in counted_kernels()]
    record_compile(time.perf_counter() - t0, via="cuda_graph", label=label)
    return CapturedGraph(graph, launches, pool)
