"""Launch counts of the port's CUDA kernels, kept true under CUDA graphs.

Rule: a kernel's ``launches`` counts its executions, and ``by_dtype``
splits the same count by the dtype it ran in.  The wrapper adds one where
it launches the kernel.  A CUDA-graph replay runs no Python, so the ring
engine (``runtime/spmd.py``) keeps the counts itself: a capture takes a
:meth:`LaunchCounter.snapshot` of every kernel, records what the capture
added as the graph's own count (:meth:`LaunchCounter.since`) and restores
the snapshot, so neither the capture nor its eager warm-up pass counts;
each replay then adds the graph's count (:meth:`LaunchCounter.add`).
A capture helper that may run beside other threads' launches (a node's
first frame, ``runtime/cuda_graph.py``) counts its own thread's launches
apart instead (:func:`counted_apart`), leaving the process's counts to
the other threads.
"""

from __future__ import annotations

import collections
import contextlib
import threading

#: per thread: where :func:`counted_apart` sends this thread's launches
_THREAD = threading.local()


class LaunchCounter:
    """``launches`` (all dtypes) and ``by_dtype`` (``{"float32": n}``)."""

    def __init__(self):
        #: kernel executions in this process (``zero()`` to count a run)
        self.launches = 0
        #: the same count by dtype name
        self.by_dtype: collections.Counter = collections.Counter()

    def count(self, dtype) -> None:
        """One launch of the kernel in ``dtype`` (a ``torch.dtype``)."""
        apart = getattr(_THREAD, "apart", None)
        target = self if apart is None else apart.setdefault(
            self, LaunchCounter())
        target.launches += 1
        target.by_dtype[str(dtype).removeprefix("torch.")] += 1

    def zero(self) -> None:
        self.launches = 0
        self.by_dtype.clear()

    def snapshot(self) -> tuple[int, collections.Counter]:
        return self.launches, collections.Counter(self.by_dtype)

    def restore(self, snap) -> None:
        self.launches, by_dtype = snap
        self.by_dtype = collections.Counter(by_dtype)

    def since(self, snap) -> tuple[int, collections.Counter]:
        """The launches counted after ``snap`` was taken."""
        n, by_dtype = snap
        return self.launches - n, self.by_dtype - by_dtype

    def add(self, delta) -> None:
        n, by_dtype = delta
        self.launches += n
        self.by_dtype.update(by_dtype)


@contextlib.contextmanager
def counted_apart():
    """Within the block this thread's launches count into the yielded dict
    (kernel -> its own :class:`LaunchCounter`), not into the kernels'
    counts; other threads' launches count as ever."""
    prev = getattr(_THREAD, "apart", None)
    _THREAD.apart = apart = {}
    try:
        yield apart
    finally:
        _THREAD.apart = prev


def counted_kernels() -> tuple[LaunchCounter, ...]:
    """The process's kernel instances, looked up at call time (a caller may
    have put another instance in a module's ``KERNEL``)."""
    from . import flash_attention_cuda, quant_cuda
    return (quant_cuda.KERNEL, flash_attention_cuda.KERNEL)
