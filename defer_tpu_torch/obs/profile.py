"""Stage-interior profiling plane.

The port of ``defer_tpu.obs.profile``.  Three instruments that compose
with the live observability plane instead of replacing it:

* **Phase decomposition** — the compute loops split each frame's opaque
  ``infer`` interval into named phases (``dispatch``: the program call
  returning, ``device``: the wait on the frame's CUDA event,
  ``host_sync``: the copy to the host); this module owns the phase NAME
  table and the session arithmetic over the per-node histograms the loops
  feed.
* **Recompile telemetry** — the port compiles at run time in three places,
  and each calls :func:`record_compile` when it does: a CUDA-graph capture
  (``runtime/cuda_graph.capture``, which the ring engine, the decoder, the
  serving engine and ``utils/profiling.measured_node_costs`` share), a
  ``torch.export`` trace or artifact load (``utils/export.py``) and a hand
  kernel's ``nvcc`` build (``ops/_build.py``).  :class:`RecompileWatcher`
  counts them per process (the ``compiles`` counter, read as
  ``recompiles`` in ``stats`` and pushes, the JAX package's key) and emits
  ONE ``recompile`` flight-recorder event per compile episode once armed;
  :meth:`~RecompileWatcher.wrap` is the shape-signature fallback for a
  callable that compiles behind no hook.  Nothing of torch is patched.
* **Memory telemetry** — :func:`device_memory_bytes` reads the caching
  allocator's live bytes (``torch.cuda.memory_allocated``) without
  touching CUDA in a process that never used it (``None`` there and on
  the CPU); :class:`MemoryWatcher` turns it into the ``device.mem_bytes``
  gauge plus a thresholded ``mem_pressure`` event (hysteresis re-arm at
  90% of the threshold, the card's total from ``torch.cuda.mem_get_info``
  as the limit).

:class:`ProfileSession` is the on-demand half: a node's
``profile_start``/``profile_stop`` control commands bracket a window and
reply with the DELTA phase breakdown (counts and summed seconds per phase
over exactly that window), the recompiles and hand-kernel launches inside
it, and the live-memory reading; with ``trace_dir`` the window is also
recorded by ``torch.profiler`` into a Chrome trace there.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from .events import emit as emit_event
from .registry import REGISTRY

#: the named phases of one frame through a stage node's compute loop, in
#: wall order.  ``dispatch`` + ``queue`` + ``device`` + ``host_sync`` tiles
#: ``infer``, which stays the issue-to-materialize total.  ``queue`` is the
#: frame's residency in the un-synced window between its dispatch
#: returning and its drain turn: ~0 in the serial loop, and in the
#: overlapped loop the latency the pipeline HIDES.
NODE_PHASES = ("dispatch", "queue", "device", "host_sync")

#: the decode engine's per-step phases (serve/engine.py): host-side gather
#: of the per-slot rows, the step's dispatch, device wait, host sync of the
#: sampled ids, and per-slot delivery.  Sampling and the KV write run
#: inside the step's graph, so they are part of ``device`` here; splitting
#: them needs the profile CLI's ``--torch-trace-dir``, not host timers.
ENGINE_PHASES = ("gather", "dispatch", "device", "sync", "delivery")


def _fmt_shapes(args) -> list[str]:
    """``float32[8,128]``-style abstract shapes for event payloads
    (tensors and arrays only; anything else by its type name)."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            name = str(dtype).removeprefix("torch.")
            out.append(f"{name}[{','.join(str(s) for s in shape)}]")
        else:
            out.append(type(a).__name__)
    return out


class RecompileWatcher:
    """Counts run-time compilations in this process and emits ONE
    ``recompile`` flight-recorder event per compile EPISODE.

    An episode is a burst of compiles separated from the previous burst by
    at least ``episode_gap_s`` of quiet: the first compile of a burst
    emits (carrying the via/label/shape attribution), the rest only count,
    so a shape change on a hot loop produces exactly one event, and the
    captures and loads of a warm-up before :meth:`arm` produce none.
    Counting is always on; event emission starts at :meth:`arm`.
    """

    def __init__(self, *, episode_gap_s: float = 5.0):
        self.episode_gap_s = float(episode_gap_s)
        self._lock = threading.Lock()
        self._armed = False
        self._last_t: float | None = None
        self._compiles = REGISTRY.counter("compiles")
        self._compile_s = REGISTRY.histogram("compile_s")

    @property
    def count(self) -> int:
        return self._compiles.value

    def arm(self) -> None:
        """Start (or restart) event emission: the NEXT compile opens a
        fresh episode and emits.  Call after warm-up."""
        with self._lock:
            self._armed = True
            self._last_t = None

    def disarm(self) -> None:
        """Stop event emission (counting continues)."""
        with self._lock:
            self._armed = False

    def wrap(self, fn, label: str = ""):
        """Shape-signature fallback: returns ``fn`` wrapped so a call whose
        signature (shape and dtype per argument) was never seen before is
        recorded as a compilation, with the abstract shapes attached to
        the event."""
        seen: set = set()
        lock = threading.Lock()

        def wrapped(*args, **kwargs):
            sig = tuple(_fmt_shapes(args))
            with lock:
                fresh = sig not in seen
                if fresh:
                    seen.add(sig)
            if fresh:
                self.record(0.0, via="wrap", label=label, shapes=list(sig))
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    def record(self, dur: float, *, via: str, label=None,
               shapes=None) -> None:
        """Count one compilation of ``dur`` seconds, made by ``via``."""
        self._compiles.inc()
        if dur:
            self._compile_s.record(dur)
        now = time.monotonic()
        with self._lock:
            quiet = (self._last_t is None
                     or now - self._last_t >= self.episode_gap_s)
            self._last_t = now
            # episode discipline: only the first compile after
            # episode_gap_s of quiet emits; the rest of the burst counts
            fire = self._armed and quiet
        if fire:
            data = {"count": self._compiles.value, "via": via}
            if label:
                data["label"] = label
            if shapes:
                data["shapes"] = shapes
            emit_event("recompile", **data)


def record_compile(dur: float, *, via: str, label=None) -> None:
    """The hook each compile point calls: one compilation of ``dur``
    seconds (``via`` names the kind: ``cuda_graph``, ``export.trace``,
    ``export.load``, ``nvcc``)."""
    recompile_watcher().record(dur, via=via, label=label)


def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None where this process
    has no CUDA to read (the CPU, or CUDA never initialised here and
    ``ensure`` not set by the caller)."""
    import torch
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return dev
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def device_memory(ensure: bool = False, device=None
                  ) -> tuple[int, int] | None:
    """(live bytes, live allocations) of the caching allocator on
    ``device`` (default: the current card) — ``None`` on the CPU, and where
    this process never initialised CUDA (``ensure=True`` initialises it).
    Cheap enough for the push cadence, not for the per-frame hot path."""
    if "torch" not in sys.modules and not ensure:
        return None
    import torch
    if not ensure and not torch.cuda.is_initialized():
        return None
    dev = _cuda_device(device)
    if dev is None:
        return None
    n = torch.cuda.memory_allocated(dev)
    count = torch.cuda.memory_stats(dev).get("allocation.all.current", 0)
    return int(n), int(count)


def device_memory_bytes(ensure: bool = False, device=None) -> int | None:
    mem = device_memory(ensure, device)
    return None if mem is None else mem[0]


class MemoryWatcher:
    """Publishes the allocator's live bytes as the ``device.mem_bytes``
    gauge and emits a ``mem_pressure`` event when a threshold is crossed
    (one per excursion: re-arms below 90% of the threshold).

    The threshold, first match wins: :meth:`set_threshold`, the
    ``DEFER_MEM_PRESSURE_BYTES`` environment variable (absolute bytes), or
    ``DEFER_MEM_PRESSURE_FRAC`` (default 0.9) of the card's total memory
    (``torch.cuda.mem_get_info``).  No threshold -> gauge only, no events.
    """

    def __init__(self):
        self._threshold: float | None = None
        self._armed = True
        self._gauge = REGISTRY.gauge("device.mem_bytes")

    def set_threshold(self, n_bytes: float | None) -> None:
        self._threshold = None if n_bytes is None else float(n_bytes)

    def threshold_bytes(self, device=None) -> float | None:
        if self._threshold is not None:
            return self._threshold
        env = os.environ.get("DEFER_MEM_PRESSURE_BYTES")
        if env:
            return float(env)
        dev = _cuda_device(device)
        if dev is None:
            return None
        import torch
        _, total = torch.cuda.mem_get_info(dev)
        frac = float(os.environ.get("DEFER_MEM_PRESSURE_FRAC", "0.9"))
        return total * frac

    def observe(self, device=None) -> int | None:
        """One reading: update the gauge, check the threshold.  Called
        from ``obs_snapshot`` (per push), never per frame."""
        mem = device_memory(device=device)
        if mem is None:
            return None
        n, allocs = mem
        self._gauge.v = float(n)
        thr = self.threshold_bytes(device)
        if thr:
            if self._armed and n > thr:
                self._armed = False
                emit_event("mem_pressure", bytes=n, threshold=int(thr),
                           live_arrays=allocs)
            elif not self._armed and n < 0.9 * thr:
                self._armed = True
        return n


class _TorchTrace:
    """``torch.profiler`` over a window, on a thread of its own: the
    profiler's state belongs to the thread that starts it, and a node's
    ``profile_start`` and ``profile_stop`` arrive on two connections (two
    threads).  Kernels are recorded process-wide on the card, so the
    trace holds every node thread's launches."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.path: str | None = None
        self.error: str | None = None
        self._started = threading.Event()
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="torch-profiler")

    def start(self) -> None:
        self._thread.start()
        self._started.wait(60.0)

    def _run(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — a profiler that cannot
            # start must not fail the session; the phases still answer
            self.error = repr(e)
            self._started.set()
            return
        self._started.set()
        self._halt.wait()
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(
                self.trace_dir,
                f"trace-{os.getpid()}-{time.time_ns() // 1000}.json")
            prof.export_chrome_trace(path)
            self.path = path
        except Exception as e:  # noqa: BLE001 — symmetric guard
            self.error = repr(e)

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(120.0)


class ProfileSession:
    """One ``profile_start`` .. ``profile_stop`` window on a node: a
    baseline snapshot of the phase histograms at start, a delta breakdown
    at stop.

    The phase histograms are cumulative (they feed stats and pushes for
    the process lifetime); the session subtracts its start snapshot so the
    reply prices exactly the profiled window: per-phase ``count``,
    ``sum_s`` and ``mean_ms`` (exact over the window) and the cumulative
    p50 for context.  ``launches`` (a callable returning each hand
    kernel's launches) adds the window's ``kernel_launches``; ``device``
    is the card whose memory the reply reads."""

    def __init__(self, hists: dict, *, processed=None, launches=None,
                 trace_dir: str | None = None, device=None):
        #: name -> LatencyHistogram | None (absent phases stay None)
        self._hists = dict(hists)
        self._processed = processed  # callable -> int, or None
        self._launches = launches    # callable -> {name: count}, or None
        self._trace_dir = trace_dir
        self._device = device
        self._trace: _TorchTrace | None = None
        self._t0: float | None = None
        self._base: dict | None = None

    @staticmethod
    def _snap(h) -> tuple[int, float]:
        if h is None:
            return 0, 0.0
        s = h.summary()
        return int(s.get("count", 0)), float(s.get("sum", 0.0))

    def start(self) -> dict:
        if self._t0 is not None:
            raise RuntimeError("profile session already started")
        watcher = recompile_watcher()
        self._base = {name: self._snap(h)
                      for name, h in self._hists.items()}
        self._base_compiles = watcher.count
        self._base_processed = (self._processed()
                                if self._processed else 0)
        self._base_launches = (dict(self._launches())
                               if self._launches else {})
        if self._trace_dir:
            self._trace = _TorchTrace(self._trace_dir)
            self._trace.start()
            if self._trace.error:
                print(f"profile: torch.profiler unavailable "
                      f"({self._trace.error})", file=sys.stderr, flush=True)
        self._t0 = time.perf_counter()
        return {"t0_unix": time.time()}

    def stop(self) -> dict:
        if self._t0 is None:
            raise RuntimeError("profile session never started")
        dt = time.perf_counter() - self._t0
        trace = self._trace
        if trace is not None and trace.error is None:
            trace.stop()
            if trace.error:
                print(f"profile: torch.profiler trace failed "
                      f"({trace.error})", file=sys.stderr, flush=True)
        watcher = recompile_watcher()
        phases = {}
        for name, h in self._hists.items():
            c1, s1 = self._snap(h)
            c0, s0 = self._base[name]
            dc, ds = c1 - c0, s1 - s0
            phases[name] = {
                "count": dc,
                "sum_s": round(ds, 6),
                "mean_ms": round(ds / dc * 1e3, 4) if dc else None,
                "p50_ms_cum": (round(float(h.summary().get(
                    "p50", 0.0)) * 1e3, 4) if h is not None else None),
            }
        traced = trace is not None and trace.path is not None
        doc = {
            "duration_s": round(dt, 6),
            "phases": phases,
            "recompiles": watcher.count - self._base_compiles,
            "mem_bytes": device_memory_bytes(device=self._device),
            "trace_dir": self._trace_dir if traced else None,
            "trace_file": trace.path if traced else None,
        }
        if self._processed is not None:
            doc["processed"] = self._processed() - self._base_processed
        if self._launches is not None:
            now = self._launches()
            doc["kernel_launches"] = {
                k: v - self._base_launches.get(k, 0)
                for k, v in now.items()}
        self._t0 = None
        return doc


_WATCHER: RecompileWatcher | None = None
_MEM: MemoryWatcher | None = None
_LOCK = threading.Lock()


def recompile_watcher() -> RecompileWatcher:
    """This process's recompile watcher."""
    global _WATCHER
    with _LOCK:
        if _WATCHER is None:
            _WATCHER = RecompileWatcher()
        return _WATCHER


def memory_watcher() -> MemoryWatcher:
    global _MEM
    with _LOCK:
        if _MEM is None:
            _MEM = MemoryWatcher()
        return _MEM
