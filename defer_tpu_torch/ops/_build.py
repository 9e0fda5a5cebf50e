"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface, at first use, into ``defer_tpu_torch/_build/`` (listed
in ``.gitignore``).  Library names carry a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and NO ``--use_fast_math`` — the
quantizer's bit-exactness rests on IEEE division.  ``-Xptxas -v`` reports
each kernel's registers, shared memory and spills; :func:`build` returns
that log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    """Path of ``nvcc`` in the toolkit PyTorch finds (``$CUDA_HOME``,
    ``$CUDA_PATH``, ``nvcc`` on ``PATH``, or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME
    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH (the CUDA kernels are built at first use)")
    return str(path)


def lib_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to (content- and flag-hashed)."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, dict]:
    """Compile every source not built yet, all ``nvcc`` processes started
    together.  Returns ``{source: {"path", "seconds", "log"}}`` (seconds
    0.0 and an empty log for a library that was already built).  Raises
    ``RuntimeError`` with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    running = []
    for source in sources:
        dst = lib_path(source)
        if dst.exists():
            out[source] = {"path": dst, "seconds": 0.0, "log": ""}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, dst, tmp, proc, time.perf_counter()))
    failures = []
    for source, dst, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {source} (exit "
                            f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, dst)  # atomic: a reader never sees half a library
        out[source] = {"path": dst, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load its library."""
    return ctypes.CDLL(str(build([source])[source]["path"]))
