"""Build the port's CUDA kernels with ``nvcc``, and its host C++ with
``g++``, and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface, at first use, into ``defer_tpu_torch/_build/`` (listed
in ``.gitignore``).  Library names carry a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once, and counts each
build as one run-time compilation (``obs/profile.py``).

Flags: ``sm_90a`` (Hopper), ``-O3``, and NO ``--use_fast_math`` — the
quantizer's bit-exactness rests on IEEE division.  ``-Xptxas -v`` reports
each kernel's registers, shared memory and spills; :func:`build` returns
that log.

Host C++ (``csrc/codec.cpp``, ``csrc/staging.cpp``: the wire codecs and
the staging ring) builds with ``g++`` through :func:`build_host` into the
same directory, as ``libdefer<stem>-<hash>.so``, by the same rules.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

from ..obs.profile import record_compile

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


HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]


def _hashed(source: str, flags: list[str], prefix: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{prefix}{src.stem}-{h.hexdigest()[:16]}.so"


def lib_path(source: str, defines: tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<source>`` builds to (content- and flag-hashed)."""
    return _hashed(source, NVCC_FLAGS + [f"-D{d}" for d in defines], "lib")


def build_host(source: str, timeout: float = 120.0) -> dict:
    """Compile the host C++ ``csrc/<source>`` with ``g++`` unless built
    already.  Returns ``{"path", "seconds"}`` (seconds 0.0 when it was
    built already); raises ``RuntimeError`` when ``g++`` is missing or
    fails."""
    dst = _hashed(source, HOST_FLAGS, "libdefer")
    if dst.exists():
        return {"path": dst, "seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        out = subprocess.run(["g++", *HOST_FLAGS, "-o", str(tmp),
                              str(CSRC / source)], capture_output=True,
                             text=True, timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {source}: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source} (exit "
                           f"{out.returncode}):\n{out.stderr}")
    os.replace(tmp, dst)  # atomic: a reader never sees half a library
    return {"path": dst, "seconds": time.perf_counter() - t0}


def build(sources: list[str],
          defines: tuple[str, ...] = ()) -> dict[str, dict]:
    """Compile every source not built yet, all ``nvcc`` processes started
    together, with each of ``defines`` as a ``-D`` macro.  Returns
    ``{source: {"path", "seconds", "log"}}`` (seconds 0.0 and an empty log
    for a library that was already built).  Raises ``RuntimeError`` with
    nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    running = []
    for source in sources:
        dst = lib_path(source, defines)
        if dst.exists():
            out[source] = {"path": dst, "seconds": 0.0, "log": ""}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / source)]
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
        record_compile(seconds, via="nvcc", label=source)
        out[source] = {"path": dst, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(source: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (with ``defines``) if needed and load its
    library."""
    return ctypes.CDLL(str(build([source], defines)[source]["path"]))
