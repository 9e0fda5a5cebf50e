"""Where one CTA of the flash-attention kernel spends its cycles.

    python -m defer_tpu_torch.ops.flash_timeline [B H Tq Tk D] [--causal]

Builds ``csrc/flash_attention.cu`` with ``-DDEFER_FLASH_TIMELINE`` (a
library of its own, beside the plain build), in which thread 0 of each
warpgroup of CTA (0, 0) records ``clock64()`` as each phase ends: loads
issued, Q split, and for each key tile landed, split, S, softmax and P V,
then the division and the stores.  Runs the kernel on N(0, 1) f32 inputs
(default: the BERT-Base shape 8 12 128 128 64), three times behind a
device sleep so that the clocks are up, and prints the last run's phases
in cycles from the CTA's start, with the card's name and power limit.
Clock reads order only against the kernel's barriers and ``wgmma`` waits,
so a phase's edge may move by the latency of the instructions around it.
Needs a CUDA card; nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from .flash_attention_cuda import FlashAttentionKernel

DEFINE = "DEFER_FLASH_TIMELINE"
MARKS, MARK_TILES = 64, 11  # csrc/flash_attention.cu kMarks, kMarkTiles
TILE_PHASES = ("landed", "split", "S", "softmax", "P V")


def phase_names() -> dict[int, str]:
    names = {0: "start", 1: "loads issued", 2: "Q split", 60: "loop done",
             61: "divided", 62: "stored"}
    for j in range(MARK_TILES):
        for i, phase in enumerate(TILE_PHASES):
            names[3 + 5 * j + i] = f"tile {j} {phase}"
    return names


def timeline(b: int, h: int, tq: int, tk: int, d: int, causal: bool,
             seed: int = 0) -> list[list[tuple[str, int]]]:
    """Per warpgroup, ``(phase, cycles since the CTA's start)`` in the order
    the phases ended, for one launch at [b, h, tq, d] x [b, h, tk, d]."""
    kernel = FlashAttentionKernel(defines=(DEFINE,))
    kernel.load()
    lib = kernel.lib
    for fn in (lib.defer_flash_timeline_read, lib.defer_flash_timeline_clear):
        fn.restype = ctypes.c_int
    lib.defer_flash_timeline_read.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device="cuda")
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    marks = (ctypes.c_longlong * (2 * MARKS))()
    for _ in range(3):
        torch.cuda.synchronize()
        if lib.defer_flash_timeline_clear():
            raise RuntimeError("flash_timeline: clearing the marks failed")
        torch.cuda._sleep(20_000_000)
        kernel(q, k, v, causal)
        torch.cuda.synchronize()
        if lib.defer_flash_timeline_read(ctypes.addressof(marks)):
            raise RuntimeError("flash_timeline: reading the marks failed")
    names = phase_names()
    out = []
    for w in range(2):
        row = {i: marks[w * MARKS + i] for i in range(MARKS)
               if marks[w * MARKS + i]}
        t0 = row.get(0, 0)
        out.append([(names.get(i, str(i)), row[i] - t0)
                    for i in sorted(row, key=row.get)])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", nargs="*", type=int,
                    default=[8, 12, 128, 128, 64], help="B H Tq Tk D")
    ap.add_argument("--causal", action="store_true")
    args = ap.parse_args(argv)
    if len(args.shape) != 5:
        ap.error("shape is B H Tq Tk D")
    if not torch.cuda.is_available():
        ap.error("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"flash_attention timeline, CTA (0, 0), shape {args.shape} f32 "
          f"causal={args.causal}, on {card}")
    for w, rows in enumerate(timeline(*args.shape, args.causal)):
        print(f"warpgroup {w}: cycles since start (+ since the last phase)")
        prev = 0
        for name, t in rows:
            print(f"  {name:18s} {t:8d}  (+{t - prev})")
            prev = t
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
