"""Where a pipeline-training chunk's time goes, on the card.

    python scripts/torch_train_profile.py [--rounds 3]

``PipelineTrainer.loss_and_grad`` runs eagerly: each of the chunk's
M + N - 1 ring steps launches every stage's forward, its recompute and its
backward one kernel at a time.  For the two training cells of
``chip_smoke.py`` phase 4r — ResNet50 at the paper's eight cuts (224²,
microbatch 8, 4 microbatches, ``wire="int8"``, f32 with TF32 off) and
GPT-2 small in 12 stages (``attn_impl="xla"``, 4 microbatches of 8
sequences of 64 tokens, the next-token loss) — on seed-0 weights, the
script prints the median wall of ``--rounds`` chunks after a warm-up, then
one chunk under ``torch.profiler`` (CUDA activity only): device time,
the device's idle share of the wall, the kernel count and each kernel
group's share of device time.  The last line is one JSON object.

It needs a CUDA card and takes about a minute.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: kernel groups (a kernel joins the first group whose pattern its name
#: contains; cuDNN's implicit-GEMM convolutions before cuBLAS's GEMMs)
GROUPS = {"quant_int8": ("quant_int8",),
          "conv (cuDNN, incl. layout)": ("fprop", "dgrad", "wgrad", "cudnn",
                                         "conv", "Nchw", "Nhwc", "nchw",
                                         "nhwc"),
          "matmul (cuBLAS)": ("gemm", "Gemm", "cutlass", "nvjet"),
          "copies": ("copy", "Memcpy"),
          "fills": ("FillFunctor",),
          "reductions": ("reduce_kernel",),
          "ring roll": ("roll_cuda",)}


def card_line() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile(torch, label: str, fn, rounds: int, card: str) -> dict:
    """Median wall of ``rounds`` calls of ``fn`` after one warm-up, and
    one more call's device time by kernel group under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device = sum(r[0] for r in rows) / 1e6
    if not device:
        raise SystemExit(f"{label}: no device time in the trace")
    shares = dict.fromkeys(GROUPS, 0.0)
    shares["everything else"] = 0.0
    for us, key, _ in rows:
        group = next((g for g, ms in GROUPS.items()
                      if any(m in key for m in ms)), "everything else")
        shares[group] += us / 1e6 / device
    res = {"wall_s": wall, "walls_s": walls, "device_s": device,
           "idle": max(0.0, 1 - device / wall),
           "kernels": sum(r[2] for r in rows), "shares": shares,
           "top": [[key[:90], round(us / 1e3, 3), n]
                   for us, key, n in sorted(rows, reverse=True)[:8]]}
    print(f"{label}: loss_and_grad {wall:.3f} s (median of {rounds}), "
          f"device {device:.3f} s (idle {res['idle'] * 100:.1f}%), "
          f"{res['kernels']} kernels; "
          + ", ".join(f"{g} {v * 100:.1f}%" for g, v in shares.items())
          + f"; on {card}", flush=True)
    for key, ms, n in res["top"]:
        print(f"   {ms:9.3f} ms  x{n:<6d} {key}", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from defer_tpu_torch import PipelineTrainer, SpmdPipeline, models
    from defer_tpu_torch.graph import with_attn_impl
    from defer_tpu_torch.partition import partition

    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    rng = np.random.default_rng(0)
    out = {"card": card}

    g = models.resnet50()
    stages = partition(g, models.RESNET50_8STAGE_CUTS)
    xs = rng.standard_normal((4, 8, 224, 224, 3)).astype(np.float32)
    ys = rng.integers(0, 1000, (4, 8))
    t = PipelineTrainer(SpmdPipeline(
        stages, g.init(torch.Generator().manual_seed(0)), device="cuda",
        microbatch=8, wire="int8"),
        lambda lg, y: torch.nn.functional.cross_entropy(lg.float(), y))
    out["resnet50_8_int8"] = profile(
        torch, "resnet50/8 int8 (4 x 8 images, 11 ring steps)",
        lambda: t.loss_and_grad(xs, ys), args.rounds, card)
    del t
    torch.cuda.empty_cache()

    g = with_attn_impl(models.gpt2_small(seq_len=64), "xla")
    stages = partition(g, models.gpt_stage_cuts(12, 12))
    ids = rng.integers(0, 50257, (4, 8, 64))

    def lm(logits, y):
        return torch.nn.functional.cross_entropy(
            logits[:, :-1].float().flatten(0, 1), y[:, 1:].flatten())

    t = PipelineTrainer(SpmdPipeline(
        stages, g.init(torch.Generator().manual_seed(0)), device="cuda",
        microbatch=8), lm)
    out["gpt2_small_12"] = profile(
        torch, "gpt2_small/12 (4 x 8 sequences of 64, 15 ring steps)",
        lambda: t.loss_and_grad(ids.astype(np.float32), ids), args.rounds,
        card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
