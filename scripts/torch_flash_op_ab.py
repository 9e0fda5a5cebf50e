"""The eager users of the flash kernel in one checkout of the PyTorch port.

    python scripts/torch_flash_op_ab.py ROOT [--label NAME]

ROOT is a checkout that holds ``chip_smoke.py`` and ``defer_tpu_torch/``.
The script builds the port's kernels there, then prints one JSON line:

* the host-clock wall of one eager call of ``flash_attention`` (the entry
  every model calls) and of ``flash_attention_cuda`` (the kernel's
  wrapper, called directly), at the shapes of GPT-2 small's fused prefill
  and ``Defer.score`` (median of 5 alternating rounds of 200 calls);
* ``chip_smoke.py``'s phase 4g (GPT-2 small through ``Defer.generate``
  with and without prefill, ``Defer.score`` and speculative decoding),
  whose prefill, score and speculative paths call the flash kernel
  eagerly, one call per block.

Run it on two checkouts one after the other on the same card (A B B A),
to compare how they dispatch the kernel.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

#: (B, H, Tq, Tk, D) of GPT-2 small's fused prefill and of its score calls
SHAPES = {"gpt2_prefill": (8, 12, 32, 32, 64),
          "gpt2_score": (8, 12, 128, 128, 64)}
CALLS = 200
ROUNDS = 5


def per_call_us(torch, fn) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA card")
    import chip_smoke as cs
    from defer_tpu_torch.ops import _build
    from defer_tpu_torch.ops.flash_attention import flash_attention
    from defer_tpu_torch.ops.flash_attention_cuda import (
        KERNEL as FLASH, flash_attention_cuda)
    from defer_tpu_torch.ops.quant_cuda import KERNEL as QUANT

    kernels = [QUANT, FLASH]
    _build.build([k.source for k in kernels])
    for k in kernels:
        k.load()
    card = cs.card_line()

    calls = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, h, tq, tk, d) in SHAPES.items():
        q = torch.randn(b, h, tq, d, device="cuda", generator=gen)
        k = torch.randn(b, h, tk, d, device="cuda", generator=gen)
        v = torch.randn(b, h, tk, d, device="cuda", generator=gen)
        entry, wrapper = [], []
        for _ in range(ROUNDS):
            entry.append(per_call_us(
                torch, lambda: flash_attention(q, k, v, causal=True)))
            wrapper.append(per_call_us(
                torch, lambda: flash_attention_cuda(q, k, v, causal=True)))
        calls[name] = {"entry_us": statistics.median(entry),
                       "wrapper_us": statistics.median(wrapper),
                       "entry_rounds_us": entry,
                       "wrapper_rounds_us": wrapper}

    t0 = time.perf_counter()
    dec, res = cs.gpt_path(torch, "cuda", kernels, card)
    del dec
    print(json.dumps({"flash_op_ab": {
        "label": args.label or str(root), "card": card, "calls": calls,
        "phase_4g_s": time.perf_counter() - t0,
        "ttft_prefill_s": res["ttft_s"]["prefill"],
        "tokens_per_s": res["tokens_per_s"],
        "tokens_per_s_prefill": res["tokens_per_s_prefill"],
        "score_sequences_per_s": res["score"]["sequences_per_s"],
        "speculative_wall_s": res["speculative"]["wall_s"],
        "flash_launches": {
            "prefill": res["launches"]["prefill_f32"]["flash_attention"],
            "score": res["score"]["launches"]["buffer"]["flash_attention"],
            "speculative": res["speculative"]["launches"][
                "flash_attention"]}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
