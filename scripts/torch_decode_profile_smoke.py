"""Decode steady-state X-ray: zero recompiles, accounted dispatches.

The mb64 bf16 decode cliff (docs/DECODE_CLIFF.md, DECODE_r05.json:
560 ms/token-step against 26 ms for the int8-KV variant of the SAME
shapes, with a 96.8 s first call) is a compile-side pathology, so the
guard this smoke pins down is the mechanism the cliff would have to
break through on the host side:

1. ZERO STEADY-STATE RECOMPILES: after one warmup ``generate``, a
   second ``generate`` with identical arguments must capture or
   compile ZERO times (the decoder's graphs are keyed by
   ``(chunk_steps, sample, top_k)`` — ``runtime/decode.py``), measured
   by the port's ``RecompileWatcher`` (its ``compiles`` counter: CUDA-
   graph captures, program traces and loads; the JAX script reads the
   ``jax.monitoring`` compile listener), and must emit no
   ``recompile`` flight-recorder event while armed.
2. ACCOUNTED DISPATCHES: the steady-state run performs EXACTLY
   ``ceil(num_steps / chunk_steps)`` scan dispatches (the
   ``decode.dispatches`` counter) — no hidden per-token host round
   trips — and the summed ``decode.dispatch_s`` stays a sane share of
   the generation wall (<= ~1: dispatch cannot exceed the wall it is
   part of).

Shapes are the CPU-smoke geometry of ``scripts/bench_decode.py``
(gpt 4L / d=64 / 2 heads / vocab 128, mb=4, 16 new tokens,
token_chunk=32), so this is the same program family the decode bench
drives — only the backend differs.  Exit 0 on success; one JSON row on
stdout (the ``decode_profile`` row of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/decode_profile_smoke.py``, on
``--device`` (the card by default).  Every count is read as a delta from
the smoke's own start, so ``main(argv)`` may run in a process whose
registry already holds other work.
"""

import argparse
import json
import math
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: the ``--device`` of this run (``main`` sets it): the decoder runs there
DEVICE = None


def pick_device(name):
    """``--device`` as the port's command line reads it (``cuda``,
    ``cuda:N``, ``cpu`` or a bare index N); the card when ``None``.
    Asked for the card where there is none, it raises.  On the CPU the
    decoder runs on one intra-op thread, as the port's CPU tests do."""
    import torch

    from defer_tpu_torch.utils.config import resolve_device
    if name is not None and name.isdigit():
        name = f"cuda:{name}"
    dev = resolve_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    else:
        # TF32 off, as the port's command line runs (``_no_tf32``)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="accepted for CI symmetry; the smoke is "
                         "already the small CPU geometry")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--token-chunk", type=int, default=32)
    ap.add_argument("--max-dispatch-share", type=float, default=1.02,
                    help="summed dispatch seconds / generation wall "
                         "upper bound (dispatch is part of the wall; "
                         "> 1 means double counting)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)

    import numpy as np

    import torch

    from defer_tpu_torch.models import gpt
    from defer_tpu_torch.obs import recompile_watcher, recorder
    from defer_tpu_torch.obs.registry import REGISTRY
    from defer_tpu_torch.runtime.decode import PipelinedDecoder

    layers, d, heads, vocab = 4, 64, 2, 128
    max_len, plen = 48, 8
    mb, new = args.microbatch, args.new_tokens

    graph = gpt(layers, d, heads, max_len, vocab=vocab)
    params = graph.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, vocab, size=(mb, plen)).astype(np.int32)

    # the port's watcher counts from process start (the JAX script
    # installs a jax.monitoring listener here); read it from this point
    watcher = recompile_watcher()
    watcher.disarm()
    c0 = watcher.count
    rec = recorder()

    dec = PipelinedDecoder(graph, params, num_stages=1, microbatch=mb,
                           max_len=max_len, device=DEVICE)
    kw = dict(max_new_tokens=new, token_chunk=args.token_chunk)

    t0 = time.perf_counter()
    toks = dec.generate(prompt, **kw)           # compile + run
    first_call_s = time.perf_counter() - t0
    assert toks.shape == (mb, plen + new), toks.shape
    c_warm = watcher.count - c0
    # on the card the warm-up captures the decoder's CUDA graphs; on the
    # CPU the decoder runs eagerly and nothing compiles, so there the
    # zero below holds trivially
    assert c_warm > 0 or DEVICE.type == "cpu", (
        "warmup generate captured zero graphs — the compile counter is "
        "not hooked, so the zero-recompile claim below would be vacuous")

    # steady state: identical args -> pure program-cache hits
    watcher.arm()
    ev0 = sum(1 for e in rec.snapshot() if e["kind"] == "recompile")
    d_count = REGISTRY.counter("decode.dispatches")
    d_hist = REGISTRY.histogram("decode.dispatch_s")
    n0, s0 = d_count.value, d_hist.summary().get("sum", 0.0)
    t0 = time.perf_counter()
    toks2 = dec.generate(prompt, **kw)
    wall_s = time.perf_counter() - t0
    recompiles = watcher.count - c0 - c_warm
    events = sum(1 for e in rec.snapshot()
                 if e["kind"] == "recompile") - ev0
    assert recompiles == 0, (
        f"steady-state generate compiled {recompiles} time(s) — the "
        f"decode program cache is not keying these calls identically")
    assert events == 0, f"{events} recompile event(s) in steady state"
    np.testing.assert_array_equal(toks, toks2)

    # dispatch accounting: the schedule's chunk count, nothing more
    dispatches = d_count.value - n0
    num_steps, chunk_steps = dec._schedule(plen + new, 0,
                                           args.token_chunk)
    want = math.ceil(num_steps / chunk_steps)
    assert dispatches == want, (
        f"steady-state generate made {dispatches} dispatches, "
        f"schedule says {want} ({num_steps} steps / {chunk_steps} "
        f"per chunk)")
    disp_s = d_hist.summary().get("sum", 0.0) - s0
    share = disp_s / wall_s
    assert share <= args.max_dispatch_share, (
        f"dispatch share {share:.3f} exceeds "
        f"{args.max_dispatch_share} — dispatch seconds larger than "
        f"the wall they live in")

    tps = mb * new / wall_s
    log(f"decode steady state: {tps:.1f} tok/s ({wall_s * 1e3:.1f} ms "
        f"for {new} tokens x mb{mb}), {dispatches} dispatches "
        f"(schedule {want}), dispatch share {share:.3f}, warmup "
        f"{c_warm} compiles in {first_call_s:.2f}s, steady recompiles "
        f"0, events 0")
    row = {"metric": "decode_profile", "value": round(tps, 2),
           "unit": "tokens/sec",
           "recompiles_steady": recompiles,
           "recompile_events_steady": events,
           "warmup_compiles": c_warm,
           "first_call_s": round(first_call_s, 3),
           "wall_s": round(wall_s, 4),
           "dispatches": dispatches,
           "chunk_steps": chunk_steps,
           "dispatch_share": round(share, 4),
           "config": {"layers": layers, "d_model": d, "heads": heads,
                      "vocab": vocab, "prompt_len": plen,
                      "new_tokens": new, "microbatch": mb,
                      "token_chunk": args.token_chunk},
           "cpu_count": os.cpu_count() or 1}
    print(json.dumps(row))
    log("decode profile smoke: OK")


if __name__ == "__main__":
    main()
