#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``defer_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

  1. card   — name and power limit from nvidia-smi;
  2. build  — every CUDA kernel of the port, from ``defer_tpu_torch/csrc``,
              with nvcc for sm_90a (one nvcc per source, all at once);
  3. kernel — each kernel against its plain PyTorch version on the card at
              the main paths' shapes plus edge cases (the quantizer
              bit-equal; flash attention to 1e-5 in f32 and one bf16 ulp
              in bf16, rows with no live key exactly 0, long causal and
              misaligned layouts included), then timed with CUDA events
              beside the plain version, the card's bound for the same
              work and, where one exists, the PyTorch library call that
              computes the same function (flash attention also on the
              long causal prefill beside SDPA's causal mode);
  4. main   — two paths, each driven through ``Defer.run`` with the kernel
              launch counts zeroed just before every run and read just
              after; outputs are held against the whole-graph forward on
              the card (TF32 off), then alternating timed rounds give
              throughput and a one-chunk profile gives device time by
              kernel:
                a. ResNet50 at full width, cut at the reference's
                   eight-stage list, ``wire="int8"`` (one quantizer launch
                   per pipeline step) and ``wire="buffer"``;
                b. BERT-Base at full width and depth (seq 128), one encoder
                   block per stage in 12 stages, ``wire="buffer"`` and
                   ``wire="int8"`` (12 flash-attention launches per step;
                   one quantizer launch per step under int8, none under
                   buffer);
  5. report — the ``kernels`` JSON line, the card line, and the last line
              ``{"ok": true, "device": {...}}``.

Weights are the port's own seeded random initialisation; inputs come from
``numpy`` with a fixed seed.  Needs one card; exits non-zero without CUDA
or without the ``defer_tpu_torch`` package beside it.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
MICROBATCH = 8
CHUNK = 4
IMAGE_SIZE = 224
#: int8-wire bound against the full-precision forward: max |error| over
#: the logits <= this fraction of max |logit|.  Each of the 8 hops adds at
#: most half a quant step (1/254 of its block's max) per value; 5% leaves
#: room for the network to amplify eight such perturbations.
INT8_REL_BOUND = 0.05
#: the buffer wire moves f32 values unchanged: pipeline == forward up to
#: cuDNN choosing another algorithm for a stage's slice of the graph
BUFFER_REL_BOUND = 1e-5
#: BERT-Base sequence length (BASELINE.md config 5)
SEQ_LEN = 128
#: flash attention against its plain version, f32 on N(0,1) inputs: the
#: kernel forms each product from three TF32 terms (about 1e-6 off exact
#: f32, tests/test_torch_flash_tf32.py) and sums in another order
FLASH_F32_TOL = 1e-5
#: (name, B, H, Tq, Tk, D, causal, dtype): the BERT-Base shape at
#: microbatch 8 (f32 and bf16), the JAX package's flash-attention test
#: cases, D = 128 (one and several key tiles), Tq=5 against Tk=3 causal,
#: whose rows 0 and 1 see no key, a long causal prefill (16 key tiles
#: through the ring), and two layouts that take the kernel's element-wise
#: staging: 20-byte rows (D = 5) and views one element past an allocation
FLASH_CASES = [
    ("bert_base", 8, 12, 128, 128, 64, False, "float32"),
    ("blocks", 2, 3, 64, 64, 16, False, "float32"),
    ("padding_causal", 1, 2, 100, 100, 24, True, "float32"),
    ("tq_ne_tk", 2, 2, 37, 53, 8, False, "float32"),
    ("two_q_tiles_causal", 1, 1, 130, 130, 64, True, "float32"),
    ("decode_tq1", 1, 2, 1, 48, 16, True, "float32"),
    ("decode_tq5", 1, 2, 5, 48, 16, True, "float32"),
    ("bf16", 1, 2, 64, 64, 32, False, "bfloat16"),
    ("d128", 2, 4, 128, 128, 128, False, "float32"),
    ("zero_rows", 1, 2, 5, 3, 16, True, "float32"),
    ("long_causal", 1, 12, 1024, 1024, 64, True, "float32"),
    ("d128_key_tiles_causal", 2, 2, 70, 150, 128, True, "float32"),
    ("d5_rows", 2, 3, 40, 50, 5, False, "float32"),
    ("offset_view", 2, 3, 70, 90, 32, True, "float32"),
    ("bf16_bert_base", 8, 12, 128, 128, 64, False, "bfloat16"),
]

#: device memory rate of the cards the smoke knows (bytes/s, data sheets)
MEM_RATE = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12)]
#: float32 rate outside the tensor cores, H100 SXM data sheet (flop/s)
F32_RATE = 67e12
#: TF32 tensor-core rate, H100 SXM data sheet (flop/s, dense)
TF32_RATE = 495e12
#: TF32 products per f32 product in the flash kernel (lo*hi + hi*lo + hi*hi)
TF32_TERMS = 3
#: device sleep queued ahead of a timed window (~50 ms at 2 GHz)
SLEEP_CYCLES = 100_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    fail(f"no memory rate known for card {name!r}; add it to MEM_RATE")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls back to back
    between two CUDA events, queued behind a device-side sleep so that the
    host's launch time stays out of the window (a microsecond kernel
    launched from Python would otherwise be timed at the host's pace)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms > ev[0].elapsed_time(ev[1]):
        print(f"time_ms: the host took {host_ms:.3f} ms to queue {iters} "
              "calls, longer than the device sleep before them: the time "
              "below includes host gaps", flush=True)
    return ev[1].elapsed_time(ev[2]) / iters


# ---------------------------------------------------------------------------
# phase 3: the quantizer against its plain version
# ---------------------------------------------------------------------------


def quant_inputs(torch, ring_shape, device):
    """The main-path ring shape with per-block magnitudes spread over ~6
    decades, plus edge blocks: zeros, +-inf/NaN, exact ties."""
    g = torch.Generator(device=device).manual_seed(SEED)
    n = ring_shape[-1]
    mag = torch.exp(3.0 * torch.randn(
        ring_shape[:-1] + (n // 256, 1), generator=g, device=device))
    ring = (torch.randn(ring_shape[:-1] + (n // 256, 256), generator=g,
                        device=device) * mag).reshape(ring_shape)
    edge = torch.zeros(4, 256, device=device)
    edge[1, :3] = torch.tensor([math.inf, -math.inf, math.nan])
    edge[1, 3:] = torch.linspace(-2.0, 2.0, 253)
    # ties: amax 127 -> scale 1, so k + 0.5 sits exactly on a half;
    # amax 127/8 -> scale 1/8, the same ties scaled by a power of two
    k = torch.arange(-126, 129, device=device, dtype=torch.float32)[:255]
    edge[2, 0] = 127.0
    edge[2, 1:] = (k - 0.5).clamp(-126.5, 126.5)
    edge[3] = edge[2] / 8.0
    return ring, edge


def check_quant(torch, ring_shape, device):
    """Bit-equality with the plain version, and timings.  Returns the
    kernel row of the report (without ``launches``)."""
    from defer_tpu_torch.ops.quant import quantize_int8_blocks_plain
    from defer_tpu_torch.ops.quant_cuda import KERNEL

    ring, edge = quant_inputs(torch, ring_shape, device)
    cases = {"ring_f32": ring, "ring_bf16": ring.to(torch.bfloat16),
             "edge_f32": edge, "edge_bf16": edge.to(torch.bfloat16)}
    max_err = 0.0
    for name, x in cases.items():
        qk, sk = KERNEL(x)
        qp, sp = quantize_int8_blocks_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(qk, qp)
                and torch.equal(sk.view(torch.int32), sp.view(torch.int32))):
            bad = (qk != qp).sum().item()
            fail(f"quant_int8 != plain on {name}: {bad} payload bytes differ,"
                 f" scales equal={torch.equal(sk, sp)}")
        max_err = max(max_err, (qk.int() - qp.int()).abs().max().item(),
                      (sk - sp).abs().max().item())
    print(f"kernel quant_int8: bit-equal to plain on "
          f"{', '.join(f'{k}{tuple(v.shape)}' for k, v in cases.items())}",
          flush=True)

    ms = time_ms(torch, lambda: KERNEL(ring))
    plain_ms = time_ms(torch, lambda: quantize_int8_blocks_plain(ring))
    values = ring.numel()
    nbytes = values * ring.element_size() + values + 4 * (values // 256)
    bytes_ms = nbytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
    # flush test, |x|, max, divide, round, clamp: ~6 f32 ops per value
    ops_ms = 6 * values / F32_RATE * 1e3
    return {"name": KERNEL.name, "route": "cuda",
            "source": "defer_tpu_torch/csrc/quant_int8.cu",
            "replaces": "defer_tpu/ops/quant_pallas.py:35",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": list(ring_shape),
            "dtype": "float32", "bytes": nbytes,
            "checked_by": "phase 3 (bit-equal vs plain) + phase 4 (main "
                          "path launches)"}


def bf16_ulp(torch, x):
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_flash(torch, device):
    """Flash attention against its plain version on every case of
    FLASH_CASES, then timed at the BERT-Base shape beside the plain
    version and ``scaled_dot_product_attention``.  Returns the kernel row
    of the report (without ``launches``)."""
    import torch.nn.functional as F

    from defer_tpu_torch.ops.flash_attention import flash_attention_plain
    from defer_tpu_torch.ops.flash_attention_cuda import KERNEL

    g = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    tensors = {}
    for name, b, h, tq, tk, d, causal, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        if name == "bert_base":
            # the main path's layout: head-split views of the fused
            # [b, t, 3 * h * d] projection, read by stride
            qkv = torch.randn((b, tq, 3 * h * d), generator=g, device=device)
            q, k, v = (x.reshape(b, tq, h, d).transpose(1, 2)
                       for x in qkv.chunk(3, dim=-1))
        elif name == "offset_view":
            # bases 4 bytes past a 16-byte boundary
            q, k, v = (torch.randn(math.prod(shape) + 1, generator=g,
                                   device=device)[1:].view(shape)
                       for shape in ((b, h, tq, d), (b, h, tk, d),
                                     (b, h, tk, d)))
        else:
            q, k, v = (torch.randn(shape, generator=g, device=device)
                       .to(dtype) for shape in ((b, h, tq, d), (b, h, tk, d),
                                                (b, h, tk, d)))
        tensors[name] = (q, k, v)
        out = KERNEL(q, k, v, causal)
        ref = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_t = (out.float() - ref.float()).abs()
        err = err_t.max().item()
        if dtype == torch.float32:
            ok = err <= FLASH_F32_TOL
        else:  # one bf16 ulp of the plain output, after the f32 difference
            ok = bool((err_t <= bf16_ulp(torch, ref) + FLASH_F32_TOL).all())
        if not ok:
            fail(f"flash_attention != plain on {name} {(b, h, tq, tk, d)} "
                 f"causal={causal} {dt}: max|err| {err:.3g}")
        if name == "zero_rows" and bool(out[:, :, :2].any()):
            fail("flash_attention: rows with no live key are not exactly 0")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        print(f"kernel flash_attention {name} {(b, h, tq, tk, d)} "
              f"causal={causal} {dt}: max|err| {err:.3g} vs plain", flush=True)

    # the long causal prefill beside SDPA's causal mode (the same alignment
    # when Tq = Tk)
    lq, lk, lv = tensors["long_causal"]
    long_ms = time_ms(torch, lambda: KERNEL(lq, lk, lv, True))
    long_sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True))
    print(f"kernel flash_attention long_causal {tuple(lq.shape)} f32: "
          f"{long_ms:.4f} ms, scaled_dot_product_attention(is_causal=True) "
          f"{long_sdpa_ms:.4f} ms", flush=True)

    q, k, v = tensors["bert_base"]
    ms = time_ms(torch, lambda: KERNEL(q, k, v, False))
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v))
    sdpa_err = (F.scaled_dot_product_attention(q, k, v)
                - flash_attention_plain(q, k, v)).abs().max().item()
    b, h, tq, d = q.shape
    tk = k.shape[2]
    flops = 4 * b * h * tq * tk * d
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; o written
    bytes_ms = nbytes / mem_rate(torch.cuda.get_device_name(0)) * 1e3
    # f32-accurate products on the tensor cores: three TF32 passes
    ops_ms = TF32_TERMS * flops / TF32_RATE * 1e3
    return {"name": KERNEL.name, "route": "cuda",
            "source": "defer_tpu_torch/csrc/flash_attention.cu",
            "replaces": "defer_tpu/ops/flash_attention.py:41",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "library_max_abs_err": sdpa_err,
            "shape": [b, h, tq, tk, d], "dtype": "float32",
            "bytes": nbytes, "flops": flops,
            # the bound of an FMA design (no tensor cores), for comparison
            "fma_bound_ms": flops / F32_RATE * 1e3,
            "long_causal": {"shape": list(lq.shape), "ms": long_ms,
                            "library_ms": long_sdpa_ms},
            "checked_by": "phase 3 (f32 <= 1e-5, bf16 <= 1 ulp, zero rows "
                          "vs plain on %d cases) + phase 4b (main path "
                          "launches)" % len(FLASH_CASES)}


# ---------------------------------------------------------------------------
# phase 4a: the ResNet50 main path
# ---------------------------------------------------------------------------


def zero_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def main_path(torch, device, kernels):
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS, resnet50
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = resnet50(image_size=IMAGE_SIZE)
    params = g.init(torch.Generator().manual_seed(SEED))
    n = len(RESNET50_8STAGE_CUTS) + 1
    m = 2 * CHUNK  # two full chunks; the flush adds the drain
    inputs = np.random.default_rng(SEED).standard_normal(
        (m, MICROBATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)

    defer = Defer(DeferConfig(wire="int8", microbatch=MICROBATCH,
                              chunk=CHUNK, device=device))
    zero_counts(kernels)
    out = defer.run(g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    print(f"main path: Defer.run(resnet50, {n} stages "
          f"{RESNET50_8STAGE_CUTS}, wire=int8, microbatch={MICROBATCH}, "
          f"chunk={CHUNK}) on {m} microbatches = {steps} steps; kernel "
          f"launches {launches}", flush=True)
    if launches["quant_int8"] != steps:
        fail(f"quant_int8 launched {launches['quant_int8']} times in "
             f"{steps} pipeline steps (want one per step)")

    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(device))
                        .cpu().numpy() for x in inputs])
    if out.shape != ref.shape or not np.isfinite(out).all():
        fail(f"int8 output shape {out.shape} (want {ref.shape}) or not "
             "finite")
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    top_ref, top_out = ref.argmax(-1), out.argmax(-1)
    srt = np.sort(ref, -1)
    margin = float((srt[..., -1] - srt[..., -2]).min())
    print(f"main path int8 vs whole-graph forward: max|err| {err:.6g} = "
          f"{err / scale:.6g} of max|logit| {scale:.6g} (bound "
          f"{INT8_REL_BOUND}); top-1 agree {int((top_ref == top_out).sum())}"
          f"/{top_ref.size}; smallest top-1 margin {margin:.6g}", flush=True)
    if err > INT8_REL_BOUND * scale:
        fail("int8 wire error above its bound")
    if not (top_ref == top_out).all():
        fail("int8 wire changed a top-1 class")

    zero_counts(kernels)
    buf = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                            chunk=CHUNK, device=device)).run(
        g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    torch.cuda.synchronize()
    buf_launches = read_counts(kernels)
    berr = float(np.abs(buf - ref).max())
    print(f"main path buffer wire vs forward: max|err| {berr:.6g} = "
          f"{berr / scale:.6g} of max|logit| (bound {BUFFER_REL_BOUND}); "
          f"kernel launches {buf_launches}", flush=True)
    if berr > BUFFER_REL_BOUND * scale:
        fail("buffer-wire pipeline differs from the forward")
    return {"steps": steps, "rel_err": err / scale,
            "launches": {"int8": launches, "buffer": buf_launches},
            "top1_agree": f"{int((top_ref == top_out).sum())}/"
                          f"{top_ref.size}", "buffer_rel_err": berr / scale,
            "defer": defer, "graph": g, "params": params, "inputs": inputs,
            "pdev": pdev, "cuts": RESNET50_8STAGE_CUTS}


# ---------------------------------------------------------------------------
# phase 4b: the BERT-Base main path
# ---------------------------------------------------------------------------


def bert_path(torch, device, kernels):
    """BERT-Base (seq 128, full width and depth, seeded random weights) in
    12 stages through ``Defer.run`` on both wires, each run's launch
    counts zeroed just before and read just after, the pooler output held
    against the whole-graph forward on the card (TF32 off)."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.models import BERT_BASE_12STAGE_CUTS, bert_base
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    g = bert_base(seq_len=SEQ_LEN)
    params = g.init(torch.Generator().manual_seed(SEED))
    cuts = BERT_BASE_12STAGE_CUTS
    n = len(cuts) + 1
    blocks = sum(name.startswith("block_") for name in g.topo_order)
    m = 2 * CHUNK
    vocab = g.nodes["embeddings"].op.vocab
    # token ids ride the f32 ring exactly (ids < 2**24)
    ids = np.random.default_rng(SEED).integers(
        0, vocab, (m, MICROBATCH, SEQ_LEN)).astype(np.float32)
    steps = CHUNK * -(-(m + n - 1) // CHUNK)

    pdev = params_to_device(params, device)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(x).to(
            device, torch.int32)).cpu().numpy() for x in ids])
    if not np.isfinite(ref).all():
        fail("BERT-Base forward is not finite")
    scale = float(np.abs(ref).max())

    res = {"steps": steps, "launches": {}, "rel_err": {}}
    for wire, bound in (("buffer", BUFFER_REL_BOUND),
                        ("int8", INT8_REL_BOUND)):
        defer = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                  chunk=CHUNK, device=device))
        zero_counts(kernels)
        out = defer.run(g, params, ids, cut_points=cuts)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        print(f"bert path: Defer.run(bert_base seq {SEQ_LEN}, {n} stages "
              f"block_0..block_10, wire={wire}, microbatch={MICROBATCH}, "
              f"chunk={CHUNK}) on {m} microbatches = {steps} steps; kernel "
              f"launches {launches}", flush=True)
        want = {"flash_attention": blocks * steps,
                "quant_int8": steps if wire == "int8" else 0}
        if any(launches[k] != c for k, c in want.items()):
            fail(f"bert path wire={wire}: launches {launches}, want {want} "
                 f"({blocks} flash launches and "
                 f"{'one' if wire == 'int8' else 'no'} quantizer launch "
                 f"per step)")
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"bert {wire} output shape {out.shape} (want {ref.shape}) "
                 "or not finite")
        err = float(np.abs(out - ref).max())
        mse = float(np.square(out - ref).mean())
        print(f"bert path {wire} wire vs whole-graph forward: max|err| "
              f"{err:.6g} = {err / scale:.6g} of max|output| {scale:.6g} "
              f"(bound {bound}); MSE {mse:.3g}", flush=True)
        if err > bound * scale:
            fail(f"bert {wire}-wire error above its bound")
        res["launches"][wire] = launches
        res["rel_err"][wire] = err / scale
        if wire == "int8":
            res["defer"] = defer
    res.update(graph=g, params=params, inputs=ids, pdev=pdev, cuts=cuts)
    return res


# ---------------------------------------------------------------------------
# phase 4, both paths: throughput and profile
# ---------------------------------------------------------------------------


def throughput(torch, device, mp, card, unit: str, rounds: int = 7):
    """Steady-state samples/s of the pipeline (both wires) and of the
    whole-graph forward at the same batch, all on the host clock around a
    chunk of work that ends in a synchronize (launch time included, as a
    user sees it).  The three alternate, round after round, so drift on
    the shared host hits all of them alike; the median round is kept."""
    from defer_tpu_torch import Defer, DeferConfig

    def pipeline(wire):
        pipe = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                 chunk=CHUNK, device=device)).build(
            mp["graph"], mp["params"], mp["cuts"])
        xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
        for _ in range(2):  # fill the ring
            pipe.push(xs)
        return lambda: pipe.push(xs)

    dtype = mp["graph"].input_spec.dtype
    xs = [torch.from_numpy(x).to(device, dtype) for x in mp["inputs"][:CHUNK]]

    def forward():
        with torch.inference_mode():
            for x in xs:
                mp["graph"].apply(mp["pdev"], x)

    runs = {"pipeline_int8": pipeline("int8"),
            "pipeline_buffer": pipeline("buffer"), "forward": forward}
    walls = {k: [] for k in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    rows = {}
    for name, w in walls.items():
        rows[name] = CHUNK * MICROBATCH / statistics.median(w)
        rows[f"{name}_spread"] = (max(w) - min(w)) / statistics.median(w)
    print(f"throughput {mp['graph'].name} on {card} (f32, TF32 off, "
          f"microbatch {MICROBATCH}, median of {rounds} alternating rounds "
          f"of {CHUNK} steps): "
          + ", ".join(f"{k} {rows[k]:.1f} {unit}/s (spread "
                      f"{rows[k + '_spread'] * 100:.0f}%)" for k in runs),
          flush=True)
    return rows


def profile_step(torch, mp, groups: dict):
    """Device time by kernel over one int8 chunk (torch.profiler), with
    each group's share (a kernel joins the first group whose pattern its
    name contains).  Returns the shares, or None without device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe = mp["defer"].build(mp["graph"], mp["params"], mp["cuts"])
    xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
    pipe.push(xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.push(xs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: no device time in the trace (not measured)")
        return None
    rows.sort(reverse=True)
    shares = dict.fromkeys(groups, 0.0)
    shares["everything else"] = 0.0
    for us, key, _ in rows:
        group = next((g for g, ms in groups.items()
                      if any(m in key for m in ms)), "everything else")
        shares[group] += us
    print(f"profile {mp['graph'].name}, one int8 chunk ({CHUNK} steps): "
          f"device time {total / 1e3:.3f} ms = {total / 1e3 / CHUNK:.3f} "
          f"ms/step in a {wall_us / 1e3:.3f} ms wall (device idle "
          f"{max(0.0, 1 - total / wall_us) * 100:.1f}%, profiler on); "
          + ", ".join(f"{g} {us / total * 100:.1f}%"
                      for g, us in shares.items()), flush=True)
    for us, key, count in rows[:12]:
        print(f"  {us / total * 100:6.2f}%  {us / 1e3:9.3f} ms  x{count:<5d}"
              f" {key[:100]}")
    return {g: us / total for g, us in shares.items()} | {
        "device_ms_per_step": total / 1e3 / CHUNK,
        "idle_share": max(0.0, 1 - total / wall_us)}


RESNET_GROUPS = {"quant_int8": ("quant_int8",),
                 "conv (cuDNN, incl. layout)": ("xmma", "cudnn", "conv",
                                                "Nchw", "Nhwc", "implicit")}
BERT_GROUPS = {"flash_attention": ("flash_attn",),
               "quant_int8": ("quant_int8",),
               "matmul (cuBLAS)": ("gemm", "Gemm", "cutlass")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    try:
        import defer_tpu_torch  # noqa: F401
        from defer_tpu_torch.ops import _build
        from defer_tpu_torch.ops.flash_attention_cuda import KERNEL as FLASH
        from defer_tpu_torch.ops.quant_cuda import KERNEL as QUANT
    except ImportError as e:
        fail(f"the defer_tpu_torch package is not beside this script ({e})")
    device = "cuda"
    kernels = [QUANT, FLASH]

    # phase 1: the card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # phase 2: build every kernel (one nvcc per source, started together)
    t0 = time.perf_counter()
    built = _build.build([k.source for k in kernels])
    for k in kernels:
        k.load()
    for src, info in built.items():
        print(f"build {src}: {info['seconds']:.2f} s -> {info['path'].name}")
        for line in info["log"].splitlines():
            # per kernel: its entry name, registers, spills (a line of its
            # own, without "ptxas") and any serialisation warning
            if ("spill" in line or "Compiling entry" in line
                    or ("ptxas" in line and ("Used" in line
                                             or "Performance Loss" in line))):
                print(f"  {line.strip()}")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, sm_90a)", flush=True)

    # phase 3: each kernel against its plain version, at main-path shapes
    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS, resnet50
    from defer_tpu_torch.partition import buffer_footprint, partition
    stages = partition(resnet50(image_size=IMAGE_SIZE), RESNET50_8STAGE_CUTS)
    buf = buffer_footprint(stages, microbatch=MICROBATCH,
                           wire="int8")["buf_elems"]
    ring_shape = (len(stages), MICROBATCH, buf)
    rows = {"quant_int8": check_quant(torch, ring_shape, device)}
    r = rows["quant_int8"]
    print(f"kernel quant_int8 {tuple(ring_shape)} f32: {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), "
          f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s, 1 launch per pipeline "
          f"step, on {card}", flush=True)
    rows["flash_attention"] = r = check_flash(torch, device)
    print(f"kernel flash_attention {tuple(r['shape'])} f32: {r['ms']:.4f} "
          f"ms, plain {r['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms (max|diff| vs plain "
          f"{r['library_max_abs_err']:.3g}), bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e6:.1f} MB; "
          f"{TF32_TERMS} x {r['flops'] / 1e6:.1f} MFLOP of TF32), "
          f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound, "
          f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, on {card}", flush=True)

    # phase 4a: ResNet50, the counts zeroed just before each run
    mp = main_path(torch, device, kernels)
    thr = throughput(torch, device, mp, card, "img")
    profile_step(torch, mp, RESNET_GROUPS)

    # phase 4b: BERT-Base, the counts zeroed just before each run
    bp = bert_path(torch, device, kernels)
    bthr = throughput(torch, device, bp, card, "seq")
    bprof = profile_step(torch, bp, BERT_GROUPS)

    by_path = {f"resnet50_{w}": c for w, c in mp["launches"].items()}
    by_path.update({f"bert_base_{w}": c for w, c in bp["launches"].items()})
    for k in kernels:
        row = rows[k.name]
        row["launches_by_path"] = {p: c[k.name] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] == 0:
            fail(f"kernel {k.name} was not launched on the main paths")

    # phase 5: report
    print(json.dumps({"main_path": {
        "model": "resnet50", "stages": len(stages), "wire": "int8",
        "microbatch": MICROBATCH, "chunk": CHUNK, "steps": mp["steps"],
        "rel_err": mp["rel_err"], "top1_agree": mp["top1_agree"],
        "buffer_rel_err": mp["buffer_rel_err"], "images_per_s": thr}}))
    print(json.dumps({"bert_path": {
        "model": "bert_base", "seq_len": SEQ_LEN,
        "stages": len(bp["cuts"]) + 1, "microbatch": MICROBATCH,
        "chunk": CHUNK, "steps": bp["steps"], "rel_err": bp["rel_err"],
        "sequences_per_s": bthr, "profile_int8": bprof}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
