#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``defer_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

  1. card   — name and power limit from nvidia-smi;
  2. build  — every CUDA kernel of the port, from ``defer_tpu_torch/csrc``,
              with nvcc for sm_90a (one nvcc per source, all at once);
  3. kernel — each kernel against its plain PyTorch version on the card at
              the main path's shapes plus edge cases (bit-equal), then
              timed with CUDA events beside the plain version and the
              card's bound for the same work;
  4. main   — ResNet50 at full width, cut at the reference's eight-stage
              list, served through ``Defer.run`` with ``wire="int8"``:
              the kernel launch counts are zeroed just before and read
              just after, and must equal one quantizer launch per pipeline
              step; the output is held against the whole-graph forward on
              the card (TF32 off); then a timed window gives images/s;
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

#: device memory rate of the cards the smoke knows (bytes/s, data sheets)
MEM_RATE = [("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12)]
#: float32 rate outside the tensor cores, H100 SXM data sheet (flop/s)
F32_RATE = 67e12


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
    """Median device time of ``fn()`` in ms (CUDA events per call)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


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
    for k in kernels:
        k.launches = 0
    out = defer.run(g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
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

    buf = Defer(DeferConfig(wire="buffer", microbatch=MICROBATCH,
                            chunk=CHUNK, device=device)).run(
        g, params, inputs, cut_points=RESNET50_8STAGE_CUTS)
    berr = float(np.abs(buf - ref).max())
    print(f"main path buffer wire vs forward: max|err| {berr:.6g} = "
          f"{berr / scale:.6g} of max|logit| (bound {BUFFER_REL_BOUND})",
          flush=True)
    if berr > BUFFER_REL_BOUND * scale:
        fail("buffer-wire pipeline differs from the forward")
    return {"steps": steps, "launches": launches, "rel_err": err / scale,
            "top1_agree": f"{int((top_ref == top_out).sum())}/"
                          f"{top_ref.size}", "buffer_rel_err": berr / scale,
            "defer": defer, "graph": g, "params": params, "inputs": inputs,
            "pdev": pdev}


def throughput(torch, device, mp, card, rounds: int = 7):
    """Steady-state images/s of the pipeline (both wires) and of the
    whole-graph forward at the same batch, all on the host clock around a
    chunk of work that ends in a synchronize (launch time included, as a
    user sees it).  The three alternate, round after round, so drift on
    the shared host hits all of them alike; the median round is kept."""
    from defer_tpu_torch import Defer, DeferConfig
    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS

    def pipeline(wire):
        pipe = Defer(DeferConfig(wire=wire, microbatch=MICROBATCH,
                                 chunk=CHUNK, device=device)).build(
            mp["graph"], mp["params"], RESNET50_8STAGE_CUTS)
        xs = pipe.stage_inputs(mp["inputs"][:CHUNK])
        for _ in range(2):  # fill the ring
            pipe.push(xs)
        return lambda: pipe.push(xs)

    xs = [torch.from_numpy(x).to(device) for x in mp["inputs"][:CHUNK]]

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
    print(f"throughput on {card} (f32, TF32 off, microbatch {MICROBATCH}, "
          f"median of {rounds} alternating rounds of {CHUNK} steps): "
          + ", ".join(f"{k} {rows[k]:.1f} img/s (spread "
                      f"{rows[k + '_spread'] * 100:.0f}%)" for k in runs),
          flush=True)
    return rows


def profile_step(torch, mp):
    """Device time by kernel over one int8 chunk (torch.profiler), with
    the quantizer's share and the convolutions' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS

    pipe = mp["defer"].build(mp["graph"], mp["params"], RESNET50_8STAGE_CUTS)
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
        return
    rows.sort(reverse=True)
    groups = {"quant_int8": ("quant_int8",),
              "conv (cuDNN, incl. layout)": ("xmma", "cudnn", "conv",
                                             "Nchw", "Nhwc", "implicit")}
    shares = {g: sum(us for us, key, _ in rows if any(m in key for m in ms))
              for g, ms in groups.items()}
    shares["everything else"] = total - sum(shares.values())
    print(f"profile of one int8 chunk ({CHUNK} steps): device time "
          f"{total / 1e3:.3f} ms = {total / 1e3 / CHUNK:.3f} ms/step in a "
          f"{wall_us / 1e3:.3f} ms wall (device idle "
          f"{max(0.0, 1 - total / wall_us) * 100:.1f}%, profiler on); "
          + ", ".join(f"{g} {us / total * 100:.1f}%"
                      for g, us in shares.items()))
    for us, key, count in rows[:12]:
        print(f"  {us / total * 100:6.2f}%  {us / 1e3:9.3f} ms  x{count:<5d}"
              f" {key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    try:
        import defer_tpu_torch  # noqa: F401
        from defer_tpu_torch.ops import _build
        from defer_tpu_torch.ops.quant_cuda import KERNEL as QUANT
    except ImportError as e:
        fail(f"the defer_tpu_torch package is not beside this script ({e})")
    device = "cuda"
    kernels = [QUANT]

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
            if "ptxas" in line:
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

    # phase 4: the main path, the counts zeroed just before and read after
    mp = main_path(torch, device, kernels)
    for k in kernels:
        rows[k.name]["launches"] = mp["launches"][k.name]
        if rows[k.name]["launches"] == 0:
            fail(f"kernel {k.name} was not launched on the main path")
    thr = throughput(torch, device, mp, card)
    profile_step(torch, mp)

    # phase 5: report
    print(json.dumps({"main_path": {
        "model": "resnet50", "stages": len(stages), "wire": "int8",
        "microbatch": MICROBATCH, "chunk": CHUNK, "steps": mp["steps"],
        "rel_err": mp["rel_err"], "top1_agree": mp["top1_agree"],
        "buffer_rel_err": mp["buffer_rel_err"], "images_per_s": thr}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
