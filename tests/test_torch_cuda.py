"""The port's CUDA kernels on the card (marker ``gpu``; skipped without CUDA).

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same CUDA tensors:
the quantizer bit for bit; flash attention to 1e-5 in float32 (N(0,1)
inputs; the kernel forms each product from three TF32 terms, whose error
budget ``test_torch_flash_tf32.py`` pins on the CPU, and sums in another
order), and in bfloat16 to one bf16 ulp of the plain output plus that
same 1e-5 (the f32 results may differ by it before each is rounded to
bf16).  The CPU parity tests hold
the plain versions to the JAX package.

The ring engine's tests hold one CUDA-graph replay per chunk to the eager
loop, and check that launch counts survive replays (the capture and its
warm-up pass are not counted), that ``reweight`` and ``reset`` work in
place without a new capture, and which dtypes the kernels run in.  The
decoder's tests hold its graph replays to the same steps run eagerly on
the card, count the flash launches of decode-rate steps (none) and of the
fused prefill, and check ``reweight`` without a new capture and that
sampling on the card does not depend on chunking.  The zoo's tests count
the quantizer's launches on the VGG, Inception and MobileNetV2 pipelines
(f32 and bf16 rings) and the flash launches of the MoE families.  The
continuous-batching engine's tests hold its step replays to the same steps
run eagerly on the card, and every request's tokens, alone and in a
shared batch, byte-identical on the card; the decode door serves
concurrent clients from the engine's thread.  The planner's tests check
the card's row (``utils/hw.py``) and count the flash launches of
``measured_node_costs``, whose ``k`` calls per node are one graph replay.
The profiling plane's tests count a CUDA-graph capture as one run-time
compilation, read a node's ``mem_bytes`` as the allocator's
``torch.cuda.memory_allocated``, check its MFU against the card's row,
and find the flash kernel, launched on another thread, in a profiling
window's ``torch.profiler`` trace.  The command line's tests count the
flash launches of ``amortized_forward_seconds``, whose ``k`` forwards are
one graph replay, and the quantizer launches of ``bench --wire int8`` (a
bf16 ring on the card).  The training tests hold the straight-through hop
to the inference hop (forward bit for bit, backward the roll back) and one
``PipelineTrainer.loss_and_grad`` on the card to the same on the CPU,
counting the quantizer's launches.
"""

import math

import pytest
import torch

from defer_tpu_torch.ops import quant
from defer_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from defer_tpu_torch.ops.flash_attention_cuda import KERNEL as FLASH
from defer_tpu_torch.ops.flash_attention_cuda import flash_attention_cuda
from defer_tpu_torch.ops.quant_cuda import KERNEL, quantize_int8_blocks_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _assert_kernel_equals_plain(x):
    before = KERNEL.launches
    qk, sk = quantize_int8_blocks_cuda(x)
    qp, sp = quant.quantize_int8_blocks_plain(x)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert torch.equal(qk, qp)
    assert torch.equal(sk.view(torch.int32), sp.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2048), (2, 3, 512), (1, 256),
                                   (8, 1, 802816), (3, 7, 256)])
def test_quant_kernel_bit_equal_to_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    n = shape[-1] // 256
    mag = torch.exp(3 * torch.randn(shape[:-1] + (n, 1), generator=g,
                                    device=cuda))
    x = torch.randn(shape[:-1] + (n, 256), generator=g, device=cuda) * mag
    _assert_kernel_equals_plain(x.reshape(shape).to(dtype))


def test_quant_kernel_edge_blocks(cuda):
    x = torch.zeros(4, 256, device=cuda)
    x[1, :3] = torch.tensor([math.inf, -math.inf, math.nan])
    x[1, 3:] = torch.linspace(-2, 2, 253)
    x[2] = math.nan
    x[3, 0] = 127.0
    x[3, 1:] = (torch.arange(-126, 129, device=cuda)[:255] - 0.5).clamp(
        -126.5, 126.5)
    for dtype in (torch.float32, torch.bfloat16):
        _assert_kernel_equals_plain(x.to(dtype))
    _assert_kernel_equals_plain(x[3:] / 8)


def test_quant_kernel_dispatch_and_refusals(cuda):
    x = torch.randn(2, 512, device=cuda)
    before = KERNEL.launches
    quant.quantize_int8_blocks(x)  # a CUDA tensor goes to the kernel
    assert KERNEL.launches == before + 1
    with pytest.raises(TypeError, match="dtype"):
        quantize_int8_blocks_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8_blocks_cuda(torch.randn(512, 2, device=cuda).t())
    with pytest.raises(ValueError, match="aligned"):
        quantize_int8_blocks_cuda(torch.randn(520, device=cuda)[1:257])
    with pytest.raises(ValueError, match="multiple"):
        quantize_int8_blocks_cuda(torch.randn(2, 300, device=cuda))
    assert KERNEL.launches == before + 1


def test_int8_pipeline_on_card_launches_once_per_step(cuda):
    """The ring engine on the card goes through the kernel once per step,
    and agrees with the same pipeline on the CPU (plain quantizer) to one
    quant step of the output block (cuDNN and the CPU sum convolutions in
    different orders, which can move a value across a rounding boundary)."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, models, partition

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal(
        (5, 2, 32, 32, 3)).astype(np.float32)
    stages = partition(g, num_stages=4)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = SpmdPipeline(stages, params, device=dev, microbatch=2,
                            chunk=3, wire="int8")
        before = KERNEL.launches
        outs[str(dev)] = pipe.run(x)
        launched = KERNEL.launches - before
        assert launched == (pipe.metrics.steps if dev == cuda else 0)
    cpu, gpu = outs["cpu"], outs[str(cuda)]
    assert np.abs(gpu - cpu).max() <= np.abs(cpu).max() / 127
    assert (gpu.argmax(-1) == cpu.argmax(-1)).all()


def _qkv(device, b, h, tq, tk, d, dtype=torch.float32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _assert_flash_matches_plain(q, k, v, causal):
    before = FLASH.launches
    out = flash_attention_cuda(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype == q.dtype
    if q.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:  # one bf16 ulp of the plain output, after the f32 difference
        assert ((out.float() - ref.float()).abs()
                <= _bf16_ulp(ref) + 1e-5).all()
    return out


@pytest.mark.parametrize("shape,causal", [
    ((2, 3, 64, 64, 16), False),
    ((1, 2, 100, 100, 24), True),      # not a tile multiple
    ((2, 2, 37, 53, 8), False),        # Tq != Tk
    ((1, 1, 130, 130, 64), True),      # a third query tile
    ((1, 2, 1, 48, 16), True),         # decode: the whole prefix
    ((1, 2, 5, 48, 16), True),         # chunked decode
    ((8, 12, 128, 64, 64), False),     # BERT-Base
    ((2, 2, 70, 150, 128), True),      # D = 128, several key tiles
    ((1, 3, 33, 200, 100), False),     # D padded to 128
    ((1, 12, 1024, 1024, 64), True),   # long causal prefill: 16 key tiles
    ((2, 3, 40, 50, 5), False),        # 20-byte rows: element-wise staging
])
def test_flash_kernel_matches_plain_f32(cuda, shape, causal):
    b, h, tq, tk, d = shape
    _assert_flash_matches_plain(*_qkv(cuda, b, h, tq, tk, d), causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_kernel_matches_plain_bf16(cuda, d, causal):
    _assert_flash_matches_plain(
        *_qkv(cuda, 1, 2, 64, 96, d, torch.bfloat16, seed=d), causal)


def test_flash_kernel_matches_plain_bf16_bert(cuda):
    _assert_flash_matches_plain(
        *_qkv(cuda, 8, 12, 128, 128, 64, torch.bfloat16), False)


def _offset_view(x, elems):
    """x's values in a view whose base is `elems` elements past an
    allocation (not 16-byte aligned for elems = 1)."""
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    view = buf[elems:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case", ["offset_f32", "offset_bf16",
                                  "odd_row_stride", "k_only"])
def test_flash_kernel_matches_plain_misaligned(cuda, case):
    """Views whose head base or row stride is not a multiple of 16 bytes
    take the kernel's element-wise staging: no refusal, no copy."""
    dtype = torch.bfloat16 if case == "offset_bf16" else torch.float32
    q, k, v = _qkv(cuda, 2, 3, 70, 90, 32, dtype, seed=2)
    if case == "odd_row_stride":  # rows 33 floats apart
        q, k, v = (torch.cat([x, x[..., :1]], dim=-1)[..., :32]
                   for x in (q, k, v))
    elif case == "k_only":
        k = _offset_view(k, 1)
    else:
        q, k, v = (_offset_view(x, 1) for x in (q, k, v))
    assert any(x.data_ptr() % 16 or x.stride(2) * x.element_size() % 16
               for x in (q, k, v))
    _assert_flash_matches_plain(q, k, v, False)
    _assert_flash_matches_plain(q, k, v, True)


def test_flash_kernel_zero_rows_and_strided_views(cuda):
    # Tq=5 against Tk=3, causal: rows 0 and 1 see no key and must be 0
    out = _assert_flash_matches_plain(*_qkv(cuda, 1, 2, 5, 3, 16), True)
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    # head-split views of a fused [b, t, 3*d] projection, read by stride
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 40, 3 * 64, generator=g, device=cuda)
    q, k, v = (x.reshape(2, 40, 4, 16).transpose(1, 2)
               for x in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    _assert_flash_matches_plain(q, k, v, False)


def test_flash_kernel_dispatch_and_refusals(cuda):
    q, k, v = _qkv(cuda, 1, 2, 16, 16, 32)
    before = FLASH.launches
    flash_attention(q, k, v)  # a CUDA tensor goes to the kernel
    assert FLASH.launches == before + 1
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="differ"):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="limit"):
        flash_attention_cuda(*_qkv(cuda, 1, 1, 4, 4, 160))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    with pytest.raises(ValueError, match="match"):
        flash_attention_cuda(q, k[:, :1], v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k.cpu(), v)
    assert FLASH.launches == before + 1


def test_bert_pipeline_on_card_launches_flash_per_stage_step(cuda):
    """bert_tiny in 4 stages on the card: one flash launch per block per
    step, one quantizer launch per step under int8, and the same outputs
    as the pipeline on the CPU (plain attention) — to 1e-5 of max |output|
    on the buffer wire, to one quant step of the output block on int8."""
    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models

    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.bert_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    ids = np.random.default_rng(0).integers(
        0, 100, (5, 2, 16)).astype(np.float32)
    for wire in ("buffer", "int8"):
        outs = {}
        for dev in ("cpu", "cuda"):
            d = Defer(DeferConfig(device=dev, microbatch=2, chunk=3,
                                  wire=wire))
            pipe = d.build(g, params, num_stages=4)
            f0, q0 = FLASH.launches, KERNEL.launches
            outs[dev] = pipe.run(ids)
            steps = pipe.metrics.steps if dev == "cuda" else 0
            assert FLASH.launches - f0 == 4 * steps
            assert KERNEL.launches - q0 == (steps if wire == "int8" else 0)
        scale = np.abs(outs["cpu"]).max()
        tol = 1e-5 * scale if wire == "buffer" else scale / 127
        assert np.abs(outs["cuda"] - outs["cpu"]).max() <= tol


# ---------------------------------------------------------------------------
# the ring engine on the card: one CUDA-graph replay per chunk
# ---------------------------------------------------------------------------


def _pipe(model, device, **kw):
    """A 4-stage pipeline of the tiny model on ``device``, its seeded
    params, and a [5, 2, ...] input block."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, models, partition

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = getattr(models, model)()
    params = g.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 100, (5, 2, 16)).astype(np.float32)
         if model == "bert_tiny"
         else rng.standard_normal((5, 2, 32, 32, 3)).astype(np.float32))
    kw = dict(dict(microbatch=2, chunk=3), **kw)
    return (SpmdPipeline(partition(g, num_stages=4), params, device=device,
                         **kw), params, x)


@pytest.mark.parametrize("model,wire", [("resnet_tiny", "int8"),
                                        ("bert_tiny", "buffer"),
                                        ("bert_tiny", "int8")])
def test_graph_replay_equals_eager(cuda, model, wire):
    """One chunk through the graph and through the eager loop, from the
    same ring: the same outputs and the same ring after (to 1e-6 of max
    |output|)."""
    pipe, _, x = _pipe(model, cuda, wire=wire)
    xs = pipe.stage_inputs(x[:3])
    pipe.push(xs)  # captures, then fills the ring
    assert pipe.metrics.captures == 1
    ring = pipe._a.clone()
    graph_out = pipe._run_chunk(xs).clone()
    graph_ring = pipe._a.clone()
    pipe._a.copy_(ring)
    eager_out = pipe._eager_chunk(xs)
    torch.cuda.synchronize()
    scale = eager_out.abs().max().item()
    assert scale > 0
    assert (graph_out - eager_out).abs().max().item() <= 1e-6 * scale
    assert (graph_ring - pipe._a).abs().max().item() <= \
        1e-6 * pipe._a.abs().max().item()
    assert pipe.metrics.captures == 1


def test_launch_counts_per_replay(cuda):
    """Neither the capture nor its warm-up pass counts; every replay adds
    the chunk's launches."""
    pipe, _, x = _pipe("bert_tiny", cuda, wire="int8")
    FLASH.zero()
    KERNEL.zero()
    pipe.warmup()  # capture + one replay of a bubble chunk
    assert pipe.metrics.captures == 1
    assert (FLASH.launches, KERNEL.launches) == (4 * 3, 3)
    pipe.push(x[:3])
    pipe.push(x[:3])
    assert (FLASH.launches, KERNEL.launches) == (4 * 9, 9)
    assert FLASH.by_dtype == {"float32": 36}
    assert KERNEL.by_dtype == {"float32": 9}
    assert pipe.metrics.captures == 1


def test_reweight_after_capture(cuda):
    """``reweight`` copies into the rows the graph reads: the next run
    equals a pipeline built on the new weights, with no new capture."""
    from defer_tpu_torch import SpmdPipeline
    from defer_tpu_torch.graph.ir import tree_map

    pipe, params, x = _pipe("resnet_tiny", cuda, wire="int8")
    pipe.run(x)
    assert pipe.metrics.captures == 1
    params2 = tree_map(lambda v: v * 0.5, params)
    pipe.reweight(params2)
    out = pipe.run(x)
    fresh = SpmdPipeline(pipe.stages, params2, device=cuda, microbatch=2,
                         chunk=3, wire="int8").run(x)
    assert abs(out - fresh).max() <= 1e-6 * abs(fresh).max()
    assert pipe.metrics.captures == 1


def test_reset_in_place(cuda):
    """``reset`` zeroes the ring the graph holds, never a new one; runs
    after it repeat exactly."""
    pipe, _, x = _pipe("resnet_tiny", cuda)
    ptr = pipe._a.data_ptr()
    first = pipe.run(x)
    pipe.reset()
    pipe.push(x[:3])  # mid-stream: the ring holds activations
    assert pipe._a.abs().max().item() > 0
    pipe.reset()
    assert pipe._a.data_ptr() == ptr and not pipe._a.any()
    assert (pipe.run(x) == first).all()
    assert pipe._a.data_ptr() == ptr and pipe.metrics.captures == 1
    assert pipe.metrics.graph_pool_bytes > 0


def test_bert_flash_launch_dtypes(cuda):
    """The flash kernel runs in the compute dtype: float32 on the f32
    deployment; bfloat16 in every block under ``compute_dtype=bfloat16``
    (BERT's embeddings read the bf16 table, as in the JAX engine)."""
    for cd, dt in ((None, "float32"), ("bfloat16", "bfloat16")):
        pipe, _, x = _pipe("bert_tiny", cuda, compute_dtype=cd)
        FLASH.zero()
        pipe.run(x)
        assert FLASH.by_dtype == {dt: 4 * pipe.metrics.steps}


def test_bf16_quantizer_on_bf16_ring(cuda):
    """bf16 compute on a bf16 ring under the int8 wire: one bf16 quantizer
    launch per step, and the outputs within 5e-2 of max |output| of the
    same pipeline on the CPU (cuDNN and the CPU round bf16 convolutions
    differently, and the int8 wire can turn such a difference into a quant
    step)."""
    import numpy as np

    kw = dict(wire="int8", compute_dtype="bfloat16", buffer_dtype="bfloat16")
    pipe, _, x = _pipe("resnet_tiny", cuda, **kw)
    KERNEL.zero()
    out = pipe.run(x)
    assert KERNEL.by_dtype == {"bfloat16": pipe.metrics.steps}
    cpu = _pipe("resnet_tiny", "cpu", **kw)[0].run(x)
    assert np.abs(out - cpu).max() <= 5e-2 * np.abs(cpu).max()


# ---------------------------------------------------------------------------
# the rest of the zoo: VGG, Inception, MobileNetV2 (depthwise) and MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,stages,size", [
    ("vgg_tiny", 4, 32), ("inception_tiny", 6, 75), ("mobilenet_tiny", 2, 32)])
def test_zoo_int8_pipeline_launches_once_per_step(cuda, model, stages, size,
                                                  dtype):
    """VGG19's, InceptionV3's and MobileNetV2's families in their
    BASELINE stage counts on the int8 wire: one quantizer launch per step
    in the ring's dtype (f32, or bf16 compute on a bf16 ring), and the
    output within 5e-2 of max |output| of the same pipeline on the CPU
    (cuDNN and the CPU sum convolutions differently, and the int8 wire can
    turn such a difference into a quant step)."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, models, partition

    torch.backends.cudnn.allow_tf32 = False
    g = getattr(models, model)()
    params = g.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal(
        (5, 2, size, size, 3)).astype(np.float32)
    kw = dict(microbatch=2, chunk=3, wire="int8")
    if dtype == "bfloat16":
        kw.update(compute_dtype="bfloat16", buffer_dtype="bfloat16")
    stage_list = partition(g, num_stages=stages)
    pipe = SpmdPipeline(stage_list, params, device=cuda, **kw)
    KERNEL.zero()
    out = pipe.run(x)
    assert KERNEL.by_dtype == {dtype: pipe.metrics.steps}
    cpu = SpmdPipeline(stage_list, params, device="cpu", **kw).run(x)
    assert np.isfinite(out).all()
    assert np.abs(out - cpu).max() <= 5e-2 * np.abs(cpu).max()


@pytest.mark.parametrize("model", ["moe_tiny", "moe_branched_tiny"])
def test_moe_pipeline_launches_flash_per_block_step(cuda, model):
    """The MoE families in two stages: one flash launch per block per
    step, and the buffer wire equal to the whole-graph forward on the card
    to 1e-5 of max |output|."""
    import numpy as np

    from defer_tpu_torch import SpmdPipeline, models, partition
    from defer_tpu_torch.utils.convert import params_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    g = getattr(models, model)()
    params = g.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).integers(0, 100, (5, 2, 16)).astype(
        np.float32)
    pipe = SpmdPipeline(partition(g, models.moe_stage_cuts(2)), params,
                        device=cuda, microbatch=2, chunk=3)
    FLASH.zero()
    out = pipe.run(x)
    assert FLASH.launches == 2 * pipe.metrics.steps
    pdev = params_to_device(params, cuda)
    with torch.inference_mode():
        ref = np.stack([g.apply(pdev, torch.from_numpy(xi).to(
            cuda, torch.int32)).cpu().numpy() for xi in x])
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# GPT: the flash kernel's causal mode on its served shapes, and the decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [32, 128], ids=["gpt2_prefill", "gpt2_score"])
def test_flash_kernel_gpt2_causal(cuda, t, dtype):
    """GPT-2 small's causal attention: the fused prefill of a 32-token
    prompt and Defer.score at bucket 128, microbatch 8, 12 heads of 64."""
    _assert_flash_matches_plain(*_qkv(cuda, 8, 12, t, t, 64, dtype), True)


def _decoder(device, **kw):
    """gpt_tiny (4 blocks) in 4 stages at microbatch 2, and 8 prompts."""
    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.runtime.decode import PipelinedDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.gpt_tiny(seq_len=24, vocab=97)
    params = g.init(torch.Generator().manual_seed(7))
    prompt = np.random.default_rng(3).integers(0, 97, (8, 5))
    dec = PipelinedDecoder(g, params, num_stages=kw.pop("num_stages", 4),
                           microbatch=kw.pop("microbatch", 2), max_len=24,
                           device=device, **kw)
    return dec, params, prompt


@pytest.mark.parametrize("kw", [{}, {"kv_cache": "int8"},
                                {"compute_dtype": "bfloat16",
                                 "weight_dtype": "int8"},
                                {"microbatch": 4, "beam_width": 2}],
                         ids=["f32", "int8_kv", "w8a16_bf16", "beam"])
def test_decoder_graph_equals_eager(cuda, kw):
    """One graph replay per unit against the same steps run eagerly on the
    card: equal tokens, caches within 1e-6 of their max |value|; one
    capture serves every call."""
    dec, _, prompt = _decoder(cuda, **kw)
    prompt = prompt[:4] if "beam_width" in kw else prompt
    got = dec.generate(prompt, 9)
    snap = {k: [c.clone() for c in cs] for k, cs in dec.caches.items()}
    assert dec.captures == 1 and dec.graph_pool_bytes > 0
    dec.cuda_graphs = False
    want = dec.generate(prompt, 9)
    assert (got == want).all()
    for k in snap:
        for a, b in zip(snap[k], dec.caches[k]):
            scale = b.float().abs().max().item() or 1.0
            assert (a.float() - b.float()).abs().max().item() <= 1e-6 * scale
    dec.cuda_graphs = True
    assert (dec.generate(prompt, 9, token_chunk=2) == got).all()
    assert dec.captures == 1


def test_decoder_launch_counts(cuda):
    """Decode-rate steps launch no flash kernel (decode attention is two
    matmuls); the fused prefill launches it once per block per group, in
    its graph replay as in the eager pass."""
    dec, _, prompt = _decoder(cuda)
    FLASH.zero()
    rate = dec.generate(prompt, 6)
    assert FLASH.launches == 0
    for graphs in (True, False):
        dec.cuda_graphs = graphs
        FLASH.zero()
        pre = dec.generate(prompt, 6, prefill=True)
        assert FLASH.launches == 4 * 4  # 4 blocks x 4 groups
        assert FLASH.by_dtype == {"float32": 16}
        assert (pre == rate).all()


def test_decoder_reweight_and_sampling_on_card(cuda):
    """``reweight`` after capture equals a fresh decoder with no new
    capture; sampled tokens on the card are the same under any chunking
    and equal to the CPU's (the noise is a hash of seed, step, row and
    column)."""
    from defer_tpu_torch.graph.ir import tree_map

    dec, params, prompt = _decoder(cuda)
    dec.generate(prompt, 6)
    captures = dec.captures
    params2 = tree_map(lambda v: v * 1.1, params)
    dec.reweight(params2)
    fresh, _, _ = _decoder(cuda)
    fresh.reweight(params2)
    assert (dec.generate(prompt, 6) == fresh.generate(prompt, 6)).all()
    assert dec.captures == captures
    kw = dict(temperature=0.8, top_k=5, seed=4)
    a = dec.generate(prompt, 8, **kw)
    assert (a == dec.generate(prompt, 8, token_chunk=3, **kw)).all()
    cpu, _, _ = _decoder("cpu")
    cpu.reweight(params2)
    same = (a == cpu.generate(prompt, 8, **kw)).mean()
    assert same > 0.9  # float rounding may move a near tie


# ---------------------------------------------------------------------------
# the host edge: Defer.serve_endpoint on the card
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_serve_endpoint_on_card(cuda):
    """resnet_tiny in 4 stages, bf16 compute on a bf16 ring under the int8
    wire, behind ``serve_endpoint(max_clients=2)``: two concurrent clients
    (raw and bf8 replies) each get rows equal to ``Defer.run`` of the same
    deployment (raw exactly; bf8 within the row max / 127), the quantizer
    launches once per step the endpoint ran, the native ring staged the
    inputs, and the endpoint counters read every sample."""
    import threading

    import numpy as np

    from defer_tpu_torch import Defer, DeferConfig, models
    from defer_tpu_torch.obs import REGISTRY
    from defer_tpu_torch.transport.framed import TensorClient

    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    kw = dict(microbatch=2, chunk=3, wire="int8", compute_dtype="bfloat16",
              buffer_dtype="bfloat16")
    rng = np.random.default_rng(0)
    xs = {c: [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
              for _ in range(7)] for c in ("raw", "bf8")}
    want = {c: Defer(DeferConfig(device=cuda, **kw)).run(
        g, params, np.stack(v), num_stages=4) for c, v in xs.items()}
    outs = {}
    ep_in = REGISTRY.counter("endpoint.samples_in")
    n_in = ep_in.n
    for codec in ("raw", "bf8"):
        address, thread = Defer(DeferConfig(device=cuda, **kw)) \
            .serve_endpoint(g, params, num_stages=4, max_clients=2,
                            codec=codec)
        pipe = thread.pipeline
        steps0 = pipe.metrics.steps
        KERNEL.zero()

        def go(k):
            c = TensorClient(*address, timeout_s=120)
            outs[(codec, k)] = c.infer_stream(xs[codec])
            c.close()

        ts = [threading.Thread(target=go, args=(k,), daemon=True)
              for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
        thread.join(timeout=120)
        assert not thread.is_alive() and thread.errors == []
        assert KERNEL.by_dtype == {"bfloat16": pipe.metrics.steps - steps0}
        for k in range(2):
            got = np.stack(outs[(codec, k)])
            if codec == "raw":
                assert np.array_equal(got, want[codec])
            else:
                bound = np.abs(want[codec]).max(axis=(1, 2)) / 127
                assert (np.abs(got - want[codec]).max(axis=(1, 2))
                        <= bound).all()
    assert ep_in.n - n_in == 2 * 2 * 7 * 2  # samples: microbatch 2 a frame


# ---------------------------------------------------------------------------
# the serving front door: the continuous-batching decode engine on the card
# ---------------------------------------------------------------------------


def _engine_setup(device):
    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.serve import ContinuousBatchEngine, DecodeRequest

    g = models.gpt_tiny(seq_len=32)
    params = g.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, (int(n),)) for n in rng.integers(2, 9, 6)]

    def engine(width=3):
        return ContinuousBatchEngine(g, params, num_stages=2, width=width,
                                     device=device)

    def reqs():
        return [DecodeRequest(prompt=q, max_new_tokens=6 + i % 3,
                              request_id=i, seed=40 + i,
                              temperature=0.9 if i % 2 else 0.0)
                for i, q in enumerate(prompts)]

    return engine, reqs


def test_engine_replay_equals_eager(cuda):
    """Every step one graph replay (two captures at construction, greedy
    and sampled) against the same steps run eagerly on the card: equal
    tokens, caches within 1e-6 of their max |value|, and no quantizer or
    flash launch."""
    engine, reqs = _engine_setup(cuda)
    KERNEL.zero()
    FLASH.zero()
    graphs = engine()
    assert graphs.captures == 2 and graphs.graph_pool_bytes > 0
    got = graphs.run_all(reqs())
    eager = engine()
    eager.cuda_graphs = False
    want = eager.run_all(reqs())
    assert sorted(got) == sorted(want)
    for rid in want:
        assert (got[rid] == want[rid]).all()
    for a, b in zip(graphs._caches, eager._caches):
        for name in ("k", "v"):
            scale = b[name].abs().max().item() or 1.0
            assert (a[name] - b[name]).abs().max().item() <= 1e-6 * scale
    assert KERNEL.launches == 0 and FLASH.launches == 0


def test_engine_solo_vs_continuous_on_card(cuda):
    """Each request run alone through a fresh engine of the same width
    (its own captures) gives the bytes it gets in a staggered shared
    batch, greedy and sampled rows mixed."""
    engine, reqs = _engine_setup(cuda)
    solo = {}
    for req in reqs():
        solo[req.request_id] = engine().run_all([req])[req.request_id]

    def stagger(e, queue):
        while queue and e.free_slots() \
                and e.steps >= 2 * queue[0].request_id:
            e.join(queue.pop(0))

    batched = engine().run_all(reqs(), joiner=stagger)
    for rid, ids in solo.items():
        assert (batched[rid] == ids).all()


@pytest.mark.timeout(300)
def test_decode_door_on_card(cuda):
    """The decode door on the card: three concurrent tenants, each
    tenant's tokens equal to a solo run through the same door; every
    replay runs on the engine's thread."""
    import threading

    import numpy as np

    from defer_tpu_torch.serve import ServeClient, ServeFrontDoor
    from defer_tpu_torch.serve.client import fetch_stats

    engine, _ = _engine_setup(cuda)
    door = ServeFrontDoor(engine=engine(4),
                          decode_defaults={"max_new_tokens": 5}).start()
    try:
        rng = np.random.default_rng(7)
        data = {t: [rng.integers(0, 97, (int(n),)).astype(np.int32)
                    for n in rng.integers(2, 12, 4)]
                for t in ("alpha", "beta", "gamma")}
        kw = {"alpha": {}, "beta": {"temperature": 0.8, "seed": 5},
              "gamma": {"weight": 2.0}}
        solo = {t: ServeClient(*door.address, t + "_solo", **kw[t]).stream(
            data[t]) for t in data}
        outs = {}

        def go(t):
            outs[t] = ServeClient(*door.address, t, **kw[t]).stream(data[t])

        ts = [threading.Thread(target=go, args=(t,), daemon=True)
              for t in data]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
        door.healthcheck()
        for t in data:
            for a, b in zip(outs[t], solo[t]):
                assert a[0] == b[0] == "ok" and (a[1] == b[1]).all()
        doc = fetch_stats(*door.address)
        assert doc["decode"]["captures"] == 2
        assert doc["tenants"]["gamma"]["completed"] == 4
    finally:
        door.stop()


# ---------------------------------------------------------------------------
# the stage-node chain on the card
# ---------------------------------------------------------------------------

def _bert_tiny_stages():
    from defer_tpu_torch import models, partition
    g = models.bert_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    return g, p, partition(g, num_stages=2)


def test_exported_stage_launches_flash_through_the_operator(cuda):
    """An artifact exported on the CPU loads on the card; a BERT stage runs
    the hand kernel once per block per call through the custom operator,
    within 1e-5 of max |y| of the same program on the CPU (the plain
    version)."""
    import numpy as np

    from defer_tpu_torch.utils.export import (export_stage_bytes,
                                              load_stage_program)

    g, p, stages = _bert_tiny_stages()
    ids = np.random.default_rng(0).integers(0, 100, (2, 16)).astype(np.int32)
    x = ids
    for s in stages:
        blob = export_stage_bytes(s, p, batch=2)
        on_cpu = load_stage_program(blob, device="cpu")
        on_card = load_stage_program(blob, device=cuda)
        assert on_card.device.type == "cuda"
        blocks = sum(n.startswith("block_") for n in s.node_names)
        before = FLASH.launches
        y = on_card(x)
        torch.cuda.synchronize()
        assert FLASH.launches == before + blocks
        want = on_cpu(x)
        assert y.device.type == "cuda"
        err = float((y.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        x = want.numpy()


def test_card_program_replays_one_capture(cuda):
    """On the card a stage program captures itself when it loads and
    replays at every call: three calls on new inputs each within 1e-5 of
    max |y| of the same program on the CPU, no capture (no ``compiles``
    count) among them, each output its own tensor; a reweight copies into
    the captured weights, and the next replay matches the CPU program
    reweighted the same way, with no second capture."""
    import numpy as np

    from defer_tpu_torch import models, partition
    from defer_tpu_torch.obs import REGISTRY
    from defer_tpu_torch.utils.export import (export_stage_bytes,
                                              load_stage_program,
                                              stage_weight_leaves,
                                              weights_blob)

    g = models.resnet_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stage = partition(g, num_stages=2)[1]
    blob = export_stage_bytes(stage, p, batch=2)
    on_cpu = load_stage_program(blob, device="cpu")
    compiles = REGISTRY.counter("compiles")
    loaded = compiles.value
    on_card = load_stage_program(blob, device=cuda)
    # the load's two: the program's deserialization and its capture
    assert on_card._graph is not None and compiles.value == loaded + 2
    rng = np.random.default_rng(0)
    shape = (2,) + tuple(stage.in_spec.shape)
    before = compiles.value

    def check(prog_cpu):
        x = rng.standard_normal(shape).astype(np.float32)
        y = on_card(x)
        want = prog_cpu(x)
        err = float((y.cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        return y

    ys = [check(on_cpu) for _ in range(3)]
    assert compiles.value == before
    assert len({y.data_ptr() for y in ys}) == 3
    p2 = g.init(torch.Generator().manual_seed(1))
    new = weights_blob(stage_weight_leaves(stage, p2))
    on_cpu.reweight(new)
    on_card.reweight(new)
    check(on_cpu)
    assert compiles.value == before


def test_join_artifact_carries_the_flash_operator(cuda):
    """The join of a branched MoE region (``moe_0`` merging the residual
    and four experts, then ``block_1``) exported as a program of five
    inputs on the CPU keeps the ``defer_tpu_torch::flash_attention``
    operator: on the card it launches the hand kernel once per call, and
    its output is within 1e-5 of max |y| of the same program on the CPU
    (the plain version)."""
    import numpy as np

    from defer_tpu_torch import models
    from defer_tpu_torch.plan import StageCostModel, solve_dag
    from defer_tpu_torch.runtime.topology import ChainTopology
    from defer_tpu_torch.utils.export import (export_stage_bytes,
                                              load_stage_program)

    g = models.moe_branched_tiny(seq_len=16)
    p = g.init(torch.Generator().manual_seed(0))
    heavy = {n: 1e-3 for n in g.topo_order
             if n.startswith("block_") or "_e" in n}
    cm = StageCostModel(g, gen="h100", link_bw_s=1e12,
                        node_costs={n: heavy.get(n, 1e-6)
                                    for n in g.topo_order})
    topo = ChainTopology.from_json(
        solve_dag(g, cm, num_nodes=12).topology_json())
    join = next(s for v, s in zip(topo, topo.stage_specs(g))
                if v.join >= 2)
    assert join.num_inputs == 5 and "block_1" in join.node_names
    blob = export_stage_bytes(join, p, batch=2)
    on_cpu = load_stage_program(blob, device="cpu")
    on_card = load_stage_program(blob, device=cuda)
    assert any("flash_attention" in str(n.target)
               for n in on_card.graph.nodes)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2,) + tuple(s.shape)).astype(np.float32)
          for s in join.in_specs]
    before = FLASH.launches
    y = on_card(*xs)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    want = on_cpu(*xs)
    err = float((y.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.timeout(300)
@pytest.mark.parametrize("model", ["bert_tiny", "resnet_tiny"])
def test_two_thread_chain_on_card_equals_forward(cuda, model, monkeypatch):
    """Two stage nodes on threads, on the card, deployed in-band: rows
    within 1e-5 of max |y| of the whole-graph forward on the card (TF32
    off, as the ``node`` command runs), one flash launch per block per
    frame, the nodes' stats on cuda."""
    import threading

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    import numpy as np

    from defer_tpu_torch import models, partition
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
    from defer_tpu_torch.utils.convert import params_to_device

    g = getattr(models, model)()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=2)
    rng = np.random.default_rng(1)
    spec = stages[0].in_spec
    xs = [rng.integers(0, 100, (2,) + spec.shape).astype(np.int32)
          if not spec.dtype.is_floating_point else
          rng.standard_normal((2,) + spec.shape).astype(np.float32)
          for _ in range(3)]
    nodes = [StageNode(None, "127.0.0.1:0", None) for _ in stages]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    ts = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in ts:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="lzb")
    try:
        disp.deploy(stages, p, addrs, batch=2)
        before = FLASH.launches
        outs = disp.stream(xs)
        launches = FLASH.launches - before
        st = disp.stats(addrs)
    finally:
        disp.close()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    blocks = sum(n.startswith("block_") for n in g.topo_order)
    assert launches == blocks * len(xs)
    assert all(s["device"].startswith("cuda") and s["processed"] == 3
               and s["mem_bytes"] > 0 for s in st)
    pdev = params_to_device(p, cuda)
    with torch.inference_mode():
        for x, y in zip(xs, outs):
            want = g.apply(pdev, torch.from_numpy(x).to(cuda)).cpu().numpy()
            err = float(np.abs(y - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), err


@pytest.mark.timeout(300)
@pytest.mark.parametrize("model", ["bert_tiny", "resnet_tiny"])
def test_ici_hop_on_card(cuda, model, monkeypatch):
    """Two stage nodes on threads, on the card, with an ici hop between
    them and into the dispatcher: no node records a host sync (the output
    tensor is handed over on the card), the dispatcher host-copies each
    result once, and the rows equal the same chain's over tcp hops."""
    import threading

    import numpy as np

    from defer_tpu_torch import models, partition
    from defer_tpu_torch.obs import REGISTRY
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = getattr(models, model)()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=2)
    rng = np.random.default_rng(2)
    spec = stages[0].in_spec
    xs = [rng.integers(0, 100, (2,) + spec.shape).astype(np.int32)
          if not spec.dtype.is_floating_point else
          rng.standard_normal((2,) + spec.shape).astype(np.float32)
          for _ in range(4)]

    def run(tier):
        nodes = [StageNode(None, "127.0.0.1:0", None, tier=tier)
                 for _ in stages]
        addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
        ts = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
        for t in ts:
            t.start()
        disp = ChainDispatcher(addrs[0], tier="auto" if tier == "ici"
                               else "tcp")
        try:
            disp.deploy(stages, p, addrs, batch=2)
            outs = disp.stream(xs)
            st = disp.stats(addrs)
        finally:
            disp.close()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        return outs, st, disp

    tcp, _, _ = run("tcp")
    chs0 = int(REGISTRY.histogram("chain.host_sync_s").summary()
               .get("count", 0))
    outs, st, disp = run("ici")
    assert [s["tier"] for s in st] == ["ici", "ici"]
    assert st[1]["tier_in"] == "ici" and disp.tier_in == "ici"
    assert [s["host_sync_s"]["count"] for s in st] == [0, 0]
    assert all(s["device"].startswith("cuda") for s in st)
    assert int(REGISTRY.histogram("chain.host_sync_s").summary()
               .get("count", 0)) - chs0 == len(xs)
    for a, b in zip(tcp, outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.timeout(300)
def test_replicated_bert_chain_on_card(cuda, monkeypatch):
    """A three-stage BERT-tiny chain of in-process nodes on the card, with
    stage 1 as two replicas behind a fan-out and a fan-in: one flash
    launch per block per frame in all, the two replicas process the frames
    once between them, and the rows equal the unreplicated chain's."""
    import threading

    import numpy as np

    from defer_tpu_torch import models, partition
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = models.bert_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 100, (2,) + stages[0].in_spec.shape)
          .astype(np.int32) for _ in range(5)]

    def run(r1):
        groups = [[StageNode(None, "127.0.0.1:0", None)],
                  [StageNode(None, "127.0.0.1:0", None,
                             replica=j if r1 > 1 else None)
                   for j in range(r1)],
                  [StageNode(None, "127.0.0.1:0", None, fan_in=r1)]]
        addrs = [[f"127.0.0.1:{n.address[1]}" for n in grp]
                 for grp in groups]
        ts = [threading.Thread(target=n.serve, daemon=True)
              for grp in groups for n in grp]
        for t in ts:
            t.start()
        disp = ChainDispatcher(addrs[0][0])
        try:
            disp.deploy(stages, p, [a[0] if len(a) == 1 else a
                                    for a in addrs], batch=2)
            before = FLASH.launches
            outs = disp.stream(xs)
            launches = FLASH.launches - before
            st = disp.stats([a for grp in addrs for a in grp])
        finally:
            disp.close()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        return outs, launches, st

    base, _, _ = run(1)
    outs, launches, st = run(2)
    blocks = sum(n.startswith("block_") for n in g.topo_order)
    assert launches == blocks * len(xs)
    shares = [s["processed"] for s in st if s["stage"] == 1]
    assert [s["replica"] for s in st if s["stage"] == 1] == [0, 1]
    assert sum(shares) == len(xs) and min(shares) > 0
    assert st[-1]["fan_in"] == 2
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_identify_chip_on_the_card(cuda):
    """The card's row: the H100 SXM is ``"h100"`` with its data-sheet
    peaks; any other card is ``"unknown"`` and borrows none."""
    from defer_tpu_torch.models import resnet_tiny
    from defer_tpu_torch.plan import StageCostModel
    from defer_tpu_torch.utils import hw
    name = torch.cuda.get_device_name(0)
    gen = hw.card_generation(name)
    assert hw.identify_chip(cuda) == hw.identify_chip(0) == gen
    cm = StageCostModel(resnet_tiny())
    assert cm.gen == gen
    if gen == "h100":
        assert (cm.peak_flops_s, cm.hbm_bw_s) == (989e12, 3.35e12)
    else:
        assert hw.peak_flops(gen) == 0.0


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_measured_node_costs_counts_flash_launches(cuda, dtype):
    """Each node runs ``k`` calls per CUDA-graph replay, one warm replay
    and ``reps`` timed ones: every block adds ``k * (reps + 1)`` flash
    launches (the capture and its warm-up are not counted)."""
    import math

    from defer_tpu_torch.models import bert_tiny
    from defer_tpu_torch.utils.profiling import measured_node_costs
    g = bert_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    blocks = sum(n.startswith("block_") for n in g.topo_order)
    k, reps = 8, 2
    before = FLASH.launches
    costs = measured_node_costs(g, params, batch=2, compute_dtype=dtype,
                                k=k, reps=reps)
    torch.cuda.synchronize()
    assert FLASH.launches - before == blocks * k * (reps + 1)
    assert set(costs) == set(g.topo_order)
    assert all(math.isfinite(v) and v > 0 for v in costs.values())


# ---------------------------------------------------------------------------
# the profiling plane on the card (obs/profile.py)
# ---------------------------------------------------------------------------

def test_cuda_graph_capture_counts_one_recompile(cuda):
    """A CUDA-graph capture is one run-time compilation: the counter moves
    by one per capture, not per replay, and an armed watcher emits one
    ``recompile`` event naming the capture."""
    from defer_tpu_torch.obs import recorder, recompile_watcher
    from defer_tpu_torch.runtime.cuda_graph import capture

    with torch.inference_mode():
        x = torch.ones(64, device=cuda)
    w = recompile_watcher()
    c0 = w.count
    cursor = recorder().cursor()
    w.arm()
    try:
        g = capture(lambda: x.mul_(1.0), cuda, label="unit")
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
    finally:
        w.disarm()
    assert w.count - c0 == 1
    _, evs = recorder().events_since(cursor)
    evs = [e["data"] for e in evs if e["kind"] == "recompile"]
    assert evs and evs[0]["via"] == "cuda_graph"
    assert evs[0]["label"] == "unit"


def test_mem_bytes_equals_memory_allocated(cuda):
    """A node on the card reports the caching allocator's live bytes, and
    the profiling plane reads the same number."""
    from defer_tpu_torch.obs import device_memory_bytes
    from defer_tpu_torch.runtime.node import StageNode

    node = StageNode(None, "127.0.0.1:0", None, device="cuda")
    try:
        keep = torch.ones(1 << 20, device=cuda)
        torch.cuda.synchronize()
        want = torch.cuda.memory_allocated(node.device)
        assert node._stats({})["mem_bytes"] == want
        assert device_memory_bytes(device=cuda) == want > 0
        payload, _, _ = node.obs_snapshot(include_spans=False)
        assert payload["mem_bytes"] == want
        del keep
    finally:
        node._srv.close()


def test_node_mfu_on_the_card(cuda):
    """MFU against the card's row: a number in (0, 1] on an H100, None on a
    card without a row."""
    from defer_tpu_torch.runtime.node import StageNode
    from defer_tpu_torch.utils import hw

    node = StageNode(None, "127.0.0.1:0", None, device="cuda")
    try:
        node.stage_flops = 4e9
        node.infer_hist.record(0.002)
        mfu = node._stats({})["mfu"]
        if hw.identify_chip(cuda) == "h100":
            assert mfu == 4e9 / (node.infer_hist.quantile(0.5) * 989e12)
            assert 0 < mfu <= 1
        else:
            assert mfu is None
    finally:
        node._srv.close()


def test_profile_window_trace_holds_the_flash_kernel(cuda, tmp_path):
    """A profiling window with ``trace_dir`` records the card's kernels
    launched on another thread (a node's compute loop) into its Chrome
    trace, and counts the window's flash launches."""
    import json
    import threading

    from defer_tpu_torch.obs import ProfileSession
    from defer_tpu_torch.runtime.node import _kernel_launches

    q = torch.randn(2, 4, 128, 64, device=cuda)
    sess = ProfileSession({}, launches=_kernel_launches,
                          trace_dir=str(tmp_path))
    sess.start()
    th = threading.Thread(target=lambda: [flash_attention(q, q, q)
                                          for _ in range(3)])
    th.start()
    th.join(timeout=60)
    torch.cuda.synchronize()
    rep = sess.stop()
    assert rep["kernel_launches"]["flash_attention"] == 3
    events = json.load(open(rep["trace_file"]))["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    assert any("flash_attn_kernel" in n for n in names), names[:20]


# ---------------------------------------------------------------------------
# the profiling helpers and the bench command on the card
# ---------------------------------------------------------------------------

def test_amortized_forward_seconds_is_one_graph_replay(cuda):
    """The ``k`` forwards of a timed call are one CUDA-graph replay: every
    replay (one warm call, ``max_iters`` timed ones) adds ``k`` flash
    launches per block, and the capture and its warm-up add none."""
    import math

    from defer_tpu_torch.models import bert_tiny
    from defer_tpu_torch.obs import recompile_watcher
    from defer_tpu_torch.utils.convert import params_to_device
    from defer_tpu_torch.utils.profiling import amortized_forward_seconds
    g = bert_tiny()
    params = params_to_device(g.init(torch.Generator().manual_seed(0)),
                              cuda)
    blocks = sum(n.startswith("block_") for n in g.topo_order)
    ids = torch.zeros((2,) + tuple(g.input_spec.shape), dtype=torch.int32,
                      device=cuda)
    k, timed = 4, 3
    before, compiles = FLASH.launches, recompile_watcher().count
    sec = amortized_forward_seconds(g.apply, params, ids, k,
                                    min_iters=timed, min_s=0.0,
                                    max_iters=timed)
    torch.cuda.synchronize()
    assert FLASH.launches - before == blocks * k * (timed + 1)
    assert recompile_watcher().count - compiles == 1
    assert math.isfinite(sec) and sec > 0


def test_bench_int8_counts_one_quantizer_launch_per_step(cuda, capsys):
    """``bench --wire int8`` on the card: a bf16 ring, one bf16 quantizer
    launch per pipeline step of every push (the capture push's replay
    included, the capture itself not), no flash launch."""
    import json

    from defer_tpu_torch import cli
    q0, f0 = KERNEL.snapshot(), FLASH.launches
    cli.main(["bench", "--model", "resnet_tiny", "--stages", "2",
              "--chunk", "4", "--wire", "int8", "--seconds", "0.5"])
    torch.cuda.synchronize()
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n, by_dtype = KERNEL.since(q0)
    assert row["wire"] == "int8" and row["devices"] >= 1
    assert n == row["steps"] + 4 and row["steps"] == 4 * row["chunk_calls"]
    assert dict(by_dtype) == {"bfloat16": n}
    assert FLASH.launches == f0
    assert row["value"] > 0


def test_ste_hop_on_card_is_the_inference_hop(cuda):
    """The straight-through hop on the card: its forward is the inference
    hop bit for bit in one quantizer launch, its backward rolls the
    cotangent one slot back and launches nothing."""
    from defer_tpu_torch.ops.quant import quantized_ring_hop, ste_ring_hop
    gen = torch.Generator(device=cuda).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        y = torch.randn((4, 8, 1024), generator=gen, device=cuda).to(
            dtype).requires_grad_(True)
        before = KERNEL.launches
        out = ste_ring_hop(y, dtype)
        assert KERNEL.launches == before + 1
        ct = torch.randn((4, 8, 1024), generator=gen, device=cuda).to(dtype)
        (gy,) = torch.autograd.grad(out, y, ct)
        assert KERNEL.launches == before + 1
        assert torch.equal(gy, torch.roll(ct, -1, 0))
        with torch.no_grad():
            assert torch.equal(out, quantized_ring_hop(y, dtype))


@pytest.mark.parametrize("wire", ["buffer", "int8"])
def test_training_step_on_card_matches_cpu(cuda, wire):
    """One ``loss_and_grad`` of a 4-stage resnet_tiny ring on the card
    against the same on the CPU: the quantizer launched once per step of
    the chunk (T = M + N - 1; the recompute reruns no hop).  Buffer wire:
    loss rtol 1e-5, each stage's gradient row within 1e-4 of its max |g|
    (cuDNN and the CPU sum in other orders).  int8: a rounding flip moves
    one value by one int8 step, so loss rtol 1e-3, rows within 1e-2."""
    import numpy as np

    from defer_tpu_torch import (PipelineTrainer, SpmdPipeline, models,
                                 partition)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, 2, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 2))
    stages = partition(g, num_stages=4)
    loss_fn = lambda lg, y: torch.nn.functional.cross_entropy(  # noqa: E731
        lg.float(), y)
    res = {}
    for dev in ("cpu", cuda):
        t = PipelineTrainer(SpmdPipeline(stages, params, device=dev,
                                         microbatch=2, wire=wire), loss_fn)
        before = KERNEL.launches
        loss, grads = t.loss_and_grad(xs, ys)
        torch.cuda.synchronize()
        want = 3 + 4 - 1 if dev == cuda and wire == "int8" else 0
        assert KERNEL.launches - before == want
        res[str(dev)] = (float(loss), [gr.cpu() for gr in grads])
    (lc, gc), (lg, gg) = res["cpu"], res[str(cuda)]
    loss_rtol, rel = (1e-5, 1e-4) if wire == "buffer" else (1e-3, 1e-2)
    assert abs(lg - lc) <= loss_rtol * abs(lc)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= rel * b.abs().max()
