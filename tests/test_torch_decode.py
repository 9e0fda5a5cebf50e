"""Port parity: pipelined decoding, ``Defer.generate``/``logits``/``score``
and speculative decoding of ``defer_tpu_torch`` against JAX.

The same ``gpt_tiny`` weights (``params_from_jax``) and the same prompts go
through the JAX package's ``PipelinedDecoder`` on the CPU mesh and the
port's on the CPU.  Greedy and beam tokens are token-exact: the math is
the same op for op, and an f32 reduction-order difference moves no argmax
on these inputs (a near tie would show here as a mismatch; none occurs).
Sampling cannot match ``jax.random`` draws, so it is held on the port
alone: determinism, independence from chunking, distinct rounds, the
top-k support, and the distribution of 20,000 draws (every category above
1% within 4 standard errors of its softmax probability).  ``score`` is
held to rtol 1e-4 and ``logits`` to 1e-5 of max |logit|, the float paths'
summation-order tolerance.
"""

import numpy as np
import pytest
import torch

import jax

import defer_tpu as jdt
import defer_tpu.models as jax_models
from defer_tpu.runtime.decode import PipelinedDecoder as JaxDecoder
from defer_tpu_torch import (Defer, DeferConfig, models, params_from_jax,
                             speculative_generate)
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.obs import REGISTRY, enable_tracing, tracer
from defer_tpu_torch.runtime import flatbuf
from defer_tpu_torch.runtime.decode import (PipelinedDecoder, _sample_ids,
                                            _split_blocks)

torch.set_num_threads(1)

VOCAB = 97
MAX_LEN = 24


@pytest.fixture(scope="module")
def model():
    jg = jax_models.gpt_tiny(seq_len=MAX_LEN, vocab=VOCAB)
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(7)))
    tg = models.gpt_tiny(seq_len=MAX_LEN, vocab=VOCAB)
    return jg, jp, tg, params_from_jax(tg, jp)


@pytest.fixture(scope="module")
def gqa_model():
    jg = jax_models.gpt_tiny(seq_len=MAX_LEN, vocab=VOCAB, kv_heads=1)
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(9)))
    tg = models.gpt_tiny(seq_len=MAX_LEN, vocab=VOCAB, kv_heads=1)
    return jg, jp, tg, params_from_jax(tg, jp)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(3).integers(0, VOCAB, (8, 5)).astype(
        np.int32)


def _port(tg, tp, n, mb, **kw):
    return PipelinedDecoder(tg, tp, num_stages=n, microbatch=mb,
                            max_len=MAX_LEN, device="cpu", **kw)


def _jax(jg, jp, n, mb, **kw):
    return JaxDecoder(jg, jp, num_stages=n, microbatch=mb, max_len=MAX_LEN,
                      **kw)


@pytest.mark.parametrize("n,mb", [(4, 2), (2, 4), (1, 8)])
def test_greedy_matches_jax(model, prompt, n, mb):
    """Decode-rate and fused-prefill greedy tokens equal JAX's; the port's
    chunked dispatch gives the same tokens with one dispatch per chunk."""
    jg, jp, tg, tp = model
    jdec, dec = _jax(jg, jp, n, mb), _port(tg, tp, n, mb)
    want = jdec.generate(prompt, 9)
    np.testing.assert_array_equal(dec.generate(prompt, 9), want)
    np.testing.assert_array_equal(dec.generate(prompt, 9, prefill=True),
                                  jdec.generate(prompt, 9, prefill=True))
    counter = REGISTRY.counter("decode.dispatches")
    before = counter.n
    np.testing.assert_array_equal(dec.generate(prompt, 9, token_chunk=2),
                                  want)
    num_steps, _ = dec._schedule(14, 0, 2)
    assert counter.n - before == -(-num_steps // (2 * n))


@pytest.mark.parametrize("case", ["int8_kv", "w8a16", "int8_kv_prefill",
                                  "gqa", "gqa_prefill", "two_fills"])
def test_decoder_options_match_jax(model, gqa_model, prompt, case):
    jg, jp, tg, tp = gqa_model if case.startswith("gqa") else model
    n, mb = (2, 2) if case == "two_fills" else (4, 2)
    ctor = {"int8_kv": dict(kv_cache="int8"),
            "int8_kv_prefill": dict(kv_cache="int8"),
            "w8a16": dict(weight_dtype="int8")}.get(case, {})
    gen = dict(prefill=True) if case.endswith("prefill") else {}
    want = _jax(jg, jp, n, mb, **ctor).generate(prompt, 8, **gen)
    dec = _port(tg, tp, n, mb, **ctor)
    np.testing.assert_array_equal(dec.generate(prompt, 8, **gen), want)
    if case.startswith("gqa"):
        assert dec.num_kv_heads == 1 and dec._cache_shape[3] == 1
    if case.startswith("int8_kv"):
        assert dec.caches["k"][0].dtype == torch.int8
        assert dec.caches["ks"][0].dtype == torch.float32


def test_eos_and_streaming_match_jax(model, prompt):
    """``eos_id`` with ``token_chunk`` (the early stop), and ``on_tokens``
    spans: contiguous, covering exactly the generated region, with and
    without prefill and over two fills."""
    jg, jp, tg, tp = model
    dec = _port(tg, tp, 2, 4)
    ref = dec.generate(prompt, 10)
    eos = int(ref[0, 6])
    want = _jax(jg, jp, 2, 4).generate(prompt, 10, eos_id=eos,
                                       token_chunk=2)
    got = dec.generate(prompt, 10, eos_id=eos, token_chunk=2)
    np.testing.assert_array_equal(got, want)
    gen = got[0, 5:]
    hits = np.where(gen == eos)[0]
    assert hits.size and (gen[hits[0]:] == eos).all()

    for d, kw, rows in ((_port(tg, tp, 4, 2), dict(token_chunk=2), {(0, 8)}),
                        (_port(tg, tp, 4, 2),
                         dict(token_chunk=3, prefill=True), {(0, 8)}),
                        (_port(tg, tp, 2, 2), dict(token_chunk=2),
                         {(0, 4), (4, 8)})):
        spans = []
        out = d.generate(prompt, 9, on_tokens=lambda lo, hi, t, rows:
                         spans.append((lo, hi, t, rows)), **kw)
        np.testing.assert_array_equal(out, ref[:, :14])
        assert {s[3] for s in spans} == rows
        for r0, r1 in rows:
            mine = [s for s in spans if s[3] == (r0, r1)]
            assert mine[0][0] == 5 and mine[-1][1] == 14
            assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
            np.testing.assert_array_equal(
                np.concatenate([s[2] for s in mine], axis=1), out[r0:r1, 5:])


@pytest.mark.parametrize("n,mb,beam", [(4, 4, 2), (2, 6, 3), (1, 4, 4)])
def test_beam_matches_jax(model, prompt, n, mb, beam):
    jg, jp, tg, tp = model
    nspg = mb // beam
    b = min(8, n * nspg)
    b -= b % nspg
    want = _jax(jg, jp, n, mb, beam_width=beam).generate(prompt[:b], 8)
    dec = _port(tg, tp, n, mb, beam_width=beam)
    np.testing.assert_array_equal(dec.generate(prompt[:b], 8), want)
    # chunk-overshoot steps are true bubbles: the ledger stays right
    np.testing.assert_array_equal(
        dec.generate(prompt[:b], 8, token_chunk=1), want)


def test_beam_one_equals_greedy_and_int8_beam(model, prompt):
    _, _, tg, tp = model
    greedy = _port(tg, tp, 2, 4).generate(prompt, 6)
    np.testing.assert_array_equal(
        _port(tg, tp, 2, 4, beam_width=1).generate(prompt, 6), greedy)
    # beam re-parenting gathers the int8 rows AND their scales
    exact = _port(tg, tp, 2, 4, beam_width=2).generate(prompt[:4], 7)
    quant = _port(tg, tp, 2, 4, beam_width=2, kv_cache="int8")
    got = quant.generate(prompt[:4], 7)
    assert (got[:, :5] == prompt[:4]).all() and (got == exact).mean() > 0.85
    np.testing.assert_array_equal(got, quant.generate(prompt[:4], 7))


def test_defer_entry_points_match_jax(model, prompt):
    jg, jp, tg, tp = model
    jd = jdt.Defer(config=jdt.DeferConfig(microbatch=2, chunk=4))
    td = Defer(DeferConfig(microbatch=2, chunk=4, device="cpu"))
    np.testing.assert_array_equal(
        td.generate(tg, tp, prompt, 6, num_stages=4),
        jd.generate(jg, jp, prompt, 6, num_stages=4))
    dec = next(iter(td._decoder_cache.values()))[2]
    td.generate(tg, tp, prompt, 4, num_stages=4)
    assert next(iter(td._decoder_cache.values()))[2] is dec
    td.generate(tg, tp, prompt, 4, num_stages=4, kv_cache="int8")
    assert len(td._decoder_cache) == 2

    ids = np.random.default_rng(5).integers(0, VOCAB, (4, 10)).astype(
        np.int32)
    lp, ppl = td.score(tg, tp, ids, num_stages=4)
    jlp, jppl = jd.score(jg, jp, ids, num_stages=4)
    np.testing.assert_allclose(lp, jlp, rtol=1e-4)
    np.testing.assert_allclose(ppl, np.exp(-lp / 9), rtol=1e-6)
    assert (ppl > 0).all()
    # T=6 runs through the 8-position bucket, cached; logits to JAX's
    short = ids[:, :6]
    got = td.logits(tg, tp, short, num_stages=4)
    want = jd.logits(jg, jp, short, num_stages=4)
    assert got.shape == want.shape == (4, 6, VOCAB)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pipes = [v[2] for v in td._score_cache.values()]
    assert sorted(p.in_spec.shape[0] for p in pipes) == [8, 16]
    td.logits(tg, tp, short, num_stages=4)
    assert len(td._score_cache) == 2
    with pytest.raises(ValueError, match="multiple of microbatch"):
        td.logits(tg, tp, ids[:3], num_stages=4)
    with pytest.raises(ValueError, match="exceeds"):
        td.logits(tg, tp, np.zeros((2, MAX_LEN + 1), np.int32))


def test_sampling_properties(model, prompt):
    """Same seed, same draw; chunking changes nothing (decode rate and
    prefill); another seed differs; ids stay in the vocabulary; rounds of
    a larger batch draw independently."""
    _, _, tg, tp = model
    dec = _port(tg, tp, 2, 4)
    kw = dict(temperature=1.0, seed=11)
    a = dec.generate(prompt, 8, **kw)
    np.testing.assert_array_equal(a, dec.generate(prompt, 8, **kw))
    np.testing.assert_array_equal(a, dec.generate(prompt, 8, token_chunk=3,
                                                  **kw))
    assert not np.array_equal(a, dec.generate(prompt, 8, temperature=1.0,
                                              seed=12))
    assert ((a >= 0) & (a < VOCAB)).all()
    tk = dict(temperature=0.7, top_k=7, seed=3, prefill=True)
    np.testing.assert_array_equal(
        dec.generate(prompt, 10, **tk),
        dec.generate(prompt, 10, token_chunk=4, **tk))
    same = np.full((8, 5), 3, np.int32)  # two rounds of four equal prompts
    out = _port(tg, tp, 2, 2).generate(same, 8, temperature=1.0, seed=0)
    assert not np.array_equal(out[:4], out[4:])


def test_top_k_support_and_distribution():
    """``_sample_ids``: top-k draws never leave the k largest logits; over
    20,000 rows, each category of probability above 1% is drawn within 4
    standard errors of its softmax probability."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4096, VOCAB, generator=g) * 3
    ids = _sample_ids(logits, torch.tensor(0.8), 5, torch.tensor(1), 17)
    top = logits.topk(5, dim=-1).indices
    assert (top == ids[:, None]).any(dim=-1).all()

    draws, temp = 20_000, 0.7
    row = torch.randn(10, generator=g) * 2
    for t in (0, 12345):
        ids = _sample_ids(row.expand(draws, 10), torch.tensor(temp), None,
                          torch.tensor(5), t)
        freq = torch.bincount(ids, minlength=10).double() / draws
        p = (row / temp).double().softmax(-1)
        se = (p * (1 - p) / draws).sqrt()
        big = p > 0.01
        assert big.sum() >= 3
        assert ((freq - p).abs()[big] <= 4 * se[big]).all(), (freq, p)


def test_reweight_equals_fresh_decoder(model, prompt):
    _, _, tg, tp = model
    for kw in ({}, dict(weight_dtype="int8")):
        dec = _port(tg, tp, 4, 2, **kw)
        a = dec.generate(prompt, 6)
        tp2 = tree_map(lambda v: v * 1.1, tp)
        dec.reweight(tp2)
        np.testing.assert_array_equal(
            dec.generate(prompt, 6), _port(tg, tp2, 4, 2, **kw).generate(
                prompt, 6))
        dec.reweight(tp)
        np.testing.assert_array_equal(dec.generate(prompt, 6), a)
    # W8A16 rows are quantize_leaves of each stage's leaves, on the host
    for s, (q_row, s_row) in enumerate(dec._rows):
        paths, leaves = flatbuf.flatten_leaves(
            {nm: tp[nm] for nm in dec._stage_param_names[s]})
        q, sc, _ = flatbuf.quantize_leaves(leaves, dec._wmeta[s])
        assert q_row.dtype == torch.int8
        assert torch.equal(q_row, q) and torch.equal(s_row, sc)
    bad = dict(tp, lm_head={"w": torch.zeros(2, 2), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="reweight"):
        dec.reweight(bad)
    drift = dict(tp, lm_head=tree_map(lambda v: v.to(torch.int32),
                                      tp["lm_head"]))
    with pytest.raises(ValueError, match="reweight"):
        dec.reweight(drift)


def test_validation_and_device(model, prompt):
    _, _, tg, tp = model
    dec = _port(tg, tp, 2, 4)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        dec.generate(prompt[:3], 2)
    with pytest.raises(ValueError, match="exceeds"):
        dec.generate(prompt, MAX_LEN)
    with pytest.raises(ValueError, match="at least one token"):
        dec.generate(np.zeros((8, 0), np.int32), 4)
    np.testing.assert_array_equal(dec.generate(prompt, 0), prompt)
    with pytest.raises(ValueError, match="max_len"):
        PipelinedDecoder(tg, tp, num_stages=2, max_len=MAX_LEN + 1,
                         device="cpu")
    with pytest.raises(ValueError, match="divide"):
        _port(tg, tp, 2, 4, beam_width=3)
    beam = _port(tg, tp, 2, 4, beam_width=2)
    for kw in (dict(prefill=True), dict(temperature=0.5)):
        with pytest.raises(ValueError, match="beam search"):
            beam.generate(prompt[:4], 4, **kw)
    assert _split_blocks(12, 4) == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                    [9, 10, 11]]
    with pytest.raises(ValueError):
        _split_blocks(2, 4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot "
                    "be shown here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelinedDecoder(tg, tp, num_stages=2, microbatch=4)


def test_decode_chunk_trace_records(model, prompt):
    _, _, tg, tp = model
    was_on = tracer().enabled
    tr = enable_tracing()
    try:
        tr.clear()
        dec = _port(tg, tp, 2, 4)
        dec.generate(prompt, 4, token_chunk=1)
        num_steps, chunk = dec._schedule(9, 0, 1)
        spans = [s for s in tr.spans if s["name"] == "decode.chunk"]
        assert [s["args"]["steps_run"] for s in spans] == \
            list(range(0, num_steps, chunk))
        assert all(s["args"]["chunk_steps"] == 2 for s in spans)
    finally:
        tr.enabled = was_on
    assert tracer() is tr


# ---------------------------------------------------------------------------
# speculative decoding (the scenarios of tests/test_speculative.py)
# ---------------------------------------------------------------------------

SPEC_VOCAB = 61
SPEC_T = 32


@pytest.fixture(scope="module")
def pair():
    target = models.gpt(4, 32, 2, SPEC_T, vocab=SPEC_VOCAB,
                        name="spec_target")
    draft = models.gpt(2, 16, 2, SPEC_T, vocab=SPEC_VOCAB, name="spec_draft")
    return (target, target.init(torch.Generator().manual_seed(0)),
            draft, draft.init(torch.Generator().manual_seed(1)))


def reference_greedy(graph, params, prompt, max_new):
    """Target-only greedy via full recompute per token (oracle)."""
    out = np.array(prompt)
    for _ in range(max_new):
        logits = graph.apply(params, torch.from_numpy(out)).numpy()
        nxt = np.argmax(logits[:, out.shape[1] - 1], axis=-1)
        out = np.concatenate([out, nxt[:, None].astype(out.dtype)], axis=1)
    return out


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_speculative_token_exact(pair, gamma):
    target, tparams, draft, dparams = pair
    defer = Defer(DeferConfig(microbatch=2, chunk=4, device="cpu"))
    prompt = np.random.default_rng(3).integers(0, SPEC_VOCAB, (4, 5))
    got, stats = speculative_generate(
        defer, target, tparams, draft, dparams, prompt, 10,
        gamma=gamma, num_stages=4, draft_num_stages=2, return_stats=True)
    np.testing.assert_array_equal(
        got, reference_greedy(target, tparams, prompt, 10))
    assert stats["rounds"] >= 1 and stats["target_forwards"] >= 1
    assert 0.0 <= stats["accept_rate"] <= 1.0


def test_speculative_perfect_draft_and_eos(pair):
    target, tparams, draft, dparams = pair
    defer = Defer(DeferConfig(microbatch=2, chunk=4, device="cpu"))
    prompt = np.random.default_rng(4).integers(0, SPEC_VOCAB, (2, 4))
    gamma, new = 4, 12
    got, stats = speculative_generate(
        defer, target, tparams, target, tparams, prompt, new,
        gamma=gamma, num_stages=4, draft_num_stages=4, return_stats=True)
    ref = reference_greedy(target, tparams, prompt, new)
    np.testing.assert_array_equal(got, ref)
    assert stats["accept_rate"] == 1.0
    assert stats["target_forwards"] <= -(-new // (gamma + 1)) + 1

    eos = int(ref[0, 5])
    got = speculative_generate(defer, target, tparams, draft, dparams,
                               prompt, new, gamma=3, eos_id=eos,
                               num_stages=4, draft_num_stages=2)
    row = got[0, 4:]
    hits = np.where(row == eos)[0]
    assert hits.size and (row[hits[0]:] == eos).all()
    np.testing.assert_array_equal(got[0, :4 + hits[0] + 1],
                                  ref[0, :4 + hits[0] + 1])
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(defer, target, tparams, draft, dparams,
                             prompt, 4, gamma=0)
    with pytest.raises(ValueError, match="exceeds"):
        speculative_generate(defer, target, tparams, draft, dparams,
                             prompt, SPEC_T, num_stages=4)
