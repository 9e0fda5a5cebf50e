"""Port parity: decoding and scoring across ``torch.distributed`` processes.

One spawn of ``scripts/torch_ring_procs.py --cases decode`` (four gloo CPU
processes, a deadline of 120 s) runs every decoder case of
``R.DECODE["cpu"]``; the tests read its results.  The workers map the
seeded weights and numpy prompts this process builds and hands them
(``R.make_inputs``), so the same values go through:

* the decoder across processes: ``gpt_tiny`` in 4 stages on (stage 4),
  one a process; an eight-block ``gpt_tiny`` in 8 stages on (stage 8), two
  a process (the local roll and the boundary); ``gpt_tiny`` in 2 stages on
  (data 2, stage 2), each line's ring on two processes.  The cases
  (``R.DECODE_CASES``): greedy with and without the fused prefill at two
  ``token_chunk`` values, sampled, beam width 2, int8 KV cache, W8A16,
  ``eos_id`` with ``on_tokens``, ``Defer(mesh=).generate``, ``.logits``
  and ``.score`` on both wires, and ``speculative_generate`` over that
  ``Defer``;
* the same cases on the port's one-process engines (``R.DecodeRun`` with
  ``mesh=None``): every array bit-equal (the same ops on the same rows, one
  thread everywhere), every process's the same, the kernel calls summed
  over the processes equal to the one process's;
* the JAX ``PipelinedDecoder``/``Defer`` on the conftest's CPU mesh, the
  weights carried over with ``params_to_jax``, at
  ``tests/test_torch_decode.py``'s bounds: greedy, beam, int8-KV, W8A16,
  prefill and eos tokens equal; logits within 1e-5 of max |logit| on the
  buffer wire (one quant step, max |logit| / 127, on the int8 wire, as
  ``tests/test_torch_multiproc_ring.py`` holds the int8 ring); scores
  within rtol 1e-4 (int8: the logits' bound carried through a log-softmax
  and a sum, 2 (T - 1) max |logit| / 127); speculative tokens equal to
  the JAX target's greedy by full recompute.  Sampled tokens cannot match
  ``jax.random`` draws: they are held to the one-process decoder, and to
  their vocabulary and prompts.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import defer_tpu as jdt
import defer_tpu.models as jax_models
from defer_tpu.runtime.decode import PipelinedDecoder as JaxDecoder
from defer_tpu_torch import models, params_to_jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_ring_procs as R  # noqa: E402

torch.set_num_threads(1)

PROCS = 4
DC = R.DECODE["cpu"]
MB, NEW, MAX_LEN = DC["microbatch"], DC["new"], DC["max_len"]
PLEN = DC["prompts"][1]
#: (mesh, case) pairs the workers ran
CASES = [(key, case) for key in DC["meshes"]
         for case in R.decode_cases(DC, key)]
#: the cases held to JAX (sampling draws cannot match jax.random's)
JAX_CASES = [c for c in CASES if c[1] != "sampled"]


def _id(c):
    return f"{c[0]}-{c[1]}"


@pytest.fixture(scope="module")
def given():
    return R.make_inputs("cpu", ("decode",))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, given):
    return R.spawn(PROCS, "cpu", "cpu", tmp_path_factory.mktemp("decode"),
                   given, cases=("decode",), deadline_s=120.0,
                   timeout_s=60.0)


@pytest.fixture(scope="module")
def one(given):
    """Per (mesh, case): the one-process engines' ``(arrays, meta)`` on the
    same weights and inputs, counted as the workers count; per mesh, the
    greedy decoder's rows under ``(mesh, "rows")``."""
    counts = R.Counts("cpu")
    out = {}
    try:
        graphs = R.decode_graphs(models, DC)
        for key in DC["meshes"]:
            run = R.DecodeRun(torch, models, DC, given, key, "cpu", graphs)
            for case in R.decode_cases(DC, key):
                out[key, case] = run.case(case, counts)
            out[key, "rows"] = run.rows()
    finally:
        counts.close()
    return out


def _got(worker, key, case):
    pre = f"dec_{key}_{case}__"
    return {k[len(pre):]: v for k, v in worker.items()
            if k.startswith(pre)}


@pytest.mark.parametrize("c", CASES, ids=_id)
def test_every_process_returns_the_same(spawned, c):
    """Tokens, logits and scores are one global value, as the JAX
    multi-controller program returns: every process holds all of it."""
    first = _got(spawned[0], *c)
    assert first
    for r in spawned[1:]:
        got = _got(r, *c)
        assert got.keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(got[k], first[k], err_msg=k)


@pytest.mark.parametrize("c", CASES, ids=_id)
def test_bit_equal_to_one_process(spawned, one, c):
    want, meta = one[c]
    got = _got(spawned[0], *c)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mine = spawned[0]["meta"]["decode"][c[0]][c[1]]
    assert mine.get("spans") == meta.get("spans")
    assert mine.get("stats") == meta.get("stats")


@pytest.mark.parametrize("c", CASES, ids=_id)
def test_launches_sum_to_one_process(spawned, one, c):
    """Flash and quantizer calls summed over the processes equal the one
    process's; the stages split evenly, so each process makes its share
    (flash: its blocks' calls; the quantizer: one a step over its own
    slots, so the sum is the one process's times four)."""
    want = one[c][1]["launches"]
    each = [r["meta"]["decode"][c[0]][c[1]]["launches"] for r in spawned]
    assert all(e == each[0] for e in each)
    assert sum(e["flash_attention"] for e in each) == \
        want["flash_attention"]
    if c[1].endswith("int8") and c[1] != "w8a16":
        steps = spawned[0]["meta"]["decode"][c[0]][c[1]]["steps"]
        assert each[0]["quant_int8"] == steps == want["quant_int8"] > 0
    else:
        assert sum(e["quant_int8"] for e in each) == want["quant_int8"] == 0
    if c[1].startswith("prefill"):
        assert each[0]["flash_attention"] > 0


@pytest.mark.parametrize("key", list(DC["meshes"]))
def test_each_process_holds_its_stages(spawned, one, key):
    """Host-major: process i holds consecutive stages (on (data 2, stage
    2), lines {0, 1} and {2, 3}); its caches and weight rows are its
    stages' only, each row bit-equal to the one-process decoder's for
    that stage; gloo carries the hop and no graph is captured."""
    _, n, dp, _ = DC["meshes"][key]
    per = n * dp // PROCS
    for i, r in enumerate(spawned):
        meta = r["meta"]["decode"][key]["greedy"]
        first = (i * per) % n
        stages = list(range(first, first + per))
        assert meta["local_stages"] == stages
        assert meta["caches"] == {"k": per, "v": per} and meta["rows"] == per
        assert meta["transport"] == "gloo" and meta["captures"] == 0
        rows = sorted(k for k in r if k.startswith(f"dec_{key}_row"))
        assert rows == [f"dec_{key}_row{s}" for s in stages]
        for s in stages:
            np.testing.assert_array_equal(r[f"dec_{key}_row{s}"],
                                          one[key, "rows"][f"row{s}"])
    kv = spawned[0]["meta"]["decode"][key]
    if "int8_kv" in kv:
        assert kv["int8_kv"]["caches"] == {"k": per, "v": per, "ks": per,
                                           "vs": per}


@pytest.mark.parametrize("key", [k for k in DC["meshes"] if k != "dp"])
def test_one_slot_crosses_a_boundary_a_step(spawned, key):
    """A decode step sends one ring slot per process, ``[mb, d]`` f32 (the
    parent column too under beam search); the fused prefill sends each
    group's ``[mb, plen, d]`` activation across each boundary once a
    round, from every process but the last stage's."""
    model, n, _, _ = DC["meshes"][key]
    d = R.decode_graphs(models, DC)[model].nodes["block_0"].out_spec.shape[-1]
    rounds = -(-DC["prompts"][0] // (n * MB))
    slot, act = MB * d * 4, MB * PLEN * d * 4
    for r in spawned:
        metas = r["meta"]["decode"][key]
        for case, width in (("greedy", d), ("beam", d + 1)):
            m = metas[case]
            assert m["boundary_sends"] > 0
            assert m["boundary_bytes"] == m["boundary_sends"] * MB * width * 4
        p = metas["prefill"]
        # k prefill sends among the sends: bytes = (sends - k) slots + k
        # activations
        k, rest = divmod(p["boundary_bytes"] - p["boundary_sends"] * slot,
                         act - slot)
        last = p["local_stages"][-1] == n - 1
        assert rest == 0 and k == (0 if last else rounds * n)


def test_sampled_tokens_keep_their_prompts_and_vocabulary(spawned, given):
    vocab = DC["models"]["gpt_tiny"][1]["vocab"]
    prompts = given["gpt_prompts"]
    for key in ("s4", "s8"):
        toks = spawned[0][f"dec_{key}_sampled__tokens"]
        np.testing.assert_array_equal(toks[:, :PLEN], prompts)
        assert ((toks >= 0) & (toks < vocab)).all()
        assert not np.array_equal(toks, spawned[0][f"dec_{key}_greedy__tokens"])


# ---------------------------------------------------------------------------
# the JAX engines on the CPU mesh
# ---------------------------------------------------------------------------


def _jax_graph(spec):
    factory, kw = spec
    return getattr(jax_models, factory)(**kw)


@pytest.fixture(scope="module")
def jax_refs(given):
    """Per (mesh, case): the JAX engines' result on the same weights and
    inputs (``params_to_jax``), computed once per engine."""
    graphs = R.decode_graphs(models, DC)
    prompts, ids = given["gpt_prompts"], given["gpt_score_ids"]
    out = {}
    for key, (model, n, _, draft) in DC["meshes"].items():
        tg = graphs[model]
        jg = _jax_graph(DC["models"][model])
        jp = params_to_jax(tg, given[f"{model}_params"])
        blocks = sum(nm.startswith("block_") for nm in tg.topo_order)
        cuts = models.gpt_stage_cuts(blocks, n)

        def dec(_n=n, _jg=jg, _jp=jp, **kw):
            return JaxDecoder(_jg, _jp, num_stages=_n, microbatch=MB,
                              max_len=MAX_LEN, **kw)

        greedy_dec = dec()
        greedy = greedy_dec.generate(prompts, NEW)
        out[key, "greedy"] = {"tokens": greedy}
        if key == "dp":
            continue
        prefill = greedy_dec.generate(prompts, NEW, prefill=True)
        eos = int(greedy[0, PLEN + 1])
        out[key, "eos"] = {"tokens": greedy_dec.generate(
            prompts, NEW, eos_id=eos, token_chunk=2)}
        for case in ("greedy_chunk2", "defer_generate"):
            out[key, case] = {"tokens": greedy}
        for case in ("prefill", "prefill_chunk2"):
            out[key, case] = {"tokens": prefill}
        out[key, "beam"] = {"tokens": dec(beam_width=2).generate(
            prompts[:n * (MB // 2)], NEW)}
        out[key, "int8_kv"] = {"tokens": dec(kv_cache="int8").generate(
            prompts, NEW)}
        out[key, "w8a16"] = {"tokens": dec(weight_dtype="int8").generate(
            prompts, NEW)}
        for wire in R.WIRES:
            jd = jdt.Defer(config=jdt.DeferConfig(
                microbatch=MB, chunk=DC["chunk"], wire=wire))
            out[key, f"logits_{wire}"] = {"logits": np.asarray(jd.logits(
                jg, jp, ids, cut_points=cuts))}
            lp, ppl = jd.score(jg, jp, ids, cut_points=cuts)
            out[key, f"score_{wire}"] = {"logprob": np.asarray(lp),
                                         "perplexity": np.asarray(ppl)}
        # the target's greedy by full recompute, at its whole length
        # (causal: the zero padding reaches no earlier position)
        apply = jax.jit(jg.apply)
        toks = np.zeros((2 * MB, MAX_LEN), np.int32)
        toks[:, :PLEN] = prompts[:2 * MB]
        for t in range(PLEN, PLEN + NEW):
            logits = np.asarray(apply(jp, jnp.asarray(toks)))
            toks[:, t] = logits[:, t - 1].argmax(-1)
        out[key, "speculative"] = {"tokens": toks[:, :PLEN + NEW]}
    return out


@pytest.mark.parametrize("c", JAX_CASES, ids=_id)
def test_within_bounds_of_jax(spawned, jax_refs, c):
    want = jax_refs[c]
    got = _got(spawned[0], *c)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k == "tokens":
            np.testing.assert_array_equal(g, w)
            continue
        wire = c[1].rsplit("_", 1)[1]
        scale = np.abs(jax_refs[c[0], f"logits_{wire}"]["logits"]).max()
        t = DC["score_ids"][1]
        if k == "logits":
            bound = 1e-5 * scale if wire == "buffer" else scale / 127
            assert np.abs(g - w).max() <= bound
        elif wire == "buffer":
            np.testing.assert_allclose(g, w, rtol=1e-4)
        elif k == "logprob":
            assert np.abs(g - w).max() <= 2 * (t - 1) * scale / 127
        else:  # perplexity, from the log-probability as in the port
            np.testing.assert_allclose(g, np.exp(-got["logprob"] / (t - 1)),
                                       rtol=1e-6)
