"""The port's command line against the JAX package's: ``models``, ``bench``,
``export``, ``generate``, ``serve``, ``serve-client``, ``train`` and
``--sock-buf``.

Both CLIs run in this process (``cli.main([...])``) on the CPU; the port's
commands take ``--device cpu`` (without it they run on the card, and raise
here).  Where the two print the same thing, it is compared equal:
``models`` byte for byte, ``bench``'s JSON keys, ``generate``'s
``first_row`` token for token (greedy, on the JAX weights carried across
with ``params_from_jax`` by patching the port's one params helper,
``cli._init_params``), ``chain``'s ``sock-buf: auto`` line.  The exported
artifacts load with ``device="cpu"`` and match the JAX stage forward
within 1e-5 of max |output|.  The serving commands run against each
other across the packages: the JAX ``serve-client`` against the port's
door.  Each socket test has its own timeout.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import defer_tpu.models as jax_models
from defer_tpu import cli as jcli
from defer_tpu import partition as jax_partition
from defer_tpu_torch import cli, models, params_from_jax
from defer_tpu_torch.obs import REGISTRY

torch.set_num_threads(1)


def _lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.strip()]


def _json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in _lines(text) if ln.startswith("{")]


def _jax_params(name: str):
    """The JAX CLI's graph and weights for ``name`` (its ``init(key(0))``),
    as numpy."""
    jg = getattr(jax_models, name)()
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(0)))
    return jg, jp


@pytest.fixture
def jax_weights(monkeypatch):
    """Point the port's params helper at the JAX CLI's weights."""
    def init(graph):
        jg = getattr(jax_models, graph.name)()
        return params_from_jax(graph, jg.init(jax.random.key(0)))
    monkeypatch.setattr(cli, "_init_params", init)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_models_stdout_byte_equal(capsys):
    jcli.main(["models"])
    want = capsys.readouterr().out
    cli.main(["models"])
    got = capsys.readouterr().out
    assert got == want
    assert "resnet50\n" in got and "(cut list, 7 cuts)" in got


def test_help_lists_every_command(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in ("models", "bench", "export", "serve", "serve-client",
                "generate", "node", "chain", "partition", "plan",
                "monitor", "postmortem", "profile"):
        assert cmd in out


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------

BENCH = ["bench", "--model", "resnet_tiny", "--stages", "2", "--chunk", "4",
         "--seconds", "1"]


def test_bench_json_keys_equal_to_jax(capsys):
    jcli.main(BENCH)
    want = _json_lines(capsys.readouterr().out)[-1]
    cli.main(BENCH + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)[-1]
    assert list(got) == list(want)
    assert got["unit"] == "inferences/sec" and got["value"] > 0
    assert got["metric"] == want["metric"] == "resnet_tiny_2stage_throughput"
    assert (got["num_stages"], got["wire"], got["devices"]) == (2, "buffer",
                                                                1)
    # the capture push is cleared: the counters cover the window only
    assert got["steps"] == 4 * got["chunk_calls"]
    assert got["push_latency_ms"]["count"] == got["chunk_calls"]
    assert got["buffer_bytes_per_hop"] == want["buffer_bytes_per_hop"]


def test_bench_int8_exports_and_default_stages(capsys, tmp_path):
    """One stage on the CPU by default; ``--trace-out``/``--metrics-out``
    add the per-stage latencies and the ``dispatcher.bench_window`` span."""
    trace, met = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    cli.main(["bench", "--model", "resnet_tiny", "--chunk", "2",
              "--seconds", "0.3", "--wire", "int8", "--device", "cpu",
              "--trace-out", trace, "--metrics-out", met])
    d = _json_lines(capsys.readouterr().out)[-1]
    assert d["metric"] == "resnet_tiny_1stage_throughput"
    assert d["wire"] == "int8" and d["num_stages"] == 1
    assert len(d["stage_latency_ms"]) == 1
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert "dispatcher.bench_window" in names
    snap = json.load(open(met))
    assert snap["pipeline"]["num_stages"] == 1 and "registry" in snap


@pytest.mark.parametrize("argv,match", [
    (["--cuts", "add_1", "--balance", "bottleneck"], "conflict"),
    (["--model", "no_such_model"], "unknown model")])
def test_bench_refuses_like_jax(argv, match, capsys):
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit, match=match):
            main(BENCH + argv + (["--device", "cpu"]
                                 if main is cli.main else []))


def test_bench_balance_bottleneck_cuts_equal_jax(capsys):
    args = ["bench", "--model", "resnet_tiny", "--stages", "3", "--chunk",
            "2", "--seconds", "0.2", "--balance", "bottleneck"]
    jcli.main(args)
    want = _json_lines(capsys.readouterr().out)[-1]
    cli.main(args + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)[-1]
    assert got["num_stages"] == want["num_stages"] == 3
    assert got["buffer_bytes_per_hop"] == want["buffer_bytes_per_hop"]


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    [], ["--prefill"], ["--token-chunk", "3", "--kv-cache", "int8"],
    ["--beam", "2", "--stages", "2"]])
def test_generate_first_row_equals_jax(extra, jax_weights, capsys):
    args = ["generate", "--model", "gpt_tiny", "--new-tokens", "6"] + extra
    jcli.main(args)
    want = _json_lines(capsys.readouterr().out)[-1]
    cli.main(args + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)[-1]
    assert got["first_row"] == want["first_row"]
    assert {k: v for k, v in got.items() if k != "tokens_per_s"} == \
        {k: v for k, v in want.items() if k != "tokens_per_s"}
    assert got["tokens_per_s"] > 0


def test_generate_incompatible_flags_raise_like_jax(jax_weights):
    args = ["generate", "--model", "gpt_tiny", "--beam", "2", "--prefill"]
    with pytest.raises(ValueError) as jerr:
        jcli.main(args)
    with pytest.raises(ValueError) as terr:
        cli.main(args + ["--device", "cpu"])
    assert "prefill" in str(jerr.value) and "prefill" in str(terr.value)
    with pytest.raises(SystemExit, match="not a decoder"):
        cli.main(["generate", "--model", "resnet_tiny", "--device", "cpu"])


def test_generate_clears_the_capture_run(monkeypatch, capsys, tmp_path):
    """The decode histogram and counter are cleared after the first run:
    the export covers the timed run alone."""
    seen = []
    real = cli._obs_begin

    def begin(args, **kw):
        seen.append((REGISTRY.counter("decode.dispatches").n,
                     REGISTRY.histogram("decode.dispatch_s").count))
        return real(args, **kw)

    monkeypatch.setattr(cli, "_obs_begin", begin)
    met = str(tmp_path / "m.json")
    cli.main(["generate", "--model", "gpt_tiny", "--device", "cpu",
              "--metrics-out", met])
    assert seen == [(0, 0)]
    reg = json.load(open(met))["registry"]
    n = REGISTRY.counter("decode.dispatches").n
    assert n > 0 and reg["decode.dispatches"] == n


def test_generate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["generate", "--model", "gpt_tiny"])


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

TRAIN = ["train", "--stages", "2", "--chunk", "3", "--steps", "2",
         "--device", "cpu"]


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


@pytest.mark.parametrize("wire", ["buffer", "int8"])
def test_train_losses_equal_the_api_and_checkpoint(wire, capsys, tmp_path):
    """``train`` prints the JAX package's JSON line (plus ``attn_impl``);
    its losses are the API's on the same seed (Adam at ``--lr``, the
    command's seeded data), and ``--save`` writes the trained rows."""
    from defer_tpu_torch import PipelineTrainer, SpmdPipeline, partition

    ck = str(tmp_path / "ck")
    cli.main(TRAIN + ["--model", "resnet_tiny", "--wire", wire,
                      "--save", ck])
    (row,) = _json_lines(capsys.readouterr().out)
    assert list(row) == ["model", "stages", "steps", "losses", "attn_impl"]
    assert (row["model"], row["stages"], row["steps"]) == ("resnet_tiny",
                                                           2, 2)
    assert row["attn_impl"] is None and np.isfinite(row["losses"]).all()

    g = models.resnet_tiny()
    pipe = SpmdPipeline(partition(g, num_stages=2), cli._init_params(g),
                        device="cpu", microbatch=1, chunk=3, wire=wire)
    adam = lambda rows: torch.optim.Adam(rows, lr=1e-3)  # noqa: E731
    t = PipelineTrainer(pipe, _ce, optimizer=adam)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 1, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (2, 1))
    assert [round(t.step(xs, ys), 4) for _ in range(2)] == row["losses"]
    t2 = PipelineTrainer(SpmdPipeline(
        partition(g, num_stages=2), cli._init_params(g), device="cpu",
        microbatch=1, chunk=3, wire=wire), _ce, optimizer=adam)
    t2.load_checkpoint(ck)
    for a, b in zip(t2.rows, t.rows):
        assert torch.equal(a, b)


def test_train_attention_model_reports_xla(capsys):
    cli.main(TRAIN + ["--model", "bert_tiny", "--steps", "1"])
    (row,) = _json_lines(capsys.readouterr().out)
    assert row["attn_impl"] == "xla" and np.isfinite(row["losses"]).all()


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--model", "resnet_tiny"])


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,stages", [("resnet_tiny", 3),
                                          ("bert_tiny", 2)])
def test_export_matches_the_jax_stage_forward(model, stages, jax_weights,
                                              capsys, tmp_path):
    from defer_tpu_torch.utils.export import load_stage

    cli.main(["export", "--model", model, "--stages", str(stages),
              "--batch", "2", "--out", str(tmp_path)])
    paths = _lines(capsys.readouterr().out)
    assert paths == [str(tmp_path / f"stage_{i}.zip")
                     for i in range(stages)]
    jg, jp = _jax_params(model)
    jstages = jax_partition(jg, None, num_stages=stages)
    rng = np.random.default_rng(1)
    spec = jstages[0].in_spec
    if np.issubdtype(spec.dtype, np.integer):
        x = rng.integers(0, 100, (2,) + spec.shape).astype(np.int32)
    else:
        x = rng.standard_normal((2,) + spec.shape).astype(np.float32)
    for path, js in zip(paths, jstages):
        prog, manifest = load_stage(path, device="cpu")
        assert manifest["index"] == js.index and manifest["batch"] == 2
        want = np.asarray(js.fn(js.select_params(jp), x))
        got = prog(x).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        if model == "bert_tiny" and js.index == 1:
            ops = {str(n.target) for n in prog.graph.nodes}
            assert any("flash_attention" in o for o in ops)
        x = np.array(want)


# ---------------------------------------------------------------------------
# --sock-buf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 100, 1 << 15, 1 << 16, 40000,
                                  1 << 20, 3 << 21, 1 << 23, 1 << 30])
def test_default_sock_buf_equal_to_jax(size):
    from defer_tpu.transport.framed import default_sock_buf as jbuf
    from defer_tpu_torch.transport.framed import default_sock_buf
    assert default_sock_buf(size) == jbuf(size)


@pytest.mark.parametrize("argv", [
    ["--model", "resnet_tiny", "--stages", "3", "--batch", "4"],
    ["--model", "bert_tiny", "--stages", "2"]])
def test_chain_auto_sock_buf_line_equal_to_jax(argv, monkeypatch, capsys):
    """``chain`` prints the same ``sock-buf: auto`` line as JAX's before it
    spawns (the spawn is cut short here) and exports the size to the
    children's environment."""
    import defer_tpu.runtime.node as jnode
    import defer_tpu.transport.framed as jframed
    import defer_tpu_torch.runtime.node as tnode
    import defer_tpu_torch.transport.framed as tframed

    class Spawned(Exception):
        pass

    def stop(*a, **k):
        raise Spawned

    for mod in (jnode, tnode):
        monkeypatch.setattr(mod, "run_chain", stop)
    for mod in (jframed, tframed):
        monkeypatch.setattr(mod, "SOCK_SNDBUF", 0)
        monkeypatch.setattr(mod, "SOCK_RCVBUF", 0)
    monkeypatch.setenv("DEFER_SOCK_SNDBUF", "")
    monkeypatch.setenv("DEFER_SOCK_RCVBUF", "")
    lines = []
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(Spawned):
            main(["chain"] + argv + extra)
        lines.append([ln for ln in _lines(capsys.readouterr().err)
                      if ln.startswith("sock-buf:")])
    assert lines[0] == lines[1] and len(lines[1]) == 1
    n = int(lines[1][0].split()[2])
    assert tframed.SOCK_SNDBUF == tframed.SOCK_RCVBUF == n
    assert os.environ["DEFER_SOCK_SNDBUF"] == str(n)


def test_explicit_sock_buf_wins(monkeypatch, capsys):
    import argparse

    import defer_tpu_torch.transport.framed as tframed
    monkeypatch.setattr(tframed, "SOCK_SNDBUF", 0)
    monkeypatch.setattr(tframed, "SOCK_RCVBUF", 0)
    monkeypatch.setenv("DEFER_SOCK_SNDBUF", "")
    monkeypatch.setenv("DEFER_SOCK_RCVBUF", "")
    cli._apply_sock_buf(argparse.Namespace(sock_buf=0))   # node default
    assert tframed.SOCK_SNDBUF == 0
    cli._apply_sock_buf(argparse.Namespace(sock_buf=123456),
                        auto_bytes=1 << 20)
    assert capsys.readouterr().err == ""
    assert tframed.SOCK_SNDBUF == tframed.SOCK_RCVBUF == 123456
    assert os.environ["DEFER_SOCK_RCVBUF"] == "123456"
    for cmd in ("node", "chain"):
        with pytest.raises(SystemExit):
            cli.main([cmd, "--help"])
        assert "--sock-buf BYTES" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serve and serve-client
# ---------------------------------------------------------------------------

def _free_addr() -> str:
    from defer_tpu_torch.runtime.node import _free_ports
    return f"127.0.0.1:{_free_ports(1)[0]}"


def _serve(argv):
    t = threading.Thread(target=cli.main, args=(argv,), daemon=True)
    t.start()
    return t


@pytest.mark.timeout(120)
def test_serve_serve_client_and_monitor(capsys):
    """The port's serve + serve-client + monitor --serve scenario of the
    JAX package's tests/test_serve.py, thread-per-stage nodes on the
    CPU."""
    addr = _free_addr()
    t = _serve(["serve", "--model", "resnet_tiny", "--stages", "2",
                "--width", "2", "--listen", addr, "--seconds", "4",
                "--tenant", "gold=2.0:1:5000", "--device", "cpu"])
    cli.main(["serve-client", "--connect", addr, "--tenant", "gold",
              "--rate", "30", "--seconds", "1", "--seed", "3",
              "--burst", "0.2:0.6:2.0"])
    cli.main(["monitor", "--serve", addr, "--iterations", "1",
              "--interval-ms", "50", "--json"])
    t.join(timeout=60)
    assert not t.is_alive()
    lines = _lines(capsys.readouterr().out)
    gen = next(json.loads(ln) for ln in lines if "latency_p99_ms" in ln)
    assert gen["tenant"] == "gold" and gen["completed"] >= 1
    assert gen["shed"] == 0, "a 5s SLO at 30 Hz must not shed"
    assert gen["completed"] == gen["offered"]
    mon = next(json.loads(ln) for ln in lines if '"serve"' in ln)
    assert mon["serve"]["mode"] == "tensor"
    assert mon["serve"]["tenants"]["gold"]["weight"] == 2.0
    assert mon["serve"]["tenants"]["gold"]["completed"] == gen["completed"]
    head = next(json.loads(ln) for ln in lines if '"serving"' in ln)
    assert head == {"serving": addr, "mode": "tensor", "width": 2,
                    "model": "resnet_tiny", "stages": 2}
    final = next(json.loads(ln) for ln in lines if "final_stats" in ln)
    assert final["final_stats"]["tenants"]["gold"]["completed"] \
        == gen["completed"]


@pytest.mark.timeout(120)
def test_jax_serve_client_against_the_port_door(capsys):
    addr = _free_addr()
    t = _serve(["serve", "--model", "resnet_tiny", "--stages", "2",
                "--width", "2", "--listen", addr, "--seconds", "3",
                "--device", "cpu"])
    jcli.main(["serve-client", "--connect", addr, "--tenant", "jax",
               "--rate", "20", "--seconds", "1", "--deadline-ms", "5000"])
    t.join(timeout=60)
    assert not t.is_alive()
    lines = _lines(capsys.readouterr().out)
    gen = next(json.loads(ln) for ln in lines if "latency_p99_ms" in ln)
    assert gen["tenant"] == "jax"
    assert gen["completed"] >= 1 and gen["shed"] == 0


@pytest.mark.timeout(120)
def test_serve_decode_workload(capsys):
    addr = _free_addr()
    t = _serve(["serve", "--workload", "decode", "--model", "gpt_tiny",
                "--stages", "2", "--width", "3", "--listen", addr,
                "--seconds", "4", "--max-new", "3", "--device", "cpu"])
    cli.main(["serve-client", "--connect", addr, "--tenant", "words",
              "--rate", "8", "--seconds", "1", "--prompt-len", "5",
              "--max-new", "4", "--seed", "2"])
    t.join(timeout=60)
    assert not t.is_alive()
    lines = _lines(capsys.readouterr().out)
    head = next(json.loads(ln) for ln in lines if '"serving"' in ln)
    assert head["mode"] == "decode" and head["width"] == 3
    gen = next(json.loads(ln) for ln in lines if "latency_p99_ms" in ln)
    assert gen["completed"] == gen["offered"] >= 1 and gen["shed"] == 0
    final = next(json.loads(ln) for ln in lines if "final_stats" in ln)
    assert final["final_stats"]["tenants"]["words"]["completed"] \
        == gen["completed"]


@pytest.mark.timeout(120)
def test_serve_budget_width_equals_jax(capsys):
    """``--budget-ms`` sizes the width through the planner's cost model:
    the width the JAX command computes from the same flags, and its
    ``serve: width`` line."""
    import argparse

    from defer_tpu.plan import max_batch_within_budget
    jg = jax_models.resnet_tiny()
    cuts = [s.output_name for s in jax_partition(jg, None,
                                                 num_stages=2)[:-1]]
    flags = argparse.Namespace(codecs="", link_bw=0.0, calibrate=False,
                               ici_bw=0.0, hop_tier_map="", calibrated="",
                               batch=1)
    want = max_batch_within_budget(jg, cuts, jcli._cost_model(flags, jg),
                                   0.005, cap=16)
    assert 1 < want < 16
    addr = _free_addr()
    t = _serve(["serve", "--model", "resnet_tiny", "--stages", "2",
                "--budget-ms", "0.005", "--max-width", "16", "--listen",
                addr, "--seconds", "1.5", "--device", "cpu"])
    # one request, so the chain's stream is not empty at the teardown
    cli.main(["serve-client", "--connect", addr, "--rate", "5",
              "--seconds", "0.3", "--seed", "1"])
    t.join(timeout=60)
    assert not t.is_alive()
    cap = capsys.readouterr()
    head = next(json.loads(ln) for ln in _lines(cap.out)
                if '"serving"' in ln)
    assert head["width"] == want
    assert [ln for ln in _lines(cap.err) if ln.startswith("serve: width")] \
        == [f"serve: width {want} from --budget-ms 0.005"]
