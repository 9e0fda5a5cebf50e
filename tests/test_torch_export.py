"""Port parity: stage artifacts (``defer_tpu_torch.utils.export``) against
the JAX package's, mirroring ``tests/test_export.py``.

A port artifact is a ``torch.export`` program plus the stage's weights in
the JAX package's zip layout.  The same seeded weights (JAX's ``init``,
carried over with ``params_from_jax``) and the same numpy inputs go
through a reloaded port artifact and through the JAX package's
``load_stage`` of its own artifact.

Tolerances, with their reasons:

* reloaded stages and pipelines against JAX: rtol 1e-5 (atol 1e-5 of the
  output's scale).  Convolutions, matmuls and softmax sum in another
  order than XLA's;
* a reloaded port artifact against the live port stage: equal (the same
  ops on the same CPU);
* weight leaves: equal, leaf by leaf, in order, layout and dtype.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax

from defer_tpu import partition as jax_partition
from defer_tpu.models import bert_tiny as jax_bert_tiny
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.utils import export as jexport
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.partition.stage import StageModule
from defer_tpu_torch.utils import export as texport

torch.set_num_threads(1)

RTOL = 1e-5


def _pair(jax_factory, port_factory, num_stages, seed):
    jg = jax_factory()
    jp = jg.init(jax.random.key(seed))
    jstages = jax_partition(jg, num_stages=num_stages)
    g = port_factory()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    stages = partition(g, [s.output_name for s in jstages[:-1]])
    return jg, jp, jstages, g, p, stages


@pytest.fixture(scope="module")
def resnet():
    return _pair(jax_resnet_tiny, models.resnet_tiny, 4, 0)


@pytest.fixture(scope="module")
def bert():
    return _pair(jax_bert_tiny, models.bert_tiny, 2, 1)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.timeout(120)
def test_stage_roundtrip_matches_jax_load_stage(resnet, tmp_path):
    jg, jp, jstages, g, p, stages = resnet
    path = str(tmp_path / "s1.zip")
    texport.export_stage(stages[1], p, path, batch=2)
    fn, manifest = texport.load_stage(path, device="cpu")
    assert manifest["index"] == 1 and manifest["batch"] == 2
    assert tuple(manifest["in_shape"]) == stages[1].in_spec.shape
    x = np.random.default_rng(0).normal(
        size=(2,) + stages[1].in_spec.shape).astype(np.float32)
    got = fn(x).numpy()
    # against the live port stage: the same ops on the same device
    live = StageModule(stages[1], p, torch.device("cpu"))(torch.from_numpy(x))
    np.testing.assert_array_equal(got, live.numpy())
    jpath = str(tmp_path / "j1.zip")
    jexport.export_stage(jstages[1], jp, jpath, batch=2)
    jfn, _ = jexport.load_stage(jpath)
    _close(got, np.asarray(jfn(x)))


@pytest.mark.timeout(120)
def test_pipeline_export_matches_jax_pipeline(bert, tmp_path):
    """Ids relayed through every reloaded port artifact give what the JAX
    package's reloaded artifacts give, and the whole forward."""
    jg, jp, jstages, g, p, stages = bert
    paths = texport.export_pipeline(stages, p, str(tmp_path / "t"))
    jpaths = jexport.export_pipeline(jstages, jp, str(tmp_path / "j"))
    assert len(paths) == len(jpaths) == 2
    ids = (np.arange(16).reshape(1, 16) % 100).astype(np.int32)
    x, jx = ids, ids
    for path, jpath in zip(paths, jpaths):
        x = texport.load_stage(path, device="cpu")[0](x).numpy()
        jx = np.asarray(jexport.load_stage(jpath)[0](jx))
        _close(x, jx)
    _close(x, np.asarray(jg.apply(jp, ids)))


@pytest.mark.parametrize("which", ["resnet", "bert"])
def test_weight_leaves_equal_jax(which, request):
    """The port's leaves equal JAX's ``stage_weight_leaves`` leaf by leaf
    (order, layout, dtype), and so do the artifacts' ``weights.npz``."""
    jg, jp, jstages, g, p, stages = request.getfixturevalue(which)
    for s, js in zip(stages, jstages):
        got = texport.stage_weight_leaves(s, p)
        want = jexport.stage_weight_leaves(js, jp)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        with zipfile.ZipFile(io.BytesIO(
                texport.export_stage_bytes(s, p))) as z:
            with np.load(io.BytesIO(z.read("weights.npz"))) as npz:
                for i, b in enumerate(want):
                    np.testing.assert_array_equal(npz[f"w{i}"], b)


@pytest.mark.timeout(120)
def test_jax_weights_blob_reweights_port_program(resnet):
    """A reweight blob made by the JAX package installs the same weights in
    a port program: its output becomes the JAX program's on those
    weights.  Pushing the port's own blob back restores the output."""
    jg, jp, jstages, g, p, stages = resnet
    s, js = stages[2], jstages[2]
    prog = texport.load_stage_program(texport.export_stage_bytes(s, p),
                                      device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (1,) + s.in_spec.shape).astype(np.float32)
    y0 = prog(x).numpy()
    jp2 = jax.tree.map(lambda a: a * 1.5, jp)
    prog.reweight(jexport.weights_blob(jexport.stage_weight_leaves(js, jp2)))
    y1 = prog(x).numpy()
    assert not np.allclose(y0, y1)
    jprog = jexport.load_stage_program(jexport.export_stage_bytes(js, jp2))
    _close(y1, np.asarray(jprog(x)))
    prog.reweight(texport.weights_blob(texport.stage_weight_leaves(s, p)))
    np.testing.assert_array_equal(prog(x).numpy(), y0)
    bad = [np.zeros((2, 2), np.float32)] * prog.manifest["num_weights"]
    with pytest.raises(ValueError, match="re-push"):
        prog.reweight(texport.weights_blob(bad))
    with pytest.raises(ValueError, match="weight arrays"):
        prog.reweight(texport.weights_blob(bad[:1]))


@pytest.mark.timeout(120)
def test_each_loader_refuses_the_others_artifact(resnet, tmp_path):
    jg, jp, jstages, g, p, stages = resnet
    jblob = jexport.export_stage_bytes(jstages[0], jp)
    tblob = texport.export_stage_bytes(stages[0], p)
    with pytest.raises(ValueError, match="JAX package"):
        texport.load_stage_program(jblob)
    with pytest.raises(ValueError, match="not a defer_tpu stage"):
        jexport.load_stage_program(tblob)
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("manifest.json", "{}")
    with pytest.raises(ValueError, match="not a defer_tpu_torch stage"):
        texport.load_stage(bad)


def test_manifest_keeps_every_jax_key(resnet):
    jg, jp, jstages, g, p, stages = resnet
    with zipfile.ZipFile(io.BytesIO(
            texport.export_stage_bytes(stages[1], p, batch=3))) as z:
        names = set(z.namelist())
        tm = json.loads(z.read("manifest.json"))
    with zipfile.ZipFile(io.BytesIO(
            jexport.export_stage_bytes(jstages[1], jp, batch=3))) as z:
        jm = json.loads(z.read("manifest.json"))
    assert names == {"manifest.json", "stage.pt2", "weights.npz"}
    assert set(jm) <= set(tm)
    assert tm["format"] == "defer_tpu_torch.stage.v1"
    for k in set(jm) - {"format"}:
        assert tm[k] == jm[k], k


@pytest.mark.timeout(120)
def test_bert_stage_graph_carries_the_flash_operator(bert):
    """Regression: the exported attention is the custom operator, so a
    program loaded on the card launches the hand kernel.  A trace that
    took the CPU's plain branch would hold ``aten.exp`` and the matmuls of
    the plain softmax instead."""
    jg, jp, jstages, g, p, stages = bert
    for s in stages:
        prog = texport.load_stage_program(texport.export_stage_bytes(s, p),
                                          device="cpu")
        targets = [str(n.target) for n in prog.graph.nodes
                   if n.op == "call_function"]
        blocks = sum(n.startswith("block_") for n in s.node_names)
        assert blocks >= 1
        assert targets.count(
            "defer_tpu_torch.flash_attention.default") == blocks
        plain = [t for t in targets if t.split(".")[:2] in (
            ["aten", "exp"], ["aten", "amax"], ["aten", "_softmax"])]
        assert plain == [], plain


@pytest.mark.timeout(120)
def test_export_leaves_the_avgpool_cache_clean():
    """Tracing runs the ops on fake tensors; the AvgPool count cache must
    not keep one, or the live graph breaks after an export."""
    g = models.inception_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    s = stages[1]
    prog = texport.load_stage_program(texport.export_stage_bytes(s, p),
                                      device="cpu")
    x = torch.randn((1,) + s.in_spec.shape)
    live = StageModule(s, p, torch.device("cpu"))(x)
    np.testing.assert_array_equal(prog(x).numpy(), live.numpy())


def test_place_without_cuda_raises(resnet, tmp_path):
    """A program goes to the card unless the caller asks for the CPU: the
    loaders and ``place`` raise without CUDA."""
    jg, jp, jstages, g, p, stages = resnet
    blob = texport.export_stage_bytes(stages[0], p)
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA"):
        texport.load_stage_program(blob)
    path = str(tmp_path / "s0.zip")
    texport.export_stage(stages[0], p, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        texport.load_stage(path)
    prog = texport.load_stage_program(blob, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        prog.place("cuda")
    prog.place("cpu")
    assert prog.device.type == "cpu"


@pytest.mark.timeout(120)
def test_export_reuses_the_trace_and_ships_each_call_its_weights(resnet):
    """A stage exported again reuses the program traced the first time (the
    weights are the program's inputs, so the trace never reads their
    values), and each artifact carries the weights of its own call: the
    second export, on weights x1.5, computes the JAX program on those
    weights, the first still computes the first.  Another batch traces
    anew, and ``trace_stage`` keeps a trace for a later export."""
    jg, jp, jstages, g, p, stages = resnet
    s, js = stages[1], jstages[1]
    jp2 = jax.tree.map(lambda a: a * 1.5, jp)
    p2 = params_from_jax(g, jax.tree.map(np.asarray, jp2))
    n0 = len(texport._PROGRAMS)
    blob1 = texport.export_stage_bytes(s, p, batch=2)
    n1 = len(texport._PROGRAMS)
    blob2 = texport.export_stage_bytes(s, p2, batch=2)
    assert len(texport._PROGRAMS) == n1 <= n0 + 1
    with zipfile.ZipFile(io.BytesIO(blob1)) as a, \
            zipfile.ZipFile(io.BytesIO(blob2)) as b:
        assert a.read("stage.pt2") == b.read("stage.pt2")
        assert a.read("weights.npz") != b.read("weights.npz")
    x = np.random.default_rng(6).standard_normal(
        (2,) + s.in_spec.shape).astype(np.float32)
    y1 = texport.load_stage_program(blob1, device="cpu")(x).numpy()
    y2 = texport.load_stage_program(blob2, device="cpu")(x).numpy()
    _close(y1, np.asarray(jexport.load_stage_program(
        jexport.export_stage_bytes(js, jp, batch=2))(x)))
    _close(y2, np.asarray(jexport.load_stage_program(
        jexport.export_stage_bytes(js, jp2, batch=2))(x)))
    n2 = len(texport._PROGRAMS)
    texport.trace_stage(s, p, batch=7)   # a batch no test traces
    assert len(texport._PROGRAMS) == n2 + 1
    blob7 = texport.export_stage_bytes(s, p, batch=7)   # the kept trace
    assert len(texport._PROGRAMS) == n2 + 1
    assert texport.load_stage_program(blob7, device="cpu").manifest[
        "batch"] == 7


def _replay(prog, x):
    """One replay, in inference mode as ``StageProgram.__call__`` runs
    it."""
    with torch.inference_mode():
        return prog._replay([torch.as_tensor(x)])


def _stand_in_capture(monkeypatch) -> list:
    """Replace the CUDA-graph capture by a stand-in whose replay re-runs
    the captured function; returns the list of the captures' labels."""
    from defer_tpu_torch.runtime import cuda_graph

    captured = []

    class Replay:
        def __init__(self, fn):
            self.fn = fn

        def replay(self):
            self.fn()

    def fake_capture(fn, device, warmup=None, *, label=""):
        (warmup or fn)()
        captured.append(label)
        return Replay(fn)

    monkeypatch.setattr(cuda_graph, "capture", fake_capture)
    return captured


@pytest.mark.timeout(120)
def test_replay_path_reuses_its_buffers_and_weights(resnet, monkeypatch):
    """The card's replay path, run on the CPU through a stand-in capture
    that re-runs the captured function at each replay: one capture (the
    one ``place`` takes on the card) for three calls, the inputs copied
    into the same static buffers, each output its own tensor and equal to
    the JAX program's; a reweight copies into the captured weight tensors
    (the same objects), so the next replay computes the JAX program on
    the new weights."""
    captured = _stand_in_capture(monkeypatch)
    jg, jp, jstages, g, p, stages = resnet
    s, js = stages[1], jstages[1]
    prog = texport.load_stage_program(texport.export_stage_bytes(s, p),
                                      device="cpu")
    with torch.inference_mode():
        prog._capture()
    jprog = jexport.load_stage_program(jexport.export_stage_bytes(js, jp))
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((1,) + s.in_spec.shape).astype(np.float32)
          for _ in range(4)]
    ys = [_replay(prog, x) for x in xs[:3]]
    assert captured == [prog.manifest["name"]]
    static = [t.data_ptr() for t in prog._static_in]
    for x, y in zip(xs, ys):
        _close(y.numpy(), np.asarray(jprog(x)))
    assert len({y.data_ptr() for y in ys}) == 3
    leaves = [id(t) for t in prog.leaves]
    jp2 = jax.tree.map(lambda a: a * 1.5, jp)
    prog.reweight(jexport.weights_blob(jexport.stage_weight_leaves(js, jp2)))
    assert [id(t) for t in prog.leaves] == leaves
    jprog2 = jexport.load_stage_program(jexport.export_stage_bytes(js, jp2))
    y = _replay(prog, xs[3])
    _close(y.numpy(), np.asarray(jprog2(xs[3])))
    assert [t.data_ptr() for t in prog._static_in] == static
    assert captured == [prog.manifest["name"]]


@pytest.mark.timeout(120)
def test_reweight_mid_stream_replays_one_weight_set(resnet, monkeypatch):
    """A reweight from a second thread (a control connection's) while
    replays run, through the stand-in capture: every replay computes the
    JAX program on the old weights or on the new, never on a mix; the
    GIL switch interval is cut to 1 us so that the threads interleave
    inside the reweight's copies."""
    import sys
    import threading

    _stand_in_capture(monkeypatch)
    jg, jp, jstages, g, p, stages = resnet
    s, js = stages[1], jstages[1]
    prog = texport.load_stage_program(texport.export_stage_bytes(s, p),
                                      device="cpu")
    with torch.inference_mode():
        prog._capture()
    jp2 = jax.tree.map(lambda a: a * 1.5, jp)
    blobs = [jexport.weights_blob(jexport.stage_weight_leaves(js, q))
             for q in (jp, jp2)]
    x = np.random.default_rng(6).standard_normal(
        (1,) + s.in_spec.shape).astype(np.float32)
    wants = [np.asarray(jexport.load_stage_program(
        jexport.export_stage_bytes(js, q))(x)) for q in (jp, jp2)]
    outs, stop = [], threading.Event()

    def replays():
        while not stop.is_set():
            outs.append(_replay(prog, x).numpy())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=replays)
    try:
        t.start()
        for i in range(40):
            prog.reweight(blobs[(i + 1) % 2])
    finally:
        stop.set()
        t.join()
        sys.setswitchinterval(interval)
    assert outs
    for y in outs:
        assert any(np.allclose(y, w, rtol=RTOL,
                               atol=RTOL * float(np.abs(w).max()))
                   for w in wants)
    _close(_replay(prog, x).numpy(), wants[0])
