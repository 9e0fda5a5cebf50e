"""Port parity: capacity accounting and the drift auditor
(``obs/capacity.py``) and the window-bounded measurements they score
(``obs/cluster.py``), against the JAX package's, mirroring
``tests/test_capacity.py``; plus the node's live MFU against the H100 row
of the port's ``utils/hw.py``.

FLOPs and bytes are integer-valued sums, so ``stage_flops_bytes`` must be
EQUAL in both packages on every zoo graph, stage by stage.  The auditor and
the windowed estimates are Python float arithmetic in the same order on
the same inputs: equal too.  The policy is the JAX package's: one peak per
generation, whatever the dtype, and an unknown generation has no peak, so
MFU is ``None``, never a number.
"""

import pytest

import defer_tpu as jdt
import defer_tpu.graph as jgraph
import defer_tpu.graph.ops as jops
import defer_tpu.obs as jobs
import defer_tpu.obs.capacity as jcap
import defer_tpu.obs.cluster as jcluster
import defer_tpu_torch as tdt
import defer_tpu_torch.graph as tgraph
import defer_tpu_torch.graph.ops as tops
import defer_tpu_torch.obs as tobs
import defer_tpu_torch.obs.capacity as tcap
import defer_tpu_torch.obs.cluster as tcluster
import defer_tpu_torch.utils.hw as thw
from defer_tpu_torch.runtime import node as tnode

PKGS = {"jax": (jdt, jgraph, jops, jobs, jcap, jcluster),
        "torch": (tdt, tgraph, tops, tobs, tcap, tcluster)}


def both(fn):
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def dense_chain(graph_mod, ops, widths, in_width=8):
    b = graph_mod.GraphBuilder("chain")
    x = b.input((in_width,))
    for i, w in enumerate(widths):
        x = b.add(ops.Dense(w), x, name=f"fc{i}")
    return b.build()


#: every graph of the zoo, tiny and full size (no weights are built)
ZOO = ["resnet_tiny", "resnet50", "vgg_tiny", "vgg19", "inception_tiny",
       "inception_v3", "mobilenet_tiny", "mobilenet_v2", "bert_tiny",
       "bert_base", "gpt_tiny", "gpt2_small", "moe_tiny",
       "moe_branched_tiny"]


@pytest.mark.parametrize("model", ZOO)
def test_stage_flops_bytes_equal_on_the_zoo(model):
    """Every stage of a 1..4-way cut (the JAX package's linear cut points)
    and the whole graph, at batch 1 and 8."""
    jg = getattr(jdt.models, model)()
    cuts = [s.output_name for s in jdt.partition(
        jg, num_stages=min(4, 1 + len(jdt.valid_cut_points(jg))))][:-1]

    def fn(dt, graph_mod, ops, obs, cap, cluster):
        g = getattr(dt.models, model)()
        out = []
        for batch in (1, 8):
            out.append(obs.stage_flops_bytes(g, g.topo_order, batch=batch))
            for names in cap.stages_from_cuts(g, cuts):
                out.append(obs.stage_flops_bytes(g, names, batch=batch))
        return out
    got = both(fn)
    whole, *parts = got[:1 + len(cuts) + 1]
    assert whole[0] > 0 and whole[1] > 0
    assert sum(f for f, _ in parts) == pytest.approx(whole[0])


def test_achieved_mfu_honest_denominator_policy():
    def fn(dt, graph_mod, ops, obs, cap, cluster):
        return [obs.achieved_mfu(1e9, 1e-3, 0.0),
                obs.achieved_mfu(1e9, 0.0, 1e12),
                obs.achieved_mfu(0.0, 1e-3, 1e12),
                obs.achieved_mfu(1e12, 1.0, 2e12)]
    assert both(fn) == [None, None, None, 0.5]


def test_stages_from_cuts_and_capacity_model_known_gen():
    def fn(dt, graph_mod, ops, obs, cap, cluster):
        g = dense_chain(graph_mod, ops, [8, 8, 8, 8])
        order = g.topo_order
        m = obs.CapacityModel(g, [order[1]], batch=2, gen="v4")
        t = m.stage_flops[0] / m.peak_flops_s
        return (cap.stages_from_cuts(g, [order[0], order[2]]), m.to_json(),
                [m.mfu(0, t), m.mfu(1, 2 * t), m.roofline_util(1, 1e-3),
                 m.chain_mfu(max(m.stage_flops) / m.peak_flops_s)])
    stages, doc, vals = both(fn)
    assert [len(s) for s in stages] == [1, 2, 1]
    assert doc["gen"] == "v4" and vals[0] == pytest.approx(1.0)


def test_h100_row_and_capacity_against_it():
    """The card's data-sheet row: 989e12 FLOP/s and 3.35e12 B/s; the
    model prices stages against it (the JAX package has no such row, so
    the numbers are held to the formula)."""
    assert thw.peak_flops("h100") == 989e12
    assert thw.hbm_bandwidth("h100") == 3.35e12
    g = dense_chain(tgraph, tops, [64, 64, 64])
    m = tobs.CapacityModel(g, [g.topo_order[1]], batch=4, gen="h100")
    assert m.peak_flops_s == 989e12 and m.hbm_bw_s == 3.35e12
    for k in range(m.num_stages):
        assert m.roofline_s(k) == max(m.stage_flops[k] / 989e12,
                                      m.stage_bytes[k] / 3.35e12)
        assert m.mfu(k, 1e-3) == m.stage_flops[k] / (1e-3 * 989e12)


@pytest.mark.parametrize("gen", ["tpu-v99", "unknown"])
def test_capacity_model_unknown_gen_yields_none_not_zero(gen):
    def fn(dt, graph_mod, ops, obs, cap, cluster):
        g = dense_chain(graph_mod, ops, [8, 8])
        cut = g.topo_order[0]
        m = obs.CapacityModel(g, [cut], gen=gen)
        over = obs.CapacityModel(g, [cut], gen=gen, peak_flops_s=1e12,
                                 hbm_bw_s=1e11)
        return (m.peak_flops_s, m.mfu(0, 1e-3), m.roofline_s(0),
                m.roofline_util(0, 1e-3), m.chain_mfu(1e-3),
                m.to_json()["roofline_ms"], over.mfu(0, 1e-3))
    got = both(fn)
    assert got[:6] == (0.0, None, None, None, None, [None, None])
    assert got[6] is not None


# ---------------------------------------------------------------------------
# the drift auditor and the windowed measurements
# ---------------------------------------------------------------------------

class FakeView:
    def __init__(self):
        self.measured = {}
        self.windows = []

    def stage_service_ms(self, *, window=None):
        self.windows.append(window)
        return dict(self.measured)


def _drift_events(obs, since):
    _, evs = obs.recorder().events_since(since)
    return [e["data"] for e in evs if e["kind"] == "model_drift"]


def test_drift_auditor_sustain_and_one_event_per_episode():
    script = [{0: 10.5, 1: 21.0}, {0: 14.0, 1: 21.0}, {0: 14.0, 1: 21.0},
              {0: 14.0, 1: 21.0}, {0: 10.2, 1: 21.0}, {0: 30.0, 1: 21.0},
              {0: 30.0, 1: 21.0}, {0: 50.0}]

    def fn(dt, graph_mod, ops, obs, cap, cluster):
        since = obs.recorder().cursor()
        view = FakeView()
        aud = obs.DriftAuditor([10.0, 20.0], threshold=0.25, sustain=2,
                               window=6)
        flags = []
        for measured in script:
            view.measured = measured
            flags.append([f.to_json() for f in aud.observe(view)])
        return flags, aud.last, view.windows, _drift_events(obs, since)
    flags, last, windows, events = both(fn)
    assert windows == [6] * len(script)
    assert [len(f) for f in flags] == [0, 0, 1, 1, 0, 0, 1, 1]
    assert len(events) == 2 and events[0]["predicted_ms"] == 10.0
    assert last[1]["err"] is None       # stage 1 unmeasured: no error


def _push(count, total, *, p50=None, stage=0, replica=0, phase="infer_s"):
    summ = {"count": count, "sum": total,
            "p50": p50 if p50 is not None else total / max(count, 1)}
    return {"node": {"stage": stage, "replica": replica},
            "latency": {phase: summ}}


def test_win_mean_and_windowed_service_track_a_regime_shift():
    def fn(dt, graph_mod, ops, obs, cap, cluster):
        h = [(0.0, _push(10, 0.010)), (1.0, _push(20, 0.030)),
             (2.0, _push(30, 0.110))]
        means = [cluster._win_mean_ms(h, "infer_s"),
                 cluster._win_mean_ms([h[0], h[0]], "infer_s"),
                 cluster._win_mean_ms(h, "decode_s")]
        view = obs.ClusterView()
        n = s = 0.0
        for per in [0.001] * 10 + [0.005] * 4:
            n, s = n + 8, s + 8 * per
            view.ingest(_push(int(n), s, p50=1e-3))
        one = obs.ClusterView()
        one.ingest(_push(8, 0.016, p50=2e-3))
        return (means, view.stage_service_ms(),
                view.stage_service_ms(window=4),
                one.stage_service_ms(window=4))
    means, lifetime, windowed, fallback = both(fn)
    assert means[0] == pytest.approx(5.0) and means[1:] == [None, None]
    assert lifetime[0] == pytest.approx(1.0)
    assert windowed[0] == pytest.approx(5.0, rel=0.01)
    assert fallback[0] == pytest.approx(2.0)


def test_rows_surface_capacity_fields():
    def fn(dt, graph_mod, ops, obs, cap, cluster):
        view = obs.ClusterView()
        p = _push(8, 0.016, p50=2e-3)
        p["capacity"] = {"flops": 2.5e6, "mfu": 0.125,
                         "achieved_flops_s": 1.25e9}
        view.ingest(p)
        row = view.rows()[0]
        return row["flops"], row["mfu"], row["achieved_flops_s"]
    assert both(fn) == (2.5e6, 0.125, 1.25e9)


# ---------------------------------------------------------------------------
# the node's live MFU
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_node():
    node = tnode.StageNode(None, "127.0.0.1:0", None, device="cpu")
    yield node
    node._srv.close()


def test_node_mfu_against_the_h100_row(cpu_node, monkeypatch):
    """A node on an H100 divides the deploy's FLOPs by its infer p50 and
    989e12 (stubbed here: the card's name is what ``identify_chip`` reads);
    the stats row's p50 recomputes the same MFU."""
    monkeypatch.setattr(thw, "identify_chip", lambda device: "h100")
    cpu_node.stage_flops = 4.1e9
    for v in (0.002, 0.0025, 0.003):
        cpu_node.infer_hist.record(v)
    cap = cpu_node._capacity()
    p50 = cpu_node.infer_hist.quantile(0.5)
    assert cap["mfu"] == 4.1e9 / (p50 * 989e12)
    assert cap["achieved_flops_s"] == 4.1e9 / p50
    row = cpu_node._stats({})
    assert row["mfu"] == cap["mfu"] and row["flops"] == 4.1e9
    assert row["mfu"] == pytest.approx(
        row["flops"] / (row["infer_latency_s"]["p50"] * 989e12), rel=1e-3)


def test_node_mfu_is_none_without_a_peak_or_a_capacity(cpu_node):
    assert cpu_node._capacity() == {}          # no deploy shipped FLOPs
    cpu_node.stage_flops = 1e9
    cpu_node.infer_hist.record(0.001)
    cap = cpu_node._capacity()                 # the CPU: "unknown"
    assert cap["mfu"] is None and cap["achieved_flops_s"] == 1e9 / 0.001
    assert cpu_node._stats({})["mfu"] is None


def test_deploy_ships_each_stages_capacity():
    """The dispatcher's deploy message carries the stage's FLOPs and HBM
    bytes at the deploy batch, as the JAX dispatcher's does."""
    from defer_tpu.runtime import node as jnode

    jg = jdt.models.resnet_tiny()
    g = tdt.models.resnet_tiny()
    jst = jdt.partition(jg, ["add_1"])
    tst = tdt.partition(g, ["add_1"])
    for js, ts in zip(jst, tst):
        assert jnode.ChainDispatcher._stage_capacity(js, 4) \
            == tnode.ChainDispatcher._stage_capacity(ts, 4)
    assert tnode.ChainDispatcher._stage_capacity(object(), 4) == {}
