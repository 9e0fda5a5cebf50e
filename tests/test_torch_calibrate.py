"""Port parity: calibration (``plan/calibrate.py``).

The scenarios of ``tests/test_calibrate.py`` run the same synthetic
telemetry through the JAX package's fit and the port's: the fitted
constants, their provenance and every prediction must be equal (the
artifact's ``created_unix`` aside), and a ``defer_tpu.calibration.v1``
file written by either package loads in the other.  A last case fits the
port's own shm chain on the CPU: its hops' ``host_sync`` histograms give a
measured host-sync bandwidth, as phase 4m of ``chip_smoke.py`` requires
on the card.
"""

import json
import threading
import types

import numpy as np
import pytest
import torch

import defer_tpu.plan as jplan
import defer_tpu.plan.calibrate as jcal
from defer_tpu import GraphBuilder as JGraphBuilder
from defer_tpu.graph import ops as jops
import defer_tpu.models as jmodels
import defer_tpu_torch.plan as tplan
import defer_tpu_torch.plan.calibrate as tcal
from defer_tpu_torch import models, partition
from defer_tpu_torch.graph import ops as tops
from defer_tpu_torch.graph.ir import GraphBuilder as TGraphBuilder
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

torch.set_num_threads(1)

J = types.SimpleNamespace(GraphBuilder=JGraphBuilder, ops=jops, plan=jplan,
                          cal=jcal)
T = types.SimpleNamespace(GraphBuilder=TGraphBuilder, ops=tops, plan=tplan,
                          cal=tcal)


def _js(x) -> str:
    if hasattr(x, "to_json"):
        x = x.to_json()
    if isinstance(x, dict):
        x = {k: v for k, v in x.items() if k != "created_unix"}
    return json.dumps(x, sort_keys=True)


def both(scenario):
    want, got = scenario(J), scenario(T)
    assert _js(got) == _js(want)
    return got


def dense_chain(pk, widths, name="chain", in_width=8):
    b = pk.GraphBuilder(name)
    x = b.input((in_width,))
    for i, w in enumerate(widths):
        x = b.add(pk.ops.Dense(w), x, name=f"fc{i}")
    return b.build()


def summ(count, total):
    return {"count": count, "sum": total, "p50": total / max(count, 1),
            "mean": total / max(count, 1)}


def hop(raw, codec, tier="tcp", *, n=32, enc_bw=None, dec_bw=None,
        hs_bw=None, link_bw=None, ratio=1.0, tx_s=None, cut="c0",
        stage=0):
    """A synthetic per-hop record from KNOWN constants (the reference
    test's generator)."""
    rec = {"cut": cut, "stage": stage, "raw_bytes": raw, "codec": codec,
           "tier": tier, "enc_s": {"count": 0}, "dec_s": {"count": 0},
           "host_sync_s": {"count": 0}, "tx_s": {"count": 0}}
    if enc_bw:
        rec["enc_s"] = summ(n, n * raw / enc_bw)
    if dec_bw:
        rec["dec_s"] = summ(n, n * raw / dec_bw)
    if hs_bw:
        rec["host_sync_s"] = summ(n, n * raw / hs_bw)
    if tx_s is not None:
        rec["tx_s"] = summ(n, tx_s)
    elif link_bw:
        enc_sum = rec["enc_s"].get("sum", 0.0)
        rec["tx_s"] = summ(n, enc_sum + n * (raw / ratio) / link_bw)
    return rec


# -- fitting -----------------------------------------------------------------


def test_fit_recovers_known_constants():
    raw = 1 << 20
    hops = [
        hop(raw, "lzb", enc_bw=2e9, dec_bw=1e9, hs_bw=5e9, link_bw=1e8,
            ratio=1.3, cut="c0", stage=0),
        hop(raw // 2, "lzb", enc_bw=2e9, dec_bw=1e9, hs_bw=5e9,
            link_bw=1e8, ratio=1.3, cut="c1", stage=1),
    ]
    cal = both(lambda pk: pk.plan.fit_constants(hops, gen="v5e",
                                                bench_memory=False))
    spec = cal.codecs["lzb"]
    assert spec.encode_bytes_per_s == pytest.approx(2e9, rel=1e-6)
    assert spec.decode_bytes_per_s == pytest.approx(1e9, rel=1e-6)
    assert cal.host_sync_bw_s == pytest.approx(5e9, rel=1e-6)
    assert cal.link_bw_s == pytest.approx(1e8, rel=1e-6)
    assert cal.gen == "v5e"
    assert cal.provenance["codec.lzb"] == {
        "method": "measured", "samples": 128,
        "bytes": cal.provenance["codec.lzb"]["bytes"]}
    assert spec.ratio == tplan.DEFAULT_CODECS["lzb"].ratio


def test_fit_recovers_ici_bandwidth():
    raw = 1 << 22
    want = 3.2e10
    cal = both(lambda pk: pk.plan.fit_constants(
        [hop(raw, "ici", tier="ici", tx_s=32 * raw / want)],
        bench_memory=False))
    assert cal.ici_bw_s == pytest.approx(want, rel=1e-6)
    assert cal.provenance["ici_bw_s"]["method"] == "measured"


def test_fit_keys_specs_by_deployed_name():
    raw = 1 << 20
    cal = both(lambda pk: pk.plan.fit_constants(
        [hop(raw, "dsleep10+raw", enc_bw=4e9, dec_bw=raw / 10e-3)],
        bench_memory=False))
    assert cal.codecs["dsleep10+raw"].decode_bytes_per_s == pytest.approx(
        raw / 10e-3, rel=1e-6)
    assert not cal.codecs["dsleep10+raw"].lossy


def test_fit_keeps_prior_when_no_telemetry():
    def scenario(pk):
        prior = pk.plan.StageCostModel(dense_chain(pk, [8, 8]), gen="v4",
                                       link_bw_s=7e8, ici_bw_s=9e9,
                                       host_sync_bw_s=3e9)
        return pk.plan.fit_constants([hop(1 << 20, "raw", enc_bw=1e9)],
                                     prior=prior, bench_memory=False)
    cal = both(scenario)
    assert cal.host_sync_bw_s == 3e9 and cal.ici_bw_s == 9e9
    assert cal.provenance["host_sync_bw_s"]["method"] == "prior"
    assert cal.provenance["ici_bw_s"]["method"] == "prior"


def test_fit_measures_memory_bandwidth_on_request():
    cal = tplan.fit_constants([hop(1 << 20, "raw", enc_bw=1e9)])
    assert cal.local_bw_s > 0
    assert cal.provenance["local_bw_s"]["method"] == "bench"
    assert tplan.measure_memory_bw(nbytes=1 << 16, reps=1) > 0


# -- degenerate rejection ----------------------------------------------------


@pytest.mark.parametrize("hops,match", [
    ([hop(0, "raw", enc_bw=1e9)], "zero-byte"),
    ([hop(1 << 20, "raw", enc_bw=1e9, n=3)], "only 3 sample"),
    ([], "no hop telemetry")])
def test_fit_rejects_degenerate(hops, match):
    for pk in (J, T):
        with pytest.raises(pk.plan.CalibrationError, match=match):
            pk.plan.fit_constants(hops, bench_memory=False)
    assert issubclass(tplan.CalibrationError, ValueError)


def test_zero_count_is_legitimate_absence():
    rec = hop(1 << 20, "ici", tier="ici", tx_s=32 * (1 << 20) / 4.5e10)
    assert rec["host_sync_s"] == {"count": 0}
    both(lambda pk: pk.plan.fit_constants([rec], bench_memory=False))


# -- the artifact ------------------------------------------------------------


def test_artifact_roundtrip_across_packages(tmp_path):
    """A file written by either package loads in both, fields equal."""
    hops = [hop(1 << 20, "lzb", enc_bw=2e9, dec_bw=1e9, hs_bw=5e9,
                link_bw=1e8)]
    for src in (J, T):
        cal = src.plan.fit_constants(hops, gen="v4", bench_memory=False)
        p = tmp_path / f"cal_{id(src)}.json"
        cal.save(str(p))
        for dst in (J, T):
            back = dst.plan.CalibratedConstants.load(str(p))
            assert back.to_json() == cal.to_json()
            assert back.schema == tcal.SCHEMA == jcal.SCHEMA
            assert isinstance(back.codecs["lzb"], dst.plan.CodecSpec)
    with pytest.raises(tplan.CalibrationError, match="schema"):
        tplan.CalibratedConstants.from_json({"schema": "bogus.v9"})


def test_apply_overlays_without_mutating():
    def scenario(pk):
        g = dense_chain(pk, [8, 8, 8])
        cost = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e9)
        cal = pk.plan.CalibratedConstants(
            host_sync_bw_s=2e9, link_bw_s=5e7,
            codecs={"weird": pk.plan.CodecSpec(
                name="weird", ratio=1.0, encode_bytes_per_s=1e9,
                decode_bytes_per_s=1e9, lossy=False)})
        out = cal.apply(cost)
        assert out is not cost
        return {"out": out.describe(), "cost": cost.describe()}
    r = both(scenario)
    out, cost = r["out"], r["cost"]
    assert out["host_sync_bw_s"] == 2e9 and out["link_bw_s"] == 5e7
    assert "weird" in out["codecs"] and "raw" in out["codecs"]
    assert cost["link_bw_s"] == 1e9 and "weird" not in cost["codecs"]
    assert out["local_bw_s"] == cost["local_bw_s"]


# -- plan-JSON roundtrip -----------------------------------------------------


def test_calibration_survives_plan_json_roundtrip():
    def scenario(pk):
        g = dense_chain(pk, [8, 16, 8, 8])
        cuts = [g.topo_order[1], g.topo_order[2]]
        cost = pk.plan.StageCostModel(
            g, gen="v4", batch=4, link_bw_s=1e9,
            node_costs={n: 1e-4 for n in g.topo_order})
        raw = cost.cut_bytes(cuts[0])
        cal = pk.plan.fit_constants(
            [hop(raw, "dsleep5+raw", enc_bw=2e9, dec_bw=raw / 5e-3,
                 cut=cuts[0])], bench_memory=False)
        cal_cost = cal.apply(cost)
        deployed = ["dsleep5+raw", "raw"]
        pred = pk.plan.predict_stage_service_s(g, cuts, deployed, cal_cost)
        plan = pk.plan.evaluate_cuts(g, cuts, cal_cost, hop_codecs=deployed)
        doc = json.loads(json.dumps(plan.to_json()))
        restored = pk.plan.cost_model_from_plan(
            g, pk.plan.plan_from_json(doc))
        back = pk.plan.predict_stage_service_s(g, cuts, deployed, restored)
        return {"pred": pred, "back": back, "plan": doc,
                "restored": restored.describe()}
    r = both(scenario)
    assert r["plan"]["hop_codecs"] == ["dsleep5+raw", "raw"]
    assert r["restored"]["batch"] == 4
    assert "dsleep5+raw" in r["restored"]["codecs"]
    for a, b in zip(r["back"], r["pred"]):
        assert a == pytest.approx(b, rel=1e-3)


def test_evaluate_cuts_hop_codecs_validation():
    g = dense_chain(T, [8, 8, 8, 8])
    cost = tplan.StageCostModel(g, gen="v4",
                                node_costs={n: 1e-4 for n in g.topo_order})
    cut = g.topo_order[2]
    with pytest.raises(ValueError, match="hop codecs"):
        tplan.evaluate_cuts(g, [cut], cost, hop_codecs=["raw", "raw"])
    with pytest.raises(ValueError, match="replicas"):
        tplan.evaluate_cuts(g, [cut], cost, hop_codecs=["raw"],
                            replicas=[1, 2])


# -- measurement-aligned prediction ------------------------------------------


def test_predict_stage_service_alignment():
    def scenario(pk):
        g = dense_chain(pk, [8, 8, 8])
        cuts = [g.topo_order[0], g.topo_order[1]]
        cost = pk.plan.StageCostModel(
            g, gen="v4", link_bw_s=1e9,
            node_costs={n: 1e-3 for n in g.topo_order})
        cost.codecs = {**cost.codecs, "slowdec": pk.plan.CodecSpec(
            name="slowdec", ratio=1.0, encode_bytes_per_s=1e12,
            decode_bytes_per_s=10.0, lossy=False)}
        order = g.topo_order
        bounds = [0, order.index(cuts[0]) + 1, order.index(cuts[1]) + 1,
                  len(order)]
        return {"pred": pk.plan.predict_stage_service_s(
                    g, cuts, ["slowdec", "raw"], cost),
                "dec": cost.cut_bytes(cuts[0]) / 10.0,
                "compute": [cost.compute_seconds(order[a:b])
                            for a, b in zip(bounds, bounds[1:])],
                "none": pk.plan.predict_stage_service_s(
                    g, cuts, ["ici", "local"], cost)}
    r = both(scenario)
    assert r["pred"][1] == pytest.approx(max(r["dec"], r["pred"][0]),
                                         rel=1e-9)
    assert r["pred"][0] < r["dec"]
    assert r["none"] == pytest.approx(r["compute"], rel=1e-9)
    g = dense_chain(T, [8, 8, 8])
    with pytest.raises(ValueError, match="hop codecs"):
        tplan.predict_stage_service_s(
            g, [g.topo_order[0], g.topo_order[1]], ["raw"],
            tplan.StageCostModel(g, gen="v4"))


def test_codec_only_parts_unknown_falls_back_to_raw():
    def scenario(pk):
        g = dense_chain(pk, [8, 8])
        cost = pk.plan.StageCostModel(
            g, gen="v4", node_costs={n: 1e-4 for n in g.topo_order})
        cut = g.topo_order[1]
        return [list(pk.cal.codec_only_parts(cost, cut, name))
                for name in ("never-heard-of-it", "raw", "device")]
    unknown, raw, device = both(scenario)
    assert unknown == raw and device == [0.0, 0.0]


# -- stats reshaping ---------------------------------------------------------


def stats_row(stage, codec, *, enc=None, dec=None, hs=None, tx=None,
              replica=None, tier="tcp"):
    return {"stage": stage, "replica": replica, "codec": codec,
            "tier": tier,
            "encode_latency_s": enc or {"count": 0},
            "decode_latency_s": dec or {"count": 0},
            "host_sync_s": hs or {"count": 0},
            "tx_s": tx or {"count": 0}}


def test_hop_telemetry_from_stats_joins_sides():
    stats = [stats_row(0, "lzb", enc=summ(16, 0.016), hs=summ(16, 0.008),
                       tx=summ(16, 0.032)),
             stats_row(1, "raw", dec=summ(16, 0.160))]

    def scenario(pk):
        g = dense_chain(pk, [8, 8, 8])
        return pk.plan.hop_telemetry_from_stats(g, [g.topo_order[1]],
                                                stats, batch=2)
    (h,) = both(scenario)
    assert h["raw_bytes"] == 8 * 4 * 2
    assert h["codec"] == "lzb"
    assert h["enc_s"]["sum"] == pytest.approx(0.016)
    assert h["dec_s"]["sum"] == pytest.approx(0.160)


def test_hop_telemetry_window_bounds_and_pools_replicas():
    base = [stats_row(0, "lzb", enc=summ(8, 0.8)),
            stats_row(1, "raw", dec=summ(8, 0.8))]
    now = [stats_row(0, "lzb", enc=summ(24, 0.96)),
           stats_row(1, "raw", dec=summ(24, 0.96))]
    reps = [stats_row(0, "raw", enc=summ(8, 0.08), replica=0),
            stats_row(0, "raw", enc=summ(8, 0.24), replica=1),
            stats_row(1, "raw", dec=summ(16, 0.16))]

    def scenario(pk):
        g = dense_chain(pk, [8, 8, 8])
        cuts = [g.topo_order[1]]
        return [pk.plan.hop_telemetry_from_stats(g, cuts, now,
                                                 baseline=base)[0],
                pk.plan.hop_telemetry_from_stats(g, cuts, reps)[0]]
    win, pooled = both(scenario)
    assert win["enc_s"] == {"count": 16, "sum": pytest.approx(0.16)}
    assert win["dec_s"] == {"count": 16, "sum": pytest.approx(0.16)}
    assert pooled["enc_s"] == {"count": 16, "sum": pytest.approx(0.32)}


# -- a live chain of the port's nodes ----------------------------------------


@pytest.mark.timeout(120)
def test_fit_from_live_shm_chain():
    """Three in-process port nodes on shm hops (the CPU): their ``stats``
    fit a host-sync bandwidth with ``measured`` provenance (each node
    copies its output into its ring slot as its host sync), the JAX
    package's fit of the same stats agrees, and the artifact crosses."""
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    cuts = [s.output_name for s in stages[:-1]]
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
          for _ in range(10)]
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu", tier="shm")
             for _ in stages]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    threads = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw", tier="shm")
    try:
        disp.deploy(stages, params, addrs, batch=2, tiers=["shm"] * 3)
        assert len(disp.stream(xs)) == len(xs)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    assert [s["tier"] for s in stats] == ["shm"] * 3
    assert all(s["host_sync_s"]["count"] == len(xs) for s in stats)
    hops = tplan.hop_telemetry_from_stats(g, cuts, stats, batch=2)
    assert [h["tier"] for h in hops] == ["shm", "shm"]
    jg = jmodels.resnet_tiny()
    assert _js(hops) == _js(jplan.hop_telemetry_from_stats(
        jg, cuts, stats, batch=2))
    cal = tplan.fit_from_stats(g, cuts, stats, batch=2, gen="unknown")
    assert cal.provenance["host_sync_bw_s"]["method"] == "measured"
    assert cal.provenance["host_sync_bw_s"]["samples"] == 2 * len(xs)
    assert cal.host_sync_bw_s > 0
    jc = jplan.fit_from_stats(jg, cuts, stats, batch=2, gen="unknown",
                              bench_memory=False)
    assert jc.host_sync_bw_s == cal.host_sync_bw_s
    back = jplan.CalibratedConstants.from_json(
        json.loads(json.dumps(cal.to_json())))
    assert back.to_json() == cal.to_json()
    cm = cal.apply(tplan.StageCostModel(g, gen="unknown"))
    assert cm.host_sync_bw_s == cal.host_sync_bw_s
    pred = tplan.predict_stage_service_s(g, cuts, ["shm", "shm"], cm)
    assert len(pred) == 3 and all(p > 0 for p in pred)


@pytest.mark.timeout(240)
def test_cli_planner_loop(capsys, tmp_path):
    """The planner loop through the CLI: ``chain --emit-calibration``
    (two node processes on shm hops, the CPU) writes a calibration file,
    and ``plan --calibrated FILE --json`` prints the JAX CLI's document
    for the same file."""
    from defer_tpu.cli import main as jmain
    from defer_tpu_torch.cli import main as tmain
    cal_path = tmp_path / "cal.json"
    tmain(["chain", "--model", "resnet_tiny", "--stages", "2", "--count",
           "8", "--batch", "2", "--device", "cpu", "--emit-calibration",
           str(cal_path)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["calibration"] == str(cal_path)
    assert row["hop_tiers"] == ["shm"]
    cal = jplan.CalibratedConstants.load(str(cal_path))
    assert cal.provenance["host_sync_bw_s"]["method"] == "measured"
    assert cal.gen == "unknown"
    docs = []
    for main in (jmain, tmain):
        main(["plan", "--model", "resnet_tiny", "--stages", "2",
              "--calibrated", str(cal_path), "--json"])
        docs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert _js(docs[0]) == _js(docs[1])
    assert docs[1]["cost_model"]["host_sync_bw_s"] == cal.host_sync_bw_s
