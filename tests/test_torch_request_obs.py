"""Port parity: serving observability and the monitor CLI, mirroring
``tests/test_request_obs.py`` (the door's and a node's ``events_since``,
SLO attainment and attribution in the door's stats, ``monitor --serve
--events``, the serving metrics in the Prometheus exposition) and the
``monitor --nodes --plan --model`` path of ``tests/test_obs_live.py``.

A port ``ServeFrontDoor`` in tensor mode over a two-stage port chain
(in-process nodes on the CPU); each query runs with both packages'
clients and CLIs, which must read the same documents.
"""

import contextlib
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import defer_tpu.cli as jcli
import defer_tpu.serve.client as jclient
import defer_tpu_torch.cli as tcli
import defer_tpu_torch.serve.client as tclient
from defer_tpu_torch import models, partition
from defer_tpu_torch.obs import REGISTRY, start_prom_server
from defer_tpu_torch.plan import StageCostModel, evaluate_cuts
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
from defer_tpu_torch.serve import ServeClient, ServeFrontDoor, TenantConfig
from defer_tpu_torch.serve.frontdoor import ChainBackend
from defer_tpu_torch.transport.framed import (K_CTRL, connect_retry,
                                              recv_expect, send_ctrl,
                                              send_end)

torch.set_num_threads(1)

IN_SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def door():
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, ["add_1"])
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu")
             for _ in stages]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(stages, params, addrs, batch=2)
    d = ServeFrontDoor(backend=ChainBackend(disp, 2, IN_SHAPE),
                       tenants=[TenantConfig("obs_gold",
                                             deadline_ms=5000.0)]).start()
    yield d, addrs, g
    d.stop()
    for t in threads:
        t.join(timeout=30)


def _stream(door, tenant, n, deadline_ms=60_000.0):
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(IN_SHAPE).astype(np.float32)
            for _ in range(n)]
    outs = ServeClient(*door.address, tenant,
                       deadline_ms=deadline_ms).stream(data)
    assert all(o is not None and o[0] == "ok" for o in outs), outs


@pytest.mark.timeout(120)
def test_stats_carry_slo_attainment_and_attribution(door):
    d, _, _ = door
    _stream(d, "obs_slo", 2)
    docs = [c.fetch_stats(*d.address) for c in (tclient, jclient)]
    for doc in docs:
        row = doc["tenants"]["obs_slo"]
        assert row["slo_attainment"] == 1.0 and row["slo_measured"] == 2
        buckets = doc["attribution"]["obs_slo"]
        assert buckets["e2e"]["count"] == 2
        for k in ("admission", "gather", "chain", "result_edge"):
            assert buckets[k]["count"] == 2
        assert "events_dropped" in doc
    assert docs[0]["tenants"]["obs_slo"] == docs[1]["tenants"]["obs_slo"]
    _stream(d, "obs_noslo", 1, deadline_ms=None)
    assert tclient.fetch_stats(*d.address)["tenants"]["obs_noslo"][
        "slo_attainment"] is None


@pytest.mark.timeout(120)
def test_events_since_queries_node_and_door(door):
    d, addrs, _ = door
    _stream(d, "obs_gold", 2)
    host, _, port = addrs[0].rpartition(":")
    s = connect_retry(host, int(port), 30.0)
    try:
        send_ctrl(s, {"cmd": "events_since", "cursor": 0})
        reply = recv_expect(s, K_CTRL)
        send_end(s)
    finally:
        s.close()
    assert reply["cmd"] == "events_reply"
    assert isinstance(reply["dropped"], int)
    kinds = {e["kind"] for e in reply["events"]}
    assert {"stream_begin", "admit"} <= kinds
    hops = {e["data"].get("hop") for e in reply["events"]
            if e["kind"] == "stream_begin"}
    assert {"stage0", "stage1"} <= hops
    reps = [c.fetch_events(*d.address, cursor=0) for c in (tclient, jclient)]
    for rep in reps:
        assert {e["kind"] for e in rep["events"]} >= {"client_open",
                                                     "client_close"}
        again = tclient.fetch_events(*d.address, cursor=rep["cursor"])
        assert again["events"] == [] or again["cursor"] > rep["cursor"]


def _monitor(cli, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(["monitor", *argv])
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cli", [tcli, jcli], ids=["port", "jax"])
def test_monitor_serve_renders_events_and_slo(cli, door):
    d, _, _ = door
    _stream(d, "obs_gold", 1)
    host, port = d.address
    (doc,) = _monitor(cli, ["--serve", f"{host}:{port}", "--events",
                            "--iterations", "1", "--interval-ms", "50",
                            "--json"])
    assert "client_open" in {e["kind"] for e in doc["events"]}
    assert doc["events_dropped"] == 0
    assert "slo_attainment" in doc["serve"]["tenants"]["obs_gold"]
    assert "attribution" in doc["serve"]


@pytest.mark.timeout(120)
def test_monitor_nodes_with_a_plan_in_both_clis(door, tmp_path):
    """``monitor --nodes --plan --model --json`` against the port's nodes:
    both packages' CLIs give rows for every stage with the drift audit's
    columns, and the same document keys."""
    d, addrs, g = door
    plan = evaluate_cuts(g, ["add_1"], StageCostModel(g, batch=2,
                                                      gen="unknown"))
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_json()))
    _stream(d, "obs_gold", 4)
    docs = []
    for cli in (tcli, jcli):
        lines = _monitor(cli, ["--nodes", ",".join(addrs), "--plan",
                               str(path), "--model", "resnet_tiny",
                               "--iterations", "2", "--interval-ms", "60",
                               "--json"])
        assert [doc["iteration"] for doc in lines] == [1, 2]
        docs.append(lines[-1])
    for doc in docs:
        assert sorted(r["stage"] for r in doc["rows"]) == [0, 1]
        assert all({"pred_ms", "meas_ms", "err"} <= set(r)
                   for r in doc["rows"])
        assert set(doc["clock_offsets"]) == set(addrs)
    assert set(docs[0]) == set(docs[1])
    assert [r["processed"] for r in docs[0]["rows"]] == \
        [r["processed"] for r in docs[1]["rows"]]


def test_monitor_needs_an_address():
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit, match="--nodes"):
            cli.main(["monitor"])
        with pytest.raises(SystemExit, match="unknown event kind"):
            cli.main(["monitor", "--serve", "127.0.0.1:1", "--kind",
                      "nope"])


@pytest.mark.timeout(60)
def test_prom_exposition_carries_serving_metrics(door):
    d, _, _ = door
    _stream(d, "obs_gold", 1)
    text = REGISTRY.exposition()
    assert "serve_admitted" in text and "serve_shed" in text
    assert "serve_tenant_obs_gold_admitted" in text
    assert 'serve_tenant_obs_gold_queue_delay_s{quantile="0.99"}' in text
    assert "events_dropped" in text
    srv = start_prom_server(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/metrics",
            timeout=10).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    assert "serve_tenant_obs_gold_admitted" in body
