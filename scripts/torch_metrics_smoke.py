"""Telemetry smoke test: tiny CPU pipeline -> non-empty trace + metrics.

Runs a 2-stage resnet_tiny SPMD pipeline on the CPU backend with tracing
enabled, then asserts that (a) the Chrome-trace export contains dispatcher
and per-stage spans sharing one trace id, and (b) the metrics registry
snapshot carries per-stage latency percentiles and per-hop byte counters.
Exit 0 on success; any assertion failure is loud.  Cheap enough for a
tier-1 time budget.

The PyTorch port's copy of ``scripts/metrics_smoke.py``: the same checks
and row, on ``--device`` (the card by default).  The trace holds this
smoke's spans only (the tracer is drained at its start), so ``main(argv)``
may run in a process whose tracer and registry already hold other work.

Usage:  python scripts/torch_metrics_smoke.py [--out-dir DIR]
            [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the ``--device`` of this run (``main`` sets it): the pipeline runs there
DEVICE = None


def pick_device(name):
    """``--device`` as the port's command line reads it (``cuda``,
    ``cuda:N``, ``cpu`` or a bare index N); the card when ``None``.
    Asked for the card where there is none, it raises.  On the CPU the
    pipeline runs on one intra-op thread, as the port's CPU tests do."""
    import torch

    from defer_tpu_torch.utils.config import resolve_device
    if name is not None and name.isdigit():
        name = f"cuda:{name}"
    dev = resolve_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        # TF32 off, as the port's command line runs (``_no_tf32``)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=None,
                    help="keep the exports here (default: tempdir)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)

    import numpy as np

    import torch

    from defer_tpu_torch import SpmdPipeline, partition, pipeline_mesh
    from defer_tpu_torch.models import resnet_tiny
    from defer_tpu_torch.obs import REGISTRY, enable_tracing, tracer

    was_on = tracer().enabled
    tr = enable_tracing(process="dispatcher")
    tr.clear()
    tr.start_trace()

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=2)
    # both stages on the one device (the JAX script's mesh is one forced
    # host device too): the ring runs its stage axis on one card
    pipe = SpmdPipeline(stages, params,
                        mesh=pipeline_mesh(2, devices=[DEVICE] * 2),
                        microbatch=1, chunk=4)
    xs = np.zeros((4, 1, 32, 32, 3), np.float32)
    for _ in range(3):
        pipe.push(xs)
    pipe.flush()
    pipe.stage_latencies(iters=2)

    out_dir = args.out_dir or tempfile.mkdtemp(prefix="defer_obs_smoke_")
    trace_path = os.path.join(out_dir, "trace.json")
    metrics_path = os.path.join(out_dir, "metrics.json")
    tr.export_chrome(trace_path)
    REGISTRY.dump_json(metrics_path)
    tr.enabled = was_on

    # ---- assertions: the exports are non-empty and self-consistent
    t = json.load(open(trace_path))
    events = [e for e in t["traceEvents"] if e.get("ph") == "X"]
    assert events, "trace export has no spans"
    trace_ids = {e["args"].get("trace_id") for e in events}
    assert len(trace_ids) == 1, f"spans span {len(trace_ids)} trace ids"
    names = {e["name"] for e in events}
    assert any(n.startswith("spmd.push") for n in names), names
    assert any(n.startswith("stage0") for n in names), names

    m = json.load(open(metrics_path))
    prefix = pipe.metrics.prefix
    stage0 = m[f"{prefix}.stage0.latency_s"]
    for q in ("p50", "p95", "p99", "max"):
        assert q in stage0, stage0
    hop0 = m[f"{prefix}.hop0.bytes"]
    assert hop0 > 0, "per-hop byte counter did not accumulate"
    push = m[f"{prefix}.push_latency_s"]
    assert push["count"] >= 3, push

    print(json.dumps({
        "metric": "metrics_smoke", "value": 1, "unit": "ok",
        "spans": len(events),
        "push_p99_ms": round(push["p99"] * 1e3, 3),
        "trace": trace_path, "metrics": metrics_path,
    }))
    print("metrics smoke: OK", file=sys.stderr)
    # clean up tempdir exports unless the caller asked to keep them
    if args.out_dir is None:
        for p in (trace_path, metrics_path):
            os.unlink(p)
        os.rmdir(out_dir)


if __name__ == "__main__":
    main()
