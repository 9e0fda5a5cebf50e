"""Command line of the port: the stage-node process chain.

    python -m defer_tpu_torch node --listen :5000 [--device cpu]
    python -m defer_tpu_torch chain --model resnet_tiny --stages 3 \\
        [--in-band] [--codec lzb] [--device cpu]

``node`` boots one stage node (empty, to be deployed in-band, or from an
``--artifact`` file with its ``--next`` hop) and serves until its stream
ends; each ``--co-stage`` boards one more stage node on a thread of the
same process, so the hops between them can take the in-process transport
tiers.  ``chain`` spawns the node processes of a model's stages on this
host, streams seeded random inputs through them with
:func:`~defer_tpu_torch.runtime.node.run_chain`, and prints one JSON row:
inferences/s, each hop's negotiated tier and the largest difference from
the whole-graph forward.

These are the port's two subcommands of the JAX package's CLI
(``defer_tpu/cli.py``); the others come with ROADMAP item A17.  Nodes run
on the CUDA card unless ``--device cpu`` is given; a float32 stage runs
without TF32 (cuBLAS and cuDNN), so its rows match the float32 forward.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _no_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parse_co_stage(spec: str) -> dict:
    """``listen=ADDR[;artifact=P][;next=A][;codec=C][;tier=T][;accept=0|1]
    [;device=J]`` -> dict.  The grammar uses ``;`` separators because a
    ``next`` value may itself be a comma list.  ``accept`` says whether
    this housemate grants inbound tier offers (default: its own ``tier``
    is not tcp), apart from its outbound policy: a stage whose next hop
    leaves the process may still be the in-process target of its
    upstream housemate."""
    kv = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        k, sep, v = part.partition("=")
        if not sep:
            raise SystemExit(f"--co-stage: {part!r} is not key=value")
        kv[k.strip()] = v.strip()
    if "listen" not in kv:
        raise SystemExit(f"--co-stage {spec!r} needs listen=host:port")
    bad = set(kv) - {"listen", "artifact", "next", "codec", "tier",
                     "accept", "device"}
    if bad:
        raise SystemExit(f"--co-stage: unknown keys {sorted(bad)}")
    if kv.get("accept") not in (None, "0", "1"):
        raise SystemExit(f"--co-stage: accept must be 0|1, "
                         f"got {kv['accept']!r}")
    if "device" in kv:
        try:
            kv["device"] = int(kv["device"])
        except ValueError:
            raise SystemExit(f"--co-stage: device must be an integer "
                             f"CUDA device index, got {kv['device']!r}")
    return kv


def _device_arg(v: str | None):
    """``--device``: ``cuda``, ``cuda:N``, ``cpu``, or a bare index ``J``
    meaning ``cuda:J``."""
    return int(v) if v is not None and v.isdigit() else v


def cmd_node(args) -> None:
    import threading
    import traceback

    from .runtime.node import StageNode
    from .transport.framed import _codec

    _codec(args.codec)  # loud at boot, not when the first tensor relays
    specs = [_parse_co_stage(c) for c in args.co_stage or []]
    for kv in specs:
        _codec(kv.get("codec", "raw"))
    _no_tf32()

    def boot(artifact, listen, nxt, codec, tier, accept, device,
             primary):
        node = StageNode(artifact, listen, nxt,
                         codec=codec, overlap=not args.no_overlap,
                         rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                         inflight=args.inflight,
                         infer_delay_s=args.infer_delay_ms / 1e3
                         if primary else 0.0,
                         tier=tier, tier_accept=accept, device=device,
                         persist=args.persist)
        what = (f"stage {node.manifest['index']} ({node.manifest['name']})"
                if node.manifest else "EMPTY (awaiting in-band deploy)")
        print(f"node: {what} on {node.device} listening on "
              f"{node.address[0]}:{node.address[1]}, next {nxt}"
              f"{' [serial]' if args.no_overlap else ''}",
              file=sys.stderr, flush=True)
        return node

    accept = (args.tier != "tcp") if args.tier_accept == "auto" \
        else args.tier_accept == "1"
    device = _device_arg(args.device)
    node = boot(args.artifact, args.listen, args.next, args.codec,
                args.tier, accept, device, True)
    # each --co-stage boards this process as its own serve thread: the
    # hops between housemates negotiate the in-process tiers
    co = [boot(kv.get("artifact"), kv["listen"], kv.get("next"),
               kv.get("codec", "raw"), kv.get("tier", args.tier),
               kv["accept"] == "1" if "accept" in kv
               else kv.get("tier", args.tier) != "tcp",
               kv.get("device", device), False)
          for kv in specs]
    counts: dict[int, int] = {}

    def serve_co(i: int):
        try:
            counts[i] = co[i].serve(connect_timeout_s=args.connect_timeout)
        except BaseException:  # noqa: BLE001 — a dead co-stage kills the
            # process, so the parent sees one attributed failure instead
            # of a wedged chain
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)

    threads = [threading.Thread(target=serve_co, args=(i,), daemon=True)
               for i in range(len(co))]
    for t in threads:
        t.start()
    n = node.serve(connect_timeout_s=args.connect_timeout)
    # the process exits once every housemate's stream has drained
    for t in threads:
        t.join()
    n += sum(counts.values())
    print(f"node: served {n} tensors; chain drained", file=sys.stderr)


def cmd_chain(args) -> None:
    import numpy as np
    import torch

    from . import models, partition
    from .runtime.node import run_chain
    from .utils.config import resolve_device
    from .utils.convert import params_to_device

    if not hasattr(models, args.model):
        raise SystemExit(f"unknown model {args.model!r}")
    graph = getattr(models, args.model)()
    params = graph.init(torch.Generator().manual_seed(0))
    cuts = args.cuts.split(",") if args.cuts else None
    stages = partition(graph, cuts, num_stages=None if cuts else args.stages)
    spec = stages[0].in_spec
    rng = np.random.default_rng(0)
    if spec.dtype.is_floating_point:
        xs = [rng.standard_normal((args.batch,) + spec.shape)
              .astype(np.float32) for _ in range(args.count)]
    else:
        vocab = next(n.op.vocab for n in graph.nodes.values()
                     if hasattr(n.op, "vocab"))
        xs = [rng.integers(0, vocab, (args.batch,) + spec.shape)
              .astype(np.int32) for _ in range(args.count)]
    hop_tiers = ([t.strip() for t in args.hop_tiers.split(",") if t.strip()]
                 if args.hop_tiers else None)
    device_map = None
    if args.device_map:
        device_map = {}
        for part in args.device_map.split(","):
            k, sep, v = part.strip().partition("=")
            if not sep or not k.startswith("stage"):
                raise SystemExit(f"--device-map: {part!r} is not stageK=J")
            try:
                device_map[int(k[len("stage"):])] = int(v)
            except ValueError:
                raise SystemExit(f"--device-map: {part!r} is not stageK=J")
    stats: list = []
    t0 = time.perf_counter()
    outs = run_chain(stages, params, xs, batch=args.batch, codec=args.codec,
                     in_band=args.in_band, overlap=not args.no_overlap,
                     rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                     inflight=args.inflight, stats_out=stats,
                     tier=args.tier, hop_tiers=hop_tiers,
                     devices=args.devices, device_map=device_map,
                     device=args.device)
    dt = time.perf_counter() - t0

    dev = resolve_device(args.device)
    _no_tf32()
    pdev = params_to_device(params, dev)
    with torch.inference_mode():
        worst = max(float(np.abs(
            graph.apply(pdev, torch.from_numpy(x).to(dev)).cpu().numpy()
            - y).max()) for x, y in zip(xs, outs))
    print(json.dumps({
        "metric": f"{args.model}_{len(stages)}proc_chain",
        "value": round(len(xs) * args.batch / dt, 3),
        "unit": "inferences/sec",
        "stages": len(stats), "codec": args.codec, "tier": args.tier,
        "overlap": not args.no_overlap, "device": str(dev),
        "hop_tiers": [s["tier"] for s in stats[:-1]],
        "result_tier": stats[-1]["tier"],
        "max_abs_err_vs_single_program": worst,
        "kernel_launches": [s["kernel_launches"] for s in stats],
    }))


def _add_overlap_flags(p) -> None:
    """Transport-overlap tuning shared by ``node`` and ``chain``."""
    p.add_argument("--no-overlap", action="store_true",
                   help="serial recv->infer->send node loop (the baseline "
                        "the overlapped loop is measured against)")
    p.add_argument("--rx-depth", type=int, default=8, metavar="N",
                   help="decoded frames buffered by each rx channel")
    p.add_argument("--tx-depth", type=int, default=8, metavar="N",
                   help="frames queued to each tx channel before the "
                        "producer blocks")
    p.add_argument("--inflight", type=int, default=2, metavar="N",
                   help="stage programs kept un-synced per node (the "
                        "window of CUDA events waited on in order)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m defer_tpu_torch",
        description="DEFER's stage-node process chain, in PyTorch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    nd = sub.add_parser("node", help="run one standalone stage node")
    nd.add_argument("--artifact", default=None,
                    help="pre-placed stage artifact; omit to boot empty "
                         "and receive it in-band (control handshake)")
    nd.add_argument("--listen", required=True, metavar="[host]:port")
    nd.add_argument("--next", default=None, metavar="host:port",
                    help="successor hop (last node: the dispatcher's "
                         "result port); omit to receive it in-band")
    nd.add_argument("--codec", default="raw",
                    help="hop codec: raw | lzb | bf8/bf12/bf16 | "
                         "sleep<ms>+<codec> (bench-only delay wrapper; "
                         "esleep/dsleep delay one side only)")
    nd.add_argument("--connect-timeout", type=float, default=30.0)
    nd.add_argument("--infer-delay-ms", type=float, default=0.0,
                    help="bench-only: sleep this long per frame in the "
                         "compute loop (simulated device time)")
    nd.add_argument("--device", default=None,
                    help="where the stage program runs: cuda (the "
                         "default; raises without a card), cuda:N, a bare "
                         "card index J (cuda:J), or cpu")
    nd.add_argument("--persist", action="store_true",
                    help="survive stream END: keep serving segments until "
                         "a 'shutdown' control frame arrives")
    nd.add_argument("--tier", choices=["auto", "ici", "local", "shm", "tcp"],
                    default="auto",
                    help="outbound transport-tier policy: auto walks the "
                         "ladder on the downstream dial — ici (same "
                         "process and platform, the output tensor handed "
                         "over on the card) over local (same process, the "
                         "host copy by reference) over shm (same host, a "
                         "shared-memory ring with the socket as doorbell) "
                         "over tcp; ici/local/shm offer that rung alone; "
                         "tcp never probes")
    nd.add_argument("--tier-accept", choices=["auto", "0", "1"],
                    default="auto",
                    help="grant inbound tier offers (auto: exactly when "
                         "--tier is not tcp; a stage whose own outbound is "
                         "tcp may still be the colocated target of its "
                         "upstream)")
    nd.add_argument("--co-stage", action="append", default=[],
                    metavar="SPEC",
                    help="host one more stage node in this process "
                         "(repeatable): 'listen=host:port[;artifact=P]"
                         "[;next=host:port][;codec=C][;tier=T]"
                         "[;accept=0|1][;device=J]' — hops between "
                         "housemates negotiate the in-process tiers (ici "
                         "on one platform, local otherwise); accept gates "
                         "inbound offers (default: tier != tcp); device "
                         "pins the housemate's program to cuda:J")
    _add_overlap_flags(nd)

    c = sub.add_parser("chain", help="spawn a local N-process chain and "
                                     "verify it against the forward")
    c.add_argument("--model", default="resnet_tiny")
    c.add_argument("--stages", type=int, default=3)
    c.add_argument("--cuts", help="comma-separated cut points (in place "
                                  "of --stages)")
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--count", type=int, default=8)
    c.add_argument("--codec", default="raw",
                   choices=["raw", "lzb", "bf8", "bf12", "bf16"])
    c.add_argument("--in-band", action="store_true",
                   help="boot nodes empty; ship artifacts over the "
                        "control handshake")
    c.add_argument("--device", default="cuda",
                   help="where every node runs: cuda (the default) or cpu")
    c.add_argument("--tier", choices=["auto", "shm", "tcp"], default="auto",
                   help="transport-tier policy of every hop, the "
                        "dispatcher's edges included: auto negotiates the "
                        "cheapest rung per hop (ici > local > shm > tcp), "
                        "shm pins the shared-memory offer, tcp is a pure "
                        "wire chain end to end.  Pin ici/local on stage "
                        "hops with --hop-tiers (the dispatcher is a "
                        "process of its own)")
    c.add_argument("--hop-tiers", default="", metavar="T0,T1,...",
                   help="one tier per inter-stage hop (stages-1 of them, "
                        "each tcp|auto|local|shm|ici|device): device fuses "
                        "the two stages into one program, ici and local run "
                        "them in one process (ici hands the tensor over on "
                        "the card), shm keeps separate processes and hands "
                        "activations through a shared-memory ring")
    c.add_argument("--devices", type=int, default=None, metavar="N",
                   help="require N visible CUDA cards (for --device-map)")
    c.add_argument("--device-map", default="", metavar="stageK=J,...",
                   help="pin stage K's program to cuda:J; an ici hop "
                        "between cards moves each activation device to "
                        "device")
    _add_overlap_flags(c)

    args = ap.parse_args(argv)
    {"node": cmd_node, "chain": cmd_chain}[args.cmd](args)


if __name__ == "__main__":
    main()
