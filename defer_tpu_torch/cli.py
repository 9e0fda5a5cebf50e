"""Command line of the port: the stage-node process chain.

    python -m defer_tpu_torch node --listen :5000 [--device cpu]
    python -m defer_tpu_torch chain --model resnet_tiny --stages 3 \\
        [--in-band] [--codec lzb] [--device cpu]

``node`` boots one stage node (empty, to be deployed in-band, or from an
``--artifact`` file with its ``--next`` hop) and serves until its stream
ends.  ``chain`` spawns one ``node`` process per stage of a model on this
host, streams seeded random inputs through them with
:func:`~defer_tpu_torch.runtime.node.run_chain`, and prints one JSON row:
inferences/s and the largest difference from the whole-graph forward.

These are the port's two subcommands of the JAX package's CLI
(``defer_tpu/cli.py``); the others come with ROADMAP item A17.  Nodes run
on the CUDA card unless ``--device cpu`` is given; a float32 stage runs
without TF32 (cuBLAS and cuDNN), so its rows match the float32 forward.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _no_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cmd_node(args) -> None:
    from .runtime.node import StageNode
    from .transport.framed import _codec

    _codec(args.codec)  # loud at boot, not when the first tensor relays
    _no_tf32()
    node = StageNode(args.artifact, args.listen, args.next,
                     codec=args.codec, overlap=not args.no_overlap,
                     rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                     inflight=args.inflight,
                     infer_delay_s=args.infer_delay_ms / 1e3,
                     device=args.device,
                     persist=args.persist)
    what = (f"stage {node.manifest['index']} ({node.manifest['name']})"
            if node.manifest else "EMPTY (awaiting in-band deploy)")
    print(f"node: {what} on {node.device} listening on "
          f"{node.address[0]}:{node.address[1]}, next {args.next}"
          f"{' [serial]' if args.no_overlap else ''}",
          file=sys.stderr, flush=True)
    n = node.serve(connect_timeout_s=args.connect_timeout)
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
    stats: list = []
    t0 = time.perf_counter()
    outs = run_chain(stages, params, xs, batch=args.batch, codec=args.codec,
                     in_band=args.in_band, overlap=not args.no_overlap,
                     rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                     inflight=args.inflight, stats_out=stats,
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
        "stages": len(stages), "codec": args.codec,
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
                         "default; raises without a card), cuda:N or cpu")
    nd.add_argument("--persist", action="store_true",
                    help="survive stream END: keep serving segments until "
                         "a 'shutdown' control frame arrives")
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
    _add_overlap_flags(c)

    args = ap.parse_args(argv)
    {"node": cmd_node, "chain": cmd_chain}[args.cmd](args)


if __name__ == "__main__":
    main()
