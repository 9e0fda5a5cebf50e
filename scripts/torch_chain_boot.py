"""Where a chain's boot goes when its node processes boot side by side.

    python scripts/torch_chain_boot.py [--procs 8] [--rounds 2]

A chain of stage processes (``deploy_chain``, ``run_chain``) starts every
node at once, and each node makes its CUDA context and loads cuDNN and
cuBLAS before it announces its bind (``runtime/node.py`` ``_warm_cuda``).
Alone, a node binds in about 9 s; eight at once have taken 19-40 s.  The
script boots ``--procs`` fresh processes at once through the steps of a
node's boot (interpreter start, ``import torch``, the port's package, the
CUDA context, the cuDNN/cuBLAS warm-up) and prints, for each round, the
wall from the first spawn to the last process done, each step's median
and largest seconds over the processes, and their CPU seconds: first one
process alone, then ``--rounds`` alternating rounds with the parent's
environment, with ``OMP_NUM_THREADS=1`` (what ``torchrun`` gives each of
its processes) and with ``PYTHONPYCACHEPREFIX`` naming a bytecode cache in
the checkout's build directory (``defer_tpu_torch/_build/pycache_probe``,
emptied, then filled by one process alone) and
``PYTHONDONTWRITEBYTECODE`` unset, as ``chip_smoke.py`` runs its node
processes where the installed torch carries no bytecode.  It prints whether the installed ``torch``
has bytecode beside its sources and whether Python may write it there.  A
warm-up round first fills the file cache; its numbers are printed and not
compared.

It needs a CUDA card and takes about four minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: one fresh process's boot, step by step (argv: spawn time)
BOOT = r'''
import json, resource, sys, time
t = [float(sys.argv[1]), time.time()]
import torch; t.append(time.time())
import defer_tpu_torch.cli; t.append(time.time())
torch.empty(0, device="cuda"); t.append(time.time())
from defer_tpu_torch.runtime.node import _warm_cuda
_warm_cuda(torch.device("cuda")); t.append(time.time())
steps = ["interpreter", "torch", "package", "cuda_context", "warm"]
ru = resource.getrusage(resource.RUSAGE_SELF)
print(json.dumps({**{k: b - a for k, a, b in zip(steps, t, t[1:])},
                  "cpu_s": ru.ru_utime + ru.ru_stime, "done": t[-1]}))
'''

STEPS = ("interpreter", "torch", "package", "cuda_context", "warm", "cpu_s")


def boot_round(n: int, env: dict) -> dict:
    """``n`` processes spawned at once; the round's wall and step stats."""
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", BOOT, repr(t0)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(n)]
    rows = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        if p.returncode:
            raise SystemExit(f"boot probe failed: {err[-2000:]}")
        rows.append(json.loads(out.strip().splitlines()[-1]))
    res = {"procs": n, "wall_s": max(r["done"] for r in rows) - t0}
    for k in STEPS:
        vals = [r[k] for r in rows]
        res[k] = {"median": statistics.median(vals), "max": max(vals)}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {os.cpu_count()} cores", flush=True)
    import importlib.util

    spec = importlib.util.find_spec("torch")
    init = spec.origin
    print(json.dumps({
        "torch_init": init,
        "bytecode_beside_source": os.path.exists(
            importlib.util.cache_from_source(init)),
        "package_dir_writable": os.access(os.path.dirname(init), os.W_OK),
        "dont_write_bytecode": sys.flags.dont_write_bytecode,
        "PYTHONDONTWRITEBYTECODE": os.environ.get("PYTHONDONTWRITEBYTECODE"),
        "PYTHONPYCACHEPREFIX": os.environ.get("PYTHONPYCACHEPREFIX")}),
        flush=True)
    base = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("OMP_NUM_THREADS", "PYTHONPYCACHEPREFIX"):
        base.pop(k, None)
    cache = ROOT / "defer_tpu_torch" / "_build" / "pycache_probe"
    shutil.rmtree(cache, ignore_errors=True)
    cached = {k: v for k, v in base.items() if k != "PYTHONDONTWRITEBYTECODE"}
    variants = {"default": base, "omp1": dict(base, OMP_NUM_THREADS="1"),
                "pycache": dict(cached, PYTHONPYCACHEPREFIX=str(cache))}

    def show(tag, r):
        print(json.dumps({"round": tag, **r}), flush=True)

    show("warmup", boot_round(args.procs, base))
    show("alone", boot_round(1, base))
    show("pycache_fill", boot_round(1, variants["pycache"]))
    show("pycache_alone", boot_round(1, variants["pycache"]))
    for i in range(args.rounds):
        order = list(variants) if i % 2 == 0 else list(variants)[::-1]
        for name in order:
            show(f"{name}{i}", boot_round(args.procs, variants[name]))


if __name__ == "__main__":
    main()
