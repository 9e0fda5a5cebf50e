"""Where a respawned replica's boot goes, step by step, on the card.

    python scripts/torch_respawn_boot.py [--probes 3]

A replica that a failover chain's supervisor respawns must register with
the fan-in below it within ``failover_grace_s`` (30 s), or the fan-in
fails the stream.  A node binds once the port's package is imported, then
makes its CUDA context and loads its artifact, and serves after that.
The script exports ResNet50's eight stages at the paper's cuts (batch 8,
seeded random weights) and, for ``--probes`` fresh processes, prints the
seconds of each step of that boot: interpreter start, ``import torch``,
the port's package (the bind comes here), the CUDA context, the
``torch.export`` loader's import and the stage-1 artifact load; first
alone, then beside a live chain of phase 4n's shape (``deploy_chain``
with stage 1 as two replica processes and ``failover=True``, nine
processes, ``tier="auto"``, one stream through it).  ``chip_smoke.py``
phase 4n times a whole respawn: a ``SIGKILL``, the bind, the listening
line and the healed redial.

It needs a CUDA card and takes about two minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: one fresh process's boot, step by step (argv: artifact, spawn time)
BOOT = r'''
import json, sys, time
t = [float(sys.argv[2]), time.time()]
import torch; t.append(time.time())
import defer_tpu_torch.cli; t.append(time.time())
torch.empty(0, device="cuda"); t.append(time.time())
from defer_tpu_torch.utils.export import load_stage_program; t.append(time.time())
load_stage_program(sys.argv[1], device=torch.device("cuda")); t.append(time.time())
steps = ["interpreter", "torch", "package", "cuda_context", "export_import",
         "artifact_load"]
print(json.dumps({k: round(b - a, 3) for k, a, b in zip(steps, t, t[1:])}))
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from defer_tpu_torch.models import RESNET50_8STAGE_CUTS, resnet50
    from defer_tpu_torch.partition import partition
    from defer_tpu_torch.runtime.node import deploy_chain
    from defer_tpu_torch.utils.export import export_pipeline

    if not torch.cuda.is_available():
        raise SystemExit("torch_respawn_boot.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    g = resnet50(image_size=224)
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, RESNET50_8STAGE_CUTS)
    paths = export_pipeline(stages, params, tempfile.mkdtemp(), batch=8)
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def probe(tag):
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", BOOT, paths[1],
                              repr(t0)], capture_output=True, text=True,
                             env=env, check=True)
        print(json.dumps({"boot": tag, "wall_s": round(time.time() - t0, 3),
                          **json.loads(out.stdout)}), flush=True)

    for i in range(args.probes):
        probe(f"alone{i}")
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
              for _ in range(8)]
    with deploy_chain(stages, params, batch=8, replicas={1: 2},
                      failover=True, tier="auto") as chain:
        chain.dispatcher.stream(frames)
        for i in range(args.probes):
            probe(f"beside_chain{i}")


if __name__ == "__main__":
    main()
