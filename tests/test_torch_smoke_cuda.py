"""The port's fifteen smoke scripts on the card (marker ``gpu``; skipped
without CUDA).  Imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_smoke_cuda.py

Each ``scripts/torch_<name>_smoke.py`` runs in its default mode (the full
one: node processes where the JAX script spawns them) with ``--device
cuda``, as a subprocess from the repository's root, and must exit 0 with
its JAX script's row metric and at least the keys of its quick row.  With
``TORCH_SMOKE_ROWS`` naming a file, each test appends its script's
seconds and row there as a JSON line.
"""

import json
import os

import pytest
import torch

import torch_smoke_harness as H

pytestmark = pytest.mark.gpu

#: each full run's limit (the chain smokes boot node processes, each of
#: which imports torch and loads CUDA)
TIMEOUT_S = 420.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.timeout(TIMEOUT_S + 60)
@pytest.mark.parametrize("name", sorted(H.ROWS))
def test_smoke_script_on_the_card(cuda, name):
    row, seconds = H.run(name, quick=False, device=cuda, timeout=TIMEOUT_S)
    H.check_row(name, row, quick=False)
    out = os.environ.get("TORCH_SMOKE_ROWS")
    if out:
        with open(out, "a") as f:
            f.write(json.dumps({"name": name, "seconds": seconds,
                                "row": row}) + "\n")
