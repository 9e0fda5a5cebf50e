"""Import hygiene of the port: ``defer_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``defer_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _is_forbidden(module: str) -> bool:
    # ``defer_tpu_torch`` shares a prefix with ``defer_tpu``: compare by
    # dotted component, never by string prefix
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "defer_tpu")


@pytest.mark.parametrize("name,ok", [
    ("jax", False), ("jax.numpy", False), ("jaxlib.xla_client", False),
    ("defer_tpu", False), ("defer_tpu.ops.quant", False),
    ("defer_tpu_torch", True), ("defer_tpu_torch.ops.quant", True),
    ("jaxtyping", True), ("torch", True)])
def test_forbidden_rule(name, ok):
    assert _is_forbidden(name) is not ok


def test_import_loads_no_jax_module():
    code = ("import json, sys; import defer_tpu_torch; "
            "import defer_tpu_torch.ops.quant_cuda; "
            "import defer_tpu_torch.ops.flash_attention_cuda; "
            "import defer_tpu_torch.ops.flash_timeline; "
            "import defer_tpu_torch.ops.launches; "
            "import defer_tpu_torch.runtime.flatbuf; "
            "import defer_tpu_torch.obs.events; "
            "import defer_tpu_torch.transport.replay; "
            "import defer_tpu_torch.transport.replicate; "
            "import defer_tpu_torch.models.gpt; "
            "import defer_tpu_torch.runtime.decode; "
            "import defer_tpu_torch.runtime.speculative; "
            "import defer_tpu_torch.runtime.cuda_graph; "
            "import defer_tpu_torch.graph.optimize; "
            "import defer_tpu_torch.graph.viz; "
            "import defer_tpu_torch.models.vgg; "
            "import defer_tpu_torch.models.inception; "
            "import defer_tpu_torch.models.mobilenet; "
            "import defer_tpu_torch.models.moe; "
            "import defer_tpu_torch.utils.checkpoint; "
            "import defer_tpu_torch.utils.pretrained; "
            "import defer_tpu_torch.codec.codecs; "
            "import defer_tpu_torch.codec.native; "
            "import defer_tpu_torch.transport.framed; "
            "import defer_tpu_torch.transport.channel; "
            "import defer_tpu_torch.transport.staging; "
            "import defer_tpu_torch.obs.attrib; "
            "import defer_tpu_torch.serve; "
            "import defer_tpu_torch.serve.arrivals; "
            "import defer_tpu_torch.serve.admission; "
            "import defer_tpu_torch.serve.batcher; "
            "import defer_tpu_torch.serve.engine; "
            "import defer_tpu_torch.serve.client; "
            "import defer_tpu_torch.serve.frontdoor; "
            "import defer_tpu_torch.utils.export; "
            "import defer_tpu_torch.transport.local; "
            "import defer_tpu_torch.transport.shm; "
            "import defer_tpu_torch.transport.ici; "
            "import defer_tpu_torch.runtime.node; "
            "import defer_tpu_torch.cli; "
            "import defer_tpu_torch.utils.hw; "
            "import defer_tpu_torch.utils.profiling; "
            "import defer_tpu_torch.plan; "
            "import defer_tpu_torch.plan.cost; "
            "import defer_tpu_torch.plan.solver; "
            "import defer_tpu_torch.plan.dag; "
            "import defer_tpu_torch.plan.calibrate; "
            "import defer_tpu_torch.plan.replan; "
            "import defer_tpu_torch.codec.native as n; "
            "import defer_tpu_torch.transport.staging as st; "
            "assert n.load() is not None and st._load() is not None; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "defer_tpu_torch" in mods
    for new in ("defer_tpu_torch.runtime.flatbuf",
                "defer_tpu_torch.obs.events",
                "defer_tpu_torch.transport.replay",
                "defer_tpu_torch.transport.replicate",
                "defer_tpu_torch.ops.launches",
                "defer_tpu_torch.models.gpt",
                "defer_tpu_torch.runtime.decode",
                "defer_tpu_torch.runtime.speculative",
                "defer_tpu_torch.runtime.cuda_graph",
                "defer_tpu_torch.graph.optimize",
                "defer_tpu_torch.graph.viz",
                "defer_tpu_torch.models.vgg",
                "defer_tpu_torch.models.inception",
                "defer_tpu_torch.models.mobilenet",
                "defer_tpu_torch.models.moe",
                "defer_tpu_torch.utils.checkpoint",
                "defer_tpu_torch.utils.pretrained",
                "defer_tpu_torch.codec.codecs",
                "defer_tpu_torch.codec.native",
                "defer_tpu_torch.transport.framed",
                "defer_tpu_torch.transport.channel",
                "defer_tpu_torch.transport.staging",
                "defer_tpu_torch.obs.attrib",
                "defer_tpu_torch.serve",
                "defer_tpu_torch.serve.arrivals",
                "defer_tpu_torch.serve.admission",
                "defer_tpu_torch.serve.batcher",
                "defer_tpu_torch.serve.engine",
                "defer_tpu_torch.serve.client",
                "defer_tpu_torch.serve.frontdoor",
                "defer_tpu_torch.utils.export",
                "defer_tpu_torch.transport.local",
                "defer_tpu_torch.transport.shm",
                "defer_tpu_torch.transport.ici",
                "defer_tpu_torch.runtime.node",
                "defer_tpu_torch.cli",
                *PLANNER_MODULES):
        assert new in mods
    bad = [m for m in mods if _is_forbidden(m)]
    assert bad == []


#: the planner's modules (they are pure Python over graph metadata; the
#: JAX package's ``plan/solver.py`` imports no JAX either, and the port
#: keeps its own copy all the same)
PLANNER_MODULES = ("defer_tpu_torch.utils.hw",
                   "defer_tpu_torch.utils.profiling",
                   "defer_tpu_torch.plan",
                   "defer_tpu_torch.plan.cost",
                   "defer_tpu_torch.plan.solver",
                   "defer_tpu_torch.plan.dag",
                   "defer_tpu_torch.plan.calibrate",
                   "defer_tpu_torch.plan.replan")


def test_planner_imports_with_jax_blocked():
    """The planner's modules, the CLI, the re-exporting batcher and the
    replication transport (``transport.replicate`` and ``replay``, whose
    JAX counterparts import no JAX either) import, and a plan solves, with
    ``jax``, ``jaxlib`` and ``defer_tpu`` made unimportable (a meta-path
    finder that refuses them)."""
    mods = list(PLANNER_MODULES) + ["defer_tpu_torch.serve.batcher",
                                    "defer_tpu_torch.graph.analysis",
                                    "defer_tpu_torch.transport.replicate",
                                    "defer_tpu_torch.transport.replay",
                                    "defer_tpu_torch.cli"]
    code = (
        "import importlib, json, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'defer_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from defer_tpu_torch import models, plan\n"
        "g = models.resnet_tiny()\n"
        "p = plan.solve(g, 3, plan.StageCostModel(g, gen='unknown'))\n"
        "assert len(p.cuts) == 2\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_host_cpp_is_the_ports_own_copy():
    """The native libraries build from ``defer_tpu_torch/csrc`` into
    ``defer_tpu_torch/_build``; nothing of ``defer_tpu/_native`` is read
    (a source scan of the loaders and the build)."""
    for rel in ("codec/native.py", "transport/staging.py", "ops/_build.py"):
        text = (ROOT / "defer_tpu_torch" / rel).read_text()
        assert '"_native"' not in text and "_native/" not in text, rel
    for src in ("codec.cpp", "staging.cpp"):
        assert (ROOT / "defer_tpu_torch" / "csrc" / src).exists()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_scan_finds_no_jax_import():
    files = sorted((ROOT / "defer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _is_forbidden(m)]
    assert bad == []
