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
            "import defer_tpu_torch.transport.branch; "
            "import defer_tpu_torch.runtime.topology; "
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
            + "".join(f"import {m}; " for m in OBS_MODULES)
            + "".join(f"import {m}; " for m in PARALLEL_MODULES) +
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
                "defer_tpu_torch.transport.branch",
                "defer_tpu_torch.runtime.topology",
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
                *PLANNER_MODULES, *OBS_MODULES, *PARALLEL_MODULES):
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


#: mesh parallelism (the JAX package's ``parallel/``)
PARALLEL_MODULES = ("defer_tpu_torch.parallel",
                    "defer_tpu_torch.parallel.mesh",
                    "defer_tpu_torch.parallel.tensor",
                    "defer_tpu_torch.parallel.expert",
                    "defer_tpu_torch.parallel.ring_attention",
                    "defer_tpu_torch.parallel.ulysses",
                    "defer_tpu_torch.parallel.distributed")


#: the observability plane (the JAX package's ``obs/`` imports no JAX
#: outside ``obs/profile.py``'s hooks; the port keeps its own copy)
OBS_MODULES = ("defer_tpu_torch.obs",
               "defer_tpu_torch.obs.cluster",
               "defer_tpu_torch.obs.capacity",
               "defer_tpu_torch.obs.report",
               "defer_tpu_torch.obs.journal",
               "defer_tpu_torch.obs.postmortem",
               "defer_tpu_torch.obs.profile")


def test_obs_imports_with_jax_blocked(tmp_path):
    """The observability modules import, journal, and collect a
    postmortem with ``jax``, ``jaxlib`` and ``defer_tpu`` made
    unimportable."""
    code = (
        "import importlib, json, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'defer_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {OBS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from defer_tpu_torch import obs\n"
        f"obs.start_journal({str(tmp_path)!r}, 'unit', interval_s=0.05)\n"
        "obs.emit_event('admit', rid=1)\n"
        "obs.stop_journal()\n"
        f"b = obs.collect_postmortem({str(tmp_path)!r})\n"
        "assert [p['proc'] for p in b['procs']] == ['unit']\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(OBS_MODULES) <= set(loaded)
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_no_not_ported_raise_remains():
    """Every ROADMAP item the port has taken up answers: no module raises
    a "not ported" error for the observability plane, and ``deploy_chain``
    and ``run_chain`` take ``plan=`` and ``journal_dir=``."""
    import inspect

    from defer_tpu_torch.runtime import node
    for f in sorted((ROOT / "defer_tpu_torch").rglob("*.py")):
        text = f.read_text()
        assert '_not_ported("A12"' not in text, f
        assert "not ported yet (ROADMAP item A12" not in text, f
    for fn in (node.deploy_chain, node.run_chain):
        params = inspect.signature(fn).parameters
        assert {"plan", "graph", "report_interval_ms",
                "journal_dir"} <= set(params)


@pytest.mark.parametrize("cmd,reply", [
    ("clock_probe", "clock_probe_reply"), ("clock_adjust", None),
    ("obs_subscribe", "obs_push"), ("profile_start", "profile_started"),
    ("profile_stop", "profile_err")])
def test_control_commands_answer(cmd, reply):
    """The five commands a JAX node answers get the JAX node's answer
    from a port node instead of a raise (``profile_stop`` with no window
    open: the loud refusal)."""
    import socket

    from defer_tpu_torch.obs import tracer
    from defer_tpu_torch.runtime.node import StageNode
    from defer_tpu_torch.transport.framed import K_ACK, K_CTRL, recv_frame

    node = StageNode(None, "127.0.0.1:0", None, device="cpu")
    a, b = socket.socketpair()
    tr = tracer()
    wall0 = tr._wall0_us
    try:
        assert node._handle_ctrl(a, {"cmd": cmd, "interval_ms": 20,
                                     "offset_us": 0}) is True
        kind, msg = recv_frame(b)
        if reply is None:
            assert kind == K_ACK
        else:
            assert kind == K_CTRL and msg["cmd"] == reply
    finally:
        if node._profile is not None:
            node._profile.stop()
        a.close()
        b.close()
        node._srv.close()
        for r in node._reporters:
            r.join(timeout=10)
        tr.shift_wall_anchor(wall0 - tr._wall0_us)


def test_planner_imports_with_jax_blocked():
    """The planner's modules, the CLI, the re-exporting batcher, the
    replication transport (``transport.replicate`` and ``replay``) and the
    branched-chain modules (``transport.branch``, ``runtime.topology``),
    whose JAX counterparts import no JAX either, import, and a plan
    solves and deploys as a topology, with ``jax``, ``jaxlib`` and
    ``defer_tpu`` made unimportable (a meta-path finder that refuses
    them)."""
    mods = list(PLANNER_MODULES) + ["defer_tpu_torch.serve.batcher",
                                    "defer_tpu_torch.graph.analysis",
                                    "defer_tpu_torch.transport.replicate",
                                    "defer_tpu_torch.transport.replay",
                                    "defer_tpu_torch.transport.branch",
                                    "defer_tpu_torch.runtime.topology",
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
        "from defer_tpu_torch.runtime.topology import ChainTopology\n"
        "m = models.moe_branched_tiny()\n"
        "d = plan.solve_dag(m, plan.StageCostModel(m, gen='unknown'), "
        "num_nodes=4)\n"
        "assert len(ChainTopology.from_json(d.topology_json())) >= 1\n"
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
    files.append(ROOT / "scripts" / "torch_ring_procs.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _is_forbidden(m)]
    assert bad == []


def test_ring_procs_script_imports_with_jax_blocked():
    """``scripts/torch_ring_procs.py`` (the launcher of the ring across
    processes), its worker's modules and its launch counts load with
    ``jax``, ``jaxlib`` and ``defer_tpu`` made unimportable."""
    code = (
        "import importlib, json, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'defer_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        "import torch_ring_procs as R\n"
        "import defer_tpu_torch.parallel.distributed\n"
        "import defer_tpu_torch.runtime.spmd\n"
        "R.Counts('cpu')\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch_ring_procs" in loaded
    assert [m for m in loaded if _is_forbidden(m)] == []
