"""Port parity: the multi-host helpers against the JAX package.

The scenarios of ``tests/test_distributed.py`` (single-host contracts:
``initialize`` is a safe no-op, the global mesh has the documented axes,
too large a mesh raises, the per-host batch) and of
``tests/test_distributed_multiproc.py``: two real processes form a
``torch.distributed`` group over localhost (gloo, four CPU positions
each), the host-major mesh puts stages 0-3 on process 0 and 4-7 on
process 1 (one host-boundary hop), and a psum over the stage axis crosses
the process boundary, forward and backward.
"""

import os
import socket
import subprocess
import sys
import time

import pytest

import jax

from defer_tpu import multihost_pipeline_mesh as jax_multihost_mesh
from defer_tpu_torch.parallel import distributed as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_single_host_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    D.initialize()  # must not raise or hang on one host
    assert not D._initialized  # not latched: explicit args may follow
    assert D.process_count() == 1 and D.process_index() == 0
    with pytest.raises(ValueError, match="num_processes"):
        D.initialize(coordinator_address="127.0.0.1:1")


def test_multihost_mesh_axes_match_jax():
    for kw in (dict(data_parallel=2), dict(data_parallel=2,
                                           tensor_parallel=2)):
        n = 4 if "tensor_parallel" not in kw else 2
        want = jax_multihost_mesh(n, **kw)
        got = D.multihost_pipeline_mesh(n, local_devices=["cpu"] * 8, **kw)
        assert got.shape == dict(want.shape)
        assert (got.processes == 0).all()


def test_multihost_mesh_too_big_raises():
    with pytest.raises(ValueError, match="available"):
        D.multihost_pipeline_mesh(64, data_parallel=64,
                                  local_devices=["cpu"] * 8)


def test_process_local_batch():
    assert D.process_local_batch(32) == 32 // jax.process_count()


_WORKER = r"""
import sys
import torch
from defer_tpu_torch.parallel import distributed as D
from defer_tpu_torch.parallel.mesh import STAGE_AXIS, pmean, psum

pid = int(sys.argv[1])
D.initialize(coordinator_address="127.0.0.1:%PORT%", num_processes=2,
             process_id=pid, backend="gloo")
assert D.process_count() == 2 and D.process_index() == pid

mesh = D.multihost_pipeline_mesh(8, local_devices=["cpu"] * 4)
owners = [int(p) for p in mesh.processes.flatten()]
# host-major stage layout: exactly one host-boundary hop in the chain
assert owners == sorted(owners), owners
assert sum(1 for a, b in zip(owners, owners[1:]) if a != b) == 1, owners
assert mesh.axis_crosses_processes(STAGE_AXIS)

# a psum over the stage axis crosses the process boundary: this process's
# four positions hold 4*pid .. 4*pid+3, the sum over all eight is 28
mine = [torch.tensor([float(4 * pid + i)]) for i in range(4)]
total = psum(mine, mesh=mesh, axis=STAGE_AXIS)
assert len(total) == 4 and all(float(t) == 28.0 for t in total), total
assert D.process_local_batch(16) == 8

# autograd through the cross-process psum: each process's loss is the sum
# of its four copies of the total, so the loss over both processes is
# 8 * sum(leaves) and every leaf's gradient is 8, on either process
leaves = [torch.tensor([float(4 * pid + i)], requires_grad=True)
          for i in range(4)]
total = psum(leaves, mesh=mesh, axis=STAGE_AXIS)
assert all(t.requires_grad for t in total)
torch.stack(total).sum().backward()
assert all(float(x.grad) == 8.0 for x in leaves), [x.grad for x in leaves]
# pmean: each process's loss is the mean over all eight leaves, so the
# loss over both processes is sum(leaves) / 4 and every gradient 1/4
leaves = [torch.tensor([1.0], requires_grad=True) for _ in range(4)]
mean = pmean(leaves, mesh=mesh, axis=STAGE_AXIS)
assert all(float(t) == 1.0 for t in mean), mean
mean[0].sum().backward()
assert all(float(x.grad) == 0.25 for x in leaves), [x.grad for x in leaves]
torch.distributed.destroy_process_group()
print(f"worker {pid} OK", flush=True)
"""


#: what a worker's stderr says when the probed port was taken before its
#: group's store bound it (scripts/torch_ring_procs.py's marks)
_BIND_RACE_MARKS = ("EADDRINUSE", "Address already in use",
                    "address already in use")


def _run_pair(script, env, deadline_s: float = 90.0) -> list:
    """Both workers' ``(rc, stdout, stderr)``: the pair runs until both
    exit, one exits non-zero (the other is killed then) or the deadline."""
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < deadline_s:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rcs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode,) + p.communicate() for p in procs]


@pytest.mark.timeout(120)
def test_two_process_cluster(tmp_path):
    """The pair forms its group on a probed port; a pair whose port was
    taken before worker 0 bound it runs again on a fresh one."""
    script = tmp_path / "worker.py"
    env = dict(os.environ, PYTHONPATH=ROOT)
    for _ in range(3):
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        srv.close()
        script.write_text(_WORKER.replace("%PORT%", str(port)))
        outs = _run_pair(script, env)
        if not any(rc != 0 and any(m in err for m in _BIND_RACE_MARKS)
                   for rc, _, err in outs):
            break
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} rc={rc}\n{err[-3000:]}"
        assert f"worker {i} OK" in out
