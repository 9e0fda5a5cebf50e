"""Several hosts: process-group initialization and host-major meshes — the
port of ``defer_tpu.parallel.distributed``.

Where the JAX package joins hosts with ``jax.distributed.initialize`` and
lays one global ``Mesh`` over every host's devices, the port joins them
with ``torch.distributed.init_process_group`` and lays its own
:class:`~defer_tpu_torch.parallel.mesh.Mesh` over every process's devices,
each position recording the process that owns it.  This module is the one
place the port calls ``torch.distributed`` to form a group; the
collectives of ``parallel/mesh.py`` all-reduce over it where an axis
crosses processes.

On a single host everything degrades gracefully: ``initialize`` without
arguments or a cluster environment is a no-op, and the meshes cover the
local devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, pipeline_mesh, visible_cards

_initialized = False


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the multi-host process group (idempotent; a no-op on a single
    host).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group forms over TCP at that address.  With no
    arguments the cluster environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``, as ``torchrun`` sets them) is used when present; otherwise
    the call returns without latching, so a later call with explicit
    arguments can still form the group.  ``backend`` defaults to ``nccl``
    when CUDA is available, else ``gloo``.
    """
    global _initialized
    dist = _dist()
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None and num_processes is None:
        if not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(os.environ):
            return  # one host, no cluster environment: not latched
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize needs num_processes and "
                             "process_id with a coordinator address")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    _initialized = True


def process_count() -> int:
    """Processes in the group (1 before or without ``initialize``)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def multihost_pipeline_mesh(num_stages: int, data_parallel: int = 1,
                            tensor_parallel: int = 1,
                            local_devices=None) -> Mesh:
    """Global pipeline mesh over every device of every process.

    The global device list is host-major (process 0's devices, then
    process 1's, ...), so consecutive stages stay on one host wherever
    possible and only a host boundary crosses processes; the data axis,
    if any, is outermost.  Every process holds ``local_devices`` (default:
    its visible cards), as many as each other process.
    """
    local = (list(local_devices) if local_devices is not None
             else visible_cards())
    n_proc = process_count()
    devices = [d for _ in range(n_proc) for d in local]
    owners = [p for p in range(n_proc) for _ in local]
    mesh = pipeline_mesh(num_stages, data_parallel, tensor_parallel,
                         devices=devices)
    mesh.processes = np.asarray(owners[:mesh.size],
                                np.int64).reshape(mesh.devices.shape)
    return mesh


def process_local_batch(global_batch: int) -> int:
    """This process's share of a global batch (processes feed disjoint
    input shards)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    return global_batch // n
