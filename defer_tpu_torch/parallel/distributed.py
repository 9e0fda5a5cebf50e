"""Several hosts: process-group initialization and host-major meshes — the
port of ``defer_tpu.parallel.distributed``.

Where the JAX package joins hosts with ``jax.distributed.initialize`` and
lays one global ``Mesh`` over every host's devices, the port joins them
with ``torch.distributed.init_process_group`` and lays its own
:class:`~defer_tpu_torch.parallel.mesh.Mesh` over every process's devices,
each position recording the process that owns it.  This module is the one
place the port calls ``torch.distributed`` to form a group; the
collectives of ``parallel/mesh.py`` and the ring across processes
(``runtime/spmd.py``) send, receive and all-reduce over it where an axis
crosses processes.

On a single host everything degrades gracefully: ``initialize`` without
arguments or a cluster environment is a no-op, and the meshes cover the
local devices.

Several processes on ONE card (as the one-card machine runs a ring across
processes) need ``backend="gloo"``: NCCL refuses two ranks on the same
device ("Duplicate GPU detected").  A ring engine built over NCCL checks
every rank's card where it is known, at placement (``runtime/spmd.py``
``ring_transport``, keyed on the ring's own device), and raises, naming
gloo, before the first collective would fail, whether a launcher maps
ranks to cards through ``CUDA_VISIBLE_DEVICES`` or only through the
mesh's ``local_devices``.  gloo's point-to-point ops take host tensors;
the port stages a CUDA tensor through pinned host memory
(``parallel/mesh.py``).
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
import time

import numpy as np
import torch

from .mesh import Mesh, _dist, current_process, pipeline_mesh, visible_cards

_initialized = False
#: ``initialize``'s ``timeout_s``: the default group's, and that of the
#: groups made later for a mesh from :func:`multihost_pipeline_mesh`
_timeout_s: float | None = None
#: the card swaps made so far: each swap's store keys are its own (every
#: rank refuses in the same order, so the rank's count names the swap)
_swaps = itertools.count()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               timeout_s: float | None = None) -> None:
    """Join the multi-host process group (idempotent; a no-op on a single
    host).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group forms over TCP at that address.  With no
    arguments the cluster environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``, as ``torchrun`` sets them) is used when present; otherwise
    the call returns without latching, so a later call with explicit
    arguments can still form the group.  ``backend`` defaults to ``nccl``
    when CUDA is available, else ``gloo``; several processes on one card
    need ``gloo`` (a ring engine raises under NCCL, see the module's
    docstring).
    ``timeout_s`` bounds the group's formation and every collective
    (``init_process_group``'s ``timeout``): a dead peer then fails its
    neighbours instead of leaving them blocked.  The groups the port makes
    later for a mesh from :func:`multihost_pipeline_mesh`
    (``parallel/mesh.py``'s line groups and ``regroup``) time out alike.
    """
    global _initialized, _timeout_s
    dist = _dist()
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    _timeout_s = timeout_s
    if coordinator_address is None and num_processes is None:
        if not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(os.environ):
            return  # one host, no cluster environment: not latched
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize needs num_processes and "
                             "process_id with a coordinator address")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kw)
    _initialized = True


def card_key(device=None) -> str:
    """A ring's card as its host and the card's UUID (its index where
    torch gives no UUID), the same across ``CUDA_VISIBLE_DEVICES``
    renumberings.  The card is ``device``'s (a CUDA device: ``"cuda:1"``
    names card 1, ``"cuda"`` the current device): the port calls no
    ``set_device``, since a ring's card comes from its mesh."""
    dev = torch.device("cuda" if device is None else device)
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(i), "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else i}"


def shared_cards(keys: list[str]) -> dict[str, list[int]]:
    """The cards named by more than one rank (``keys[rank]``, as
    :func:`card_key` gives them), each with its ranks."""
    ranks: dict[str, list[int]] = {}
    for r, k in enumerate(keys):
        ranks.setdefault(k, []).append(r)
    return {k: rs for k, rs in ranks.items() if len(rs) > 1}


def swap_card_keys(store, rank: int, world: int, key: str,
                   prefix: str = "defer_card") -> list[str]:
    """Every rank's card key (``keys[rank]``), swapped through ``store``
    under ``prefix``: each rank sets its own and reads them all."""
    store.set(f"{prefix}/{rank}", key)
    return [store.get(f"{prefix}/{r}").decode() for r in range(world)]


def refuse_shared_cards(device) -> None:
    """Under NCCL, on every rank: raise when two ranks' rings share a card
    (``device``, this rank's ring's; :func:`card_key`), leaving the group
    (see :func:`_refuse_shared_cards`).  A ring engine calls it at
    placement (``runtime/spmd.py`` ``ring_transport``)."""
    _refuse_shared_cards(_dist(), card_key(device))


def _refuse_shared_cards(dist, key: str) -> None:
    """Raise (and leave the group) when two ranks share a card, which
    NCCL's first collective would refuse ("Duplicate GPU detected").
    ``key`` is this rank's card (:func:`card_key`); the ranks swap theirs
    through the group's store, under keys of this swap's own."""
    global _initialized
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    prefix = f"defer_card/{next(_swaps)}"
    shared = shared_cards(swap_card_keys(store, rank, world, key, prefix))
    if shared:
        # rank 0 serves the store: it leaves once every rank has read
        store.add(f"{prefix}/read", 1)
        while rank == 0 and store.add(f"{prefix}/read", 0) < world:
            time.sleep(0.01)
        dist.destroy_process_group()
        _initialized = False
        raise RuntimeError(
            f"NCCL cannot run two ranks on one card ({shared}): pass "
            "backend=\"gloo\" for several processes on one card (a "
            "rank's card is its ring's device)")


def process_count() -> int:
    """Processes in the group (1 before or without ``initialize``)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 before or without ``initialize``)."""
    return current_process()


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
    mesh.group_timeout_s = _timeout_s
    return mesh


def process_local_batch(global_batch: int) -> int:
    """This process's share of a global batch (processes feed disjoint
    input shards)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    return global_batch // n
