"""Device meshes and the collectives over their axes: the port of
``defer_tpu.parallel.mesh``.

The JAX package places a pipeline on a ``jax.sharding.Mesh``: the "stage"
axis is the ring (the successor relation is a ``ppermute``), an optional
"data" axis replicates the whole pipeline for batch parallelism and an
optional "model" axis shards each stage's weights (tensor parallelism).
The port keeps that picture with one controller, as JAX runs a mesh from
one process per host: :class:`Mesh` is a numpy array of ``torch.device``s
with axis names, and per-device code under ``shard_map`` becomes a loop
over an axis's ranks, in phases between collectives.

A collective takes the per-rank tensors of one mesh axis (one tensor per
position, in rank order) and returns one result per rank, on that rank's
device.  They are built from sums, ``cat``/``split`` and ``.to()``, so
autograd passes through them: the gradient of a :func:`psum` reaches every
rank's input once.  On one card every rank's tensor lives on the card and
the moves are no-ops.  :func:`psum` and :func:`pmean` also cross processes
(``parallel/distributed.py``): over an axis whose positions sit in several
processes they add the local ranks, then all-reduce the sum with
``torch.distributed.nn.functional.all_reduce``, whose backward
all-reduces the cotangent.

A mesh on one card names the same device in every position, the
counterpart of the JAX tests' eight virtual CPU devices; ask for it with
``devices=[dev] * n`` or through an engine's ``device=``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

STAGE_AXIS = "stage"
DATA_AXIS = "data"
MODEL_AXIS = "model"


def visible_cards() -> list[torch.device]:
    """Every CUDA card this process sees (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """An n-d array of devices with one name per axis.

    As ``jax.sharding.Mesh``: ``devices`` (a numpy object array of
    ``torch.device``), ``axis_names``, ``shape`` (an ordered name -> size
    dict) and ``size``.  ``processes`` holds the ``torch.distributed``
    rank owning each position (all 0 in one process).
    """

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-d device array with axis names "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names {self.axis_names}")
        self.processes = (np.zeros(arr.shape, np.int64) if processes is None
                          else np.asarray(processes, np.int64))
        if self.processes.shape != arr.shape:
            raise ValueError(f"processes {self.processes.shape} != devices "
                             f"{arr.shape}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list[torch.device]:
        """The devices the mesh names, each once, in position order."""
        seen: list[torch.device] = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis (the
        rank order of a collective over ``axis``)."""
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if j == i else 0
                    for j in range(self.devices.ndim))
        return list(self.devices[idx])

    def axis_crosses_processes(self, axis: str) -> bool:
        """Whether some line along ``axis`` holds positions of several
        processes (a collective over it must call ``torch.distributed``)."""
        i = self.axis_names.index(axis)
        lines = np.moveaxis(self.processes, i, -1).reshape(
            -1, self.devices.shape[i])
        return bool((lines != lines[:, :1]).any())

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.distinct_devices()})"


def pipeline_mesh(num_stages: int, data_parallel: int = 1,
                  tensor_parallel: int = 1, devices=None) -> Mesh:
    """Mesh of shape (data, stage[, model]) over ``devices`` (default:
    every visible card).

    The model (tensor-parallel) axis is innermost, so a stage's ranks sit
    on adjacent devices; stage neighbours come next.  Too few devices
    raise ``ValueError``; pass ``devices=[dev] * n`` for a one-card mesh.
    """
    devices = list(devices) if devices is not None else visible_cards()
    need = num_stages * data_parallel * tensor_parallel
    if len(devices) < need:
        raise ValueError(
            f"pipeline needs {need} devices "
            f"({data_parallel} data x {num_stages} stages x "
            f"{tensor_parallel} model) but only {len(devices)} available")
    arr = np.empty(need, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:need]]
    if tensor_parallel > 1:
        return Mesh(arr.reshape(data_parallel, num_stages, tensor_parallel),
                    (DATA_AXIS, STAGE_AXIS, MODEL_AXIS))
    return Mesh(arr.reshape(data_parallel, num_stages),
                (DATA_AXIS, STAGE_AXIS))


def stage_axis_size(mesh: Mesh) -> int:
    return mesh.shape[STAGE_AXIS]


def one_card_mesh(device, num_stages: int, data_parallel: int = 1,
                  tensor_parallel: int = 1) -> Mesh:
    """The pipeline mesh of these extents with ``device`` in every
    position: how an engine given ``device=`` and no mesh runs."""
    need = num_stages * data_parallel * tensor_parallel
    return pipeline_mesh(num_stages, data_parallel, tensor_parallel,
                         devices=[device] * need)


def mesh_device(mesh: Mesh, engine: str) -> torch.device:
    """The one device of a one-card mesh, for an engine that runs its ring
    on one card.  A mesh naming two or more devices (or positions of
    another process) raises ``NotImplementedError`` before anything is
    placed: the ring across cards is ROADMAP queue A15b."""
    devs = mesh.distinct_devices()
    if len(devs) != 1 or len(set(mesh.processes.flat)) != 1:
        raise NotImplementedError(
            f"{engine} runs a mesh on one card; this mesh names "
            f"{[str(d) for d in devs]} in processes "
            f"{sorted(set(int(p) for p in mesh.processes.flat))}: the ring "
            "across several devices is ROADMAP queue A15b")
    return devs[0]


# ---------------------------------------------------------------------------
# collectives over the per-rank tensors of one axis
# ---------------------------------------------------------------------------


def _all_reduce(total: torch.Tensor, mesh: Mesh | None,
                axis: str | None) -> torch.Tensor:
    """``total`` summed with the other processes' partial sums when the
    axis crosses processes (every process's lines must then span all of
    them: a sub-group is ROADMAP A15b)."""
    if mesh is None or axis is None or not mesh.axis_crosses_processes(axis):
        return total
    import torch.distributed as dist

    i = mesh.axis_names.index(axis)
    lines = np.moveaxis(mesh.processes, i, -1).reshape(
        -1, mesh.devices.shape[i])
    world = set(range(dist.get_world_size()))
    if any(set(line.tolist()) != world for line in lines):
        raise NotImplementedError(
            f"a psum over {axis!r} whose lines span only some processes "
            "needs process sub-groups (ROADMAP queue A15b)")
    # the autograd-aware all-reduce: its backward all-reduces the
    # cotangent, so gradients flow through a psum across processes
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(total)


def psum(xs: Sequence[torch.Tensor], *, mesh: Mesh | None = None,
         axis: str | None = None) -> list[torch.Tensor]:
    """Sum over the ranks: every rank gets the sum, on its own device.
    With ``mesh`` and ``axis`` naming an axis that crosses processes,
    ``xs`` are this process's ranks and the sum is all-reduced."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    total = _all_reduce(total, mesh, axis)
    return [total.to(x.device) for x in xs]


def pmean(xs: Sequence[torch.Tensor], *, mesh: Mesh | None = None,
          axis: str | None = None) -> list[torch.Tensor]:
    """Mean over the ranks (of every process, when the axis crosses
    processes)."""
    n = len(xs)
    if mesh is not None and axis is not None:
        n = mesh.shape[axis]
    return [s / n for s in psum(xs, mesh=mesh, axis=axis)]


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """``lax.ppermute``: rank ``dst`` gets rank ``src``'s tensor for each
    ``(src, dst)`` pair; a rank no pair sends to gets zeros."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> list[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: each rank splits its tensor
    into ``n`` chunks along ``split_axis`` and sends chunk ``j`` to rank
    ``j``; rank ``j`` concatenates what it received, in rank order, along
    ``concat_axis``."""
    n = len(xs)
    size = xs[0].shape[split_axis]
    if size % n:
        raise ValueError(f"axis {split_axis} of size {size} does not split "
                         f"over {n} ranks")
    chunks = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([chunks[src][dst].to(xs[dst].device)
                       for src in range(n)], dim=concat_axis)
            for dst in range(n)]


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = False) -> list[torch.Tensor]:
    """``lax.all_gather``: every rank gets all ranks' tensors, stacked on
    a new ``axis`` (concatenated along it with ``tiled=True``)."""
    join = torch.cat if tiled else torch.stack
    return [join([x.to(dst.device) for x in xs], dim=axis) for dst in xs]
