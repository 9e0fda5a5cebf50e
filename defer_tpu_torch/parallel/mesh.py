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
processes they add the local ranks, then all-reduce the sum over the
line's group (:class:`_AllReduce`, whose backward all-reduces the
cotangent; over gloo a CUDA tensor is staged through pinned host memory).
A stage's ops run their psums over a :class:`ModelLine`: this process's
ranks of the model line, and the mesh they all-reduce over.

A mesh on one card names the same device in every position, the
counterpart of the JAX tests' eight virtual CPU devices; ask for it with
``devices=[dev] * n`` or through an engine's ``device=``.

Several processes (``torch.distributed``, one per card as ``torchrun``
launches them, or several sharing one card): a mesh from
``multihost_pipeline_mesh`` records each position's process, and each
process holds the positions of its one device (:func:`mesh_placement`).
A collective over an axis that crosses processes takes this process's
ranks of its line along the axis and exchanges with the line's other
processes: ``ppermute``, ``all_gather`` and ``all_to_all`` by
point-to-point sends and receives (:func:`exchange`), ``psum`` by an
all-reduce over the line's process group (:func:`line_group`).

A mesh's collectives run on the default group unless it was made by
:func:`regroup`, a copy whose groups are its own (and which
:func:`release` destroys): sends made on one such copy can only ever meet
receives made on it.
"""

from __future__ import annotations

import copy
import datetime
import time
from typing import Sequence

import numpy as np
import torch

STAGE_AXIS = "stage"
DATA_AXIS = "data"
MODEL_AXIS = "model"


def _dist():
    import torch.distributed as dist
    return dist


def current_process() -> int:
    """This process's ``torch.distributed`` rank (0 without a group)."""
    dist = _dist()
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


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
        #: per axis: the process group of this process's line
        #: (:func:`line_group`), made once
        self._groups: dict = {}
        #: the group over every process that this mesh's collectives use
        #: (None: the default group; :func:`regroup` gives a copy its own)
        self.world = None
        #: seconds a collective on a group made for this mesh waits (None:
        #: torch's default); ``multihost_pipeline_mesh`` gives the default
        #: group's, as ``initialize(timeout_s=)`` set it
        self.group_timeout_s: float | None = None
        #: whether ``world`` and ``_groups`` were made for this mesh alone
        #: (:func:`regroup`), for :func:`release` to destroy
        self._own_groups = False

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

    @property
    def spans_processes(self) -> bool:
        """Whether the positions belong to more than one process."""
        return len(set(self.processes.flat)) > 1

    def axis_lines(self, axis: str) -> np.ndarray:
        """``[lines, size]``: the owning process of each rank, per line
        along ``axis`` (every other axis's index flattened)."""
        i = self.axis_names.index(axis)
        return np.moveaxis(self.processes, i, -1).reshape(
            -1, self.devices.shape[i])

    def axis_crosses_processes(self, axis: str) -> bool:
        """Whether some line along ``axis`` holds positions of several
        processes (a collective over it must call ``torch.distributed``)."""
        lines = self.axis_lines(axis)
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


def mesh_placement(mesh: Mesh, engine: str) -> tuple[np.ndarray, torch.device]:
    """This process's positions (a boolean mask over the mesh) and its one
    device.  A mesh held by one process is this process's, whatever its
    rank.  Positions of this process naming two or more devices raise
    ``NotImplementedError`` before anything is placed: one process driving
    several cards is ROADMAP queue A15b."""
    if mesh.spans_processes:
        me = current_process()
        mine = mesh.processes == me
        if not mine.any():
            raise ValueError(f"{engine}: process {me} holds no position of "
                             f"the mesh {mesh.shape}")
    else:
        mine = np.ones(mesh.devices.shape, bool)
    devs = []
    for d in mesh.devices[mine]:
        if d not in devs:
            devs.append(d)
    if len(devs) != 1:
        raise NotImplementedError(
            f"{engine} runs one device per process; this process's "
            f"positions name {[str(d) for d in devs]}: one process driving "
            "several devices is ROADMAP queue A15b")
    return mine, devs[0]


# ---------------------------------------------------------------------------
# collectives over the per-rank tensors of one axis
# ---------------------------------------------------------------------------


def _line(mesh: Mesh, axis: str) -> tuple[np.ndarray, list[int]]:
    """``(owners, ranks)``: the owning process of each rank of this
    process's line along ``axis``, and this process's ranks on it.  This
    process's positions must lie on one line of the axis."""
    me = current_process()
    lines = [line for line in mesh.axis_lines(axis) if (line == me).any()]
    if not lines:
        raise ValueError(f"process {me} holds no position of the mesh")
    if any(not np.array_equal(line, lines[0]) for line in lines[1:]):
        raise ValueError(f"process {me}'s positions lie on several lines "
                         f"along {axis!r}: pass one line's ranks")
    owners = lines[0]
    return owners, [r for r in range(len(owners)) if owners[r] == me]


def _crosses(mesh: Mesh | None, axis: str | None) -> bool:
    return (mesh is not None and axis is not None
            and mesh.axis_crosses_processes(axis))


def line_group(mesh: Mesh, axis: str):
    """The process group of this process's line along ``axis``: the
    default group where a line spans every process, a sub-group from
    ``dist.new_group`` where it spans some, None where it lies in this
    process alone.  ``new_group`` must be called by every process, in the
    same order, for every group, including processes outside it: so the
    groups of every line of the axis are made here at once, in one order,
    and cached on the mesh.  An engine calls this at construction."""
    if axis in mesh._groups:
        return mesh._groups[axis]
    dist = _dist()
    world = dist.get_world_size()
    me = dist.get_rank()
    sets = sorted({tuple(sorted(set(int(p) for p in line)))
                   for line in mesh.axis_lines(axis)})
    mine = None
    for ranks in sets:
        if len(ranks) == 1:
            continue
        group = ((mesh.world or dist.group.WORLD) if len(ranks) == world
                 else _new_group(list(ranks), mesh.group_timeout_s))
        if me in ranks:
            mine = group
    mesh._groups[axis] = mine
    return mine


def _new_group(ranks: list[int], timeout_s: float | None):
    """``dist.new_group(ranks)`` whose collectives wait ``timeout_s``."""
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})
    return _dist().new_group(ranks, **kw)


def regroup(mesh: Mesh) -> Mesh:
    """A copy of ``mesh`` whose collectives run on groups of its own: a new
    group over every process (``world``) and line groups made anew
    (:func:`line_group`), none shared with ``mesh`` or another copy.  A
    mesh within one process is returned as it is.  ``new_group`` is
    collective: every process calls this in one order, as it makes every
    group, and from no other thread while it runs."""
    if not mesh.spans_processes:
        return mesh
    out = copy.copy(mesh)
    out._groups = {}
    out.world = _new_group(list(range(_dist().get_world_size())),
                           mesh.group_timeout_s)
    out._own_groups = True
    return out


def release(mesh: Mesh) -> None:
    """Destroy the groups of a copy made by :func:`regroup` (any other
    mesh is left as it is), once this process's collectives on them are
    over.  Destroying is local: a peer still waiting on one of them times
    out as the group's timeout says."""
    if not mesh._own_groups:
        return
    mesh._own_groups = False
    dist = _dist()
    groups = {id(g): g for g in (mesh.world, *mesh._groups.values())
              if g is not None}
    for g in groups.values():
        dist.destroy_process_group(g)


def _staged(t: torch.Tensor) -> bool:
    """gloo's point-to-point ops and this module's broadcasts take host
    tensors: a CUDA tensor crosses through pinned host memory."""
    return t.is_cuda and _dist().get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (the copy synchronizes with the stream
    that produced ``t``)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def exchange(sends, recvs, group=None, count=None) -> list[torch.Tensor]:
    """One ``dist.batch_isend_irecv`` of ``sends`` (``(tensor, process)``)
    and ``recvs`` (``(like, process)``: a tensor of the shape, dtype and
    device to receive); returns the received tensors, each on its
    ``like``'s device.  Every send and receive is posted before any is
    waited for, so a ring of them cannot deadlock; two processes exchange
    their messages in the order both list them.  Over gloo a CUDA tensor
    is staged through pinned host memory (the copy back is queued on the
    current stream, so the kernels after it read it in order).  ``group``:
    a group over every process, as a mesh's ``world`` (None: the default
    group).  ``count`` (a pipeline's metrics, or None) gets the host
    seconds spent in the sends and receives, staging excluded, in its
    ``boundary_s``."""
    dist = _dist()
    ops, landed = [], []
    for t, peer in sends:
        t = _to_host(t) if _staged(t) else t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, int(peer), group))
    for like, peer in recvs:
        staged = _staged(like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device,
                          pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, buf, int(peer), group))
        landed.append((buf, like.device))
    if ops:
        t0 = time.perf_counter()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if count is not None:
            count.boundary_s += time.perf_counter() - t0
    return [buf.to(dev, non_blocking=True) if buf.device != dev else buf
            for buf, dev in landed]


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of process ``src`` on every process (every process calls it
    with a tensor of the same shape and dtype; ``group`` as in
    :func:`exchange`)."""
    dist = _dist()
    if not _staged(t):
        dist.broadcast(t, src, group=group)
        return t
    h = _to_host(t)
    dist.broadcast(h, src, group=group)
    return h.to(t.device, non_blocking=True)


def _sum_over(t: torch.Tensor, group, count) -> torch.Tensor:
    """``t`` summed over ``group``'s processes (a new tensor; ``t`` is left
    as it is).  Over gloo a CUDA tensor is staged through pinned host
    memory, as :func:`exchange` stages it; ``count`` (a pipeline's
    metrics, or None) counts the call, the bytes each process hands the
    all-reduce and the host seconds spent in it, staging excluded
    (``allreduce_calls``, ``allreduce_bytes``, ``allreduce_s``)."""
    h = _to_host(t) if _staged(t) else t.contiguous().clone()
    t0 = time.perf_counter()
    _dist().all_reduce(h, group=group)
    if count is not None:
        count.allreduce_s += time.perf_counter() - t0
        count.allreduce_calls += 1
        count.allreduce_bytes += h.numel() * h.element_size()
    return h.to(t.device, non_blocking=True) if h.device != t.device else h


class _AllReduce(torch.autograd.Function):
    """The all-reduce of a psum across processes, with its backward: the
    same all-reduce of the cotangent (each process's input reaches every
    process's output once, so its gradient is the sum of every output's
    cotangent).  Both count in ``count``."""

    @staticmethod
    def forward(ctx, t, group, count):
        ctx.route = (group, count)
        return _sum_over(t, group, count)

    @staticmethod
    def backward(ctx, g):
        group, count = ctx.route
        return _sum_over(g, group, count), None, None


def _all_reduce(total: torch.Tensor, mesh: Mesh | None, axis: str | None,
                count=None) -> torch.Tensor:
    """``total`` summed with the partial sums of the other processes on
    this process's line when the axis crosses processes: over the default
    group or the line's sub-group (autograd passes through it)."""
    if not _crosses(mesh, axis):
        return total
    group = line_group(mesh, axis)
    if group is None:  # this process's line lies in this process
        return total
    return _AllReduce.apply(total, group, count)


def psum(xs: Sequence[torch.Tensor], *, mesh: Mesh | None = None,
         axis: str | None = None, count=None) -> list[torch.Tensor]:
    """Sum over the ranks: every rank gets the sum, on its own device.
    With ``mesh`` and ``axis`` naming an axis that crosses processes,
    ``xs`` are this process's ranks of its line and the sum is
    all-reduced over the line's processes (``count``, as
    :class:`ModelLine` passes it, counts each all-reduce)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    total = _all_reduce(total, mesh, axis, count)
    return [total.to(x.device) for x in xs]


def pmean(xs: Sequence[torch.Tensor], *, mesh: Mesh | None = None,
          axis: str | None = None) -> list[torch.Tensor]:
    """Mean over the ranks (of every process, when the axis crosses
    processes)."""
    n = len(xs)
    if mesh is not None and axis is not None:
        n = mesh.shape[axis]
    return [s / n for s in psum(xs, mesh=mesh, axis=axis)]


class ModelLine:
    """The ranks of one model (tensor-parallel) line that a process runs:
    the line's ``size``, this process's ``ranks`` of it (in order: the
    per-rank lists an op's ``tp_apply`` takes are these ranks') and, where
    the line crosses processes, the ``mesh`` and ``axis`` its psums
    all-reduce over, counted in ``count`` (a pipeline's metrics: its
    ``allreduce_calls`` and ``allreduce_bytes``).  ``LayerGraph.apply``'s
    ``tp=`` takes one, or an int: every rank of the line in this process
    (:meth:`of`)."""

    def __init__(self, size: int, ranks: Sequence[int] | None = None,
                 mesh: Mesh | None = None, axis: str = MODEL_AXIS,
                 count=None):
        self.size = int(size)
        self.ranks = tuple(range(self.size) if ranks is None else ranks)
        self.mesh, self.axis, self.count = mesh, axis, count

    @classmethod
    def of(cls, tp, n: int) -> "ModelLine":
        """``tp`` as it is, or (an int) the line of ``n`` ranks held here."""
        return tp if isinstance(tp, ModelLine) else cls(n)

    def local(self) -> "ModelLine":
        """The same ranks with the psums summing this process's ranks
        only (no all-reduce): a stage run on its own, crossing nothing."""
        return ModelLine(self.size, self.ranks)

    def psum(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """:func:`psum` over the line (this process's ranks' ``xs``)."""
        return psum(xs, mesh=self.mesh, axis=self.axis, count=self.count)


def _local_line(xs, mesh, axis):
    """``(owners, ranks, at)`` of this process's line, checked against
    the ``xs`` given for it (``at``: rank -> index into ``xs``)."""
    owners, ranks = _line(mesh, axis)
    if len(xs) != len(ranks):
        raise ValueError(f"{len(xs)} tensors for this process's "
                         f"{len(ranks)} ranks along {axis!r}")
    return owners, ranks, {r: i for i, r in enumerate(ranks)}


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[tuple[int, int]],
             *, mesh: Mesh | None = None,
             axis: str | None = None) -> list[torch.Tensor]:
    """``lax.ppermute``: rank ``dst`` gets rank ``src``'s tensor for each
    ``(src, dst)`` pair; a rank no pair sends to gets zeros.  Over an axis
    that crosses processes, ``xs`` are this process's ranks and a pair
    between two processes is a send and a receive (:func:`exchange`)."""
    if not _crosses(mesh, axis):
        out: list[torch.Tensor | None] = [None] * len(xs)
        for src, dst in perm:
            out[dst] = xs[src].to(xs[dst].device)
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]
    owners, _, at = _local_line(xs, mesh, axis)
    me = current_process()
    out = [None] * len(xs)
    sends, recvs, into = [], [], []
    for src, dst in perm:
        if owners[src] == me and owners[dst] == me:
            out[at[dst]] = xs[at[src]].to(xs[at[dst]].device)
        elif owners[src] == me:
            sends.append((xs[at[src]], owners[dst]))
        elif owners[dst] == me:
            recvs.append((xs[at[dst]], owners[src]))
            into.append(at[dst])
    for i, t in zip(into, exchange(sends, recvs)):
        out[i] = t
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int, *, mesh: Mesh | None = None,
               axis: str | None = None) -> list[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: each rank splits its tensor
    into ``n`` chunks along ``split_axis`` and sends chunk ``j`` to rank
    ``j``; rank ``j`` concatenates what it received, in rank order, along
    ``concat_axis``.  Over an axis that crosses processes, ``xs`` are this
    process's ranks; chunks between processes are sent and received."""
    crosses = _crosses(mesh, axis)
    n = mesh.shape[axis] if crosses else len(xs)
    size = xs[0].shape[split_axis]
    if size % n:
        raise ValueError(f"axis {split_axis} of size {size} does not split "
                         f"over {n} ranks")
    if not crosses:
        chunks = [x.chunk(n, dim=split_axis) for x in xs]
        return [torch.cat([chunks[src][dst].to(xs[dst].device)
                           for src in range(n)], dim=concat_axis)
                for dst in range(n)]
    owners, ranks, at = _local_line(xs, mesh, axis)
    me = current_process()
    chunks = {r: xs[at[r]].chunk(n, dim=split_axis) for r in ranks}
    like = chunks[ranks[0]]
    sends = [(chunks[src][dst], owners[dst]) for src in ranks
             for dst in range(n) if owners[dst] != me]
    remote = [(src, dst) for src in range(n) if owners[src] != me
              for dst in ranks]
    got = dict(zip(remote, exchange(
        sends, [(like[dst], owners[src]) for src, dst in remote])))
    return [torch.cat([chunks[src][dst].to(xs[at[dst]].device)
                       if owners[src] == me else got[src, dst]
                       for src in range(n)], dim=concat_axis)
            for dst in ranks]


def all_gather(xs: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = False, *, mesh: Mesh | None = None,
               axis_name: str | None = None) -> list[torch.Tensor]:
    """``lax.all_gather``: every rank gets all ranks' tensors, stacked on
    a new ``axis`` (concatenated along it with ``tiled=True``).  Over a
    mesh axis (``axis_name``, as JAX names it: ``axis`` is the tensor's)
    that crosses processes, ``xs`` are this process's ranks; each is sent
    to the line's other processes."""
    join = torch.cat if tiled else torch.stack
    if not _crosses(mesh, axis_name):
        return [join([x.to(dst.device) for x in xs], dim=axis) for dst in xs]
    owners, ranks, at = _local_line(xs, mesh, axis_name)
    me = current_process()
    peers = sorted(set(int(p) for p in owners) - {me})
    remote = [r for r in range(len(owners)) if owners[r] != me]
    got = dict(zip(remote, exchange(
        [(xs[at[r]], q) for r in ranks for q in peers],
        [(xs[0], owners[r]) for r in remote])))
    full = [xs[at[r]] if owners[r] == me else got[r]
            for r in range(len(owners))]
    return [join([x.to(xs[at[r]].device) for x in full], dim=axis)
            for r in ranks]
