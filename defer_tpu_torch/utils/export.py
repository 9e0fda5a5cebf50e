"""Stage program serialization: a ``torch.export`` program plus weights.

The port of ``defer_tpu.utils.export``.  The reference's control plane
ships each partition to its node as Keras architecture JSON plus weights
(reference src/dispatcher.py:44-65, rebuilt via ``model_from_json`` at
src/node.py:31); the JAX package ships StableHLO.  Here the artifact is
the stage function traced by ``torch.export`` on the CPU and saved with
``torch.export.save``, beside the stage's weights: a node loads it with
no model code at all and runs it on its own device.

The zip keeps the JAX package's layout — ``manifest.json`` with the same
keys, ``weights.npz`` of leaves ``w0…wN`` — and only the program differs
(``stage.pt2`` in place of ``stage.stablehlo``).  The manifest's format is
``defer_tpu_torch.stage.v1``; each package's loader refuses the other's
artifact.

Weights are inputs of the exported function, as in the JAX package, so
:meth:`StageProgram.reweight` swaps tensors without exporting again.  The
npz leaves are in the JAX package's order (sorted key paths, the order
``jax.tree.flatten`` gives a dict) and layout (conv kernels HWIO), so a
reweight blob made by either package installs the same weights in the
other's node; the program itself reads conv kernels as OIHW, and
:class:`StageProgram` turns them on install (the manifest's
``hwio_leaves``).

Attention rides the ``defer_tpu_torch::flash_attention`` custom operator
(``ops/flash_attention.py``): the exported graph holds that one node, and
a program loaded on the card runs the hand kernel through it.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch
# the program (de)serializer, imported with this module: about 2.4 s on a
# CPU core at first import, which a chain node pays while it boots beside
# its siblings rather than in its turn of the serial in-band deploy
import torch._export.serde.serialize  # noqa: F401

from ..obs.profile import record_compile
from ..partition.stage import StageSpec
from ..runtime import flatbuf
from .config import resolve_device
from .convert import hwio_to_oihw, is_hwio_leaf, oihw_to_hwio

#: ``torch.export.load`` keeps its deserializer in a module global, so two
#: threads may not load at once (the nodes of one process load in-band
#: deploys on their own serve threads)
_LOAD_LOCK = threading.Lock()
#: serialized programs by stage layout (see :func:`_program_bytes`), each
#: beside its graph, held so that the graph's id is never reused
_PROGRAMS: dict = {}
_PROGRAMS_LOCK = threading.Lock()
_MANIFEST = "manifest.json"
_PROGRAM = "stage.pt2"
_WEIGHTS = "weights.npz"
FORMAT = "defer_tpu_torch.stage.v1"
#: the JAX package's format tag, refused by name
JAX_FORMAT = "defer_tpu.stage.v1"


def _leaves(stage: StageSpec, params: dict[str, Any]):
    """``(paths, port-layout tensors, indices of HWIO leaves)`` of the
    stage's parameters, in the JAX leaf order."""
    paths, leaves = flatbuf.flatten_leaves(stage.select_params(params))
    hwio = [i for i, p in enumerate(paths)
            if is_hwio_leaf(stage.graph.nodes[p[0]], "/".join(p[1:]))]
    return paths, leaves, hwio


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()  # exact; numpy has no bfloat16
    return t.numpy()


def stage_weight_leaves(stage: StageSpec,
                        params: dict[str, Any]) -> list[np.ndarray]:
    """The stage's weights as the artifact ships them: numpy leaves in the
    JAX package's order and layout (equal, leaf by leaf, to the JAX
    package's ``stage_weight_leaves`` of the same weights) — the unit both
    a full export and a weights-only re-push carry."""
    _, leaves, hwio = _leaves(stage, params)
    out = [_to_numpy(t) for t in leaves]
    for i in hwio:
        out[i] = np.ascontiguousarray(oihw_to_hwio(out[i]))
    return out


def weights_blob(leaves: list[np.ndarray]) -> bytes:
    """npz-serialize a leaf list (the reweight payload)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"w{i}": l for i, l in enumerate(leaves)})
    return buf.getvalue()


def _load_weights_blob(data: bytes, num: int) -> list[np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        if len(npz.files) != num:
            raise ValueError(f"expected {num} weight arrays, got "
                             f"{len(npz.files)}")
        return [npz[f"w{i}"] for i in range(num)]


class _StageFn(torch.nn.Module):
    """The exported function: ``(port-layout leaves, *xs) -> y`` — one
    input, or a join stage's P inputs in path order."""

    def __init__(self, stage: StageSpec, paths):
        super().__init__()
        self.stage = stage
        self.paths = paths

    def forward(self, leaves: list[torch.Tensor], *xs: torch.Tensor):
        return self.stage.fn(flatbuf.unflatten_leaves(self.paths, leaves),
                             *xs)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _program_bytes(stage, paths, leaves, xs) -> bytes:
    """The stage's ``torch.export`` program, serialized.  The weights are
    inputs of the exported function, so the trace reads their shapes,
    dtypes and strides and never their values: a stage exported again (a
    redeploy with another codec, a replanned chain's unchanged stages, the
    same topology spawned as processes) reuses the program traced the
    first time in this process, keyed on the graph, the node slice, the
    leaf layout and the inputs' shapes."""
    key = (id(stage.graph), type(stage).__name__, tuple(stage.node_names),
           tuple(getattr(stage, "input_names", None) or (stage.input_name,)),
           stage.output_name, tuple(paths),
           tuple((tuple(t.shape), t.dtype, t.stride()) for t in leaves),
           tuple((tuple(x.shape), x.dtype) for x in xs))
    with _PROGRAMS_LOCK:
        hit = _PROGRAMS.get(key)
        if hit is not None and hit[0] is stage.graph:
            return hit[1]
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(_StageFn(stage, paths),
                                          (leaves, *xs))
        record_compile(time.perf_counter() - t0, via="export.trace",
                       label=stage.output_name)
        # the trace's example inputs are the weights themselves: the
        # artifact ships them once, in weights.npz
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        _PROGRAMS[key] = (stage.graph, buf.getvalue())
        return _PROGRAMS[key][1]


def _traced(stage, paths, leaves, batch: int):
    """(the stage's input specs, its serialized program at ``batch``)."""
    leaves = [t.detach().cpu() for t in leaves]
    in_specs = tuple(getattr(stage, "in_specs", None) or (stage.in_spec,))
    xs = tuple(torch.zeros((batch,) + tuple(s.shape), dtype=s.dtype)
               for s in in_specs)
    return in_specs, _program_bytes(stage, paths, leaves, xs)


def trace_stage(stage: StageSpec, params: dict[str, Any], *,
                batch: int = 1) -> None:
    """Trace the stage's program at ``batch`` and keep it, without packing
    its weights: a later :func:`export_stage_bytes` of the stage finds the
    trace ready (``deploy_chain`` traces while its nodes boot)."""
    paths, leaves, _ = _leaves(stage, params)
    _traced(stage, paths, leaves, batch)


def export_stage_bytes(stage: StageSpec, params: dict[str, Any],
                       *, batch: int = 1) -> bytes:
    """Serialize one pipeline stage to zip-archive bytes.

    Contents: the stage function traced by ``torch.export`` on the CPU at
    batch ``batch`` with the weights as inputs, the stage's weight leaves
    (:func:`stage_weight_leaves`), and a JSON manifest with the JAX
    package's keys plus ``hwio_leaves`` — one blob the dispatcher ships
    over the control connection.

    A :class:`~defer_tpu_torch.partition.stage.JoinStageSpec` (the join of
    a branched pipeline) exports a program of P inputs, one per merged
    branch path in path order, and its manifest adds ``num_inputs``,
    ``in_shapes`` and ``in_dtypes`` as the JAX package's does.  A failed
    trace raises: no artifact falls back to eager code.
    """
    paths, leaves, hwio = _leaves(stage, params)
    in_specs, program = _traced(stage, paths, leaves, batch)
    spec = in_specs[0]

    manifest = {
        "format": FORMAT,
        "index": stage.index,
        "name": stage.name,
        "graph": stage.graph.name,
        "input": (getattr(stage, "input_name", None)
                  or ",".join(stage.input_names)),
        "output": stage.output_name,
        "batch": batch,
        "in_shape": list(spec.shape),
        "in_dtype": _dtype_name(spec.dtype),
        "out_shape": list(stage.out_spec.shape),
        "out_dtype": _dtype_name(stage.out_spec.dtype),
        "num_weights": len(leaves),
        "hwio_leaves": hwio,
    }
    if len(in_specs) > 1:
        manifest["num_inputs"] = len(in_specs)
        manifest["in_shapes"] = [list(s.shape) for s in in_specs]
        manifest["in_dtypes"] = [_dtype_name(s.dtype) for s in in_specs]
    out = io.BytesIO()
    # the program (itself a zip) and the weights are stored, not deflated:
    # float weights barely compress, and deflating ResNet50's 102 MB would
    # cost seconds of every deploy
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr(_MANIFEST, json.dumps(manifest, indent=1))
        z.writestr(_PROGRAM, program)
        z.writestr(_WEIGHTS, weights_blob(stage_weight_leaves(stage,
                                                              params)))
    return out.getvalue()


def export_stage(stage: StageSpec, params: dict[str, Any], path: str,
                 *, batch: int = 1) -> None:
    """Serialize one pipeline stage to ``path`` (see export_stage_bytes)."""
    data = export_stage_bytes(stage, params, batch=batch)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


class StageProgram:
    """A loaded stage artifact: callable, with swappable weights.

    ``prog(x)`` runs the exported program with its shipped weights on
    :attr:`device` and returns the output tensor there (the analogue of the
    node's ``model_from_json`` + ``set_weights``, reference
    src/node.py:31-34).  ``x`` may be a numpy array or a tensor on any
    device; a join stage's program takes its P inputs, ``prog(*xs)``.  ``reweight(blob)`` installs a fresh weight set (same shapes
    and dtypes) without reloading the program.  The program is built on
    the CPU, where it was exported; :func:`load_stage_program` places it
    on its device with :meth:`place`.
    """

    def __init__(self, program, leaves: list[np.ndarray], manifest: dict):
        self.manifest = manifest
        self.device = torch.device("cpu")
        self._program = program
        self._fn = program.module()
        self._in_dtypes = [getattr(torch, d) for d in manifest.get(
            "in_dtypes", [manifest["in_dtype"]])]
        self._install(leaves)

    def _install(self, leaves: list[np.ndarray]) -> None:
        """Turn JAX-layout numpy leaves into the program's tensors on
        :attr:`device` (conv kernels OIHW, stored channels_last on the
        card as ``params_to_device`` stores them)."""
        if len(leaves) != self.manifest["num_weights"]:
            raise ValueError(
                f"expected {self.manifest['num_weights']} weight arrays, "
                f"got {len(leaves)}")
        hwio = set(self.manifest["hwio_leaves"])
        out = []
        for i, a in enumerate(leaves):
            if i in hwio:
                t = torch.from_numpy(np.ascontiguousarray(hwio_to_oihw(a)))
                t = t.to(self.device, memory_format=torch.channels_last)
            else:
                t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            out.append(t)
        self._np_leaves = leaves
        self.leaves = out

    def place(self, device) -> None:
        """Move the program and its weights to ``device`` (``"cuda"``,
        ``"cpu"``, a ``torch.device``); raises when CUDA is asked for and
        absent."""
        dev = resolve_device(device)
        if dev != self.device:
            from torch.export.passes import move_to_device_pass
            self._program = move_to_device_pass(self._program, dev)
            self._fn = self._program.module()
            self.device = dev
            self._install(self._np_leaves)

    def reweight(self, blob: bytes) -> None:
        """Install a weights npz blob (shapes and dtypes must match the
        artifact's)."""
        new = _load_weights_blob(blob, self.manifest["num_weights"])
        for i, (old, nw) in enumerate(zip(self._np_leaves, new)):
            if old.shape != nw.shape or old.dtype != nw.dtype:
                raise ValueError(
                    f"weight {i}: artifact has {old.shape}/{old.dtype}, "
                    f"re-push has {nw.shape}/{nw.dtype}")
        self._install(new)

    def __call__(self, *xs) -> torch.Tensor:
        if len(xs) != len(self._in_dtypes):
            raise ValueError(f"stage {self.manifest['index']} takes "
                             f"{len(self._in_dtypes)} inputs, got {len(xs)}")
        ts = [torch.as_tensor(x).to(self.device, d)
              for x, d in zip(xs, self._in_dtypes)]
        with torch.inference_mode():
            return self._fn(self.leaves, *ts)

    @property
    def graph(self):
        """The exported program's FX graph (its nodes name the operators
        the stage runs)."""
        return self._program.graph


def load_stage_program(src, *, device=None) -> StageProgram:
    """Load an exported stage from a path or bytes into a
    :class:`StageProgram` placed on ``device``: the CUDA card by default
    (raising without one), or ``"cpu"`` when the caller asks for it."""
    from ..ops import flash_attention  # noqa: F401 — registers the operator

    f = io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src
    with zipfile.ZipFile(f) as z:
        manifest = json.loads(z.read(_MANIFEST).decode())
        fmt = manifest.get("format")
        if fmt == JAX_FORMAT:
            raise ValueError(f"{src!r:.80}: a JAX package (defer_tpu) stage "
                             f"artifact; this loader takes {FORMAT}")
        if fmt != FORMAT:
            raise ValueError(f"{src!r:.80}: not a defer_tpu_torch stage "
                             f"artifact")
        t0 = time.perf_counter()
        with _LOAD_LOCK:
            program = torch.export.load(io.BytesIO(z.read(_PROGRAM)))
        record_compile(time.perf_counter() - t0, via="export.load",
                       label=manifest.get("name"))
        leaves = _load_weights_blob(z.read(_WEIGHTS),
                                    manifest["num_weights"])
    prog = StageProgram(program, leaves, manifest)
    prog.place(device)
    return prog


def load_stage(path: str, *, device=None):
    """Back-compat loader: returns ``(fn, manifest)``, the program placed
    as :func:`load_stage_program` places it."""
    prog = load_stage_program(path, device=device)
    return prog, prog.manifest


def export_pipeline(stages, params, directory: str, *, batch: int = 1):
    """Export every stage of a partition to ``directory/stage_<i>.zip``."""
    paths = []
    for s in stages:
        p = os.path.join(directory, f"stage_{s.index}.zip")
        export_stage(s, params, p, batch=batch)
        paths.append(p)
    return paths
