"""The chain topology: the process graph a deployment spawns.

The port of ``defer_tpu.runtime.topology``.  A :class:`ChainTopology`
makes a deployment's shape explicit: a validated DAG of stage VERTICES,
each naming its slice of the layer graph, its downstream vertices and its
transport role (unicast relay, per-seq broadcast fork, or all-paths
join).  The DAG planner emits one (``plan/dag.py``, the plan JSON's
``topology`` field), ``ChainDispatcher.deploy_topology`` ships it, and
``run_dag_chain`` spawns it: the same object end to end, so a plan file
is a deployable topology.  The document is the JAX package's, byte for
byte, so either package reads the other's.

Schema (``to_json`` / ``from_json``)::

    {"format": "defer_tpu.topology.v1",
     "vertices": [
       {"id": 0, "nodes": [...], "inputs": ["input"],
        "output": "stem_pool2", "next": [1, 2], "fan": "broadcast",
        "join": 0, "branch": null, "codec": "raw"},
       ...]}

Invariants ``validate`` enforces: exactly one entry (the dispatcher
feeds it) and one exit (it dials the result server); edges topological
(``next`` ids strictly increase — vertex order is a topological order);
``fan="broadcast"`` iff a vertex has several downstreams (round-robin
replica fan-out is the linear deploy path's business, not a topology
vertex's); every join's in-degree equals its ``join`` count with
distinct path labels 0..P-1; and join/broadcast never mix with
replication — the ordered fan machinery owns the wire there.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

TOPOLOGY_FORMAT = "defer_tpu.topology.v1"


@dataclasses.dataclass(frozen=True)
class TopoVertex:
    """One deployed stage of a branched (or linear) pipeline."""

    vid: int
    nodes: tuple[str, ...]        #: layer-graph nodes this stage evaluates
    inputs: tuple[str, ...]       #: seed boundary tensors (P for a join)
    output: str                   #: boundary tensor this stage emits
    next: tuple[int, ...]         #: downstream vertex ids; () = result hop
    fan: str = "unicast"          #: "unicast" | "broadcast"
    join: int = 0                 #: >= 2: merge this many labeled paths
    branch: int | None = None     #: path index inside a fork/join region
    codec: str = "raw"            #: outbound hop codec

    @property
    def label(self) -> str:
        """Span/stats label: ``stageK``, or ``stageK.bJ`` for a branch
        vertex."""
        base = f"stage{self.vid}"
        return base if self.branch is None else f"{base}.b{self.branch}"

    def to_json(self) -> dict:
        return {"id": self.vid, "nodes": list(self.nodes),
                "inputs": list(self.inputs), "output": self.output,
                "next": list(self.next), "fan": self.fan,
                "join": self.join, "branch": self.branch,
                "codec": self.codec}


class ChainTopology:
    """A validated stage-graph deployment plan (see module docstring)."""

    def __init__(self, vertices: Sequence[TopoVertex]):
        self.vertices = list(vertices)
        self.validate()

    def __len__(self) -> int:
        return len(self.vertices)

    def __iter__(self):
        return iter(self.vertices)

    @property
    def entry(self) -> TopoVertex:
        return self.vertices[0]

    @property
    def exit(self) -> TopoVertex:
        return self.vertices[-1]

    def upstreams(self, vid: int) -> list[TopoVertex]:
        return [v for v in self.vertices if vid in v.next]

    def path_of_edge(self, up: TopoVertex, vid: int) -> int | None:
        """The join-path label an edge ``up -> vid`` carries: the
        upstream's own branch index, or — for a direct fork->join edge
        (an empty branch / residual skip) — its position in the fork's
        broadcast list."""
        if up.branch is not None:
            return up.branch
        if up.fan == "broadcast":
            return up.next.index(vid)
        return None

    def validate(self) -> None:
        vs = self.vertices
        if not vs:
            raise ValueError("topology has no vertices")
        ids = [v.vid for v in vs]
        if ids != list(range(len(vs))):
            raise ValueError(f"vertex ids must be 0..{len(vs) - 1} in "
                             f"order, got {ids}")
        exits = [v for v in vs if not v.next]
        if len(exits) != 1 or exits[0] is not vs[-1]:
            raise ValueError("topology needs exactly one exit vertex "
                             "(empty `next`), and it must come last")
        indeg = {v.vid: 0 for v in vs}
        for v in vs:
            if v.fan not in ("unicast", "broadcast"):
                raise ValueError(f"vertex {v.vid}: fan must be "
                                 f"unicast|broadcast, got {v.fan!r}")
            if (len(v.next) > 1) != (v.fan == "broadcast"):
                raise ValueError(
                    f"vertex {v.vid}: {len(v.next)} downstreams with "
                    f"fan={v.fan!r} — broadcast exactly when fanning to "
                    f"parallel branches")
            for n in v.next:
                if not (v.vid < n < len(vs)):
                    raise ValueError(f"vertex {v.vid}: next {n} is not a "
                                     f"later vertex id")
                indeg[n] += 1
        entries = [v for v in vs if indeg[v.vid] == 0]
        if len(entries) != 1 or entries[0] is not vs[0]:
            raise ValueError("topology needs exactly one entry vertex "
                             "(no upstreams), and it must come first")
        for v in vs:
            if v.join >= 2:
                if len(v.inputs) != v.join:
                    raise ValueError(
                        f"join vertex {v.vid} merges {v.join} paths but "
                        f"seeds {len(v.inputs)} inputs")
                labels = []
                for u in self.upstreams(v.vid):
                    p = self.path_of_edge(u, v.vid)
                    if p is None:
                        raise ValueError(
                            f"join vertex {v.vid}: upstream vertex "
                            f"{u.vid} carries no path label — join "
                            f"inputs must arrive from a branch member "
                            f"or a broadcast fork")
                    labels.append(p)
                paths = sorted(labels)
                if paths != list(range(v.join)):
                    raise ValueError(
                        f"join vertex {v.vid} needs one labeled upstream "
                        f"per path 0..{v.join - 1}, got {paths}")
            elif indeg[v.vid] > 1:
                raise ValueError(f"vertex {v.vid} has {indeg[v.vid]} "
                                 f"upstreams but join={v.join}")

    # -- mutation (live replan) ---------------------------------------------

    def update(self, vid: int, **changes) -> TopoVertex:
        """Mutate one vertex in place (``dataclasses.replace`` on the
        frozen vertex, swapped into the list) and revalidate the whole
        graph.  A change that breaks an invariant is ROLLED BACK before
        the ``ValueError`` propagates — a topology object is never left
        observably invalid, because a live replan hands it straight to
        ``deploy_topology``."""
        if not 0 <= vid < len(self.vertices):
            raise ValueError(f"no vertex {vid} in {self!r}")
        old = self.vertices[vid]
        new = dataclasses.replace(old, **changes)
        self.vertices[vid] = new
        try:
            self.validate()
        except ValueError:
            self.vertices[vid] = old
            raise
        return new

    def move_boundary(self, vid: int, *, nodes, output: str,
                      downstream_nodes, downstream_inputs) -> None:
        """Shift the cut between vertex ``vid`` and ``vid + 1``: the
        upstream vertex now evaluates ``nodes`` and emits ``output``;
        the downstream evaluates ``downstream_nodes`` seeded by
        ``downstream_inputs``.  This is the replanner's one move —
        migrating layer-graph nodes across an adjacent boundary —
        expressed as a single atomic topology edit."""
        if vid + 1 >= len(self.vertices):
            raise ValueError(f"vertex {vid} has no downstream boundary")
        up_old, dn_old = self.vertices[vid], self.vertices[vid + 1]
        self.vertices[vid] = dataclasses.replace(
            up_old, nodes=tuple(nodes), output=output)
        self.vertices[vid + 1] = dataclasses.replace(
            dn_old, nodes=tuple(downstream_nodes),
            inputs=tuple(downstream_inputs))
        try:
            self.validate()
        except ValueError:
            self.vertices[vid] = up_old
            self.vertices[vid + 1] = dn_old
            raise

    def diff(self, other: "ChainTopology") -> dict:
        """Structural delta ``self -> other``: which vertex ids changed,
        appeared, or vanished.  A live replan redeploys EXACTLY
        ``changed + added`` — untouched stages keep their loaded
        artifact across the cutover."""
        mine = {v.vid: v.to_json() for v in self.vertices}
        theirs = {v.vid: v.to_json() for v in other.vertices}
        return {
            "changed": sorted(vid for vid in mine.keys() & theirs.keys()
                              if mine[vid] != theirs[vid]),
            "added": sorted(theirs.keys() - mine.keys()),
            "removed": sorted(mine.keys() - theirs.keys()),
        }

    def copy(self) -> "ChainTopology":
        """Deep-enough copy: vertices are frozen, the list is fresh —
        mutate the copy, diff against the original."""
        return ChainTopology(list(self.vertices))

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> dict:
        return {"format": TOPOLOGY_FORMAT,
                "vertices": [v.to_json() for v in self.vertices]}

    @classmethod
    def from_json(cls, doc: dict) -> "ChainTopology":
        """Accepts a bare topology dict, a DAG plan's ``to_json``, or a
        whole ``plan --dag --json`` document."""
        doc = doc.get("plan", doc)
        doc = doc.get("topology", doc)
        if doc.get("format") != TOPOLOGY_FORMAT:
            raise ValueError(f"not a {TOPOLOGY_FORMAT} document "
                             f"(format={doc.get('format')!r})")
        vs = [TopoVertex(vid=int(d["id"]), nodes=tuple(d["nodes"]),
                         inputs=tuple(d["inputs"]), output=d["output"],
                         next=tuple(int(n) for n in d["next"]),
                         fan=d.get("fan", "unicast"),
                         join=int(d.get("join", 0)),
                         branch=(None if d.get("branch") is None
                                 else int(d["branch"])),
                         codec=d.get("codec", "raw"))
              for d in doc["vertices"]]
        return cls(vs)

    @classmethod
    def linear(cls, stages, *, codecs: Sequence[str] | None = None
               ) -> "ChainTopology":
        """The chain special case: every ``StageSpec`` a unicast vertex —
        what ``run_chain``'s implicit wiring has always meant, now as a
        first-class object."""
        vs = []
        n = len(stages)
        for i, s in enumerate(stages):
            vs.append(TopoVertex(
                vid=i, nodes=tuple(s.node_names),
                inputs=(s.input_name,), output=s.output_name,
                next=(i + 1,) if i + 1 < n else (),
                codec=codecs[i] if codecs else "raw"))
        return cls(vs)

    # -- stage building -----------------------------------------------------

    def stage_specs(self, graph) -> list:
        """One ``StageSpec``/``JoinStageSpec`` per vertex (vertex order)
        — what ``deploy_topology``/``run_dag_chain`` export and ship."""
        from ..partition.partitioner import stage_specs_for_vertices
        return stage_specs_for_vertices(graph, self.vertices)

    def __repr__(self):
        joins = sum(1 for v in self.vertices if v.join >= 2)
        forks = sum(1 for v in self.vertices if v.fan == "broadcast")
        return (f"ChainTopology({len(self.vertices)} vertices, "
                f"{forks} forks, {joins} joins)")
