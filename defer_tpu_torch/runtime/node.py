"""Standalone stage-node processes: linear, replicated and branched chains.

The port of ``defer_tpu.runtime.node``.  Reference
parity: the reference's compute node is a separate process on another
machine that receives its partition, then serves the chain forever —
recv activation, predict, relay to its successor (reference
src/node.py:80-108, boot at src/node.py:110-127).  The last node relays
back to the dispatcher (reference src/dispatcher.py:51-55).

The port keeps the JAX package's design:

* The partition arrives as an exported program plus weights
  (``utils/export.py``: a ``torch.export`` artifact, loaded with no model
  code and placed on the node's device; attention runs the hand kernel
  through the ``defer_tpu_torch::flash_attention`` operator).
* One typed framed connection per hop (``transport/framed.py``, frames
  byte-identical to the JAX package's, so JAX and port nodes chain
  together); the hop codec (raw / lzb / blockfloat) is symmetric.
* Readiness is connect-with-retry, and shutdown is an in-band END frame
  that cascades down the chain.
* Each hop negotiates its transport tier when it opens (``tier``): the
  ladder ici (same process and platform: the output tensor is handed over
  on the card, ``transport/ici.py``) over local (same process: the host
  copy by reference, ``transport/local.py``) over shm (same host: a
  shared-memory ring with the socket as doorbell, ``transport/shm.py``)
  over tcp.  Nodes grant offers by default; a refused offer degrades to
  tcp with one labeled ``transport.tier_fallback.<hop>`` count and a
  ``tier`` event.  ``run_chain`` fuses ``device``-tier hops into one
  program and runs ``local``/``ici`` runs of stages as ``--co-stage``
  threads of one process.

A node's program runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA and no explicit CPU it raises.  The
dispatch is asynchronous on the card: a CUDA event recorded after the
program marks the frame, the overlapped loop keeps up to ``inflight``
frames un-synced, and the DEVICE phase waits on the event before the
HOST_SYNC phase copies the output to the host — or, on an ici hop, hands
the tensor on without any host copy (its ``host_sync`` records nothing).

Replication (the JAX package's design, ``transport/replicate.py``): a
``next`` hop may name R comma-separated replicas of the downstream stage,
and frames then fan out round-robin with sequence numbers; a node with
``fan_in=R`` merges R sequence-stamped upstream connections through a
bounded reorder buffer that releases frames strictly in order; ``replica``
labels a node's spans and stats ``stageK.rN``.  Fan paths ride tcp.  With
``failover`` the fan-out retains each frame until the fan-in's cumulative
``replay_ack`` (relayed upstream by the replicas on their inbound
sockets), heals a dead replica channel by redialing and replaying
(``transport/replay.py`` ``ReplayFanOut``), and the fan-in waits one
``failover_grace_s`` for the respawned replica and drops the replayed
duplicates; ``deploy_chain``'s supervisor respawns a dead replica
process from its argv on the same port.

Branched stage graphs (the JAX package's design, ``transport/branch.py``,
``runtime/topology.py``): a fork node (``fan_mode="broadcast"``) sends
every frame to all of its ``next`` hops under one sequence stamp, each
channel announced with its path label; a branch node (``branch=J``)
announces its path on its outbound hop; a join node (``join_in=P``)
merges P labeled paths per sequence in a ``BranchJoin`` and runs its
P-input program on each complete set.  ``ChainDispatcher.deploy_topology``
and :func:`run_dag_chain` deploy a ``defer_tpu.topology.v1`` document.
Branch hops are wire-framed, so they never probe a tier, and they refuse
replicas and colocation.

Observability (the JAX package's plane, ``obs/``): a node answers
``clock_probe``/``clock_adjust`` (the dispatcher aligns every process's
timeline onto its own), ``obs_subscribe`` (an ``obs_push`` frame every
interval on that connection, read by ``obs.cluster.ClusterView``),
``profile_start``/``profile_stop`` (a phase breakdown, the recompiles and
the hand-kernel launches of exactly that window, optionally a
``torch.profiler`` trace) and reports live MFU against its card's peak
(``utils/hw.py``) from the FLOPs the deploy carries.  ``run_chain`` and
``deploy_chain`` watch a chain live against a plan (``plan=``) and journal
every process to disk (``journal_dir=``), and a failed run or a respawn
assembles a postmortem bundle (``obs.postmortem.maybe_autopsy``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..obs import REGISTRY, LatencyHistogram, new_span_id, tracer
from ..obs.events import emit as emit_event
from ..obs.events import recorder
from ..obs.capacity import achieved_mfu, stage_flops_bytes
from ..obs.cluster import ClusterView, align_clock
from ..obs.journal import active_journal, start_journal, stop_journal
from ..obs.postmortem import maybe_autopsy
from ..obs.profile import (ProfileSession, device_memory_bytes,
                           memory_watcher, recompile_watcher)
from ..obs.report import ObsReporter, WatermarkSplit
from ..transport.branch import BranchJoin, BroadcastSender
from ..transport.channel import AsyncReceiver, AsyncSender, _sampled
from ..transport.framed import (K_ACK, K_BYTES, K_CTRL, K_END, K_TENSOR,
                                K_TENSOR_SEQ, configure_socket,
                                connect_retry, recv_expect, recv_frame,
                                send_ack, send_ctrl, send_end, send_frame)
from ..transport.ici import IciSender
from ..transport.local import answer_probe
from ..transport.replay import ACK_EVERY, ReplayFanOut
from ..transport.replicate import FanInMerge, FanOutSender
from ..transport.shm import (ShmSender, answer_tier_probe,
                             offer_tier_ladder, sweep_orphan_segments)
from ..utils.config import resolve_device

#: serve()-loop sentinel a ``shutdown`` control command enqueues: a
#: persistent node returns its accumulated stream total NOW
_SHUTDOWN = object()

#: the transport tiers a node or a dispatcher offers on its outbound hop
_TIERS = ("tcp", "auto", "local", "shm", "ici")

#: the senders that announce every channel themselves when they open
_FAN_SENDERS = (FanOutSender, ReplayFanOut, BroadcastSender)

#: fan-in dedup window under failover: how far behind the merge head a
#: replayed duplicate may land and still be dropped silently.  It bounds
#: the fan-out's retained window (ack lag plus reorder capacity) with an
#: order of magnitude of slack; beyond it a duplicate raises as in strict
#: mode
_REPLAY_DEDUP_WINDOW = 4096


#: guards the lazy creation of a node's watermark splitter
_WM_LOCK = threading.Lock()

#: how long the failover supervisor's postmortem waits after a respawn
#: before it reads the journals: a dead process reads as the first fault
#: once its journal stops ``STALL_MARGIN_US`` (1 s) before the survivors',
#: and a survivor with no events writes a record only with its snapshot,
#: once a second, so 2.5 s leaves the corpse at least 1.5 s behind (the
#: JAX package waits 0.75 s, and its first bundle may name no fault)
_AUTOPSY_DELAY_S = 2.5


def _check_tier(tier: str, who: str) -> str:
    if tier not in _TIERS:
        raise ValueError(f"{who}: tier must be tcp|auto|local|shm|ici, "
                         f"got {tier!r}")
    return tier


def _pin_device(device) -> torch.device:
    """``device`` as a node's ``torch.device``: a bare integer ``J`` (the
    JAX package's form) means ``cuda:J``; an index past the visible cards
    raises ``ValueError`` naming their count."""
    if isinstance(device, int) and not isinstance(device, bool):
        if device < 0:
            raise ValueError(f"device {device} must be >= 0")
        device = f"cuda:{device}"
    elif isinstance(device, str) and device.isdigit():
        device = f"cuda:{device}"
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda" and dev.index is not None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= have:
            raise ValueError(f"device {dev} out of range: this process "
                             f"sees {have} CUDA device(s)")
    return resolve_device(dev)


def _warm_cuda(device: torch.device) -> None:
    """Make ``device``'s CUDA context and load cuDNN and cuBLAS with one
    tiny convolution and one tiny matmul.  A node process otherwise loads
    both libraries on its first frame, and the nodes of a fresh chain do
    it one after another as that frame travels down the chain; done at
    boot, the chain's processes load them side by side.  Launches no hand
    kernel."""
    with torch.inference_mode():
        x = torch.ones((1, 1, 2, 2), device=device)
        torch.nn.functional.conv2d(x, x)
        torch.mm(x[0, 0], x[0, 0])
    torch.cuda.synchronize(device)


def _parse_hostport(s: str, default_host: str = "127.0.0.1"
                    ) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or default_host), int(port)


def _parse_hops(s: str) -> list[tuple[str, int]]:
    """``host:port[,host:port...]`` -> list of (host, port).  More than one
    entry names replicas of the downstream stage: the sender fans out
    round-robin with sequence numbers."""
    return [_parse_hostport(p) for p in s.split(",") if p]


def _kernel_launches() -> dict[str, int]:
    """Each hand kernel's launches in this process."""
    from ..ops.launches import counted_kernels
    return {k.name: k.launches for k in counted_kernels()}


class StageNode:
    """One compute node of a process chain: recv -> stage program -> relay.

    ``python -m defer_tpu_torch node --listen :5000`` boots an EMPTY node
    that receives its stage artifact in-band over the control handshake,
    as the reference node gets its model over the wire
    (src/node.py:20-55).  ``artifact`` (a path) pre-loads one instead, with
    ``next_hop`` naming the successor; it loads on a thread of its own
    after the bind, while the node already serves (``prog`` and
    ``manifest`` wait for it, and raise if it failed).

    ``device`` is where the stage program runs: the CUDA card by default,
    ``"cuda:J"`` or a bare index ``J`` for card J, ``"cpu"`` only when
    asked.  ``tier`` is the outbound transport-tier policy: ``"tcp"`` never
    probes; ``"auto"`` walks the ladder ici > local > shm > tcp when the
    downstream connection opens; ``"ici"``/``"local"``/``"shm"`` offer that
    rung alone.  ``tier_accept`` (the default) grants inbound offers whose
    proof holds; ``False`` answers every offer with tcp.

    Replication: ``next_hop`` may name R comma-separated replicas of the
    downstream stage (frames fan out round-robin with sequence numbers);
    ``fan_in=R`` merges R sequence-stamped upstream connections in order;
    ``replica=N`` labels this node replica N of its stage (``stageK.rN``).
    Branched graphs: ``fan_mode="broadcast"`` sends every frame to every
    next hop (a fork); ``branch=J`` labels this node's path through a
    fork/join region (``stageK.bJ``; its outbound ``stream_begin`` carries
    the path); ``join_in=P`` makes it the region's join, merging P labeled
    paths per sequence before its P-input program runs.
    ``failover`` arms the seq-replay plane: a fan-out retains and heals, a
    replica relays acks upstream, a fan-in acks, drops replayed duplicates
    and waits ``failover_grace_s`` for a dead upstream's replacement before
    it fails the stream.  Fan paths never probe a tier,
    so a shm/ici/local pin on a replica, a branch or a fan-out raises
    ``ValueError``.
    """

    def __init__(self, artifact: str | None, listen: str,
                 next_hop: str | None, *, codec: str = "raw",
                 overlap: bool = True, rx_depth: int = 8,
                 tx_depth: int = 8, inflight: int = 2,
                 fan_in: int = 1, replica: int | None = None,
                 fan_mode: str = "rr", branch: int | None = None,
                 join_in: int = 0,
                 infer_delay_s: float = 0.0, tier: str = "tcp",
                 tier_accept: bool = True, device=None,
                 failover: bool = False, failover_grace_s: float = 30.0,
                 persist: bool = False):
        self.tier = _check_tier(tier, "StageNode")
        self.tier_accept = bool(tier_accept)
        self.device = _pin_device(device)
        self.next_hops = _parse_hops(next_hop) if next_hop else None
        self.replica = None if replica is None else int(replica)
        self.fan_in = max(1, int(fan_in))
        if fan_mode not in ("rr", "broadcast"):
            raise ValueError(f"fan_mode must be rr|broadcast, "
                             f"got {fan_mode!r}")
        self.fan_mode = fan_mode
        self.branch = None if branch is None else int(branch)
        self.join_in = max(0, int(join_in))
        if self.join_in == 1:
            raise ValueError("join_in must be 0 or >= 2 (a single-path "
                             "join is a plain unicast hop)")
        if self.join_in >= 2 and self.fan_in > 1:
            raise ValueError("a node cannot be both a branch join and a "
                             "replica fan-in (the two merges own "
                             "different sequence namespaces)")
        self._check_tier_pin()
        # bind before the slow part of the boot (the CUDA context and the
        # artifact load), so upstream connect-retries land as soon as the
        # process exists; ``bound_at`` (wall clock) marks the bind for a
        # spawner that times a respawn's boot
        host, port = _parse_hostport(listen, "0.0.0.0")
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self.bound_at = time.time()
        if self.device.type == "cuda":
            # the CUDA context and libraries, made before the bind is
            # announced: chain processes boot theirs in parallel, not at
            # their deploy turn or their first frame
            _warm_cuda(self.device)
        from ..utils.export import load_stage_program
        self.prog = None
        if artifact is not None:
            self.prog = load_stage_program(artifact, device=self.device)
        self.codec = codec
        self.overlap = overlap
        self.rx_depth = rx_depth
        self.tx_depth = tx_depth
        self.inflight = max(1, inflight)
        self.infer_delay_s = max(0.0, float(infer_delay_s))
        self.failover = bool(failover)
        self.failover_grace_s = float(failover_grace_s)
        self.persist = bool(persist)
        #: fan-in state: the reorder merge shared by the upstream reader
        #: connections and the one compute loop (lazy, lock-guarded), the
        #: live upstream connections the ack plane writes to, and the
        #: registration epoch a respawned upstream's dial-in bumps (which
        #: cancels the grace timer)
        self._merge: FanInMerge | None = None
        self._merge_lock = threading.Lock()
        #: join state: the (path, seq) reorder buffer shared by the P path
        #: readers and the one join compute loop (lazy, under _merge_lock)
        self._join: BranchJoin | None = None
        self._fanin_conns: list | None = None
        self._fanin_epoch = 0
        #: duplicates the last finished merge segment dropped
        self._merge_dups = 0
        self.tier_out: str | None = None
        self.tier_in: str | None = None
        #: outbound offers that degraded to tcp (this hop's fallback twin)
        self.tier_fallbacks = 0
        self.processed = 0    # tensors relayed, lifetime
        self.reweights = 0    # weights-only re-pushes accepted
        #: analytic capacity of the deployed stage, shipped by the
        #: dispatcher in the deploy message (FLOPs and HBM bytes at the
        #: deploy batch): what the live MFU divides by.  None until a
        #: deploy carries them (a node with no dispatcher reports no MFU)
        self.stage_flops: float | None = None
        self.stage_bytes_moved: float | None = None
        #: the card's peak FLOP/s, probed once: 0.0 = probed and unknown
        #: (MFU stays None, never a number against a guessed peak)
        self._peak_flops_s: float | None = None
        #: the active profile_start session; None between sessions
        self._profile = None
        #: push subscriptions (one ObsReporter per obs_subscribe) and the
        #: per-subscriber watermark splitter (lazy, under _WM_LOCK)
        self._reporters: list[ObsReporter] = []
        self._wm_split: WatermarkSplit | None = None
        #: waterfall sampling period carried by the trace context (0 =
        #: every frame records spans, N >= 1 = only wire-seq multiples)
        self.trace_sample_every = 0
        #: trace-context K_CTRL received from upstream, held until this
        #: node opens its downstream connection so the context cascades
        #: hop by hop through the whole chain
        self._pending_trace: dict | None = None
        self._done_q: queue.Queue | None = None
        #: live data-path channels (set once a connection proves to be
        #: the stream)
        self._live_rx = None
        self._live_tx = None
        #: per-NODE histograms (the registry's ``node.*_s`` twins are
        #: process-wide, shared by in-process thread chains): the infer
        #: interval and its four phases — dispatch (the program call
        #: returning), queue (residency in the un-synced window), device
        #: (the CUDA event's wait), host_sync (the copy to the host)
        self.infer_hist = LatencyHistogram()
        self.disp_hist = LatencyHistogram()
        self.queue_hist = LatencyHistogram()
        self.dev_hist = LatencyHistogram()
        self.host_sync_hist = LatencyHistogram()

    @property
    def manifest(self):
        return None if self.prog is None else self.prog.manifest

    @property
    def next_hop(self) -> tuple[str, int] | None:
        """The first downstream hop (``next_hops`` holds every replica)."""
        return self.next_hops[0] if self.next_hops else None

    @next_hop.setter
    def next_hop(self, value: tuple[str, int] | None) -> None:
        self.next_hops = None if value is None else [value]

    def _check_tier_pin(self) -> None:
        """Refuse an explicit colocated-tier pin (shm/ici/local) on a node
        whose hop rides the ordered fan machinery (a replica into a fan-in,
        a labeled branch into a join, a fan-out or a fork): those paths are
        wire-framed, so the offer would be skipped and the hop would run
        over tcp under a tier claim.  ``auto`` stays allowed (riding tcp
        there is policy)."""
        if self.tier not in ("shm", "ici", "local"):
            return
        role = ("replica" if self.replica is not None
                else "branch" if self.branch is not None
                else "fan-out" if self.next_hops
                and len(self.next_hops) > 1 else None)
        if role is not None:
            raise ValueError(
                f"tier {self.tier!r} pinned on a {role} node; fan paths "
                f"ride tcp (drop the replicas/branching or the tier pin)")

    def set_device(self, device) -> None:
        """Pin this node's stage program to ``device`` (``cuda:J``, a bare
        index ``J``, ``cpu``): its outputs live there, and an upstream ici
        hop moves each activation onto it before the program runs.
        Applied to a loaded program at once; an in-band deploy applies it
        at load."""
        self.device = _pin_device(device)
        if self.device.type == "cuda":
            _warm_cuda(self.device)
        if self.prog is not None:
            self.prog.place(self.device)

    def _span_label(self) -> str:
        """The prefix of this node's spans and events; a replica's is
        ``stageK.rN``, a branch-path node's ``stageK.bJ``."""
        m = self.manifest
        base = (f"stage{m['index']}" if m is not None
                else f"node{self.address[1]}")
        if self.replica is not None:
            return f"{base}.r{self.replica}"
        if self.branch is not None:
            return f"{base}.b{self.branch}"
        return base

    # -- the four phases of a frame ------------------------------------------

    def _phase(self, hist, name: str, t0: float, t_end: float, seq) -> None:
        dt = t_end - t0
        REGISTRY.histogram(f"node.{name}_s").record(dt)
        hist.record(dt)
        tr = tracer()
        if tr.enabled and _sampled(self.trace_sample_every, seq):
            tr.record(f"{self._span_label()}.{name}", t0, dt,
                      {} if seq is None else {"seq": seq})

    def _dispatch(self, *xs, seq=None):
        """Run the stage program on its input (a join: its P inputs) and
        time the DISPATCH phase: the call returning (on the card the
        kernels are queued, not done).
        Returns ``(t0, t_end, (y, event))``: ``t0`` anchors the frame's
        ``infer`` interval, ``t_end`` seeds the QUEUE phase, and the CUDA
        event (None on the CPU) marks the end of this frame's work."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # the hand kernels launch on the thread's current card
            with torch.cuda.device(self.device):
                y = self.prog(*xs)
        else:
            y = self.prog(*xs)
        ev = None
        if y.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(y.device))
        t_end = time.perf_counter()
        self._phase(self.disp_hist, "dispatch", t0, t_end, seq)
        return t0, t_end, (y, ev)

    def _queue_wait(self, t_end, seq=None):
        """The frame's residency in the un-synced window (dispatch
        returned -> its drain turn), as the QUEUE phase.  Returns the
        phase's end, the next phase's start."""
        t_now = time.perf_counter()
        self._phase(self.queue_hist, "queue", t_end, t_now, seq)
        return t_now

    def _device_wait(self, ev, seq=None, t0=None):
        """Wait for the frame's CUDA event as the DEVICE phase (device
        compute plus whatever queued ahead of it).  No-op on the CPU,
        where the program ran synchronously.  Returns the phase's end."""
        if t0 is None:
            t0 = time.perf_counter()
        if ev is None:
            return t0
        ev.synchronize()
        t_end = time.perf_counter()
        self._phase(self.dev_hist, "device", t0, t_end, seq)
        return t_end

    def _host_sync(self, y, seq=None, t0=None, out=None):
        """Sync the frame (:meth:`_device_wait`), then copy the output to
        the host as the HOST_SYNC phase: into ``out`` (a CPU tensor, a shm
        slot) when given, else into a numpy array, or a bfloat16 tensor
        (numpy has no bfloat16; the framed transport sends it as such).
        Device-resident (ici) hops never call this, so their zero sample
        count shows the host round trip is gone.  Returns ``(out,
        t_end)``; the loops close the ``infer`` interval at ``t_end`` so
        the four phases tile it."""
        y, ev = y
        t0 = self._device_wait(ev, seq=seq, t0=t0)
        if out is not None:
            out.copy_(y)
        else:
            out = y.cpu()
            if out.dtype != torch.bfloat16:
                out = out.numpy()
        t_end = time.perf_counter()
        self._phase(self.host_sync_hist, "host_sync", t0, t_end, seq)
        return out, t_end

    def _infer_done(self, t0, t_done, seq, label_seq) -> None:
        dt = t_done - t0
        REGISTRY.histogram("node.infer_s").record(dt)
        self.infer_hist.record(dt)
        tr = tracer()
        if tr.enabled and _sampled(self.trace_sample_every, seq):
            tr.record(f"{self._span_label()}.infer", t0, dt,
                      {"seq": label_seq if seq is None else seq,
                       "stage": self.manifest["index"]})

    def _check_frame(self, value) -> None:
        m = self.manifest
        want = tuple(m["in_shape"])
        if tuple(value.shape[1:]) != want:
            raise ValueError(
                f"stage {m['index']} expects sample shape {want}, got "
                f"{tuple(value.shape[1:])}")
        if value.shape[0] != m["batch"]:
            raise ValueError(
                f"stage {m['index']} was exported at batch {m['batch']}, "
                f"got a frame of {value.shape[0]}")

    def _make_tx(self, connect_timeout_s: float):
        """Open the downstream connection(s): ``(sender, sockets)``.

        One next hop: with a ``tier`` other than tcp the hop walks the
        tier ladder (``transport.shm.offer_tier_ladder``, shared with the
        dispatcher's first edge) and takes the first rung granted: its
        sender replaces the wire, and the socket stays open as the hop's
        lifetime anchor (and, on shm, its doorbell).  Every rung refused,
        the hop rides tcp with this hop's one fallback counted.  Either way
        a ``tier`` event names the outcome.  A replica never probes: its
        hop into the fan-in is wire-framed, and the reverse direction of
        its socket carries the ack plane; it announces itself with a
        ``stream_begin``, so the fan-in registers it at once.

        R next hops (a replicated downstream stage): a
        :class:`FanOutSender`, or a :class:`ReplayFanOut` under
        ``failover``, on tcp, announced with a ``stream_begin`` so that a
        replica that gets no frame still knows it is on the data path.
        With ``fan_mode="broadcast"`` (a fork) the P next hops are the
        paths of a branch region instead: a :class:`BroadcastSender` sends
        every frame to all of them, each channel announced with its path.
        A branch-path node never probes either (the join end is the
        wire-framed (path, seq) merge), and announces its path first.

        The pending trace context goes ahead of the first tensor."""
        if not self.next_hops:
            raise ValueError("no next hop configured")
        socks = [connect_retry(*h, timeout_s=connect_timeout_s)
                 for h in self.next_hops]
        tx = None
        if len(socks) > 1 and self.fan_mode == "broadcast":
            # every parallel branch receives every frame, stamped with one
            # shared sequence number; channel i is path i of the region
            self.tier_out = "tcp"
            tx = BroadcastSender(socks, depth=self.tx_depth,
                                 codec=self.codec,
                                 gauge="node.tx_queue_depth",
                                 span=self._span_label, hist="node.tx_s")
        elif len(socks) > 1:
            self.tier_out = "tcp"
            if self.failover:
                # retain each frame until the fan-in's cumulative ack;
                # heal a dead replica channel by redialing its address
                # (the supervisor respawns it on the same port) and
                # replaying the unacked window
                tx = ReplayFanOut(socks, self.next_hops,
                                  depth=self.tx_depth, codec=self.codec,
                                  gauge="node.tx_queue_depth",
                                  span=self._span_label, hist="node.tx_s",
                                  redial_timeout_s=connect_timeout_s)
            else:
                tx = FanOutSender(socks, depth=self.tx_depth,
                                  codec=self.codec,
                                  gauge="node.tx_queue_depth",
                                  span=self._span_label, hist="node.tx_s")
            tx.send_ctrl({"cmd": "stream_begin"})
        elif self.tier != "tcp" and self.replica is None \
                and self.branch is None:
            self.tier_out, tx, fell_back = offer_tier_ladder(
                socks[0], tier=self.tier, depth=self.tx_depth,
                hop=self._span_label(), device=self.device)
            if fell_back:
                self.tier_fallbacks += 1
            emit_event("tier", hop=self._span_label(), tier=self.tier_out,
                       wanted=self.tier, fallback=bool(fell_back))
        if tx is None:
            self.tier_out = "tcp"
            tx = AsyncSender(socks[0], depth=self.tx_depth,
                             codec=self.codec, gauge="node.tx_queue_depth",
                             span=self._span_label, hist="node.tx_s")
            if self.replica is not None:
                tx.send_ctrl({"cmd": "stream_begin"})
            elif self.branch is not None:
                # this connection's join path, before any frame, so the
                # downstream join can slot it (a non-join downstream
                # ignores the label)
                tx.send_ctrl({"cmd": "stream_begin", "path": self.branch})
        tx.sample_every = self.trace_sample_every
        self._live_tx = tx
        if self._pending_trace is not None:
            tx.send_ctrl(self._pending_trace)
        return tx, socks

    # -- the ack plane of failover -------------------------------------------

    def _start_ack_relay(self, up_conn, down_sock, lock) -> None:
        """The replica's half of the ack plane: read the fan-in's
        cumulative ``replay_ack`` frames off the reverse direction of the
        outbound socket and forward each one hop upstream on this
        replica's inbound connection.  ``lock`` serializes those writes
        with the stream-end ``replay_done``; the thread ends with either
        socket."""

        def relay():
            try:
                while True:
                    kind, value = recv_frame(down_sock)
                    if kind == K_END:
                        return
                    if kind == K_CTRL and isinstance(value, dict) \
                            and value.get("cmd") == "replay_ack":
                        with lock:
                            send_ctrl(up_conn, value)
            except (OSError, ConnectionError, ValueError):
                return

        threading.Thread(target=relay, daemon=True,
                         name="node-ack-relay").start()

    def _fanin_ack(self, merge) -> None:
        """The fan-in's half of the ack plane: one cumulative
        ``replay_ack`` (every seq below it merged in order) on each live
        upstream connection.  A connection whose write fails leaves the
        ack set; its reader sees the death itself."""
        with self._merge_lock:
            conns = list(self._fanin_conns or ())
        upto = merge.next_seq
        for c in conns:
            try:
                send_ctrl(c, {"cmd": "replay_ack", "seq": upto})
            except OSError:
                self._fanin_forget(c)

    def _fanin_forget(self, conn) -> None:
        with self._merge_lock:
            if self._fanin_conns and conn in self._fanin_conns:
                self._fanin_conns.remove(conn)

    def _fanin_grace(self, merge, exc: BaseException) -> None:
        """Fail ``merge`` with ``exc`` after ``failover_grace_s`` unless a
        fresh upstream registers meanwhile (the respawned replica's dial-in
        bumps ``_fanin_epoch``) or the segment completes: failover with a
        bounded hang."""
        with self._merge_lock:
            epoch = self._fanin_epoch

        def watch():
            deadline = time.monotonic() + self.failover_grace_s
            while time.monotonic() < deadline:
                with self._merge_lock:
                    if self._fanin_epoch != epoch \
                            or self._merge is not merge:
                        return
                time.sleep(0.1)
            with self._merge_lock:
                expired = (self._merge is merge
                           and self._fanin_epoch == epoch)
            if expired:
                merge.fail(exc)

        threading.Thread(target=watch, daemon=True,
                         name="node-failover-grace").start()

    # -- control plane --------------------------------------------------------

    def _deploy(self, msg: dict, blob: bytes) -> None:
        """Apply a ``deploy`` message: check the roles it names (the
        replica roles ``fan_in``/``replica``, the branch roles ``fan``,
        ``branch``, ``join``), load the artifact onto this node's device,
        then take the roles."""
        if msg.get("fan") and msg["fan"] not in ("rr", "broadcast"):
            raise ValueError(f"deploy: fan must be rr|broadcast, "
                             f"got {msg['fan']!r}")
        join = int(msg["join"]) if msg.get("join") else None
        if join is not None:
            if join < 2:
                raise ValueError(f"deploy: join must be >= 2, got {join}")
            if max(self.fan_in, int(msg.get("fan_in") or 1)) > 1:
                raise ValueError("deploy: a node cannot be both a branch "
                                 "join and a replica fan-in")
        tier = msg.get("tier")
        if tier:
            _check_tier(tier, "deploy")
        nxt = _parse_hops(msg["next"]) if msg.get("next") else None
        if msg.get("device") is not None:
            self.device = _pin_device(msg["device"])
        from ..utils.export import load_stage_program
        self.prog = load_stage_program(blob, device=self.device)
        if nxt is not None:
            self.next_hops = nxt
        if msg.get("fan_in"):
            self.fan_in = max(1, int(msg["fan_in"]))
        if msg.get("replica") is not None:
            self.replica = int(msg["replica"])
        if msg.get("fan"):
            self.fan_mode = msg["fan"]
        if msg.get("branch") is not None:
            self.branch = int(msg["branch"])
        if join is not None:
            self.join_in = join
        if msg.get("codec"):
            self.codec = msg["codec"]
        if tier:
            self.tier = tier
        if msg.get("tier_accept") is not None:
            self.tier_accept = bool(msg["tier_accept"])
        if msg.get("infer_delay_ms") is not None:
            self.infer_delay_s = max(0.0,
                                     float(msg["infer_delay_ms"]) / 1e3)
        if msg.get("flops") is not None:
            self.stage_flops = float(msg["flops"])
        if msg.get("bytes_moved") is not None:
            self.stage_bytes_moved = float(msg["bytes_moved"])
        self._check_tier_pin()

    def _handle_ctrl(self, conn, msg: dict, recv=None) -> bool:
        """One control command; True if the connection should keep
        serving.

        ``recv`` supplies the follow-up frame of multi-frame commands
        (deploy/reweight blobs); the overlapped loop passes its rx-queue
        getter because the channel's rx thread owns all socket reads.

        deploy:   {"cmd": "deploy", "next": "host:port", "codec": ...}
                  followed by a K_BYTES artifact blob -> load, ACK (the
                  in-band analogue of the reference's weights+arch sockets
                  and \\x06 ACK, src/dispatcher.py:44-65).
        reweight: {"cmd": "reweight"} followed by a K_BYTES npz blob ->
                  swap the loaded program's weights, ACK.
        trace:    adopt the dispatcher's trace context and cascade it
                  downstream when the data connection opens (no ACK).
        trace_dump: reply with (and drain) this process's spans.
        clock_probe: reply with this process's tracer-timeline "now"
                  (``{"cmd": "clock_probe_reply", "t_us", "echo"}``), one
                  leg of the min-RTT offset estimator (obs/cluster.py).
        clock_adjust: ``{"offset_us": d}`` -> shift the tracer's wall
                  anchor (buffered spans and events included), ACK.
        obs_subscribe: ``{"interval_ms", "spans", "span_limit"}`` -> push
                  ``obs_push`` frames back on THIS connection every
                  interval until it closes (obs/report.py).  The
                  subscriber sends nothing more on it but its final END.
        events_since: reply with the flight recorder's events since a
                  cursor.
        profile_start: open a profiling window (obs/profile.py; with
                  ``trace_dir``, a ``torch.profiler`` trace too); a second
                  start is refused with a ``profile_err`` reply.
        profile_stop: close it and reply with its ``profile_report``.
        stats:    reply with what this node is and has done.
        quiesce:  reply once this node's data plane is drained.
        shutdown: ACK; a persistent node leaves its serve loop.
        """
        def _expect(kind):
            if recv is None:
                return recv_expect(conn, kind)
            got, value = recv()
            if got != kind:
                raise ConnectionError(
                    f"expected frame kind {kind}, got {got}")
            return value

        cmd = msg.get("cmd")
        if cmd == "deploy":
            self._deploy(msg, _expect(K_BYTES))
            send_ack(conn)
            return True
        if cmd == "reweight":
            if self.prog is None:
                raise ValueError("reweight before deploy")
            self.prog.reweight(_expect(K_BYTES))
            self.reweights += 1
            send_ack(conn)
            return True
        if cmd == "trace":
            tr = tracer()
            tr.adopt(msg)
            m = self.manifest
            tr.process = (f"stage{m['index']}" if m is not None
                          else f"node:{self.address[1]}")
            self._pending_trace = dict(msg)
            # waterfall sampling rides the trace context: every process
            # of the chain samples the SAME 1-in-N wire sequences
            self.trace_sample_every = int(msg.get("sample_every", 0) or 0)
            for ch in (self._live_rx, self._live_tx):
                if ch is not None:
                    ch.sample_every = self.trace_sample_every
            return True
        if cmd == "clock_probe":
            send_ctrl(conn, {"cmd": "clock_probe_reply",
                             "t_us": tracer().now_us(),
                             "echo": msg.get("echo")})
            return True
        if cmd == "clock_adjust":
            tracer().shift_wall_anchor(int(msg.get("offset_us", 0)))
            REGISTRY.gauge("clock.offset_us").inc(
                float(msg.get("offset_us", 0)))
            send_ack(conn)
            return True
        if cmd == "obs_subscribe":
            rep = ObsReporter(
                self, conn,
                interval_s=float(msg.get("interval_ms", 250.0)) / 1e3,
                spans=bool(msg.get("spans", True)),
                span_limit=int(msg.get("span_limit", 256)))
            self._reporters = [r for r in self._reporters
                               if r.is_alive()] + [rep]
            rep.start()
            return True
        if cmd == "profile_start":
            return self._profile_start(conn, msg)
        if cmd == "profile_stop":
            return self._profile_stop(conn)
        if cmd == "events_since":
            rec = recorder()
            cursor, evs = rec.events_since(int(msg.get("cursor", 0)),
                                           limit=int(msg.get("limit", 512)))
            send_ctrl(conn, {"cmd": "events_reply", "events": evs,
                             "cursor": cursor, "dropped": rec.dropped})
            return True
        if cmd == "trace_dump":
            tr = tracer()
            send_ctrl(conn, {"spans": tr.drain()})
            # the trace is over once collected: stop recording so a node
            # that later serves untraced streams doesn't accumulate spans
            tr.enabled = False
            tr._remote_parent = None
            self._pending_trace = None
            return True
        if cmd == "stats":
            send_ctrl(conn, self._stats(msg))
            return True
        if cmd == "quiesce":
            at = msg.get("at_seq")
            processed = self._quiesce(None if at is None else int(at),
                                      float(msg.get("timeout_s", 30.0)))
            emit_event("quiesce", hop=self._span_label(),
                       processed=processed)
            send_ctrl(conn, {"cmd": "quiesced", "processed": processed})
            return True
        if cmd == "shutdown":
            # a persistent node exits its serve loop; a one-shot node
            # ACKs harmlessly (its serve returns at stream end anyway)
            send_ack(conn)
            if self._done_q is not None:
                self._done_q.put(_SHUTDOWN)
            return True
        raise ValueError(f"unknown control command {msg!r}")

    def _stats(self, msg: dict) -> dict:
        """The ``stats`` reply: every key of the JAX node's, plus
        ``kernel_launches`` (each hand kernel's launches in this process —
        how a multi-process chain shows its stages ran them)."""
        m = self.manifest
        reg = REGISTRY
        rx, tx = self._live_rx, self._live_tx
        rec = recorder()
        _, evs = rec.events_since(int(msg.get("event_cursor", 0)),
                                  limit=int(msg.get("event_limit", 256)))
        cap = self._capacity()
        return {
            "stage": None if m is None else m["index"],
            "name": None if m is None else m["name"],
            "replica": self.replica,
            "branch": self.branch,
            "join": self.join_in,
            "fan_in": self.fan_in,
            "processed": self.processed,
            "reweights": self.reweights,
            "codec": self.codec,
            # the negotiated outbound tier (the policy until a data path
            # opens) and this hop's degraded offers
            "tier": self.tier_out or self.tier,
            "tier_in": self.tier_in,
            "tier_fallbacks": self.tier_fallbacks,
            "device": str(self.device),
            # an ici outbound hop's cross-device moves and their pairs
            "ici_d2d": tx.d2d if isinstance(tx, IciSender) else 0,
            "ici_device_pairs": (sorted([list(p) for p in tx.device_pairs])
                                 if isinstance(tx, IciSender) else []),
            "next": (None if not self.next_hops
                     else ",".join(f"{h}:{p}" for h, p in self.next_hops)),
            "tx_frames": reg.counter("transport.tx_frames").value,
            "tx_bytes": reg.counter("transport.tx_bytes").value,
            "rx_frames": reg.counter("transport.rx_frames").value,
            "rx_bytes": reg.counter("transport.rx_bytes").value,
            "infer_latency_s": self.infer_hist.summary(),
            "host_sync_s": self.host_sync_hist.summary(),
            "dispatch_s": self.disp_hist.summary(),
            "queue_s": self.queue_hist.summary(),
            "device_s": self.dev_hist.summary(),
            # run-time compilations in this process (graph captures,
            # artifact loads, kernel builds; obs/profile.py) and the
            # caching allocator's live bytes on this node's card (None on
            # the CPU)
            "recompiles": REGISTRY.counter("compiles").value,
            "mem_bytes": device_memory_bytes(device=self.device),
            "profiling": self._profile is not None,
            "rx_s": reg.histogram("node.rx_s").summary(),
            "tx_s": reg.histogram("node.tx_s").summary(),
            "encode_latency_s": (tx.enc.summary() if tx is not None else
                                 reg.histogram("codec.encode_s").summary()),
            "decode_latency_s": (rx.dec.summary() if rx is not None else
                                 reg.histogram("codec.decode_s").summary()),
            "overlap": self.overlap,
            "rx_queue_depth": reg.gauge("node.rx_queue_depth").value,
            "tx_queue_depth": reg.gauge("node.tx_queue_depth").value,
            "rx_depth": self.rx_depth,
            "tx_depth": self.tx_depth,
            "rx_watermark": self._chan_hi(rx),
            "tx_watermark": self._chan_hi(tx),
            "inflight": reg.gauge("node.inflight").value,
            # capacity accounting (obs/capacity.py): the deploy's stage
            # FLOPs over the measured infer p50, and MFU against THIS
            # card's peak (None without a deployed capacity or a known
            # generation)
            "flops": self.stage_flops,
            "mfu": cap.get("mfu"),
            "achieved_flops_s": cap.get("achieved_flops_s"),
            # the seq-replay plane: channels healed, frames retained for
            # replay, duplicates the fan-in dropped in its window
            "failovers": getattr(tx, "failovers", 0),
            "replay_depth": (tx.replay_depth()
                             if isinstance(tx, ReplayFanOut) else 0),
            "merge_duplicates": (self._merge_dups if self._merge is None
                                 else self._merge.duplicates),
            "events": {"dropped": rec.dropped, "events": evs},
            "kernel_launches": _kernel_launches(),
        }

    @staticmethod
    def _chan_hi(chan) -> int:
        """Peek a channel's occupancy watermark without resetting it."""
        if chan is None:
            return 0
        return max(int(chan.hi), chan.qsize())

    # -- live observability -------------------------------------------------

    def _profile_start(self, conn, msg: dict) -> bool:
        """Open a profiling window.  A double start is refused loudly (an
        error reply, the connection kept): restarting silently would
        corrupt the first caller's window arithmetic."""
        if self._profile is not None:
            send_ctrl(conn, {
                "cmd": "profile_err",
                "error": "profile session already active on this node "
                         "(profile_stop it first)"})
            return True
        # the session marks warm-up done: arm the one-event-per-episode
        # recompile emitter and prime the memory gauge
        recompile_watcher().arm()
        memory_watcher().observe(self.device)
        sess = ProfileSession(
            {"dispatch": self.disp_hist, "queue": self.queue_hist,
             "device": self.dev_hist, "host_sync": self.host_sync_hist,
             "infer": self.infer_hist},
            processed=lambda: self.processed, launches=_kernel_launches,
            trace_dir=msg.get("trace_dir") or None, device=self.device)
        started = sess.start()
        self._profile = sess
        send_ctrl(conn, {"cmd": "profile_started",
                         "node": self._span_label(), **started})
        return True

    def _profile_stop(self, conn) -> bool:
        if self._profile is None:
            send_ctrl(conn, {
                "cmd": "profile_err",
                "error": "no active profile session on this node "
                         "(profile_start first)"})
            return True
        report = self._profile.stop()
        self._profile = None
        report["node"] = self._span_label()
        m = self.manifest
        report["stage"] = None if m is None else m["index"]
        report["replica"] = self.replica
        send_ctrl(conn, {"cmd": "profile_report", "report": report})
        return True

    def _capacity(self) -> dict:
        """Live MFU accounting for stats and pushes: the deploy message's
        analytic stage FLOPs against this node's measured infer p50 and
        its OWN card's peak.  Empty when no deploy shipped capacity;
        ``mfu`` is None, never a number, when the card's generation has no
        peak (``utils/hw.py``)."""
        if self.stage_flops is None:
            return {}
        if self._peak_flops_s is None:
            from ..utils import hw
            self._peak_flops_s = hw.peak_flops(hw.identify_chip(self.device))
        hist = self.infer_hist
        p50 = hist.quantile(0.5) if hist.count else 0.0
        return {
            "flops": self.stage_flops,
            "bytes_moved": self.stage_bytes_moved,
            "achieved_flops_s": (self.stage_flops / p50
                                 if p50 > 0 else None),
            "mfu": achieved_mfu(self.stage_flops, p50, self._peak_flops_s),
        }

    def _wm(self) -> WatermarkSplit:
        with _WM_LOCK:
            if self._wm_split is None:
                self._wm_split = WatermarkSplit()
            return self._wm_split

    def obs_register(self, sid: int) -> None:
        """Register a push subscriber with the watermark splitter (one per
        :class:`ObsReporter`)."""
        self._wm().register(sid)

    def obs_unregister(self, sid: int) -> None:
        self._wm().unregister(sid)

    def obs_snapshot(self, *, cursor: int = 0, include_spans: bool = True,
                     span_limit: int = 256, subscriber: int | None = None,
                     event_cursor: int = 0, event_limit: int = 128
                     ) -> tuple[dict, int, int]:
        """One ``obs_push`` payload (the JAX node's keys): identity,
        lifetime counters, queue depths and per-interval watermarks,
        cumulative latency summaries, capacity, compile and memory
        telemetry, the flight recorder's events since ``event_cursor``
        and, when tracing is live, the spans recorded since ``cursor``
        (without draining what ``trace_dump`` collects).  Runs on the
        reporter's thread; everything read is an attribute or a registry
        instrument, so the hot path never waits on it.

        Watermarks are reset-on-read at the channel but split per
        ``subscriber`` (:class:`WatermarkSplit`): every subscription sees
        the true peak since its own last push."""
        m = self.manifest
        reg = REGISTRY
        rx, tx = self._live_rx, self._live_tx
        merge = self._merge if self._merge is not None else self._join
        payload = {
            "node": {"stage": None if m is None else m["index"],
                     "name": None if m is None else m["name"],
                     "replica": self.replica, "branch": self.branch,
                     "join": self.join_in, "fan_in": self.fan_in,
                     "port": self.address[1], "codec": self.codec,
                     "tier": self.tier_out or self.tier,
                     "tier_in": self.tier_in,
                     "tier_fallbacks": self.tier_fallbacks,
                     "device": str(self.device)},
            "processed": self.processed,
            "reweights": self.reweights,
            "counters": {
                "tx_frames": reg.counter("transport.tx_frames").value,
                "tx_bytes": reg.counter("transport.tx_bytes").value,
                "rx_frames": reg.counter("transport.rx_frames").value,
                "rx_bytes": reg.counter("transport.rx_bytes").value,
            },
            "queues": {
                "rx_depth": self.rx_depth, "tx_depth": self.tx_depth,
                "rx": rx.qsize() if rx is not None else 0,
                "tx": tx.qsize() if tx is not None else 0,
                "rx_hi": self._wm().take(subscriber, "rx", rx),
                "tx_hi": self._wm().take(subscriber, "tx", tx),
                "inflight": reg.gauge("node.inflight").value,
                "merge": merge.qsize() if merge is not None else 0,
                # retained-frame memory of a failover fan-out
                "replay": (tx.replay_depth()
                           if isinstance(tx, ReplayFanOut) else 0),
            },
            "latency": {
                "infer_s": self.infer_hist.summary(),
                "host_sync_s": self.host_sync_hist.summary(),
                "dispatch_s": self.disp_hist.summary(),
                "queue_s": self.queue_hist.summary(),
                "device_s": self.dev_hist.summary(),
                "rx_s": reg.histogram("node.rx_s").summary(),
                "tx_s": reg.histogram("node.tx_s").summary(),
                "encode_s": (tx.enc.summary() if tx is not None
                             else reg.histogram("codec.encode_s").summary()),
                "decode_s": (rx.dec.summary() if rx is not None
                             else reg.histogram("codec.decode_s").summary()),
            },
            "capacity": self._capacity(),
            "kernel_launches": _kernel_launches(),
        }
        # observe() updates the device.mem_bytes gauge and runs the
        # mem_pressure check: push cadence, never the frame hot path
        payload["recompiles"] = reg.counter("compiles").value
        payload["mem_bytes"] = memory_watcher().observe(self.device)
        tr = tracer()
        trace_doc: dict = {"dropped": tr.dropped}
        if include_spans and tr.enabled:
            cursor, spans = tr.spans_since(cursor, limit=span_limit)
            trace_doc["spans"] = spans
        payload["trace"] = trace_doc
        rec = recorder()
        event_cursor, evs = rec.events_since(event_cursor,
                                             limit=event_limit)
        payload["events"] = {"dropped": rec.dropped, "events": evs}
        return payload, cursor, event_cursor

    def _quiesce(self, at_seq: int | None, timeout_s: float) -> int:
        """Block until this node's data plane is drained and stable:
        ``processed`` past ``at_seq`` (when given) and unchanged across
        consecutive samples, no dispatch in flight, live queues and the
        reorder merge empty.
        Returns the stable processed count; TimeoutError if the node
        never settles."""
        deadline = time.monotonic() + timeout_s
        inflight_g = REGISTRY.gauge("node.inflight")
        last = -1
        while True:
            p = self.processed
            rx, tx = self._live_rx, self._live_tx
            merges = (self._merge, self._join)
            if ((at_seq is None or p >= at_seq) and p == last
                    and inflight_g.value == 0
                    and (rx is None or rx.qsize() == 0)
                    and (tx is None or tx.qsize() == 0)
                    and all(m is None or m.qsize() == 0 for m in merges)):
                return p
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"quiesce: node did not stabilize within "
                    f"{timeout_s:.1f}s (processed {p}, at_seq {at_seq})")
            last = p
            time.sleep(0.05)

    # -- serving ----------------------------------------------------------------

    def serve(self, *, connect_timeout_s: float = 30.0) -> int:
        """Serve control/data connections until a data stream completes.

        Connections are handled concurrently (a thread per connection):
        control connections (deploy / reweight / stats ..., each ending
        with the peer's END) may arrive before or during the upstream data
        stream, which is relayed through the stage program until its END
        frame.  Returns the number of tensors the completed data stream
        processed (a ``persist`` node: the total over its segments, once a
        ``shutdown`` command arrives).  The END is forwarded downstream
        before closing, so shutdown cascades through the chain to the
        dispatcher's result server.
        """
        done: queue.Queue = queue.Queue()
        self._done_q = done

        def worker(conn):
            try:
                configure_socket(conn)
                n = self._serve_conn(conn, connect_timeout_s)
                if n is not None:
                    done.put(n)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                done.put(e)
            finally:
                conn.close()

        total = 0
        self._srv.settimeout(0.25)
        try:
            while True:
                try:
                    conn, _ = self._srv.accept()
                except TimeoutError:
                    conn = None
                if conn is not None:
                    threading.Thread(target=worker, args=(conn,),
                                     daemon=True).start()
                try:
                    r = done.get_nowait()
                except queue.Empty:
                    continue
                if r is _SHUTDOWN:
                    return total
                if isinstance(r, BaseException):
                    raise r
                if not self.persist:
                    return r
                total += r
        finally:
            self._srv.close()

    def _serve_conn(self, conn, connect_timeout_s: float) -> int | None:
        """One connection: None if it was control-only, else its tensor
        count.  ``overlap=True`` runs the three-phase overlapped loop,
        ``overlap=False`` the strictly serial baseline.  With ``fan_in >
        1`` every connection instead feeds the shared reorder merge
        (:meth:`_serve_conn_fanin`) and one compute loop consumes the
        merged in-order stream; with ``join_in >= 2`` the connections feed
        the (path, seq) join (:meth:`_serve_conn_join`) and the join's
        compute loop runs the P-input program."""
        if self.join_in >= 2:
            return self._serve_conn_join(conn, connect_timeout_s)
        if self.fan_in > 1:
            return self._serve_conn_fanin(conn, connect_timeout_s)
        if self.overlap:
            return self._serve_conn_overlapped(conn, connect_timeout_s)
        return self._serve_conn_serial(conn, connect_timeout_s)

    def _relay(self, tx, t0, t_end, s, y, relay_seq) -> None:
        """Finish the oldest un-synced frame and send it downstream: its
        QUEUE phase, then on an ici hop the DEVICE wait alone (the tensor
        stays on the card), on a shm hop one copy from the card straight
        into the ring's slot, else the copy to the host; the frame's
        ``infer`` interval; the send, stamped ``relay_seq``."""
        slot = None
        if isinstance(tx, ShmSender):
            # a full ring parks here, inside the frame's QUEUE phase
            slot = tx.claim(y[0].numel() * y[0].element_size())
        tq = self._queue_wait(t_end, seq=relay_seq)
        if isinstance(tx, IciSender):
            # device-resident hop: the output is synced (bounding the
            # window) but never copied to the host; the downstream program
            # reads the tensor where it lies.  Node programs run eagerly,
            # so the tensor is a fresh allocation no later frame
            # overwrites — a node that replays its program from a
            # CUDA-graph pool must copy its output here.
            t_done = self._device_wait(y[1], seq=relay_seq, t0=tq)
            out = y[0]
        elif slot is not None:
            # one device-to-host copy, straight into the ring's slot
            view = tx.slot_tensor(slot, y[0])
            _, t_done = self._host_sync(y, seq=relay_seq, t0=tq, out=view)
            del view
            out = y[0]
        else:
            out, t_done = self._host_sync(y, seq=relay_seq, t0=tq)
        self._infer_done(t0, t_done, relay_seq, s)
        self.processed += 1  # before the send: a stats query can race
        #   the relay of the final tensor otherwise
        if slot is not None:
            tx.commit(slot, out, seq=relay_seq)
        else:
            tx.send(out, seq=relay_seq)

    def _serve_conn_overlapped(self, conn,
                               connect_timeout_s: float) -> int | None:
        """Three-phase overlap: rx thread -> compute loop -> tx thread.

        An :class:`AsyncReceiver` decodes upstream frames into a bounded
        queue while this thread computes, and an :class:`AsyncSender`
        encodes and sends relayed tensors from a bounded queue, so the rx
        of frame j+1, the compute of j and the tx of j-1 run at once.  The
        compute loop keeps up to ``inflight`` programs un-synced on the
        card: the copy to the host of output j-1 overlaps the device
        compute of j.  Bounded queues keep end-to-end backpressure.

        Sequence-stamped frames (``K_TENSOR_SEQ``, this node a replica on
        a fan-out path) relay their sequence number onto the output frame
        unchanged, so the downstream fan-in can restore the stream's order.
        Under ``failover`` a replica relays the fan-in's acks upstream on
        this connection, and ends its stream with a ``replay_done``.
        """
        tx = out_socks = None
        n = 0                   # tensors relayed downstream
        seq = 0                 # tensors received
        streamed = False
        stream_marked = False   # upstream announced this conn as data path
        ended = False           # the stream ran to its END
        inflight_g = REGISTRY.gauge("node.inflight")
        #: issued-but-unsynced stage outputs, oldest first
        pending: collections.deque = collections.deque()
        # no gauge yet: most connections are short-lived control round
        # trips; the gauge is bound once this connection is the stream
        rx = AsyncReceiver(conn, depth=self.rx_depth,
                           span=self._span_label)
        # the replica's half of the ack plane: the lock serializes the
        # relayed acks with the stream-end replay_done on this connection
        ack_lock = threading.Lock()
        relay_on = False

        def open_tx():
            nonlocal tx, out_socks, relay_on
            tx, out_socks = self._make_tx(connect_timeout_s)
            if self.failover and self.replica is not None:
                relay_on = True
                self._start_ack_relay(conn, out_socks[0], ack_lock)

        def drain_one():
            nonlocal n, streamed
            entry = pending.popleft()
            inflight_g.dec()
            self._relay(tx, *entry)
            n += 1
            streamed = True

        try:
            while True:
                if pending:
                    # compute-ahead only while input is immediately
                    # available: an idle upstream means the window must
                    # drain NOW, or the stream's tail stalls in the node
                    try:
                        kind, value = rx.get_nowait()
                    except queue.Empty:
                        drain_one()
                        continue
                else:
                    kind, value = rx.get()
                if kind == K_END:
                    while pending:
                        drain_one()
                    if streamed or stream_marked:
                        if tx is None:
                            # marked data path with zero frames (fewer
                            # inputs than replicas, say): still propagate
                            # the stream, so the END cascades and a
                            # downstream fan-in counts this path's END
                            # (fan-outs, forks, replicas and branch paths
                            # announced themselves in _make_tx)
                            open_tx()
                            if not isinstance(tx, _FAN_SENDERS) \
                                    and self.replica is None \
                                    and self.branch is None:
                                tx.send_ctrl({"cmd": "stream_begin"})
                        # END + join: every relayed frame is on the wire
                        # before the finally block closes the socket
                        tx.close(timeout=connect_timeout_s)
                        if relay_on:
                            # every frame of this replica's segment went
                            # downstream: the upstream fan-out must read the
                            # coming EOF as shutdown, not death
                            try:
                                with ack_lock:
                                    send_ctrl(conn, {"cmd": "replay_done"})
                            except OSError:
                                pass
                        emit_event("stream_end", hop=self._span_label(),
                                   n=n)
                        ended = True
                        return n
                    return None  # control connection closing
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        stream_marked = True
                        continue
                    if cmd == "tier_probe":
                        # an ici/local grant swaps the data path to the
                        # offered in-process pipe (ici frames stay tensors
                        # on the card); a shm grant wraps this socket's
                        # channel (descriptors keep riding the socket,
                        # payloads come out of the ring); refused, the
                        # stream goes on on this socket
                        self.tier_in, chan = answer_tier_probe(
                            conn, value, accept=self.tier_accept,
                            inner=rx, depth=self.rx_depth,
                            device=self.device)
                        if chan is not None:
                            rx = chan
                            rx.sample_every = self.trace_sample_every
                        continue
                    if cmd == "req_meta":
                        # serve-front-door request metadata: cascade
                        # downstream now — a meta may only move EARLIER
                        # relative to its own frame, never later, and
                        # the result hop joins meta to frame by seq
                        stream_marked = True
                        if tx is None:
                            open_tx()
                        tx.send_ctrl(value)
                        continue
                    if cmd == "trace":
                        # relay order: everything received before this
                        # ctrl frame must reach downstream ahead of it
                        while pending:
                            drain_one()
                    self._handle_ctrl(conn, value, recv=rx.get)
                    if cmd == "trace" and tx is not None:
                        # downstream already connected (a second traced
                        # stream on a live chain): cascade the new
                        # context now, not just at connection open
                        tx.send_ctrl(self._pending_trace)
                    continue
                if kind == K_TENSOR_SEQ:
                    relay_seq, value = value
                elif kind == K_TENSOR:
                    relay_seq = None
                else:
                    raise ValueError(f"unexpected frame kind {kind}")
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if tx is None:
                    open_tx()
                if self._live_rx is not rx:
                    # first tensor on this channel: bind the live
                    # telemetry to the channel the stream rides
                    rx.bind_gauge("node.rx_queue_depth")
                    rx.bind_hist("node.rx_s")
                    rx.sample_every = self.trace_sample_every
                    self._live_rx = rx
                    emit_event("stream_begin", hop=self._span_label())
                self._check_frame(value)
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(value, seq=relay_seq)
                pending.append((t0, t_end, seq, y, relay_seq))
                seq += 1
                inflight_g.inc()
                while len(pending) >= self.inflight:
                    drain_one()
        except Exception as e:  # noqa: BLE001 — see below
            if streamed:
                raise  # upstream died / corrupted mid-stream: loud
            # a connection that never became the data stream must not be
            # able to kill a serving node: port scanners and malformed
            # control peers are logged and dropped.  The remote side still
            # fails loudly — its recv gets a cut connection, no ACK/END.
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None
        finally:
            # reconcile the ADDITIVE gauges: an abandoned stream's queued
            # frames / un-synced dispatches are never consumed
            if self._live_rx is rx:
                self._live_rx = None
            rx.release_gauge()
            if pending:
                inflight_g.dec(len(pending))
            if tx is not None and hasattr(tx, "detach"):
                # a colocated tier's sender: a stream abandoned without
                # its END must fail the consumer as a cut socket would
                tx.detach()
            for sock in out_socks or ():
                if not ended:
                    # an abandoned stream cuts its downstream hop at once,
                    # as a dead process would: a close alone leaves the
                    # connection up while the ack relay is blocked reading
                    # it, and the fan-in then sees the death only once an
                    # ack wakes that read
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                sock.close()

    def _serve_conn_serial(self, conn,
                           connect_timeout_s: float) -> int | None:
        """The serial loop: per tensor, rx + decode, compute with an
        immediate host sync, encode + tx — phases pay their sum.  Kept as
        the baseline the overlap is measured against."""
        out = None
        n = 0
        streamed = False
        stream_marked = False

        def open_out():
            if self.next_hop is None:
                raise ValueError("no next hop configured")
            if len(self.next_hops) > 1:
                raise ValueError("a fan-out to replicas or branches needs "
                                 "the overlapped node loop (drop "
                                 "overlap=False / --no-overlap)")
            sock = connect_retry(*self.next_hop,
                                 timeout_s=connect_timeout_s)
            self.tier_out = "tcp"
            if self.branch is not None:
                send_ctrl(sock, {"cmd": "stream_begin",
                                 "path": self.branch})
            if self._pending_trace is not None:
                send_ctrl(sock, self._pending_trace)
            return sock

        try:
            while True:
                kind, value = recv_frame(conn)
                if kind == K_END:
                    if streamed or stream_marked:
                        if out is None:
                            out = open_out()
                            if self.branch is None:
                                send_ctrl(out, {"cmd": "stream_begin"})
                        send_end(out)
                        return n
                    return None  # control connection closing
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        stream_marked = True
                        continue
                    if cmd == "tier_probe":
                        # the serial loop is the pure-wire baseline: it
                        # refuses every tier (the offer degrades to tcp)
                        answer_probe(conn, value, accept=False)
                        self.tier_in = "tcp"
                        continue
                    if cmd == "req_meta":
                        stream_marked = True
                        if out is None:
                            out = open_out()
                        send_ctrl(out, value)
                        continue
                    self._handle_ctrl(conn, value)
                    if cmd == "trace" and out is not None:
                        send_ctrl(out, self._pending_trace)
                    continue
                if kind == K_TENSOR_SEQ:
                    relay_seq, value = value
                elif kind == K_TENSOR:
                    relay_seq = None
                else:
                    raise ValueError(f"unexpected frame kind {kind}")
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if out is None:
                    out = open_out()
                self._check_frame(value)
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(value, seq=relay_seq)
                tq = self._queue_wait(t_end, seq=relay_seq)
                y, t_done = self._host_sync(y, seq=relay_seq, t0=tq)
                self._infer_done(t0, t_done, relay_seq, n)
                self.processed += 1
                send_frame(out, y, codec=self.codec, seq=relay_seq)
                n += 1
                streamed = True
        except Exception as e:  # noqa: BLE001 — see the overlapped loop
            if streamed:
                raise
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None
        finally:
            if out is not None:
                out.close()

    # -- fan-in: this node merges R replicated upstreams ----------------------

    def _serve_conn_fanin(self, conn, connect_timeout_s: float) -> None:
        """One upstream connection of a fan-in node: a reader that decodes
        frames on this thread (R connections, R decoders in parallel) and
        feeds sequence-stamped tensors into the shared reorder merge.
        Control connections (deploy, stats, reweight ...) are served
        inline as on any node.  Always returns None: the merged compute
        loop (:meth:`_merge_compute`) counts the stream's tensors."""
        registered = False
        merge = None
        try:
            while True:
                kind, value = recv_frame(conn)
                if kind == K_END:
                    if registered:
                        self._fanin_forget(conn)
                        merge.end()
                    return None
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        # the upstream fan-out marks every replica path,
                        # so even a zero-frame upstream counts in the
                        # merge's END bookkeeping
                        if not registered:
                            registered = True
                            merge = self._ensure_merge_loop(
                                connect_timeout_s, conn=conn)
                        continue
                    if cmd == "tier_probe":
                        # fan paths are wire-framed (the ordered seq
                        # merge): refuse, the offer degrades to tcp
                        answer_probe(conn, value, accept=False)
                        continue
                    self._handle_ctrl(conn, value)
                    if registered and cmd == "trace":
                        # a trace context arriving mid-stream must still
                        # cascade past an open downstream connection: it
                        # rides the merge so the compute loop resends it
                        # (a copy per upstream path is harmless: adoption
                        # is idempotent and the dispatcher skips it)
                        merge.put_ctrl(dict(self._pending_trace))
                    continue
                if kind == K_TENSOR:
                    raise ValueError(
                        "fan-in node received an unsequenced tensor "
                        "frame — the upstream must fan out with "
                        "sequence numbers (K_TENSOR_SEQ)")
                if kind != K_TENSOR_SEQ:
                    raise ValueError(f"unexpected frame kind {kind}")
                seq, arr = value
                if not registered:
                    registered = True
                    merge = self._ensure_merge_loop(connect_timeout_s,
                                                    conn=conn)
                t0 = time.perf_counter()
                merge.put(seq, arr)
                tr = tracer()
                if tr.enabled:
                    tr.record(f"{self._span_label()}.merge_wait", t0,
                              time.perf_counter() - t0, {"seq": seq})
        except Exception as e:  # noqa: BLE001 — the single-upstream policy
            if registered:
                if self.failover and isinstance(e, (ConnectionError,
                                                    OSError)):
                    # a replica died mid-stream: wait one redial grace,
                    # while the healed fan-out replays the dead path's
                    # unacked frames through the respawned replica's new
                    # connection; only an unfilled grace fails the merge
                    emit_event("replica_lost", hop=self._span_label(),
                               error=repr(e))
                    self._fanin_forget(conn)
                    self._fanin_grace(merge, e)
                    return None
                merge.fail(e)
                raise
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None

    def _ensure_merge_loop(self, connect_timeout_s: float,
                           conn=None) -> FanInMerge:
        """Create the shared reorder merge and its one compute thread the
        first time an upstream turns out to be a data path; under
        failover ``conn`` joins the ack set and bumps the registration
        epoch (a respawned replica's dial-in cancels the grace timer).
        Returns the segment's merge: readers hold it, so a persistent
        node's next segment cannot swap it under them."""
        with self._merge_lock:
            if self.failover and conn is not None:
                if self._fanin_conns is None:
                    self._fanin_conns = []
                self._fanin_conns.append(conn)
                self._fanin_epoch += 1
            if self._merge is None:
                # every upstream gets rx_depth frames of reorder slack
                # before backpressure parks its reader; the dedup window
                # absorbs a failover replay's overlap
                self._merge = FanInMerge(
                    self.fan_in,
                    capacity=max(self.fan_in, self.fan_in * self.rx_depth),
                    replay_window=(_REPLAY_DEDUP_WINDOW
                                   if self.failover else 0))
                threading.Thread(target=self._merge_loop,
                                 args=(connect_timeout_s,), daemon=True,
                                 name="node-merge-compute").start()
            return self._merge

    def _merge_loop(self, connect_timeout_s: float) -> None:
        done = self._done_q
        merge = self._merge
        try:
            n = self._merge_compute(merge, connect_timeout_s)
            with self._merge_lock:
                # segment complete: a persistent node's next stream builds
                # a fresh merge and a fresh ack set
                self._merge_dups = merge.duplicates
                self._merge = None
                self._fanin_conns = None
            done.put(n)
        except BaseException as e:  # noqa: BLE001 — raised by serve()
            merge.fail(e)  # wake readers parked in put()
            done.put(e)

    def _merge_compute(self, merge, connect_timeout_s: float) -> int:
        """The fan-in node's compute loop: :meth:`_serve_conn_overlapped`
        with the reorder merge in place of the one rx channel.  It keeps up
        to ``inflight`` programs un-synced on CUDA events (draining
        whenever the merge has no in-order frame ready), times the four
        phases, and relays the merged stream downstream unstamped; its
        outbound hop may win shm or ici (only its inbound fan rides the
        wire).  Under failover it acks every ACK_EVERY merged frames and
        once more at the end."""
        tx = out_socks = None
        n = 0
        seq = 0
        inflight_g = REGISTRY.gauge("node.inflight")
        merge_g = REGISTRY.gauge("node.merge_depth")
        pending: collections.deque = collections.deque()

        def drain_one():
            nonlocal n
            t0, t_end, s, y = pending.popleft()
            inflight_g.dec()
            self._relay(tx, t0, t_end, s, y, None)
            n += 1

        try:
            while True:
                if pending:
                    try:
                        kind, value = merge.get_nowait()
                    except queue.Empty:
                        drain_one()
                        continue
                else:
                    kind, value = merge.get()
                merge_g.set(merge.qsize())
                if kind == K_END:
                    while pending:
                        drain_one()
                    if self.failover:
                        # the final cumulative ack releases the upstream
                        # fan-out's whole window before the END cascades
                        # (a replica that already exited misses one write)
                        self._fanin_ack(merge)
                    if tx is None:
                        # every upstream was a zero-frame path: still
                        # propagate the stream downstream
                        tx, out_socks = self._make_tx(connect_timeout_s)
                        if not isinstance(tx, _FAN_SENDERS) \
                                and self.replica is None \
                                and self.branch is None:
                            tx.send_ctrl({"cmd": "stream_begin"})
                    tx.close(timeout=connect_timeout_s)
                    emit_event("stream_end", hop=self._span_label(), n=n)
                    return n
                if kind == K_CTRL:
                    # the readers handled the command (trace adoption);
                    # what rides the merge is the copy for downstream,
                    # sent when tx is open (_make_tx sends the pending
                    # trace itself at open)
                    if tx is not None and value is not None:
                        tx.send_ctrl(value)
                    continue
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if tx is None:
                    tx, out_socks = self._make_tx(connect_timeout_s)
                    emit_event("stream_begin", hop=self._span_label())
                self._check_frame(value)
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(value)
                pending.append((t0, t_end, seq, y))
                seq += 1
                inflight_g.inc()
                if self.failover and seq % ACK_EVERY == 0:
                    # every merged seq below merge.next_seq is in order
                    # here: the upstream fan-out may release its frames
                    self._fanin_ack(merge)
                while len(pending) >= self.inflight:
                    drain_one()
        finally:
            if pending:
                # dispatches abandoned by a failed stream must not inflate
                # the shared inflight gauge
                inflight_g.dec(len(pending))
            if tx is not None and hasattr(tx, "detach"):
                tx.detach()
            for sock in out_socks or ():
                sock.close()


    # -- branch join: this node merges P labeled branch paths ----------------

    def _serve_conn_join(self, conn, connect_timeout_s: float) -> None:
        """One upstream connection of a join node: a reader that decodes
        frames on this thread (P connections, P decoders in parallel) and
        deposits sequence-stamped tensors into the shared (path, seq) join
        under the path its ``stream_begin`` announced.  Control connections
        are served inline as on any node.  Always returns None: the join's
        compute loop (:meth:`_join_compute`) counts the stream."""
        path: int | None = None
        join = None
        try:
            while True:
                kind, value = recv_frame(conn)
                if kind == K_END:
                    if path is not None:
                        join.end(path)
                    return None
                if kind == K_CTRL:
                    cmd = value.get("cmd") if isinstance(value, dict) \
                        else None
                    if cmd == "stream_begin":
                        if path is not None:
                            continue  # a repeated marker keeps its slot
                        if value.get("path") is None:
                            raise ValueError(
                                "join upstream announced a stream with no "
                                "path label — every hop into a join must "
                                "ride a labeled branch path")
                        path = int(value["path"])
                        join = self._ensure_join_loop(connect_timeout_s)
                        # a second claim of one path fails the join loudly
                        join.attach(path)
                        continue
                    if cmd == "tier_probe":
                        # join paths are wire-framed (the ordered (path,
                        # seq) merge): refuse, the offer degrades to tcp
                        answer_probe(conn, value, accept=False)
                        continue
                    if cmd == "req_meta":
                        raise ValueError(
                            "request-scoped metadata cannot cross a branch "
                            "join (P paths would reorder it); serve over a "
                            "linear chain")
                    self._handle_ctrl(conn, value)
                    if path is not None and cmd == "trace":
                        # a mid-stream trace context must still cascade
                        # past an open downstream connection; a copy per
                        # path is harmless (adoption is idempotent)
                        join.put_ctrl(dict(self._pending_trace))
                    continue
                if kind == K_TENSOR:
                    raise ValueError(
                        "join node received an unsequenced tensor frame — "
                        "branch hops carry the fork's shared sequence "
                        "stamp (K_TENSOR_SEQ)")
                if kind != K_TENSOR_SEQ:
                    raise ValueError(f"unexpected frame kind {kind}")
                if path is None:
                    raise ValueError(
                        "tensor before stream_begin on a join path — the "
                        "upstream must announce its path first")
                seq, arr = value
                t0 = time.perf_counter()
                join.put(path, seq, arr)
                tr = tracer()
                if tr.enabled:
                    tr.record(f"{self._span_label()}.join_wait", t0,
                              time.perf_counter() - t0,
                              {"seq": seq, "path": path})
        except Exception as e:  # noqa: BLE001 — the fan-in loop's policy
            if path is not None:
                # a registered path that dies fails the whole join: the
                # compute loop and the other readers see it, and the
                # stream never completes short
                join.fail(e)
                raise
            print(f"node: dropped connection before streaming: {e!r}",
                  file=sys.stderr, flush=True)
            return None

    def _ensure_join_loop(self, connect_timeout_s: float) -> BranchJoin:
        """Create the shared (path, seq) join and its one compute thread
        the first time a branch path announces itself; returns the
        segment's join (readers hold it, so a persistent node's next
        segment cannot swap it under them)."""
        with self._merge_lock:
            if self._join is None:
                # every path gets rx_depth frames of reorder slack before
                # backpressure parks its reader
                self._join = BranchJoin(self.join_in,
                                        capacity=max(2, self.rx_depth))
                threading.Thread(target=self._join_loop,
                                 args=(self._join, connect_timeout_s),
                                 daemon=True,
                                 name="node-join-compute").start()
            return self._join

    def _join_loop(self, join: BranchJoin, connect_timeout_s: float) -> None:
        done = self._done_q
        try:
            n = self._join_compute(join, connect_timeout_s)
            with self._merge_lock:
                # segment complete: a persistent node's next stream builds
                # a fresh join
                self._join = None
            done.put(n)
        except BaseException as e:  # noqa: BLE001 — raised by serve()
            join.fail(e)  # wake readers parked in put()
            done.put(e)

    def _join_compute(self, join: BranchJoin, connect_timeout_s: float
                      ) -> int:
        """The join node's compute loop: :meth:`_merge_compute` with the
        (path, seq) join in place of the round-robin merge and the P-input
        program ``prog(*parts)`` in place of ``prog(x)``.  Complete
        sequences come strictly in order; each output is relayed with the
        region's sequence stamp.  The outbound hop may win shm or ici:
        only the P inbound paths are wire-framed."""
        tx = out_socks = None
        n = 0
        inflight_g = REGISTRY.gauge("node.inflight")
        join_g = REGISTRY.gauge("node.merge_depth")
        pending: collections.deque = collections.deque()

        def drain_one():
            nonlocal n
            t0, t_end, s, y = pending.popleft()
            inflight_g.dec()
            self._relay(tx, t0, t_end, s, y, s)
            n += 1

        def want_shapes() -> list[tuple]:
            m = self.manifest
            if m.get("in_shapes"):
                return [tuple(w) for w in m["in_shapes"]]
            return [tuple(m["in_shape"])] * self.join_in

        try:
            while True:
                if pending:
                    try:
                        kind, value = join.get_nowait()
                    except queue.Empty:
                        drain_one()
                        continue
                else:
                    kind, value = join.get()
                join_g.set(join.qsize())
                if kind == K_END:
                    while pending:
                        drain_one()
                    if tx is None:
                        # every path ended with zero frames: still
                        # propagate the stream downstream
                        tx, out_socks = self._make_tx(connect_timeout_s)
                        if not isinstance(tx, _FAN_SENDERS) \
                                and self.branch is None:
                            tx.send_ctrl({"cmd": "stream_begin"})
                    tx.close(timeout=connect_timeout_s)
                    emit_event("stream_end", hop=self._span_label(), n=n)
                    return n
                if kind == K_CTRL:
                    # the readers handled the command (trace adoption);
                    # what rides the join is the copy for downstream
                    if tx is not None and value is not None:
                        tx.send_ctrl(value)
                    continue
                seq, parts = value
                if self.prog is None:
                    raise ValueError(
                        "data frame before any stage artifact (boot with "
                        "--artifact or deploy in-band first)")
                if tx is None:
                    tx, out_socks = self._make_tx(connect_timeout_s)
                    emit_event("stream_begin", hop=self._span_label())
                batch = self.manifest["batch"]
                for p, (part, want) in enumerate(zip(parts, want_shapes())):
                    if tuple(part.shape[1:]) != want \
                            or part.shape[0] != batch:
                        raise ValueError(
                            f"join stage {self.manifest['index']} path {p} "
                            f"expects frames of {batch} x {want}, got "
                            f"{tuple(part.shape)}")
                if self.infer_delay_s:
                    time.sleep(self.infer_delay_s)  # bench-only device
                t0, t_end, y = self._dispatch(*parts, seq=seq)
                pending.append((t0, t_end, seq, y))
                inflight_g.inc()
                while len(pending) >= self.inflight:
                    drain_one()
        finally:
            if pending:
                inflight_g.dec(len(pending))
            if tx is not None and hasattr(tx, "detach"):
                tx.detach()
            for sock in out_socks or ():
                sock.close()


def _to_host(y):
    """A result frame on the host: numpy, or a ``torch.bfloat16`` tensor
    (the form every other tier delivers)."""
    if not isinstance(y, torch.Tensor):
        return y
    y = y.cpu()
    return y if y.dtype == torch.bfloat16 else y.numpy()


class ChainDispatcher:
    """Drives a linear chain of stage nodes from one controller.

    Opens the result server (the reference dispatcher's own port 5000
    role, src/dispatcher.py:95-105), streams inputs to node 0, and returns
    results in order, with a bounded in-flight window so the chain stays
    full without unbounded buffering.

    ``tier`` is the transport-tier policy of the first edge (dispatcher ->
    stage 0; ``"auto"`` walks the ladder, a rung name pins it, ``"tcp"``
    never probes).  The result server grants the last node's offer
    exactly when ``tier`` is not tcp, so a ``tcp`` dispatcher keeps a pure
    wire chain end to end.  Its inputs
    live on the host, so its ici offer names the CPU: a node on the card
    refuses it and the edge takes local.

    Replication: a comma-listed ``first_hop`` names replicas of stage 0,
    and the dispatcher itself fans out round-robin with sequence numbers
    (on tcp); ``result_fan_in=R`` merges the R dial-backs of a replicated
    last stage in sequence order.
    """

    #: the one timeout default; also covers partially constructed
    #: instances
    timeout_s: float = 180.0

    def __init__(self, first_hop: str, *, listen: str = "127.0.0.1:0",
                 codec: str = "raw", window: int = 64,
                 timeout_s: float | None = None,
                 tx_depth: int = 8, rx_depth: int = 8,
                 result_fan_in: int = 1,
                 trace_sample_every: int = 0, tier: str = "tcp"):
        if timeout_s is not None:
            self.timeout_s = timeout_s
        self.tier = _check_tier(tier, "ChainDispatcher")
        self.tier_accept = tier != "tcp"
        #: ``host:port[,host:port...]``: a list names stage 0's replicas
        self.first_hop = first_hop
        self._first_hops = _parse_hops(first_hop)
        if not self._first_hops:
            raise ValueError(f"first_hop {first_hop!r} names no address")
        #: > 1: a replicated last stage, whose R replicas dial back and
        #: are merged in sequence order
        self.result_fan_in = max(1, int(result_fan_in))
        host, port = _parse_hostport(listen)
        self._res_srv = socket.create_server((host, port))
        # a dead chain fails, not hangs
        self._res_srv.settimeout(self.timeout_s)
        self.result_address = self._res_srv.getsockname()
        self.codec = codec
        self.window = window
        self.tx_depth = tx_depth
        self.rx_depth = rx_depth
        self.trace_sample_every = max(0, int(trace_sample_every))
        self.tier_out: str | None = None
        self.tier_in: str | None = None
        #: first-edge offers that degraded to tcp
        self.tier_fallbacks = 0
        #: seconds from the start of the last stream() to its first result
        self.first_result_s: float | None = None
        #: wire sequence counter, continuous across stream() calls (a warm
        #: stream and a timed stream must not reuse seq numbers — sampled
        #: spans are keyed by them)
        self._stream_seq = 0
        self._send_sock: socket.socket | None = None
        self._send_socks: list | None = None
        self._res_conn: socket.socket | None = None
        self._res_conns: list = []
        self._res_merge: FanInMerge | None = None
        self._tx_chan = None
        self._rx_chan = None

    def _ensure_connected(self) -> None:
        if self._send_sock is None and self._send_socks is None:
            # generous: every node of a spawned chain imports torch first
            socks = [connect_retry(*h, timeout_s=self.timeout_s)
                     for h in self._first_hops]
            if len(socks) == 1:
                self._send_sock = socks[0]
            else:
                self._send_socks = socks
        if self._tx_chan is None:
            if self._send_socks is not None:
                # a replicated first stage: fan out on the wire
                self.tier_out = "tcp"
                self._tx_chan = FanOutSender(self._send_socks,
                                             depth=self.tx_depth,
                                             codec=self.codec,
                                             gauge="chain.tx_queue_depth",
                                             span="chain", hist="chain.tx_s")
                self._tx_chan.send_ctrl({"cmd": "stream_begin"})
            elif self.tier != "tcp":
                # the tier ladder on the stage-0 hop; a node on another
                # host refuses every rung and the edge stays on tcp with
                # one fallback counted
                self.tier_out, self._tx_chan, fell_back = \
                    offer_tier_ladder(self._send_sock, tier=self.tier,
                                      depth=self.tx_depth, hop="chain")
                if fell_back:
                    self.tier_fallbacks += 1
                emit_event("tier", hop="chain", tier=self.tier_out,
                           wanted=self.tier, fallback=bool(fell_back))
            if self._tx_chan is None:
                # encode + send happen on the channel's tx thread, so the
                # feed loop and the wire overlap (and the END in close()
                # rides the same ordered queue)
                self.tier_out = "tcp"
                self._tx_chan = AsyncSender(self._send_sock,
                                            depth=self.tx_depth,
                                            codec=self.codec,
                                            gauge="chain.tx_queue_depth",
                                            span="chain", hist="chain.tx_s")
            self._tx_chan.sample_every = self.trace_sample_every
        # the result connection is accepted lazily in _recv_tensor: the
        # last node only dials back once its first tensor arrives, so
        # accepting before sending anything would deadlock the chain

    def stream(self, inputs) -> list:
        """Send every input through the chain; return outputs in order.

        Full duplex: a sender thread keeps the chain fed (up to ``window``
        in flight, released as results land) while this thread drains
        results, so a slow stage applies backpressure through the window.
        Encoding happens on the tx channel's thread and result decoding on
        the rx channel's.  Per-``get`` timeouts keep a dead chain failing
        rather than hanging.

        With tracing enabled the call injects its trace context as a
        K_CTRL frame ahead of the first tensor; every stage adopts it,
        cascades it downstream and parents its spans under this stream's
        root span — collect them afterwards with :meth:`collect_trace`.
        """
        self._ensure_connected()
        tr = tracer()
        root_span = None
        t_start = time.perf_counter()
        self.first_result_s = None
        if tr.enabled:
            # pre-allocate the root span id so remote stages can parent
            # under a span recorded only when the stream completes
            root_span = new_span_id()
            self._tx_chan.send_ctrl(
                {"cmd": "trace", "trace_id": tr.trace_id,
                 "span_id": root_span,
                 "sample_every": self.trace_sample_every})
        # waterfall sampling needs a wire sequence number on every frame
        # (a fan-out stamps its own)
        stamp_seq = (tr.enabled and self.trace_sample_every > 0
                     and not isinstance(self._tx_chan, FanOutSender))
        outs: list = []
        window = threading.Semaphore(self.window)
        sent = [0]
        tx_done = threading.Event()
        rx_failed = threading.Event()
        err: list[BaseException] = []

        def tx():
            try:
                for x in inputs:
                    if rx_failed.is_set():
                        return
                    if not window.acquire(timeout=self.timeout_s):
                        raise TimeoutError(
                            f"chain accepted no result for "
                            f"{self.timeout_s:.0f}s with {self.window} in "
                            f"flight — a stage is stuck")
                    if rx_failed.is_set():
                        return  # woken by the error path, not a result
                    self._tx_chan.send(
                        x if isinstance(x, torch.Tensor) else np.asarray(x),
                        seq=(self._stream_seq + sent[0]) if stamp_seq
                        else None)
                    sent[0] += 1
            except BaseException as e:  # noqa: BLE001 — surfaced below
                err.append(e)
            finally:
                self._stream_seq += sent[0]
                tx_done.set()

        t = threading.Thread(target=tx, daemon=True, name="chain-tx")
        t.start()
        try:
            while True:
                if err:
                    raise err[0]
                if len(outs) < sent[0]:
                    # something is in flight: recv (bounded by the result
                    # channel's timeout).  Never recv otherwise — nothing
                    # would arrive and the wait would run its full timeout
                    outs.append(self._recv_tensor())
                    if len(outs) == 1:
                        self.first_result_s = time.perf_counter() - t_start
                    window.release()
                    continue
                if tx_done.is_set():
                    break  # everything sent has been received
                tx_done.wait(0.01)  # sender still working; let it run
        except BaseException:
            rx_failed.set()
            # a sender parked in window.acquire must wake to see the flag;
            # then give it a bounded moment so no trailing frame interleaves
            # with the caller's teardown (close() writes END on this socket)
            window.release(self.window)
            t.join(timeout=5.0)
            raise
        t.join(timeout=self.timeout_s)  # no trailing writes after return
        if err:
            raise err[0]
        if root_span is not None:
            tr.record("chain.stream", t_start,
                      time.perf_counter() - t_start,
                      {"sent": sent[0], "received": len(outs)},
                      span_id=root_span)
        return outs

    def _control(self, addr: str, msg: dict, blob: bytes | None = None,
                 reply: int = K_ACK):
        """One control round trip on a fresh connection to ``addr``: the
        message, an optional K_BYTES blob, the expected reply, END."""
        s = connect_retry(*_parse_hostport(addr), timeout_s=self.timeout_s)
        try:
            send_ctrl(s, msg)
            if blob is not None:
                send_frame(s, blob)
            out = recv_expect(s, reply)
            send_end(s)
            return out
        finally:
            s.close()

    @staticmethod
    def _stage_capacity(stage, batch: int) -> dict:
        """The deploy message's capacity fields: the stage's analytic FLOPs
        and HBM bytes at the deploy ``batch``
        (:func:`~defer_tpu_torch.obs.capacity.stage_flops_bytes`), so the
        node reports live MFU against its own card's peak without the
        graph.  Empty for a stage that carries no graph slice."""
        graph = getattr(stage, "graph", None)
        names = getattr(stage, "node_names", None)
        if graph is None or not names:
            return {}
        flops, moved = stage_flops_bytes(graph, names, batch=batch)
        return {"flops": flops, "bytes_moved": moved}

    def deploy(self, stages, params, node_addrs: Sequence, *,
               batch: int = 1, result_hop: str | None = None,
               codecs: Sequence[str] | None = None,
               tiers: Sequence[str] | None = None,
               devices: Sequence | None = None) -> None:
        """Ship each stage's artifact to its node(s) over the control
        channel.

        Serial, in chain order, each ACKed before the next — the in-band
        model distribution of the reference dispatcher
        (src/dispatcher.py:44-65: weights, arch JSON, next-node IP, \\x06
        ACK) collapsed to one control connection per node carrying a
        self-contained ``torch.export`` program and its weights.  Nodes may
        boot with no files at all.  ``result_hop`` overrides the address
        the last node relays results to (default: this dispatcher's result
        server).  ``codecs`` (per stage) sets each stage's OUTBOUND hop
        codec; ``tiers`` (per stage, ``tcp``/``auto``/``ici``/``local``/
        ``shm``) its outbound transport-tier policy; ``devices`` (per
        stage, a card index, a device string or None) pins its program.

        Replication: an entry of ``node_addrs`` may be a list of R
        addresses.  One artifact is exported for the stage and sent to
        each replica (``replica`` j), the stage above gets the comma-joined
        list as its ``next`` (a fan-out), and the stage below gets
        ``fan_in=R``.  Two adjacent replicated stages raise: a replica
        cannot restore another fan-out's order.

        Deploying first sweeps ``/dev/shm`` for segments a killed chain
        left behind (``transport.shm.sweep_orphan_segments``).
        """
        from ..utils.export import export_stage_bytes
        sweep_orphan_segments()
        groups = self._groups(node_addrs, len(stages))
        for i in range(len(groups) - 1):
            if len(groups[i]) > 1 and len(groups[i + 1]) > 1:
                raise ValueError(
                    f"stages {i} and {i + 1} are both replicated; "
                    f"adjacent replication is not supported")
        result_hop = result_hop or \
            f"{self.result_address[0]}:{self.result_address[1]}"
        for i, (stage, addrs) in enumerate(zip(stages, groups)):
            msg = {"cmd": "deploy",
                   "next": ",".join(groups[i + 1]) if i + 1 < len(groups)
                   else result_hop,
                   "codec": codecs[i] if codecs else self.codec,
                   **self._stage_capacity(stage, batch)}
            if tiers:
                msg["tier"] = _check_tier(tiers[i], "deploy")
            if devices and devices[i] is not None:
                msg["device"] = devices[i] if isinstance(devices[i], int) \
                    else str(devices[i])
            if i > 0 and len(groups[i - 1]) > 1:
                msg["fan_in"] = len(groups[i - 1])
            blob = export_stage_bytes(stage, params, batch=batch)
            for j, addr in enumerate(addrs):
                if len(addrs) > 1:
                    msg["replica"] = j
                self._control(addr, msg, blob)

    def deploy_topology(self, topology, stages, params,
                        node_addrs: Sequence[str], *, batch: int = 1,
                        result_hop: str | None = None,
                        stage_delays: dict | None = None) -> None:
        """Ship a branched stage graph: one node per topology vertex.

        ``topology`` is a
        :class:`~defer_tpu_torch.runtime.topology.ChainTopology` whose
        vertices align with ``stages`` (``topology.stage_specs(graph)``)
        and ``node_addrs``.  Each deploy message carries the vertex's
        transport role — ``fan`` (a broadcast fork), ``branch`` (a labeled
        path), ``join`` (a P-path merge) — beside the usual next/codec
        pair; replicas never appear here (the branch and replica fans own
        different sequence namespaces, and a node refuses both at once).
        ``stage_delays`` (vertex id -> seconds) installs the bench-only
        simulated device time per vertex.  Serial, in vertex order, each
        ACKed before the next; a vertex that fails its deploy raises
        naming its label and address."""
        from ..utils.export import export_stage_bytes
        sweep_orphan_segments()
        addrs = list(node_addrs)
        if len(addrs) != len(topology.vertices) or \
                len(stages) != len(topology.vertices):
            raise ValueError(
                f"{len(topology.vertices)} topology vertices need as many "
                f"stages ({len(stages)}) and addresses ({len(addrs)})")
        result_hop = result_hop or \
            f"{self.result_address[0]}:{self.result_address[1]}"
        for v, stage, addr in zip(topology.vertices, stages, addrs):
            msg = {"cmd": "deploy",
                   "next": (",".join(addrs[n] for n in v.next) if v.next
                            else result_hop),
                   "codec": v.codec or self.codec,
                   **self._stage_capacity(stage, batch)}
            if v.fan == "broadcast":
                msg["fan"] = "broadcast"
            if v.join >= 2:
                msg["join"] = v.join
            if v.branch is not None:
                msg["branch"] = v.branch
            if stage_delays and stage_delays.get(v.vid):
                msg["infer_delay_ms"] = stage_delays[v.vid] * 1e3
            blob = export_stage_bytes(stage, params, batch=batch)
            try:
                self._control(addr, msg, blob)
            except (OSError, ConnectionError, ValueError) as e:
                raise ConnectionError(
                    f"deploy of vertex {v.label} at {addr} failed: "
                    f"{e!r}") from e

    @staticmethod
    def _groups(node_addrs: Sequence, n: int) -> list[list[str]]:
        """Each stage's addresses: a string is one node, a list a
        replicated stage's replicas."""
        groups = [[a] if isinstance(a, str) else list(a)
                  for a in node_addrs]
        if len(groups) != n:
            raise ValueError(f"{n} stages but {len(groups)} nodes")
        return groups

    def reweight(self, stages, params, node_addrs: Sequence) -> None:
        """Weights-only re-push: install fresh weights on every node's
        loaded stage program (every replica of a replicated stage) —
        redeploy without restarting any process or resending the
        program."""
        from ..utils.export import stage_weight_leaves, weights_blob
        for stage, addrs in zip(stages, self._groups(node_addrs,
                                                     len(stages))):
            blob = weights_blob(stage_weight_leaves(stage, params))
            for addr in addrs:
                self._control(addr, {"cmd": "reweight"}, blob)

    def stats(self, node_addrs: Sequence[str]) -> list[dict]:
        """Every node's ``stats`` reply (works mid-stream: nodes serve a
        thread per connection)."""
        return [self._control(a, {"cmd": "stats"}, reply=K_CTRL)
                for a in node_addrs]

    def _ensure_result_chan(self) -> None:
        """Accept the last node's dial-back and wrap it in the result
        :class:`AsyncReceiver` (idempotent)."""
        if self._res_conn is None:
            self._res_conn, _ = self._res_srv.accept()
            configure_socket(self._res_conn)
        if self._rx_chan is None:
            self._res_conn.settimeout(None)
            self._rx_chan = AsyncReceiver(self._res_conn,
                                          depth=self.rx_depth,
                                          gauge="chain.rx_queue_depth",
                                          span="chain", hist="chain.rx_s")
            self._rx_chan.sample_every = self.trace_sample_every

    def _result_item(self, *, timeout_s: float | None = None
                     ) -> tuple[int, Any]:
        """One frame off the result hop with the handshakes handled: a
        tier probe is answered (and the channel swapped on a grant), trace
        and stream_begin markers — which the dispatcher itself originated
        — are skipped; everything else is returned."""
        self._ensure_result_chan()
        t = self.timeout_s if timeout_s is None else timeout_s
        while True:
            kind, y = self._rx_chan.get(timeout=t)
            if kind == K_CTRL and isinstance(y, dict):
                cmd = y.get("cmd")
                if cmd == "tier_probe":
                    # the last node offers its fast path on the dial-back:
                    # an ici/local grant swaps results to the in-process
                    # pipe (the socket stays as lifetime anchor), a shm
                    # grant wraps the socket's channel (the doorbell)
                    self.tier_in, chan = answer_tier_probe(
                        self._res_conn, y, accept=self.tier_accept,
                        inner=self._rx_chan, depth=self.rx_depth)
                    if self.tier_in in ("local", "ici"):
                        old = self._rx_chan
                        self._rx_chan = chan
                        self._rx_chan.bind_gauge("chain.rx_queue_depth")
                        old.release_gauge()
                    elif self.tier_in == "shm":
                        # the inner channel stays live (the doorbell) and
                        # keeps its gauge
                        self._rx_chan = chan
                    self._rx_chan.sample_every = self.trace_sample_every
                    continue
                if cmd in ("trace", "stream_begin"):
                    continue
            if kind in (K_TENSOR, K_TENSOR_SEQ) and self.tier_in == "ici":
                # the chain's one host copy per frame: device-resident
                # results come to the host here, at the result edge
                t0 = time.perf_counter()
                if kind == K_TENSOR_SEQ:
                    y = (y[0], _to_host(y[1]))
                else:
                    y = _to_host(y)
                REGISTRY.histogram("chain.host_sync_s").record(
                    time.perf_counter() - t0)
            return kind, y

    # -- serve front door: request-scoped duplex stream ----------------------

    def begin_trace(self, *, sample_every: int | None = None
                    ) -> str | None:
        """Inject the current trace context into the chain ahead of any
        request-scoped frame — the serving-path twin of what
        :meth:`stream` does per call.  Returns the pre-allocated root span
        id stage spans parent under, or None when tracing is off."""
        tr = tracer()
        if not tr.enabled:
            return None
        if sample_every is not None:
            self.trace_sample_every = max(0, int(sample_every))
        self._ensure_connected()
        self._tx_chan.sample_every = self.trace_sample_every
        if self._rx_chan is not None:
            self._rx_chan.sample_every = self.trace_sample_every
        root_span = new_span_id()
        self._tx_chan.send_ctrl(
            {"cmd": "trace", "trace_id": tr.trace_id,
             "span_id": root_span,
             "sample_every": self.trace_sample_every})
        return root_span

    def send_request_frame(self, arr, *, seq: int,
                           meta: dict | None = None) -> None:
        """One request-scoped frame into the chain: stamped with ``seq``
        (``K_TENSOR_SEQ`` — every stage relays the stamp unchanged, so the
        result hop identifies the frame it answers), optionally preceded
        by a ``req_meta`` K_CTRL frame carrying its tenant/request
        composition, which stage nodes cascade downstream ahead of (never
        behind) the frame it describes."""
        self._ensure_connected()
        if meta is not None:
            msg = {"cmd": "req_meta", "seq": int(seq)}
            msg.update(meta)
            self._tx_chan.send_ctrl(msg)
        self._tx_chan.send(
            arr if isinstance(arr, torch.Tensor) else np.asarray(arr),
            seq=int(seq))

    def recv_result(self, *, timeout_s: float | None = None):
        """Next item off the result hop for a request-scoped stream:
        ``("meta", msg)`` for a cascaded ``req_meta`` frame, ``("tensor",
        (seq, arr))`` for a result (``seq`` None on unstamped frames),
        ``("end", None)`` when the chain drained."""
        kind, y = self._result_item(timeout_s=timeout_s)
        if kind == K_CTRL and isinstance(y, dict) \
                and y.get("cmd") == "req_meta":
            return "meta", y
        if kind == K_TENSOR_SEQ:
            return "tensor", (y[0], y[1])
        if kind == K_TENSOR:
            return "tensor", (None, y)
        if kind == K_END:
            return "end", None
        raise ConnectionError(
            f"unexpected frame kind {kind!r} on the result hop")

    def _recv_tensor(self):
        """One in-order result frame; a loud protocol check (an early END
        from a node that died mid-stream must raise, not mis-drain).  With
        ``result_fan_in > 1`` the results come off the sequence-ordered
        :class:`FanInMerge` over the R replica dial-backs."""
        if self.result_fan_in > 1:
            return self._recv_tensor_fanin()
        kind, y = self._result_item()
        if kind == K_TENSOR_SEQ:
            # waterfall sampling stamps every frame end to end; strip it
            return y[1]
        if kind != K_TENSOR:
            raise ConnectionError(
                f"chain returned frame kind {kind!r} while results were "
                f"still in flight (a stage node died and cascaded END?)")
        return y

    def _ensure_result_merge(self) -> FanInMerge:
        """Start the result side's fan-in: an acceptor takes the R replica
        dial-backs as they come (a replica that sees its first frame late,
        or only the END, dials late; waiting for all R up front would
        deadlock short streams), and one reader thread per connection
        feeds the sequence-ordered merge."""
        if self._res_merge is not None:
            return self._res_merge
        merge = FanInMerge(self.result_fan_in,
                           capacity=max(self.result_fan_in,
                                        self.result_fan_in * self.rx_depth))
        self._res_merge = merge

        def reader(c):
            try:
                while True:
                    kind, value = recv_frame(c)
                    if kind == K_END:
                        merge.end()
                        return
                    if kind == K_CTRL:
                        if isinstance(value, dict) \
                                and value.get("cmd") == "tier_probe":
                            # a replica's dial-back never takes a fast path
                            # (the seq merge is wire-framed): refuse, so
                            # the prober degrades instead of hanging
                            answer_probe(c, value, accept=False)
                        continue  # trace, stream_begin: informational
                    if kind != K_TENSOR_SEQ:
                        raise ConnectionError(
                            f"result fan-in got frame kind {kind!r}; "
                            f"replicas must relay sequence-stamped frames")
                    merge.put(*value)
            except BaseException as e:  # noqa: BLE001 — raised in get()
                merge.fail(e)

        def acceptor():
            try:
                for _ in range(self.result_fan_in):
                    c, _ = self._res_srv.accept()
                    configure_socket(c)
                    c.settimeout(None)
                    self._res_conns.append(c)
                    threading.Thread(target=reader, args=(c,), daemon=True,
                                     name="chain-result-rx").start()
            except BaseException as e:  # noqa: BLE001 — raised in get()
                merge.fail(e)

        threading.Thread(target=acceptor, daemon=True,
                         name="chain-result-accept").start()
        return merge

    def _recv_tensor_fanin(self):
        merge = self._ensure_result_merge()
        kind, y = merge.get(timeout=self.timeout_s)
        while kind == K_CTRL:
            kind, y = merge.get(timeout=self.timeout_s)
        if kind != K_TENSOR:
            raise ConnectionError(
                f"chain returned frame kind {kind!r} while results were "
                f"still in flight (a stage replica died and cascaded "
                f"END?)")
        return y

    def align_clocks(self, node_addrs: Sequence[str], *,
                     rounds: int = 8) -> dict:
        """Clock-align every node's tracer to this process's timeline: per
        node, a min-RTT ping-pong offset estimate over a control
        connection, then a ``clock_adjust`` shifting the node's anchor
        (obs/cluster.py).  Returns ``{addr: {"offset_us", "rtt_us",
        "rounds"}}``, each offset measured before its correction."""
        out = {}
        for addr in node_addrs:
            s = connect_retry(*_parse_hostport(addr),
                              timeout_s=self.timeout_s)
            try:
                out[addr] = align_clock(s, rounds=rounds)
                send_end(s)
            finally:
                s.close()
        return out

    def watch(self, node_addrs: Sequence[str], *,
              interval_ms: float = 250.0, spans: bool = False,
              align_clocks: bool = False) -> ClusterView:
        """Subscribe to every node's live ``obs_push`` stream: returns a
        :class:`~defer_tpu_torch.obs.cluster.ClusterView` aggregating the
        pushes on background reader threads until ``view.close()``.  Works
        mid-stream (each node serves a connection per thread)."""
        view = ClusterView()
        view.connect(node_addrs, interval_ms=interval_ms, spans=spans,
                     align_clocks=align_clocks, timeout_s=self.timeout_s)
        return view

    def collect_trace(self, node_addrs: Sequence[str]) -> int:
        """Fetch and merge every node's recorded spans into this process's
        tracer (a ``trace_dump`` round trip per node), so one export holds
        the stitched dispatcher -> stage0 -> ... -> stageN-1 trace.
        Returns the number of spans ingested.  Call while the nodes are
        still alive — after ``stream`` returns, before ``close``."""
        tr = tracer()
        total = 0
        for addr in node_addrs:
            spans = self._control(addr, {"cmd": "trace_dump"},
                                  reply=K_CTRL).get("spans", [])
            tr.ingest(spans)
            total += len(spans)
        return total

    def quiesce(self, node_addrs: Sequence[str], *,
                at_seq: int | None = None,
                timeout_s: float | None = None) -> list[int]:
        """Drain every node to a stable sequence point: per node, a
        ``quiesce`` round trip that returns once the node's queues are
        empty, its in-flight window has drained and its processed count
        has stopped moving (optionally past ``at_seq``).  Returns each
        node's processed count."""
        t = self.timeout_s if timeout_s is None else timeout_s
        out: list[int] = []
        for addr in node_addrs:
            msg: dict = {"cmd": "quiesce", "timeout_s": t}
            if at_seq is not None:
                msg["at_seq"] = int(at_seq)
            reply = self._control(addr, msg, reply=K_CTRL)
            if not isinstance(reply, dict) \
                    or reply.get("cmd") != "quiesced":
                raise ConnectionError(
                    f"node {addr} answered quiesce with {reply!r}")
            out.append(int(reply.get("processed", 0)))
        return out

    def shutdown_nodes(self, node_addrs: Sequence[str]) -> None:
        """Ask persistent nodes (``persist=True``) to leave their serve
        loop after the current segment."""
        for addr in node_addrs:
            self._control(addr, {"cmd": "shutdown"})

    def end_stream(self) -> None:
        """Drain the current stream segment (best effort) and drop every
        data-plane connection, but KEEP the result server listening, so a
        follow-up :meth:`stream` opens a fresh segment against nodes that
        persisted across it.  The wire sequence counter is not reset.

        The END handshake is wrapped so a chain that already died
        mid-stream cannot mask the original failure with a secondary
        BrokenPipe/EOF from the teardown itself."""
        try:
            if self._send_sock is not None or self._send_socks:
                # the END rides the ordered tx queue behind any trailing
                # frames; close() joins the tx thread so it is on the
                # wire before we wait for the cascaded echo (a fan-out
                # ENDs every replica channel)
                self._tx_chan.close(timeout=min(10.0, self.timeout_s))
                if self.result_fan_in > 1:
                    # drain the merge until all R replica dial-backs have
                    # delivered their END (the acceptor keeps taking late
                    # dial-backs: a replica whose only frame was the END)
                    merge = self._ensure_result_merge()
                    while merge.get(timeout=self.timeout_s)[0] != K_END:
                        pass
                elif self._res_conn is None:
                    # nothing was ever received: still accept the last
                    # node's dial-back so its cascaded END completes
                    try:
                        self._res_srv.settimeout(min(10.0, self.timeout_s))
                        self._res_conn, _ = self._res_srv.accept()
                        self._res_conn.settimeout(self.timeout_s)
                    except OSError:
                        pass
                if self._res_conn is not None:
                    # drain leftover in-flight frames until the END
                    # cascades through
                    while True:
                        if self._rx_chan is not None:
                            kind, v = self._rx_chan.get(
                                timeout=self.timeout_s)
                        else:
                            kind, v = recv_frame(self._res_conn)
                        if kind == K_CTRL and isinstance(v, dict) \
                                and v.get("cmd") == "tier_probe":
                            # a zero-result stream: the last node's offer
                            # arrives during teardown; refuse it so its
                            # END cascades over plain tcp
                            answer_probe(self._res_conn, v, accept=False)
                        if kind == K_END:
                            break
        except (OSError, ConnectionError, ValueError, TimeoutError):
            pass  # teardown after failure: keep the root cause
        finally:
            if self._rx_chan is not None:
                # reconcile the additive chain.rx_queue_depth gauge
                self._rx_chan.release_gauge()
            for sock in ([self._send_sock] + (self._send_socks or [])
                         + [self._res_conn] + self._res_conns):
                if sock is not None:
                    sock.close()
            # reset to pre-connect state: the next stream() segment
            # redials the (possibly re-deployed) chain from scratch
            self._send_sock = None
            self._send_socks = None
            self._tx_chan = None
            self._rx_chan = None
            self._res_conn = None
            self._res_conns = []
            self._res_merge = None
            try:
                self._res_srv.settimeout(self.timeout_s)
            except OSError:
                pass  # already closed (end_stream after close)

    def close(self) -> None:
        """End the current segment (:meth:`end_stream`) and close the
        result server — the dispatcher is done for good."""
        try:
            self.end_stream()
        finally:
            self._res_srv.close()


# ---------------------------------------------------------------------------
# run_chain: spawn one OS process per stage, deploy, stream, tear down
# ---------------------------------------------------------------------------

def _free_ports(n: int) -> list[int]:
    """Probe n free localhost ports.  Inherently racy (probe-then-close,
    then the children bind): ``run_chain`` detects children that died with
    a bind failure and retries the whole spawn on fresh ports."""
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


#: substrings that identify a child that lost the ``_free_ports`` race
_BIND_RACE_MARKS = ("Address already in use", "EADDRINUSE",
                    "address is already in use")


class _BindRace(RuntimeError):
    """A chain child lost the ``_free_ports`` probe race (its port was
    taken before it bound) — the spawn should retry."""


def _log_tail(lf, limit: int = 2000) -> str:
    try:
        lf.flush()
        lf.seek(0)
        return lf.read()[-limit:]
    except (OSError, ValueError):
        return "<log unavailable>"


def _kill_procs(procs, *, grace_s: float = 5.0) -> None:
    """Terminate every child now (SIGTERM, a short grace, then SIGKILL):
    a node that died mid-deploy or mid-stream must not leave its siblings
    running."""
    for pr in procs:
        if pr.poll() is None:
            try:
                pr.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace_s
    for pr in procs:
        try:
            pr.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pr.kill()
    for pr in procs:
        try:
            pr.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass


def _await_binds(procs, labels, logs, addrs, *, proc_of=None,
                 timeout_s: float = 90.0) -> None:
    """Block until every listener reports its bind (the ``listening on
    <addr>,`` line ``cmd_node`` prints once a ``StageNode`` has bound), or
    diagnose the process that died trying: a bind-race death raises
    :class:`_BindRace` (retryable), anything else a ``RuntimeError``
    carrying that process's log tail.  ``proc_of`` maps each address to
    its process (default: one each); a process with co-stages prints a
    line per listener.  The log line, not a connect probe, is the signal:
    a stolen port still accepts connections — from whoever stole it."""
    deadline = time.monotonic() + timeout_s
    for i, addr in enumerate(addrs):
        p = i if proc_of is None else proc_of[i]
        while True:
            rc = procs[p].poll()
            tail = _log_tail(logs[p], limit=8000)
            if f"listening on {addr}," in tail:
                break
            if rc is not None:
                if any(m in tail for m in _BIND_RACE_MARKS):
                    raise _BindRace(f"node {labels[i]} lost the port bind "
                                    f"race")
                raise RuntimeError(f"chain node {labels[i]} exited rc={rc} "
                                   f"during boot: {tail[-2000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"chain node {labels[i]} did not bind {addr} within "
                    f"{timeout_s:.0f}s: {tail[-2000:]}")
            time.sleep(0.1)


#: seconds a spawned node may take to exit once END has cascaded
_EXIT_TIMEOUT_S = 60.0


class NodeProcs(NamedTuple):
    """The children :func:`spawn_nodes` yields, once each has bound."""

    procs: list       # subprocess.Popen, one per process
    addrs: list       # each node's listen address, "host:port"
    result: str       # a free port for the dispatcher's result channel
    logs: list        # each process's log file (its stdout and stderr)
    env: dict         # the children's environment (a respawn's too)


@contextlib.contextmanager
def spawn_nodes(n: int, *, log_dir: str, device: str = "cuda",
                argv_for=None, co_stage_for=None, groups=None,
                labels: Sequence[str] | None = None,
                env: dict[str, str] | None = None,
                on_spawn=None, spawn_retries: int = 3):
    """Spawn ``python -m defer_tpu_torch node`` processes for ``n`` nodes
    on fresh localhost ports and yield a :class:`NodeProcs` once every
    node has bound — the one spawn path of the port's process chains
    (:func:`run_chain` runs its nodes through it).  A node is a stage, or
    one replica of a replicated stage; ``labels`` names each in errors
    (default ``stageK`` for node K).

    ``groups`` lists the nodes of each process (default: one process per
    node).  A group's first node is the process's own; the others board
    it as ``--co-stage`` serve threads, so the hops between them can take
    the in-process tiers.  Every process runs on ``device`` (its argv
    carries ``--device``), imports this package from where the parent
    did, takes ``env`` over the parent's environment and logs to
    ``log_dir/node_<nodes>.log``.  ``argv_for(k, addrs, result)`` gives
    the further arguments of a process whose own node is k (by default
    none: the node boots empty and awaits an in-band deploy), and
    ``co_stage_for(k, addrs, result)`` the ``key=value;...`` keys of
    co-stage k after its ``listen`` (default ``accept=1``: the hop into a
    co-stage is the in-process boundary that put it there).  On the card
    the parent first builds every hand kernel (``ops/_build.py``), so the
    children load the built libraries instead of each starting its own
    ``nvcc``.  ``on_spawn(procs)`` is called with each spawn's
    ``subprocess.Popen`` list.

    Processes that exit with an address-in-use bind failure at boot (the
    ``_free_ports`` race) are killed and the spawn retries on fresh ports,
    up to ``spawn_retries`` spawns; any other death at boot raises with
    that process's log tail.  Leaving the block normally waits up to
    ``_EXIT_TIMEOUT_S`` for every child to exit (the body cascaded END)
    and raises if one did not exit 0.  Leaving it on an error terminates
    every child first and names the dead ones' log tails; when every dead
    one lost the bind race it raises :class:`_BindRace`, which
    :func:`run_chain` retries.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build
        from ..ops.launches import counted_kernels
        _build.build([k.source for k in counted_kernels()])
    groups = [[k] for k in range(n)] if groups is None \
        else [list(g) for g in groups]
    if sorted(k for g in groups for k in g) != list(range(n)):
        raise ValueError(f"groups {groups} must cover nodes 0..{n - 1} "
                         f"once each")
    node_labels = (list(labels) if labels is not None
                   else [f"stage{k}" for k in range(n)])
    child_env = dict(os.environ)
    # the children import this package from where the parent did
    root = str(Path(__file__).resolve().parents[2])
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    child_env.update(env or {})
    labels = ["+".join(node_labels[k] for k in g) for g in groups]
    proc_of = {k: u for u, g in enumerate(groups) for k in g}

    last_exc: BaseException | None = None
    for attempt in range(max(1, spawn_retries)):
        procs, logs = [], []
        ports = _free_ports(n + 1)  # one listen port per node + the result
        addrs = [f"127.0.0.1:{p}" for p in ports[:n]]
        result = f"127.0.0.1:{ports[-1]}"
        try:
            for g in groups:
                # log to files, not PIPEs: an undrained pipe fills and
                # deadlocks a chatty child mid-chain
                name = "node_" + "+".join(str(k) for k in g)
                lf = open(os.path.join(log_dir, f"{name}.log"), "w+")
                logs.append(lf)
                argv = [sys.executable, "-m", "defer_tpu_torch", "node",
                        "--listen", addrs[g[0]], "--device", str(dev)]
                if argv_for is not None:
                    argv += argv_for(g[0], addrs, result)
                for k in g[1:]:
                    spec = (co_stage_for(k, addrs, result)
                            if co_stage_for is not None else "accept=1")
                    argv += ["--co-stage", f"listen={addrs[k]};{spec}"]
                procs.append(subprocess.Popen(
                    argv, env=child_env, stdout=lf,
                    stderr=subprocess.STDOUT))
            if on_spawn is not None:
                on_spawn(procs)
            _await_binds(procs, node_labels, logs, addrs,
                         proc_of=[proc_of[k] for k in range(n)])
            break
        except BaseException as e:
            _kill_procs(procs)
            for lf in logs:
                lf.close()
            if not isinstance(e, _BindRace):
                raise
            last_exc = e
            print(f"spawn_nodes: bind race on attempt {attempt + 1} ({e}); "
                  f"retrying on fresh ports", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"node spawn lost the port race {spawn_retries} "
                           f"times: {last_exc}") from last_exc

    try:
        yield NodeProcs(procs, addrs, result, logs, child_env)
        for pr in procs:
            try:
                pr.wait(timeout=_EXIT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait(timeout=_EXIT_TIMEOUT_S)
        for i, pr in enumerate(procs):
            if pr.returncode != 0:
                raise RuntimeError(f"chain node {labels[i]} exited "
                                   f"rc={pr.returncode}: "
                                   f"{_log_tail(logs[i])}")
    except BaseException as e:
        # diagnose: which children died, and why — each dead node's log
        # tail instead of the dispatcher's bare timeout
        _kill_procs(procs)
        dead = [(labels[i], pr.returncode, _log_tail(logs[i]))
                for i, pr in enumerate(procs)
                if pr.returncode not in (0, None)]
        races = [d for d in dead
                 if any(m in d[2] for m in _BIND_RACE_MARKS)]
        if races and len(races) == len(dead):
            raise _BindRace(
                f"{[d[0] for d in races]} lost the port bind race") from e
        if dead and not isinstance(e, RuntimeError):
            detail = "; ".join(f"node {lbl} rc={rc}: ...{tail[-800:]}"
                               for lbl, rc, tail in dead)
            raise RuntimeError(f"chain failed ({type(e).__name__}: {e}); "
                               f"dead nodes: {detail}") from e
        raise
    finally:
        for lf in logs:
            lf.close()


#: the tiers a hop of ``run_chain`` may name
_HOP_TIERS = ("tcp", "auto", "local", "shm", "ici", "device")


def _normalize_replicas(replicas, n: int) -> list[int]:
    """``{stage: R}`` -> each stage's replica count, validated: in range,
    >= 1, and never two adjacent replicated stages (a replica cannot
    restore another fan-out's sequence order)."""
    r_of = [1] * n
    for k, r in (replicas or {}).items():
        k, r = int(k), int(r)
        if not 0 <= k < n:
            raise ValueError(f"replicas: stage {k} out of range 0..{n - 1}")
        if r < 1:
            raise ValueError(f"replicas: stage {k} count {r} must be >= 1")
        r_of[k] = r
    for k in range(n - 1):
        if r_of[k] > 1 and r_of[k + 1] > 1:
            raise ValueError(
                f"replicas: stages {k} and {k + 1} are both replicated; "
                f"adjacent replication is not supported")
    return r_of


def _normalize_hop_tiers(hop_tiers, n: int, default: str,
                         r_of: Sequence[int] | None = None) -> list[str]:
    """One tier per inter-stage hop, validated: known names, one entry per
    hop (``default`` on every hop when ``hop_tiers`` is None, checked the
    same way), and no colocated hop (local/shm/ici/device) touching a
    replicated stage of ``r_of``: the fan paths ride tcp, and a silent
    downgrade there would belie the caller's topology."""
    tiers = ([default] * max(0, n - 1) if hop_tiers is None
             else [str(t) for t in hop_tiers])
    if len(tiers) != max(0, n - 1):
        raise ValueError(f"hop_tiers must have one entry per inter-stage "
                         f"hop ({n - 1}), got {len(tiers)}")
    r_of = list(r_of) if r_of is not None else [1] * n
    for k, t in enumerate(tiers):
        if t not in _HOP_TIERS:
            raise ValueError(f"hop_tiers[{k}] = {t!r}; "
                             f"use tcp|auto|local|shm|ici|device")
        if t in ("local", "shm", "ici", "device") \
                and (r_of[k] > 1 or r_of[k + 1] > 1):
            raise ValueError(
                f"hop_tiers[{k}] = {t!r} but stage {k} or {k + 1} is "
                f"replicated; fan paths ride tcp (drop the replicas or "
                f"the colocation)")
    return tiers


def run_chain(stages: Sequence, params: dict[str, Any], inputs,
              *, batch: int = 1, codec: str = "raw",
              artifact_dir: str | None = None,
              env: dict[str, str] | None = None,
              in_band: bool = False, overlap: bool = True,
              rx_depth: int | None = None, tx_depth: int | None = None,
              inflight: int | None = None,
              replicas: dict[int, int] | None = None,
              hop_codecs: Sequence[str] | None = None,
              hop_tiers: Sequence[str] | None = None,
              tier: str = "auto",
              devices: int | None = None,
              device_map: dict[int, int] | None = None,
              stage_delays: Sequence[float] | None = None,
              stats_out: list | None = None,
              spawn_retries: int = 3,
              on_spawn=None,
              trace_sample_every: int = 0,
              plan=None, graph=None,
              report_interval_ms: float = 250.0,
              failover: bool = False,
              journal_dir: str | None = None,
              device: str = "cuda") -> list:
    """Export, spawn the stages' node processes, deploy, stream, tear down:
    :func:`deploy_chain` and one ``stream`` of ``inputs``.

    The one-call analogue of the reference's whole deployment procedure
    (start N ``node.py`` processes, run the dispatcher,
    src/dispatcher.py:44-65 + test/test.py).  Every node runs its program
    on ``device`` (``"cuda"``, the default, or ``"cpu"``); the nodes are
    spawned by :func:`spawn_nodes`, which builds the hand kernels first on
    the card.

    ``in_band=True`` boots every node empty and ships each stage artifact
    over its control connection with an ACK handshake; ``in_band=False``
    exports the artifacts to ``artifact_dir`` (a temporary directory by
    default) and passes paths on the command line.  ``hop_codecs`` (one
    per stage) sets each stage's OUTBOUND hop codec (default ``codec``;
    the dispatcher -> stage 0 hop always uses ``codec``).
    ``stage_delays`` (seconds per stage) adds bench-only simulated device
    time per frame.  ``stats_out`` (a list) receives every node's
    ``stats`` reply, queried before teardown (each row carries its hop's
    negotiated ``tier``).  ``trace_sample_every=N`` switches per-frame
    spans to 1-in-N sampling when tracing is on; the nodes' spans are
    collected into this process's tracer.  ``env`` overrides entries of
    the children's environment.

    Transport tiers: ``hop_tiers`` (one per inter-stage hop) names each
    boundary's tier:

    * ``"device"`` — the two stages are fused into one exported program
      before spawn (``partition.fuse_stages``): the hop ceases to exist.
    * ``"ici"`` — the two stages share one OS process (the downstream one
      boards the upstream's process as a ``--co-stage`` serve thread) and
      the hop hands the output tensor over on the card: no copy to the
      host (zero ``host_sync`` samples), and one device-to-device move
      when ``device_map`` puts the stages on distinct cards.
    * ``"local"`` — one OS process as for ici; the hop hands the host
      copy by reference.
    * ``"shm"`` — separate processes; the payload crosses a shared-memory
      ring and the socket carries only doorbells.
    * ``"auto"`` — separate processes; the hop walks the ladder ici >
      local > shm > tcp when it opens, so a same-host chain negotiates
      shm everywhere without being asked.
    * ``"tcp"`` — the wire, no probe.

    A hop whose offer is refused anyway degrades to tcp with one labeled
    ``transport.tier_fallback.<hop>`` count.  ``tier`` is the policy of
    the dispatcher's edges (dispatcher -> stage 0, last stage -> result
    server) and the default of ``hop_tiers``: ``"auto"``, ``"shm"``, or
    ``"tcp"`` for a pure wire chain end to end (``ici``/``local`` cannot
    hold there: the dispatcher is a process of its own).  ``devices=N``
    asks for N visible CUDA cards (``ValueError`` naming the count when
    there are fewer), and ``device_map`` ({stage: card index}) pins each
    stage's program to ``cuda:J``.  ``run_chain`` first sweeps
    ``/dev/shm`` for segments a killed chain left behind.

    Children that exit with an address-in-use bind failure (the
    ``_free_ports`` race), at boot or later, and a dispatcher that loses
    the race for its result port, are retried on fresh ports, up to
    ``spawn_retries`` attempts; any other child death surfaces that
    node's log tail.  On any failure every child is terminated before the
    error propagates.  ``on_spawn(procs)`` is called with each spawn's
    ``subprocess.Popen`` list.

    Replication: ``replicas`` ({stage: R}) runs stage k as R node
    processes fed round-robin with sequence numbers and merged back in
    order below them (one artifact deployed to each); two adjacent stages
    cannot both be replicated, the hops touching a replicated stage ride
    tcp, and replicas need the overlapped loop.  ``stats_out`` then holds
    a row per replica.  ``failover=True`` arms the seq-replay plane: the
    fan-out above a replicated stage retains frames until the fan-in
    below acks them, the replicas relay the acks, and a supervisor
    respawns a replica process that dies from its argv on its port, so a
    ``kill -9`` of a replica mid-stream still gives a byte-identical
    stream.  It needs ``in_band=False`` (the respawn boots from the
    artifact path on its argv), at least one replicated stage, and every
    replicated stage interior (a fan-out above it, a fan-in below it).

    Live observability: with tracing on, every node's clock is aligned to
    this process's before the stream.  ``plan`` (the deployment's solved
    ``plan.solver.Plan``) together with ``stats_out`` watches every node's
    push stream (``report_interval_ms`` apart) with an
    ``obs.cluster.ClusterView`` while the stream runs, and appends one
    ``{"obs": {"rows", "bottleneck", "stragglers"}}`` entry to
    ``stats_out`` after the nodes' rows; with ``graph`` too the entry adds
    a ``replan`` suggestion fed with the live measurements.
    ``journal_dir`` arms the black box: every node process and this
    dispatcher journal their events, rows and spans under the directory
    (``obs/journal.py``), a failover respawn assembles a postmortem bundle
    naming the first fault, and a failed run assembles one before the
    error propagates (``obs.postmortem.maybe_autopsy``).
    """
    with deploy_chain(
            stages, params, batch=batch, codec=codec,
            artifact_dir=artifact_dir, env=env, in_band=in_band,
            overlap=overlap, rx_depth=rx_depth, tx_depth=tx_depth,
            inflight=inflight, replicas=replicas, hop_codecs=hop_codecs,
            hop_tiers=hop_tiers, tier=tier, devices=devices,
            device_map=device_map, stage_delays=stage_delays,
            spawn_retries=spawn_retries, on_spawn=on_spawn,
            trace_sample_every=trace_sample_every,
            plan=plan if stats_out is not None else None, graph=graph,
            report_interval_ms=report_interval_ms,
            failover=failover, journal_dir=journal_dir,
            device=device) as chain:
        disp = chain.dispatcher
        outs = disp.stream(inputs)
        if stats_out is not None:
            # queried while the nodes still serve (they exit once the
            # dispatcher's close cascades END)
            stats_out.extend(disp.stats(chain.addrs))
            if chain.view is not None:
                stats_out.append({"obs": chain.obs()})
        if tracer().enabled:
            try:
                disp.collect_trace(chain.addrs)
            except (OSError, ConnectionError) as e:
                print(f"run_chain: trace collection failed: {e!r}",
                      file=sys.stderr)
    return outs


class ChainSession(NamedTuple):
    """A spawned, deployed chain that :func:`deploy_chain` yields."""

    dispatcher: "ChainDispatcher"   # connected on the first stream
    addrs: list       # every node's address, stage by stage (replicas in
    #                   order): what ``stats`` and ``collect_trace`` take
    procs: list       # the node processes (subprocess.Popen); a respawn
    #                   replaces its corpse in place
    boot_s: float     # spawn to the last node's bind
    deploy_s: float   # the in-band deploy (0 for artifacts on argv)
    stage_addrs: list  # each stage's node addresses (R for a replicated one)
    units: list       # each process's (stage, replica) nodes
    respawns: list    # the supervisor's respawns: stage, replica, addr,
    #                   rc, spawned_at (time.time()), and once the new
    #                   process's listening line shows, bind_s and ready_s:
    #                   the seconds to its bind and to the line (it binds
    #                   first, then makes its CUDA context and loads its
    #                   artifact, then prints the line)
    view: Any = None  # the live ClusterView over every node (plan= only)
    plan: Any = None
    graph: Any = None

    def pid(self, stage: int, replica: int = 0) -> int:
        """The pid of the process that runs replica ``replica`` of
        ``stage`` now (after a respawn, the new process's)."""
        for u, members in enumerate(self.units):
            if (stage, replica) in members:
                return self.procs[u].pid
        raise KeyError(f"no node for stage {stage} replica {replica}")

    def obs(self) -> dict:
        """The live view against the plan, now: every node's row, the
        bottleneck stage, the straggler flags and, with a graph, the
        replanner's suggestion (the JAX package's ``obs`` entry)."""
        from ..obs.cluster import StragglerDetector, expected_stage_ms
        det = StragglerDetector(expected_stage_ms(self.plan))
        out = {"rows": self.view.rows(),
               "bottleneck": self.view.bottleneck(),
               "stragglers": [f.to_json() for f in det.observe(self.view)]}
        if self.graph is not None:
            try:
                out["replan"] = det.suggest(self.view, self.graph,
                                            self.plan).to_json()
            except Exception as e:  # noqa: BLE001 — advisory only
                out["replan_error"] = repr(e)
        return out


def _supervise(nodes: NodeProcs, units, r_of, stop: threading.Event,
               respawns: list, journal_dir: str | None = None) -> None:
    """The failover supervisor: poll the node processes, and respawn a
    replica process that died, from its original argv on the same port
    (the upstream fan-out's redial bridges the gap and replays its unacked
    window once the new process binds).  A ``kill -9`` skips every unlink,
    so orphan shm segments are swept first.  The corpse's entry of
    ``nodes.procs`` is replaced, so the exit check judges the respawn.  A
    death that is not a replica's ends the supervision and is left to the
    teardown to report.  Each respawn emits ``replica_respawn`` and is
    recorded in ``respawns``; once the new process's listening line shows
    (printed after its boot), the record gets the seconds to the bind the
    line carries and to the line itself.  With ``journal_dir`` each respawn
    also assembles a postmortem bundle there (rate-limited; the delay lets
    the respawn's own event reach the journals first)."""
    watching: list[tuple[dict, str, int]] = []
    while not stop.wait(0.2):
        for rec, path, before in list(watching):
            lines = re.findall(
                rf"listening on {re.escape(rec['addr'])},.*?bound at "
                rf"([0-9.]+)", Path(path).read_text(errors="replace"))
            if len(lines) > before:
                rec["ready_s"] = time.time() - rec["spawned_at"]
                rec["bind_s"] = float(lines[-1]) - rec["spawned_at"]
                watching.remove((rec, path, before))
        for idx, unit in enumerate(units):
            rc = nodes.procs[idx].poll()
            if rc is None or rc == 0:
                continue
            if len(unit) != 1 or r_of[unit[0][0]] <= 1:
                return  # not respawnable: the teardown reports the death
            k, j = unit[0]
            addr = nodes.addrs[sum(r_of[:k]) + j]
            sweep_orphan_segments()
            path = nodes.logs[idx].name
            before = len(re.findall(
                rf"listening on {re.escape(addr)},.*?bound at ",
                Path(path).read_text(errors="replace")))
            # O_APPEND: the child's lines land after the corpse's whatever
            # the parent's read offset on the shared log
            log = open(path, "a")
            rec = {"stage": k, "replica": j, "addr": addr, "rc": rc,
                   "spawned_at": time.time(), "bind_s": None,
                   "ready_s": None}
            nodes.procs[idx] = subprocess.Popen(
                nodes.procs[idx].args, env=nodes.env, stdout=log,
                stderr=subprocess.STDOUT)
            log.close()
            respawns.append(rec)
            watching.append((rec, path, before))
            emit_event("replica_respawn", stage=k, replica=j, addr=addr,
                       rc=rc)
            print(f"deploy_chain: respawned stage{k}.r{j} (rc={rc})",
                  file=sys.stderr, flush=True)
            if journal_dir is not None:
                maybe_autopsy(f"failover: respawned stage{k}.r{j} rc={rc}",
                              journal_dir=journal_dir,
                              delay_s=_AUTOPSY_DELAY_S)


@contextlib.contextmanager
def deploy_chain(stages: Sequence, params: dict[str, Any], *,
                 batch: int = 1, codec: str = "raw",
                 artifact_dir: str | None = None,
                 env: dict[str, str] | None = None,
                 in_band: bool = False, overlap: bool = True,
                 rx_depth: int | None = None, tx_depth: int | None = None,
                 inflight: int | None = None,
                 replicas: dict[int, int] | None = None,
                 hop_codecs: Sequence[str] | None = None,
                 hop_tiers: Sequence[str] | None = None,
                 tier: str = "auto",
                 devices: int | None = None,
                 device_map: dict[int, int] | None = None,
                 stage_delays: Sequence[float] | None = None,
                 spawn_retries: int = 3,
                 on_spawn=None,
                 trace_sample_every: int = 0,
                 plan=None, graph=None,
                 report_interval_ms: float = 250.0,
                 failover: bool = False,
                 journal_dir: str | None = None,
                 device: str = "cuda",
                 persist: bool = False):
    """The chain :func:`run_chain` streams through, held open: validate,
    export, spawn the node processes, deploy, and yield a
    :class:`ChainSession` whose dispatcher streams as often as the caller
    likes; leaving the block closes the dispatcher (END cascades) and
    waits for every node to exit 0.  The arguments are
    :func:`run_chain`'s, and ``persist``: every node survives the END of a
    stream segment (``node --persist``), so the caller may end a segment
    (``dispatcher.end_stream()``), deploy the same nodes again in-band
    (``dispatcher.deploy``, another codec, say) and stream a new segment;
    leaving the block then also sends every node ``shutdown``.  A bind
    race before the yield retries on fresh ports; a failure inside the
    block kills every node first.  Under
    ``failover`` the supervisor (:func:`_supervise`) runs for the whole
    session and stops before the teardown, so the END cascade's exits
    never read as deaths; ``ChainSession.pid`` names a replica's process
    for a caller that kills one.  With ``plan`` the session's ``view``
    watches every node from the deploy on and ``ChainSession.obs()`` reads
    it against the plan; ``journal_dir`` journals every process and
    assembles a postmortem bundle on a respawn or a failure (see
    :func:`run_chain`).
    """
    dev = resolve_device(device)
    sweep_orphan_segments()
    n = len(stages)
    r_of = _normalize_replicas(replicas, n)
    if any(r > 1 for r in r_of) and not overlap:
        raise ValueError("replicas require the overlapped node loop "
                         "(drop overlap=False / --no-overlap)")
    if failover:
        if in_band:
            raise ValueError(
                "failover requires in_band=False: the supervisor respawns "
                "a dead replica from its original argv, which must carry "
                "the artifact path")
        if not any(r > 1 for r in r_of):
            raise ValueError(
                "failover requires at least one replicated stage "
                "(replicas={k: R}) — an unreplicated stage's death has no "
                "surviving peer to absorb its slots")
        for k in range(n):
            if r_of[k] > 1 and not 0 < k < n - 1:
                raise ValueError(
                    f"failover: replicated stage {k} must be interior "
                    f"(0 < k < {n - 1}) — the replay/ack plane needs a "
                    f"fan-out stage above it and a fan-in stage below it")
    if tier not in ("tcp", "auto", "shm"):
        if tier in ("ici", "local"):
            raise ValueError(
                f"tier={tier!r} cannot hold on the dispatcher edges of a "
                f"spawned chain (the dispatcher is a separate process); "
                f"pin the stage hops with hop_tiers=[{tier!r}, ...] and "
                f"keep tier='auto'")
        raise ValueError(f"tier must be tcp|auto|shm, got {tier!r}")
    tiers = _normalize_hop_tiers(hop_tiers, n, tier, r_of)
    claimed = [t for t in tiers if t in ("local", "shm", "ici")]
    if not overlap and claimed:
        # the serial loop is the pure-wire baseline and refuses every
        # offer: an explicit claim would run over tcp under a tier claim
        raise ValueError(f"hop_tiers {claimed[0]!r} requires the overlapped "
                         f"node loop (drop overlap=False / --no-overlap)")
    device_map = {int(k): int(v) for k, v in (device_map or {}).items()}
    for k, v in device_map.items():
        if not 0 <= k < n:
            raise ValueError(f"device_map: stage {k} out of range "
                             f"0..{n - 1}")
        if v < 0:
            raise ValueError(f"device_map: stage {k} device {v} must be "
                             f">= 0")
    if device_map and any(t == "device" for t in tiers):
        # fusion renumbers the stages: a pin would land on the wrong one
        raise ValueError(
            "device_map does not compose with device-tier fusion (fusion "
            "renumbers the stages); fuse first and pin the fused chain, or "
            "drop the 'device' hops")
    if device_map and devices is None:
        devices = max(device_map.values()) + 1
    if devices is not None:
        bad = [v for v in device_map.values() if v >= devices]
        if bad:
            raise ValueError(f"device_map names cuda:{bad[0]} but devices="
                             f"{devices}")
        have = torch.cuda.device_count() if dev.type == "cuda" else 0
        if devices > have:
            raise ValueError(f"devices={devices} needs {devices} visible "
                             f"CUDA devices; this process sees {have} "
                             f"(device={str(dev)!r})")
    if hop_codecs is not None and len(hop_codecs) != n:
        raise ValueError(f"hop_codecs must have one entry per stage ({n}), "
                         f"got {len(hop_codecs)}")
    codec_of = list(hop_codecs) if hop_codecs is not None else [codec] * n
    if stage_delays is not None and len(stage_delays) != n:
        raise ValueError(f"stage_delays must have one entry per stage "
                         f"({n}), got {len(stage_delays)}")
    delay_of = ([float(d) for d in stage_delays]
                if stage_delays is not None else [0.0] * n)
    if in_band and any(delay_of):
        raise ValueError("stage_delays ride the node's argv: pass "
                         "in_band=False with them")
    if any(t == "device" for t in tiers):
        # adjacent stages on one device become one exported program (never
        # a replicated one: the adjacency check above refuses that)
        from ..partition.partitioner import fuse_stages
        stages, groups = fuse_stages(list(stages), tiers)
        r_of = [r_of[g[0]] for g in groups]
        codec_of = [codec_of[g[-1]] for g in groups]
        delay_of = [sum(delay_of[i] for i in g) for g in groups]
        tiers = [tiers[g[-1]] for g in groups[:-1]]
        n = len(stages)
    # the nodes: one per stage replica, stage by stage
    nodes_of = [(k, j) for k in range(n) for j in range(r_of[k])]
    first = [sum(r_of[:k]) for k in range(n)]   # stage k's first node
    # maximal runs of stages joined by local or ici hops share one OS
    # process: both tiers hand a live object within one address space (a
    # replicated stage never joins a run, so each replica is a process)
    coloc = [[0]] if n else []
    for k in range(n - 1):
        if tiers[k] in ("local", "ici"):
            coloc[-1].append(k + 1)
        else:
            coloc.append([k + 1])
    if any(delay_of[k] for g in coloc for k in g[1:]):
        raise ValueError("stage_delays ride a process's own node: a stage "
                         "behind a local or ici hop (a co-stage) takes none")
    units = []
    for g in coloc:
        if len(g) == 1:
            units += [[(g[0], j)] for j in range(r_of[g[0]])]
        else:
            units.append([(k, 0) for k in g])
    #: each stage's OUTBOUND tier policy: a claimed rung is offered alone
    tier_of = [t if t != "device" else "tcp" for t in tiers] + [tier]
    tuning = [] if overlap else ["--no-overlap"]
    if failover:
        tuning += ["--failover"]
    if persist:
        tuning += ["--persist"]
    for flag, v in (("--rx-depth", rx_depth), ("--tx-depth", tx_depth),
                    ("--inflight", inflight)):
        if v is not None:
            tuning += [flag, str(v)]

    tmp = None
    if artifact_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="defer_chain_")
        artifact_dir = tmp.name
    started_journal = False
    if journal_dir is not None and active_journal() is None:
        # the dispatcher is a member of the fleet too: its events (the
        # respawns, the stream's lifecycle) are a bundle's spine
        start_journal(journal_dir, "dispatcher")
        started_journal = True
    try:
        paths = None
        if not in_band:
            from ..utils.export import export_pipeline
            paths = export_pipeline(stages, params, artifact_dir,
                                    batch=batch)

        def next_of(k: int, addrs, result) -> str:
            return (",".join(addrs[first[k + 1]:first[k + 1] + r_of[k + 1]])
                    if k + 1 < n else result)

        def argv_for(i: int, addrs, result) -> list[str]:
            k, j = nodes_of[i]
            argv = ([] if device_map.get(k) is None
                    else ["--device", str(device_map[k])])
            argv += ["--tier", tier_of[k]]
            if (tier if k == 0 else tier_of[k - 1]) != "tcp":
                # the inbound hop offers a tier whatever this stage's own
                # outbound policy says: grant it
                argv += ["--tier-accept", "1"]
            if not in_band:
                argv += ["--artifact", paths[k],
                         "--next", next_of(k, addrs, result),
                         "--codec", codec_of[k]]
                if k > 0 and r_of[k - 1] > 1:
                    argv += ["--fan-in", str(r_of[k - 1])]
                if r_of[k] > 1:
                    argv += ["--replica", str(j)]
                if delay_of[k]:
                    argv += ["--infer-delay-ms", str(delay_of[k] * 1e3)]
            if journal_dir is not None:
                argv += ["--journal-dir", journal_dir]
            return argv + tuning

        def co_stage_for(i: int, addrs, result) -> str:
            k, _ = nodes_of[i]
            # accept=1: the hop into a co-stage is the in-process boundary
            # that put it in this process
            spec = f"accept=1;tier={tier_of[k]}"
            if not in_band:
                spec += (f";artifact={paths[k]};codec={codec_of[k]}"
                         f";next={next_of(k, addrs, result)}")
            if device_map.get(k) is not None:
                spec += f";device={device_map[k]}"
            return spec

        ahead = None
        if in_band:
            # the in-band deploy traces each stage's program here: trace
            # them while the nodes boot, so the deploy finds them ready
            from ..utils.export import trace_stage

            def trace_ahead():
                try:
                    for s in stages:
                        trace_stage(s, params, batch=batch)
                except Exception:  # noqa: BLE001 — the deploy raises it
                    pass

            ahead = threading.Thread(target=trace_ahead, daemon=True,
                                     name="chain-trace-ahead")
            ahead.start()

        last_exc: BaseException | None = None
        yielded = False
        for attempt in range(max(1, spawn_retries)):
            try:
                t0 = time.perf_counter()
                with spawn_nodes(
                        len(nodes_of), log_dir=artifact_dir,
                        device=str(dev), argv_for=argv_for,
                        co_stage_for=co_stage_for,
                        groups=[[first[k] + j for k, j in u]
                                for u in units],
                        labels=[f"stage{k}" if r_of[k] == 1
                                else f"stage{k}.r{j}" for k, j in nodes_of],
                        env=env, on_spawn=on_spawn,
                        spawn_retries=spawn_retries) as nodes:
                    boot_s = time.perf_counter() - t0
                    stage_addrs = [nodes.addrs[first[k]:first[k] + r_of[k]]
                                   for k in range(n)]
                    try:
                        disp = ChainDispatcher(
                            ",".join(stage_addrs[0]), listen=nodes.result,
                            codec=codec, tx_depth=tx_depth or 8,
                            rx_depth=rx_depth or 8,
                            result_fan_in=r_of[-1],
                            trace_sample_every=trace_sample_every,
                            tier=tier)
                    except OSError as e:
                        if any(m in str(e) for m in _BIND_RACE_MARKS):
                            raise _BindRace(f"dispatcher lost the "
                                            f"result-port bind race "
                                            f"({e})") from e
                        raise
                    stop = threading.Event()
                    supervisor = view = None
                    failed = True
                    try:
                        t0 = time.perf_counter()
                        if ahead is not None:
                            ahead.join()  # its rest counts as deploy time
                        if in_band:
                            disp.deploy(stages, params,
                                        [a[0] if len(a) == 1 else a
                                         for a in stage_addrs],
                                        batch=batch, codecs=codec_of,
                                        tiers=tier_of,
                                        devices=[device_map.get(k)
                                                 for k in range(n)])
                        deploy_s = time.perf_counter() - t0
                        if tracer().enabled:
                            # one timeline across the processes: align
                            # every node before any stream span records
                            try:
                                disp.align_clocks(nodes.addrs)
                            except (OSError, ConnectionError) as e:
                                print(f"run_chain: clock alignment "
                                      f"failed: {e!r}", file=sys.stderr)
                        if plan is not None:
                            view = disp.watch(
                                nodes.addrs, interval_ms=report_interval_ms)
                        respawns: list = []
                        if failover:
                            supervisor = threading.Thread(
                                target=_supervise,
                                args=(nodes, units, r_of, stop, respawns,
                                      journal_dir),
                                daemon=True, name="chain-supervisor")
                            supervisor.start()
                        yielded = True
                        yield ChainSession(disp, nodes.addrs, nodes.procs,
                                           boot_s, deploy_s, stage_addrs,
                                           units, respawns, view, plan,
                                           graph)
                        failed = False
                    finally:
                        # stop before the teardown: the END cascade exits
                        # every node, and an exit must not read as a death
                        stop.set()
                        if supervisor is not None:
                            supervisor.join(timeout=5.0)
                        if view is not None:
                            view.close()
                        if failed:
                            # kill the nodes first, so the dispatcher's
                            # drain hits dead sockets instead of waiting
                            # out its timeouts
                            _kill_procs(nodes.procs)
                        disp.close()
                        if persist and not failed:
                            disp.shutdown_nodes(nodes.addrs)
                return
            except _BindRace as e:
                if yielded:
                    raise RuntimeError(f"a chain node lost a port after "
                                       f"the chain started: {e}") from e
                last_exc = e
                print(f"run_chain: bind race on attempt {attempt + 1} "
                      f"({e}); retrying on fresh ports", file=sys.stderr,
                      flush=True)
        raise RuntimeError(f"chain spawn lost the port race "
                           f"{spawn_retries} times: {last_exc}") from last_exc
    except Exception as e:
        if journal_dir is not None:
            # the failure is the postmortem's trigger: spill this
            # process's journal, then assemble the bundle before the error
            # propagates (the nodes' journals are on disk, dead or alive)
            if started_journal:
                stop_journal()
                started_journal = False
            maybe_autopsy(f"run_chain: {type(e).__name__}: {e}",
                          journal_dir=journal_dir, sync=True, delay_s=0.0)
        raise
    finally:
        if started_journal:
            stop_journal()
        if tmp is not None:
            tmp.cleanup()


# ---------------------------------------------------------------------------
# run_dag_chain: one OS process per topology vertex of a branched graph
# ---------------------------------------------------------------------------

def _dag_flags(v, artifact: str, *, addrs, result_addr: str,
               codec: str = "raw",
               stage_delays: dict | None = None) -> list[str]:
    """The ``node`` flags of one topology vertex after its ``--listen``
    and ``--device``: its artifact, next hops, codec, tcp, and its role."""
    nxt = ",".join(addrs[n] for n in v.next) if v.next else result_addr
    argv = ["--artifact", artifact, "--next", nxt,
            "--codec", v.codec or codec, "--tier", "tcp"]
    if v.fan == "broadcast":
        argv += ["--fan", "broadcast"]
    if v.branch is not None:
        argv += ["--branch", str(v.branch)]
    if v.join >= 2:
        argv += ["--join", str(v.join)]
    if stage_delays and stage_delays.get(v.vid):
        argv += ["--infer-delay-ms", str(stage_delays[v.vid] * 1e3)]
    return argv


def dag_vertex_argv(v, artifact: str, *, addrs, result_addr: str,
                    codec: str = "raw", stage_delays: dict | None = None,
                    device: str = "cuda") -> list[str]:
    """argv for one topology vertex's ``python -m defer_tpu_torch node``
    process: the single source of truth for the branched deployment's
    shape (:func:`run_dag_chain` spawns its vertices with these flags, so
    a script that spawns through it measures what ``chain --dag``
    ships).  ``addrs[v.vid]`` is the vertex's own listen address."""
    return ([sys.executable, "-m", "defer_tpu_torch", "node",
             "--listen", addrs[v.vid], "--device", str(device)]
            + _dag_flags(v, artifact, addrs=addrs, result_addr=result_addr,
                         codec=codec, stage_delays=stage_delays))


def run_dag_chain(graph, params, inputs, *, topology, batch: int = 1,
                  codec: str = "raw", artifact_dir: str | None = None,
                  env: dict[str, str] | None = None,
                  rx_depth: int | None = None, tx_depth: int | None = None,
                  inflight: int | None = None,
                  stage_delays: dict | None = None,
                  replicas=None, hop_tiers=None,
                  stats_out: list | None = None,
                  spawn_retries: int = 3, on_spawn=None,
                  trace_sample_every: int = 0,
                  device: str = "cuda",
                  timings_out: dict | None = None,
                  timeout_s: float | None = None) -> list:
    """Spawn a branched process pipeline — one OS process per topology
    vertex — stream ``inputs``, tear down: the DAG analogue of
    :func:`run_chain`.

    ``topology`` is a :class:`~defer_tpu_torch.runtime.topology.ChainTopology`
    (``ChainTopology.from_json`` of a ``plan --dag --json`` document, of
    either package): trunk vertices relay as usual, a fork vertex
    broadcasts every frame to all of its region's paths under one sequence
    stamp, branch vertices ride labeled paths, and the join vertex merges
    all P paths per sequence before its P-input program runs.  Outputs
    return in order.  Every vertex runs on ``device`` (the CUDA card by
    default); the processes are spawned by :func:`spawn_nodes`, which
    builds the hand kernels first on the card.

    ``stage_delays`` (vertex id -> seconds) adds bench-only simulated
    device time per vertex.  ``stats_out`` receives every vertex's
    ``stats`` reply, queried before teardown.  ``timings_out`` receives
    ``export_s`` (the artifacts, before any spawn), ``boot_s`` (spawn to
    the last bind), ``first_result_s`` (from the stream's start) and
    ``stream_s``; ``timeout_s`` bounds the dispatcher's waits (default
    :attr:`ChainDispatcher.timeout_s`).

    Replication and colocation tiers do not compose with a branched
    topology (the two fan machineries own different sequence namespaces;
    every branch hop is wire-framed): ``replicas`` and ``hop_tiers`` raise
    ``ValueError`` before any process spawns.
    """
    if replicas:
        raise ValueError(
            "replicas do not compose with a branched topology (a branch "
            "hop touching a replicated stage is rejected like any fan "
            "hop); drop the replicas or run a linear chain")
    if hop_tiers:
        raise ValueError(
            "hop_tiers do not compose with a branched topology yet — "
            "every branch fan-out/join hop is wire-framed by design")
    dev = resolve_device(device)
    stages = topology.stage_specs(graph)
    tmp = None
    if artifact_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="defer_dag_")
        artifact_dir = tmp.name
    try:
        from ..utils.export import export_stage
        t0 = time.perf_counter()
        paths = []
        for v, stage in zip(topology.vertices, stages):
            p = os.path.join(artifact_dir, f"vertex_{v.vid}.zip")
            export_stage(stage, params, p, batch=batch)
            paths.append(p)
        if timings_out is not None:
            timings_out["export_s"] = time.perf_counter() - t0
        tuning = []
        for flag, val in (("--rx-depth", rx_depth),
                          ("--tx-depth", tx_depth),
                          ("--inflight", inflight)):
            if val is not None:
                tuning += [flag, str(val)]
        last_exc: BaseException | None = None
        for attempt in range(max(1, spawn_retries)):
            try:
                return _dag_attempt(
                    topology, paths, inputs, codec=codec, env=env,
                    artifact_dir=artifact_dir, tuning=tuning,
                    rx_depth=rx_depth, tx_depth=tx_depth,
                    stage_delays=stage_delays or {}, stats_out=stats_out,
                    on_spawn=on_spawn, spawn_retries=spawn_retries,
                    trace_sample_every=trace_sample_every, device=str(dev),
                    timings_out=timings_out, timeout_s=timeout_s)
            except _BindRace as e:
                last_exc = e
                print(f"run_dag_chain: bind race on attempt {attempt + 1} "
                      f"({e}); retrying on fresh ports", file=sys.stderr,
                      flush=True)
        raise RuntimeError(
            f"dag chain spawn lost the port race {spawn_retries} times: "
            f"{last_exc}") from last_exc
    finally:
        if tmp is not None:
            tmp.cleanup()


def _dag_attempt(topology, paths, inputs, *, codec, env, artifact_dir,
                 tuning, rx_depth, tx_depth, stage_delays, stats_out,
                 on_spawn, spawn_retries, trace_sample_every, device,
                 timings_out, timeout_s):
    """One spawn -> stream -> teardown attempt of a branched topology (see
    :func:`run_dag_chain`), with :func:`run_chain`'s discipline: a bind
    race raises :class:`_BindRace` for a retry, any other failure kills
    every vertex and names the dead ones' log tails."""
    vs = topology.vertices

    def argv_for(k: int, addrs, result) -> list[str]:
        return _dag_flags(vs[k], paths[k], addrs=addrs, result_addr=result,
                          codec=codec, stage_delays=stage_delays) + tuning

    t0 = time.perf_counter()
    with spawn_nodes(len(vs), log_dir=artifact_dir, device=device,
                     argv_for=argv_for, labels=[v.label for v in vs],
                     env=env, on_spawn=on_spawn,
                     spawn_retries=spawn_retries) as nodes:
        boot_s = time.perf_counter() - t0
        try:
            disp = ChainDispatcher(nodes.addrs[0], listen=nodes.result,
                                   codec=codec, tx_depth=tx_depth or 8,
                                   rx_depth=rx_depth or 8,
                                   timeout_s=timeout_s,
                                   trace_sample_every=trace_sample_every,
                                   tier="tcp")
        except OSError as e:
            if any(m in str(e) for m in _BIND_RACE_MARKS):
                raise _BindRace(f"dispatcher lost the result-port bind "
                                f"race ({e})") from e
            raise
        failed = True
        try:
            t1 = time.perf_counter()
            outs = disp.stream(inputs)
            if timings_out is not None:
                timings_out.update(boot_s=boot_s,
                                   first_result_s=disp.first_result_s,
                                   stream_s=time.perf_counter() - t1)
            if stats_out is not None:
                stats_out.extend(disp.stats(nodes.addrs))
            if tracer().enabled:
                try:
                    disp.collect_trace(nodes.addrs)
                except (OSError, ConnectionError) as e:
                    print(f"run_dag_chain: trace collection failed: {e!r}",
                          file=sys.stderr)
            failed = False
        finally:
            if failed:
                # kill the vertices first, so the dispatcher's drain hits
                # dead sockets instead of waiting out its timeouts
                _kill_procs(nodes.procs)
            disp.close()
    return outs
