"""Postmortem collector: one bundle from the fleet's black boxes.

The port's copy of ``defer_tpu.obs.postmortem`` (the bundle format
``defer_tpu.postmortem.v1`` is shared, as the journals are).

The journal (obs/journal.py) makes each process's telemetry survive
that process; this module makes the *fleet's* failure explainable.
:func:`collect` gathers every per-process journal under a
``--journal-dir`` — including (especially) the dead ones — aligns them
onto one wall-clock axis using their anchor records, and emits a
bundle directory:

* ``bundle.json`` — merged cross-process event timeline, last-known
  ClusterView-style row per process, per-process journal lifetimes,
  loud ``warnings`` (missing journals, torn segments, dropped-event
  evidence gaps), and the first-fault **verdict**;
* ``trace.json`` — a Perfetto/Chrome trace of the last ``last_s``
  seconds: every journaled span plus every event as an instant marker,
  all processes on one aligned timeline.

The verdict walks the aligned evidence backwards from the failure,
exactly the way a human would:

1. **who died first** — the process whose journal stops earliest,
   measurably before the survivors kept writing;
2. **who said so** — the first fatal event on the merged timeline
   (``watchdog dead``, ``node_dead``, ``backend_lost``,
   ``replica_lost``, ``failover``, ``replica_respawn``), which also
   names the victim when the supervisor respawned it;
3. **who backed up** — survivors whose upstream queue watermarks
   saturated in their final snapshot are casualties of the stall, not
   causes, and are ordered downstream of the victim.

:func:`maybe_autopsy` is the in-crisis entry point: failure paths
(``run_chain`` teardown, the failover supervisor, the dispatcher
watchdog, the serve front door's backend loss) call it fire-and-forget;
it assembles a bundle on a daemon thread, rate-limited per process,
and can never make the failure worse.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .events import merge_events
from .journal import JOURNAL_VERSION, active_journal, read_process_journals

#: bundle format version (bundle.json carries it)
BUNDLE_VERSION = "defer_tpu.postmortem.v1"

#: event kinds that are failure evidence, not routine telemetry
FATAL_KINDS = ("node_dead", "backend_lost", "replica_lost",
               "failover", "replica_respawn", "watchdog")

#: a queue watermark at >= this fraction of its depth in a process's
#: final snapshot reads as "backed up behind the fault" (the
#: ClusterView saturation convention)
SATURATION_FRAC = 0.9

#: a journal that stops this much before the latest-writing survivor
#: is an early stopper (must comfortably exceed the spill interval)
STALL_MARGIN_US = 1_000_000


def _is_fatal(ev: dict) -> bool:
    kind = ev.get("kind")
    if kind == "watchdog":
        return (ev.get("data") or {}).get("action") == "dead"
    return kind in FATAL_KINDS


def _victim_of(ev: dict) -> str | None:
    """The process label a fatal event names, where it names one."""
    data = ev.get("data") or {}
    kind = ev.get("kind")
    if kind == "replica_respawn" and data.get("stage") is not None:
        label = f"stage{data['stage']}"
        if data.get("replica") is not None:
            label += f".r{data['replica']}"
        return label
    if kind in ("node_dead",) and data.get("addr"):
        return str(data["addr"])
    return None


def _stage_index(proc: str) -> int | None:
    if proc.startswith("stage"):
        digits = ""
        for ch in proc[5:]:
            if ch.isdigit():
                digits += ch
            else:
                break
        if digits:
            return int(digits)
    return None


def _align(journal: dict) -> dict:
    """Shift one journal's records onto the wall-clock axis using its
    LAST anchor (the most recent clock correction wins), returning the
    digested per-process view the bundle uses."""
    anchors = [r for r in journal["records"] if r.get("rec") == "anchor"
               and isinstance(r.get("t_us"), int)
               and isinstance(r.get("wall_us"), int)]
    delta = (anchors[-1]["wall_us"] - anchors[-1]["t_us"]) if anchors else 0
    events: list[dict] = []
    spans: list[dict] = []
    dropped = 0
    snapshot = None
    snapshot_us = None
    lo = hi = None
    for r in journal["records"]:
        t = r.get("t_us")
        if isinstance(t, int):
            t += delta
            lo = t if lo is None else min(lo, t)
            hi = t if hi is None else max(hi, t)
        kind = r.get("rec")
        if kind == "events":
            dropped = max(dropped, int(r.get("dropped", 0) or 0))
            for ev in r.get("events") or []:
                ev = dict(ev)
                if isinstance(ev.get("t_us"), int):
                    ev["t_us"] += delta
                events.append(ev)
        elif kind == "spans":
            for s in r.get("spans") or []:
                s = dict(s)
                if isinstance(s.get("ts_us"), int):
                    s["ts_us"] += delta
                spans.append(s)
        elif kind == "snapshot":
            snapshot = r.get("payload")
            snapshot_us = t
    warnings = list(journal.get("warnings") or [])
    if not anchors:
        warnings.append(
            f"{journal['proc']}: no clock-anchor record — timeline "
            f"left on its raw tracer axis (alignment unverified)")
    return {"proc": journal["proc"], "pid": journal.get("pid"),
            "version": journal.get("version"), "delta_us": delta,
            "events": events, "spans": spans,
            "events_dropped": dropped,
            "snapshot": snapshot, "snapshot_us": snapshot_us,
            "first_us": lo, "last_us": hi,
            "truncated": bool(journal.get("truncated")),
            "segments": journal.get("segments", 0),
            "warnings": warnings}


def _saturated(snapshot: dict | None) -> list[str]:
    """Queue watermarks at/over SATURATION_FRAC of depth in a final
    snapshot — the 'backed up behind the fault' signal."""
    out = []
    q = (snapshot or {}).get("queues") or {}
    for side in ("rx", "tx"):
        depth = q.get(f"{side}_depth") or 0
        hi = q.get(f"{side}_hi") or 0
        if depth and hi >= SATURATION_FRAC * depth:
            out.append(f"{side} watermark {hi}/{depth}")
    return out


def _verdict(procs: list[dict], timeline: list[dict],
             reason: str | None) -> dict:
    """First-fault localization over the aligned evidence (see module
    docstring for the heuristics, in precedence order)."""
    evidence: list[str] = []
    last_writers = [p for p in procs if p["last_us"] is not None]
    global_last = max((p["last_us"] for p in last_writers), default=None)
    stoppers = sorted((p for p in last_writers
                       if global_last is not None
                       and p["last_us"] <= global_last - STALL_MARGIN_US),
                      key=lambda p: p["last_us"])
    fatal = next((ev for ev in timeline if _is_fatal(ev)), None)
    named = _victim_of(fatal) if fatal else None

    first_fault = None
    if stoppers:
        first_fault = stoppers[0]["proc"]
        evidence.append(
            f"journal of {first_fault} stops at "
            f"{stoppers[0]['last_us']} us, "
            f"{(global_last - stoppers[0]['last_us']) / 1e6:.2f}s before "
            f"the last surviving writer")
    if fatal is not None:
        evidence.append(
            f"first fatal event: {fatal['kind']} from {fatal['proc']} "
            f"at {fatal['t_us']} us {fatal.get('data')!r}")
        if named and first_fault is None:
            first_fault = named
        elif named and named != first_fault and \
                not str(first_fault).startswith(named):
            evidence.append(f"event names {named} (journal-stop and "
                            f"event evidence disagree)")
    if first_fault is None and reason:
        evidence.append(f"no early-stopped journal and no fatal event; "
                        f"collector reason: {reason}")

    casualties: list[dict] = []
    if first_fault is not None:
        victim_stage = _stage_index(first_fault)
        ranked = []
        for p in procs:
            if p["proc"] == first_fault:
                continue
            why = _saturated(p["snapshot"])
            stage = _stage_index(p["proc"])
            if stage is not None and victim_stage is not None:
                # downstream of the victim starves, upstream backs up;
                # order casualties downstream-first, nearest first
                order = (0, stage - victim_stage) \
                    if stage > victim_stage else (1, victim_stage - stage)
                role = ("downstream" if stage > victim_stage
                        else "upstream" if stage < victim_stage
                        else "peer replica")
            else:
                order, role = (2, 0), "control plane"
            if why or role != "control plane":
                ranked.append((order, {"proc": p["proc"], "role": role,
                                       "saturated": why}))
        ranked.sort(key=lambda t: t[0])
        casualties = [c for _, c in ranked]

    return {"first_fault": first_fault,
            "fatal_event": fatal,
            "evidence": evidence,
            "casualties": casualties,
            "reason": reason}


def _chrome_trace(procs: list[dict], cut_us: int | None) -> dict:
    """Perfetto view of the bundle's last window: journaled spans as
    complete events, flight-recorder events as instant markers."""
    pids: dict[str, int] = {}
    out: list[dict] = []

    def pid_of(proc: str) -> int:
        return pids.setdefault(proc, len(pids) + 1)

    for p in procs:
        for s in p["spans"]:
            ts = s.get("ts_us", 0)
            if cut_us is not None and ts + s.get("dur_us", 0) < cut_us:
                continue
            out.append({"name": s.get("name", "?"), "ph": "X",
                        "ts": ts, "dur": s.get("dur_us", 1),
                        "pid": pid_of(s.get("proc", p["proc"])),
                        "tid": s.get("tid", 0),
                        "cat": "span", "args": s.get("args") or {}})
        for ev in p["events"]:
            ts = ev.get("t_us", 0)
            if cut_us is not None and ts < cut_us:
                continue
            out.append({"name": ev.get("kind", "?"), "ph": "i",
                        "ts": ts, "pid": pid_of(ev.get("proc", p["proc"])),
                        "tid": 0, "s": "p", "cat": "event",
                        "args": ev.get("data") or {}})
    for proc, pid in pids.items():
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": proc}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def collect(journal_dir: str, *, out_dir: str | None = None,
            reason: str | None = None, last_s: float = 30.0) -> dict:
    """Assemble one postmortem bundle from the journals under
    ``journal_dir`` — dead processes welcome; no live control
    connection is used or needed.  Returns the bundle document (also
    written to ``<out_dir>/bundle.json`` + ``trace.json``).  Missing
    or empty journal dirs yield a loud partial bundle, never a
    crash."""
    journals = read_process_journals(journal_dir)
    procs = [_align(j) for j in journals]
    warnings: list[str] = []
    if not procs:
        warnings.append(
            f"PARTIAL BUNDLE: no journals found under {journal_dir!r} — "
            f"was the chain started with --journal-dir?")
    for p in procs:
        warnings.extend(p["warnings"])
        if p["truncated"]:
            warnings.append(
                f"{p['proc']}: final record torn mid-write (crash "
                f"artifact) — truncated at the tear, earlier records "
                f"intact")

    timeline = merge_events(*[p["events"] for p in procs])
    events_dropped = sum(p["events_dropped"] for p in procs)
    if events_dropped:
        # satellite: a bundle from rings that dropped records must
        # scream about the gap, not present a silently thinned timeline
        warnings.append(
            f"EVIDENCE GAP: {events_dropped} flight-recorder events "
            f"were dropped by ring eviction before journaling — the "
            f"timeline has holes (raise DEFER_EVENTS_CAP or shorten "
            f"the spill interval)")

    last_all = [p["last_us"] for p in procs if p["last_us"] is not None]
    cut_us = (max(last_all) - int(last_s * 1e6)) if last_all else None
    verdict = _verdict(procs, timeline, reason)
    verdict["events_dropped"] = events_dropped

    bundle = {
        "version": BUNDLE_VERSION,
        "journal_version": JOURNAL_VERSION,
        "journal_dir": journal_dir,
        "reason": reason,
        "warnings": warnings,
        "events_dropped": events_dropped,
        "procs": [{k: p[k] for k in
                   ("proc", "pid", "version", "delta_us", "first_us",
                    "last_us", "events_dropped", "truncated", "segments")}
                  for p in procs],
        "rows": {p["proc"]: p["snapshot"] for p in procs
                 if p["snapshot"] is not None},
        "timeline": timeline,
        "verdict": verdict,
    }
    if out_dir is None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        out_dir = os.path.join(journal_dir,
                               f"bundle-{stamp}-pid{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    bundle["out_dir"] = out_dir
    with open(os.path.join(out_dir, "bundle.json"), "w") as fh:
        json.dump(bundle, fh, indent=1, default=str)
    with open(os.path.join(out_dir, "trace.json"), "w") as fh:
        json.dump(_chrome_trace(procs, cut_us), fh, default=str)
    return bundle


# -- in-crisis entry point ----------------------------------------------

_AUTOPSY_LOCK = threading.Lock()
_LAST_AUTOPSY = 0.0


def maybe_autopsy(reason: str, *, journal_dir: str | None = None,
                  min_interval_s: float = 10.0,
                  sync: bool = False,
                  delay_s: float = 0.75) -> threading.Thread | None:
    """Fire-and-forget bundle assembly from a failure path.

    No-op unless this process is journaling (or an explicit
    ``journal_dir`` is given); rate-limited so a failover storm emits
    one bundle per episode, not one per casualty.  Runs on a daemon
    thread by default — a teardown path must not block on forensics —
    and swallows everything: the autopsy can never worsen the crash.
    ``delay_s`` lets the spillers flush the failure's own events
    (e.g. ``replica_respawn``) to disk before the bundle reads it."""
    global _LAST_AUTOPSY
    if journal_dir is None:
        sp = active_journal()
        if sp is None:
            return None
        journal_dir = os.path.dirname(sp.writer.dir)
    with _AUTOPSY_LOCK:
        now = time.monotonic()
        if now - _LAST_AUTOPSY < min_interval_s:
            return None
        _LAST_AUTOPSY = now

    def _run():
        try:
            if delay_s > 0:
                time.sleep(delay_s)
            bundle = collect(journal_dir, reason=reason)
            from .events import emit
            emit("postmortem", reason=reason, out=bundle["out_dir"],
                 procs=len(bundle["procs"]),
                 first_fault=(bundle["verdict"] or {}).get("first_fault"))
            print(f"postmortem: bundle at {bundle['out_dir']} "
                  f"(reason: {reason})", flush=True)
        except Exception:  # noqa: BLE001 — forensics must not re-crash
            pass

    if sync:
        _run()
        return None
    t = threading.Thread(target=_run, name="postmortem", daemon=True)
    t.start()
    return t
