"""Black-box journal: crash-surviving on-disk telemetry.

The port's copy of ``defer_tpu.obs.journal``.  The on-disk format is the
JAX package's byte for byte (records, segment names, the version string
``defer_tpu.journal.v1`` and the ``DEFER_JOURNAL_*`` variables), so either
package's ``postmortem.collect`` reads the other's journals.

Everything the observability plane knows — the flight-recorder event
ring, the metric registry, sampled spans — lives in process memory and
is only readable over a *live* control connection.  That is exactly
backwards for forensics: the more catastrophic the failure, the less
telemetry survives it.  This module is the flight-recorder's black box:
a background :class:`JournalSpiller` thread spills each process's
events, periodic registry/row snapshots, and sampled spans into an
append-only, size-bounded, crash-safe journal on disk, so a postmortem
(obs/postmortem.py) can reconstruct the fleet's last seconds from the
journals of processes that no longer exist.

Durability contract:

* **append-only segments** — each process owns one directory
  (``<root>/<proc>@<pid>/``) of numbered segment files; records are
  ``<crc32:u32><len:u32><json payload>`` so a torn final write (power
  cut, kill -9 mid-``write``) truncates cleanly at read time instead of
  poisoning the file.  Every flushed byte is in the kernel page cache —
  a SIGKILL of the process loses at most the current spill interval.
* **size-bounded ring** — segments rotate at ``segment_bytes`` and the
  OLDEST segment is deleted once the directory exceeds ``max_bytes``
  (``DEFER_JOURNAL_MAX_BYTES``), so a long-running chain journals
  forever in constant disk.
* **self-describing clock** — every segment opens with a ``meta``
  record and an ``anchor`` record pairing the tracer timeline
  (``t_us``, what events/spans are stamped with) with the host wall
  clock (``wall_us``), re-emitted whenever a ``clock_adjust`` shifts
  the tracer anchor — so post-hoc cross-process alignment needs no
  live process, only ``wall_us - t_us``.
* **measured overhead** — the spiller's own cost is first-class
  telemetry (``journal.records`` / ``journal.bytes`` counters, the
  ``journal.spill_s`` histogram).
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib

from .registry import REGISTRY
from .trace import register_anchor_hook, tracer

#: journal format version, written in every segment's meta record; a
#: reader refuses nothing — it surfaces unknown versions as a bundle
#: warning instead (forensics must degrade, not crash)
JOURNAL_VERSION = "defer_tpu.journal.v1"

#: record framing: little-endian crc32-of-payload, payload length
_HDR = struct.Struct("<II")

#: rotate the active segment past this many bytes
DEFAULT_SEGMENT_BYTES = int(os.environ.get(
    "DEFER_JOURNAL_SEGMENT_BYTES", str(512 * 1024)) or 512 * 1024)

#: delete oldest segments once one process's journal exceeds this
DEFAULT_MAX_BYTES = int(os.environ.get(
    "DEFER_JOURNAL_MAX_BYTES", str(8 * 1024 * 1024)) or 8 * 1024 * 1024)

_SEG_RE = re.compile(r"^seg-(\d{8})$")


def _sanitize(proc: str) -> str:
    """Filesystem-safe process label (stage1.r0, serve, dispatcher)."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", proc) or "proc"


class JournalWriter:
    """Append-only segment-ring writer for ONE process's journal.

    Not thread-safe by design — the single :class:`JournalSpiller`
    thread owns it; anything else that wants a record written sets a
    flag the spiller honors on its next tick."""

    def __init__(self, root: str, proc: str, *,
                 segment_bytes: int | None = None,
                 max_bytes: int | None = None,
                 pid: int | None = None):
        self.proc = proc
        self.pid = os.getpid() if pid is None else int(pid)
        self.dir = os.path.join(root, f"{_sanitize(proc)}@{self.pid}")
        self.segment_bytes = max(4096, int(segment_bytes
                                           or DEFAULT_SEGMENT_BYTES))
        self.max_bytes = max(self.segment_bytes,
                             int(max_bytes or DEFAULT_MAX_BYTES))
        os.makedirs(self.dir, exist_ok=True)
        #: lifetime spill accounting (the overhead story's raw numbers)
        self.records = 0
        self.bytes = 0
        #: segments deleted by the ring cap (evidence-gap signal: a
        #: bundle built from a capped journal must say so)
        self.segments_dropped = 0
        existing = sorted(n for name in os.listdir(self.dir)
                          if (m := _SEG_RE.match(name))
                          for n in [int(m.group(1))])
        self._seg_seq = (existing[-1] + 1) if existing else 0
        self._fh = None
        self._open_segment()

    # -- writing -----------------------------------------------------------

    def _open_segment(self) -> None:
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.dir, f"seg-{self._seg_seq:08d}")
        self._seg_seq += 1
        self._fh = open(path, "ab")
        # every segment self-describes: a lone surviving segment is
        # still attributable and clock-alignable
        self._append({"rec": "meta", "version": JOURNAL_VERSION,
                      "proc": self.proc, "pid": self.pid})
        self.write_anchor()

    def _append(self, doc: dict) -> None:
        payload = json.dumps(doc, separators=(",", ":"),
                             default=str).encode("utf-8")
        self._fh.write(_HDR.pack(zlib.crc32(payload) & 0xFFFFFFFF,
                                 len(payload)) + payload)
        self.records += 1
        self.bytes += _HDR.size + len(payload)

    def append(self, doc: dict) -> None:
        """Write one record, rotating/capping the ring as needed."""
        self._append(doc)
        if self._fh.tell() >= self.segment_bytes:
            self._fh.flush()
            self._open_segment()
            self._enforce_cap()

    def write_anchor(self) -> None:
        """Pair the tracer timeline with the wall clock RIGHT NOW — the
        record that makes dead-process clock alignment possible."""
        self._append({"rec": "anchor",
                      "t_us": tracer().now_us(),
                      "wall_us": time.time_ns() // 1_000})

    def flush(self) -> None:
        """Push buffered bytes to the kernel (kill -9 safe; no fsync —
        surviving the process is the contract, not surviving the
        host)."""
        self._fh.flush()

    def _enforce_cap(self) -> None:
        segs = self.segments()
        total = sum(sz for _, sz in segs)
        while len(segs) > 1 and total > self.max_bytes:
            path, sz = segs.pop(0)
            try:
                os.remove(path)
            except OSError:
                break
            total -= sz
            self.segments_dropped += 1

    def segments(self) -> list[tuple[str, int]]:
        """(path, size) per live segment, oldest first."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in sorted(names):
            if _SEG_RE.match(name):
                path = os.path.join(self.dir, name)
                try:
                    out.append((path, os.path.getsize(path)))
                except OSError:
                    continue
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


class JournalSpiller:
    """Background thread spilling the process's obs state to a
    :class:`JournalWriter` — the :class:`~defer_tpu_torch.obs.report.ObsReporter`
    shape (halt event + ``wait(interval)``), but the subscriber is a
    file, not a socket.

    Each tick drains flight-recorder events since the last tick
    (cursor 0 at start: boot-time events are forensics gold), the
    newest sampled spans, and — every ``snapshot_every`` ticks — one
    ``snapshot`` record from ``snapshot_fn`` (default: the metric
    registry).  A ``clock_adjust`` landing between ticks marks the
    anchor dirty; the next tick re-anchors before writing anything
    stamped with the shifted timeline."""

    def __init__(self, writer: JournalWriter, *,
                 interval_s: float = 0.25,
                 snapshot_every: int = 4,
                 snapshot_fn=None,
                 span_limit: int = 512):
        self.writer = writer
        self.interval_s = max(0.02, float(interval_s))
        self.snapshot_every = max(1, int(snapshot_every))
        self.snapshot_fn = snapshot_fn
        self.span_limit = int(span_limit)
        self._halt = threading.Event()
        self._reanchor = threading.Event()
        self._ev_cursor = 0
        self._sp_cursor = 0
        self._ticks = 0
        self._thread = threading.Thread(target=self._run,
                                        name="journal-spiller",
                                        daemon=True)
        self._spill_hist = REGISTRY.histogram("journal.spill_s")
        self._rec_ctr = REGISTRY.counter("journal.records")
        self._bytes_ctr = REGISTRY.counter("journal.bytes")
        # a clock_adjust shifts every buffered t_us; the on-disk anchor
        # must follow or post-hoc alignment silently skews.  The hook
        # list has no unregister — gate on _halt so a stopped spiller's
        # hook is a no-op, not a write into a closed file.
        register_anchor_hook(
            lambda _delta: self._halt.is_set() or self._reanchor.set())

    def start(self) -> "JournalSpiller":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._halt.wait(self.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the journal must never
                # take down the process it exists to explain
                pass

    def _tick(self, final: bool = False) -> None:
        from .events import recorder
        t0 = time.perf_counter()
        w = self.writer
        before = w.bytes
        if self._reanchor.is_set():
            self._reanchor.clear()
            w.write_anchor()
        rec = recorder()
        self._ev_cursor, evs = rec.events_since(self._ev_cursor)
        now = tracer().now_us()
        if evs:
            w.append({"rec": "events", "t_us": now, "events": evs,
                      "dropped": rec.dropped})
        tr = tracer()
        if tr.enabled:
            self._sp_cursor, spans = tr.spans_since(
                self._sp_cursor, limit=self.span_limit)
            if spans:
                w.append({"rec": "spans", "t_us": now, "spans": spans,
                          "dropped": tr.dropped})
        self._ticks += 1
        if self.snapshot_fn is not None and (
                final or self._ticks % self.snapshot_every == 1):
            try:
                payload = self.snapshot_fn()
            except Exception as e:  # noqa: BLE001 — a dying node's
                # snapshot hook may find half-torn state; record that
                payload = {"snapshot_error": repr(e)}
            w.append({"rec": "snapshot", "t_us": tracer().now_us(),
                      "payload": payload})
        w.flush()
        dt = time.perf_counter() - t0
        self._spill_hist.record(dt)
        self._rec_ctr.n = w.records
        self._bytes_ctr.n = w.bytes

    def stop(self) -> None:
        """Final spill (anchor + whatever accumulated), then close."""
        if self._halt.is_set():
            return
        self._halt.set()
        self._thread.join(timeout=5.0)
        try:
            self._tick(final=True)
            self.writer.write_anchor()
            self.writer.flush()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass
        self.writer.close()


# -- process singleton --------------------------------------------------

_ACTIVE: JournalSpiller | None = None
_ACTIVE_LOCK = threading.Lock()


def start_journal(root: str, proc: str | None = None, *,
                  snapshot_fn=None, interval_s: float = 0.25,
                  snapshot_every: int = 4,
                  segment_bytes: int | None = None,
                  max_bytes: int | None = None) -> JournalSpiller:
    """Start (or replace) THIS process's journal under ``root``.

    ``proc`` defaults to the process tracer's label so journal
    directories, span ``proc`` fields, and event ``proc`` fields all
    agree — the postmortem merger keys on that."""
    global _ACTIVE
    if snapshot_fn is None:
        snapshot_fn = lambda: {"registry": REGISTRY.snapshot()}  # noqa: E731
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.stop()
        writer = JournalWriter(root, proc or tracer().process,
                               segment_bytes=segment_bytes,
                               max_bytes=max_bytes)
        _ACTIVE = JournalSpiller(writer, interval_s=interval_s,
                                 snapshot_every=snapshot_every,
                                 snapshot_fn=snapshot_fn).start()
    from .events import emit
    emit("journal", action="start", dir=writer.dir)
    return _ACTIVE


def stop_journal() -> None:
    """Stop the process journal after one final spill (idempotent)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        sp, _ACTIVE = _ACTIVE, None
    if sp is not None:
        try:
            from .events import emit
            emit("journal", action="stop", dir=sp.writer.dir)
        except Exception:  # noqa: BLE001 — stop must stay infallible
            pass
        sp.stop()


def active_journal() -> JournalSpiller | None:
    return _ACTIVE


# -- reading (the postmortem side; works on dead processes) -------------

def read_segment(path: str) -> tuple[list[dict], bool]:
    """(records, truncated): parse one segment, STOPPING at the first
    torn record — short header, short payload, or CRC mismatch — and
    reporting it.  Everything before the tear is intact by
    construction (records are written whole, in order)."""
    records: list[dict] = []
    truncated = False
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return records, True
    off = 0
    n = len(data)
    while off < n:
        if off + _HDR.size > n:
            truncated = True
            break
        crc, ln = _HDR.unpack_from(data, off)
        payload = data[off + _HDR.size: off + _HDR.size + ln]
        if len(payload) < ln or zlib.crc32(payload) & 0xFFFFFFFF != crc:
            truncated = True
            break
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except ValueError:
            truncated = True
            break
        off += _HDR.size + ln
    return records, truncated


def read_journal(proc_dir: str) -> dict:
    """One dead-or-alive process's journal, segments stitched oldest
    first: ``{proc, pid, version, records, segments, truncated,
    warnings}``.  Never raises on bad input — forensics on a torn
    directory must yield a partial story, not a stack trace."""
    base = os.path.basename(proc_dir.rstrip("/"))
    proc, _, pid = base.rpartition("@")
    doc = {"proc": proc or base, "pid": int(pid) if pid.isdigit() else None,
           "version": None, "records": [], "segments": 0,
           "truncated": False, "warnings": []}
    segs = []
    try:
        segs = sorted(name for name in os.listdir(proc_dir)
                      if _SEG_RE.match(name))
    except OSError as e:
        doc["warnings"].append(f"unreadable journal dir {proc_dir}: {e}")
        return doc
    if not segs:
        doc["warnings"].append(f"journal dir {proc_dir} has no segments")
        return doc
    for i, name in enumerate(segs):
        records, truncated = read_segment(os.path.join(proc_dir, name))
        # only the FINAL segment may legitimately end torn (the write
        # the crash interrupted); a tear mid-ring means lost evidence
        if truncated:
            doc["truncated"] = True
            if i != len(segs) - 1:
                doc["warnings"].append(
                    f"segment {name} torn mid-ring (not the final "
                    f"segment) — records after the tear are lost")
        for r in records:
            if r.get("rec") == "meta":
                doc["version"] = r.get("version", doc["version"])
                if r.get("proc"):
                    doc["proc"] = r["proc"]
                if r.get("pid") is not None:
                    doc["pid"] = r["pid"]
        doc["records"].extend(records)
        doc["segments"] += 1
    if doc["version"] not in (None, JOURNAL_VERSION):
        doc["warnings"].append(
            f"journal version {doc['version']!r} != reader's "
            f"{JOURNAL_VERSION!r} — best-effort parse")
    if doc["version"] is None:
        doc["warnings"].append(
            f"no meta record in {proc_dir} — unversioned journal")
    return doc


def read_process_journals(root: str) -> list[dict]:
    """Every per-process journal under ``root`` (see
    :func:`read_journal`); an empty or missing root returns ``[]`` —
    the caller turns that into a loud partial-bundle warning."""
    out = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        if os.path.isdir(path) and "@" in name:
            out.append(read_journal(path))
    return out
