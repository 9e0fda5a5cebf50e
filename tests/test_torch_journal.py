"""Port parity: the black-box journal (``obs/journal.py``) and the
postmortem collector (``obs/postmortem.py``) against the JAX package's,
mirroring ``tests/test_journal.py``.

The on-disk format is shared byte for byte: under the same clock and pid,
both packages' writers produce identical segment files, and every journal
either package writes is collected by both into EQUAL bundles (the
verdict, the warnings, the timeline, the rows; only the output directory
differs).  A real ``kill -9`` of a port process mid-spill leaves a journal
both collectors read.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import pytest

import defer_tpu.obs.journal as jjournal
import defer_tpu.obs.postmortem as jpm
import defer_tpu_torch.obs.journal as tjournal
import defer_tpu_torch.obs.postmortem as tpm
from defer_tpu_torch.obs import (active_journal, maybe_autopsy,
                                 start_journal, stop_journal)
from defer_tpu_torch.obs.events import emit

ROOT = Path(__file__).resolve().parent.parent
WRITERS = {"jax": jjournal, "torch": tjournal}
_HDR = struct.Struct("<II")


def _ev(proc, seq, t_us, kind="admit", **data):
    return {"proc": proc, "seq": seq, "t_us": t_us, "kind": kind,
            "data": data}


def _journal(mod, root, proc, *records, pid=None, **kw):
    w = mod.JournalWriter(str(root), proc, pid=pid, **kw)
    for r in records:
        w.append(r)
    w.flush()
    w.close()
    return w


def collect_both(root, tmp_path, **kw) -> dict:
    """Both packages' ``collect`` of one journal root: equal bundles (the
    output directory aside); returns the port's."""
    got = {}
    for name, pm in (("jax", jpm), ("torch", tpm)):
        b = pm.collect(str(root), out_dir=str(tmp_path / f"bundle_{name}"),
                       **kw)
        b.pop("out_dir")
        got[name] = b
    assert json.dumps(got["torch"], sort_keys=True, default=str) == \
        json.dumps(got["jax"], sort_keys=True, default=str)
    return got["torch"]


class _Clock:
    """A fixed tracer timeline and wall clock for a journal module."""

    def __init__(self, t_us):
        self.t_us = t_us

    def now_us(self):
        return self.t_us

    def time_ns(self):
        return (self.t_us + 5_000_000) * 1000


def test_both_writers_write_the_same_bytes(tmp_path, monkeypatch):
    """Rotation and the ring cap included: the same records under the same
    clock and pid give the same segment names and bytes."""
    files = {}
    for name, mod in WRITERS.items():
        clock = _Clock(1_000_000)
        monkeypatch.setattr(mod, "tracer", lambda c=clock: c)
        monkeypatch.setattr(mod, "time", clock)
        root = tmp_path / name
        w = _journal(mod, root, "stage1.r0",
                     *[{"rec": "events", "t_us": i, "pad": "z" * 300,
                        "events": [_ev("stage1.r0", i, i)], "dropped": 0}
                       for i in range(60)],
                     pid=4242, segment_bytes=4096, max_bytes=8192)
        assert w.segments_dropped > 0
        files[name] = {p.name: p.read_bytes()
                       for p in sorted(Path(w.dir).iterdir())}
    assert files["torch"] == files["jax"]
    assert len(files["torch"]) >= 2


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_roundtrip_read_by_both(writer, tmp_path):
    w = _journal(WRITERS[writer], tmp_path, "stage1.r0",
                 {"rec": "events", "t_us": 10,
                  "events": [_ev("stage1.r0", 0, 10)], "dropped": 0},
                 pid=4242)
    docs = [mod.read_journal(w.dir) for mod in (jjournal, tjournal)]
    assert docs[0] == docs[1]
    j = docs[1]
    assert j["proc"] == "stage1.r0" and j["pid"] == 4242
    assert j["version"] == tjournal.JOURNAL_VERSION == "defer_tpu.journal.v1"
    assert not j["truncated"] and not j["warnings"]
    assert [r["rec"] for r in j["records"]][:2] == ["meta", "anchor"]


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_torn_final_write_truncates_at_the_tear(writer, tmp_path):
    w = _journal(WRITERS[writer], tmp_path, "p",
                 *[{"rec": "events", "t_us": i, "events": [_ev("p", i, i)],
                    "dropped": 0} for i in range(5)])
    seg = w.segments()[-1][0]
    whole = len(tjournal.read_segment(seg)[0])
    with open(seg, "ab") as fh:                 # a half record
        fh.write(_HDR.pack(123, 999) + b'{"rec')
    for mod in (jjournal, tjournal):
        records, truncated = mod.read_segment(seg)
        assert truncated and len(records) == whole
    payload = b'{"rec":"events"}'
    with open(seg, "ab") as fh:                 # a payload that lies
        fh.write(_HDR.pack((zlib.crc32(payload) ^ 1) & 0xFFFFFFFF,
                           len(payload)) + payload)
    docs = [mod.read_journal(w.dir) for mod in (jjournal, tjournal)]
    assert docs[0] == docs[1] and docs[1]["truncated"]
    assert len([r for r in docs[1]["records"]
                if r["rec"] == "events"]) == 5
    bundle = collect_both(tmp_path, tmp_path)
    assert any("torn mid-write" in x for x in bundle["warnings"])


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_mid_ring_tear_warns_about_lost_evidence(writer, tmp_path):
    mod = WRITERS[writer]
    w = mod.JournalWriter(str(tmp_path), "p", segment_bytes=4096)
    while w._seg_seq < 3:
        w.append({"rec": "events", "t_us": 0, "events": [], "pad": "x" * 600})
    w.flush()
    w.close()
    with open(w.segments()[0][0], "r+b") as fh:
        fh.seek(20)
        fh.write(b"\xff\xff\xff\xff")
    docs = [m.read_journal(w.dir) for m in (jjournal, tjournal)]
    assert docs[0] == docs[1] and docs[1]["truncated"]
    assert any("torn mid-ring" in x for x in docs[1]["warnings"])


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_segment_ring_rotates_and_caps(writer, tmp_path):
    w = _journal(WRITERS[writer], tmp_path, "p",
                 *[{"rec": "events", "t_us": i, "events": [],
                    "pad": "y" * 200} for i in range(200)],
                 segment_bytes=4096, max_bytes=4096 * 2)
    assert w.segments_dropped > 0
    live = w.segments()
    assert sum(sz for _, sz in live) <= 4096 * 3
    j = tjournal.read_journal(w.dir)
    assert j == jjournal.read_journal(w.dir)
    assert not j["truncated"]
    assert len([r for r in j["records"] if r["rec"] == "meta"]) == len(live)


def test_environment_variables_are_read_as_the_jax_package_reads_them():
    """``DEFER_JOURNAL_SEGMENT_BYTES`` and ``DEFER_JOURNAL_MAX_BYTES`` set
    the defaults at import, in a fresh interpreter for each package."""
    code = ("import importlib, json, sys; m = importlib.import_module("
            "sys.argv[1]); print(json.dumps([m.DEFAULT_SEGMENT_BYTES, "
            "m.DEFAULT_MAX_BYTES, m.JOURNAL_VERSION]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               DEFER_JOURNAL_SEGMENT_BYTES="65536",
               DEFER_JOURNAL_MAX_BYTES="131072")
    got = [json.loads(subprocess.run(
        [sys.executable, "-c", code, mod], env=env, capture_output=True,
        text=True, timeout=120, check=True).stdout)
        for mod in ("defer_tpu.obs.journal", "defer_tpu_torch.obs.journal")]
    assert got[0] == got[1] == [65536, 131072, "defer_tpu.journal.v1"]


@pytest.mark.timeout(120)
def test_kill9_mid_spill_leaves_a_journal_both_collect(tmp_path):
    """A port process journaling every 50 ms, SIGKILLed between flushes:
    what reached the kernel reads as a journal, and both collectors
    explain it with no live process."""
    root = tmp_path / "j"
    child = ("import sys, time\n"
             f"sys.path.insert(0, {str(ROOT)!r})\n"
             "from defer_tpu_torch.obs import start_journal\n"
             "from defer_tpu_torch.obs.events import emit\n"
             f"start_journal({str(root)!r}, 'victim', interval_s=0.05)\n"
             "i = 0\n"
             "while True:\n"
             "    emit('admit', rid=i); i += 1\n"
             "    time.sleep(0.01)\n")
    proc = subprocess.Popen([sys.executable, "-c", child])
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            js = tjournal.read_process_journals(str(root))
            if js and any(r["rec"] == "events" for r in js[0]["records"]):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("the victim never spilled an events record")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    js = jjournal.read_process_journals(str(root))
    assert js == tjournal.read_process_journals(str(root))
    assert len(js) == 1 and js[0]["proc"] == "victim"
    evs = [e for r in js[0]["records"] if r["rec"] == "events"
           for e in r["events"]]
    assert evs and evs[0]["kind"] == "journal"
    bundle = collect_both(root, tmp_path, reason="test kill9")
    assert [p["proc"] for p in bundle["procs"]] == ["victim"]
    assert bundle["timeline"]


def test_spiller_writes_events_and_snapshots(tmp_path):
    try:
        start_journal(str(tmp_path), "unit", interval_s=0.05,
                      snapshot_every=1, snapshot_fn=lambda: {"rows": 1})
        assert active_journal() is not None
        emit("admit", rid=1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            recs = tjournal.read_process_journals(str(tmp_path))[0][
                "records"]
            if any(r["rec"] == "snapshot" for r in recs) and any(
                    e["kind"] == "admit" for r in recs
                    if r["rec"] == "events" for e in r["events"]):
                break
            time.sleep(0.05)
    finally:
        stop_journal()
    stop_journal()                              # idempotent
    assert active_journal() is None
    (j,) = jjournal.read_process_journals(str(tmp_path))
    kinds = {r["rec"] for r in j["records"]}
    assert {"meta", "anchor", "events", "snapshot"} <= kinds
    assert [r for r in j["records"]
            if r["rec"] == "snapshot"][-1]["payload"] == {"rows": 1}


# ---------------------------------------------------------------------------
# postmortem: partial bundles, alignment, verdicts, across the packages
# ---------------------------------------------------------------------------

def test_missing_and_empty_roots_yield_loud_partial_bundles(tmp_path):
    for i, root in enumerate((tmp_path / "nope", tmp_path / "empty")):
        if i:
            root.mkdir()
        b = collect_both(root, tmp_path / f"b{i}")
        assert any("PARTIAL BUNDLE" in x for x in b["warnings"])
        assert b["procs"] == [] and b["timeline"] == []
    (tmp_path / "empty" / "ghost@7").mkdir()
    b = collect_both(tmp_path / "empty", tmp_path / "b3")
    assert any("no segments" in x for x in b["warnings"])


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_alignment_uses_the_last_anchor(writer, tmp_path):
    delta = 5_000_000
    _journal(WRITERS[writer], tmp_path, "skewed",
             {"rec": "anchor", "t_us": 1_000, "wall_us": 1_000 + delta},
             {"rec": "events", "t_us": 2_000,
              "events": [_ev("skewed", 0, 1_500)], "dropped": 0})
    b = collect_both(tmp_path, tmp_path)
    assert b["procs"][0]["delta_us"] == delta
    assert [e["t_us"] for e in b["timeline"] if e["kind"] == "admit"] \
        == [1_500 + delta]


@pytest.mark.parametrize("writers", [("jax", "torch", "jax"),
                                     ("torch", "jax", "torch")])
def test_verdict_and_casualties_across_mixed_writers(writers, tmp_path):
    """stage1 stops 5 s early, stage0 backs up, stage2 starves; each
    journal written by the package named for it, collected by both."""
    root = tmp_path / "j"
    base = time.time_ns() // 1_000
    w0, w1, w2 = (WRITERS[w] for w in writers)
    _journal(w1, root, "stage1", {"rec": "events", "t_us": base,
                                  "events": [_ev("stage1", 0, base)],
                                  "dropped": 0})
    _journal(w0, root, "stage0",
             {"rec": "events", "t_us": base + 5_000_000,
              "events": [_ev("stage0", 0, base + 5_000_000)], "dropped": 0},
             {"rec": "snapshot", "t_us": base + 5_000_000,
              "payload": {"queues": {"tx_depth": 8, "tx_hi": 8,
                                     "rx_depth": 8, "rx_hi": 0}}})
    _journal(w2, root, "stage2", {"rec": "events", "t_us": base + 5_000_000,
                                  "events": [_ev("stage2", 0,
                                                 base + 5_000_000)],
                                  "dropped": 0})
    b = collect_both(root, tmp_path, reason="unit")
    v = b["verdict"]
    assert v["first_fault"] == "stage1"
    assert [c["proc"] for c in v["casualties"]] == ["stage2", "stage0"]
    assert v["casualties"][1]["saturated"] == ["tx watermark 8/8"]
    doc = json.loads((tmp_path / "bundle_torch" / "trace.json").read_text())
    assert doc == json.loads(
        (tmp_path / "bundle_jax" / "trace.json").read_text())
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M"} == {"stage0", "stage1", "stage2"}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_fatal_event_names_the_victim(writer, tmp_path):
    base = time.time_ns() // 1_000
    _journal(WRITERS[writer], tmp_path, "dispatcher", {
        "rec": "events", "t_us": base,
        "events": [_ev("dispatcher", 0, base, kind="replica_respawn",
                       stage=1, replica=0, rc=-9)], "dropped": 0})
    v = collect_both(tmp_path, tmp_path)["verdict"]
    assert v["first_fault"] == "stage1.r0"
    assert v["fatal_event"]["kind"] == "replica_respawn"


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_evidence_gap_warning_on_dropped_events(writer, tmp_path):
    _journal(WRITERS[writer], tmp_path, "p", {
        "rec": "events", "t_us": 50, "events": [_ev("p", 9, 50)],
        "dropped": 7})
    b = collect_both(tmp_path, tmp_path)
    assert b["events_dropped"] == b["verdict"]["events_dropped"] == 7
    assert any("EVIDENCE GAP" in x for x in b["warnings"])


@pytest.mark.parametrize("gap_s,want", [(0.9, None), (1.5, "stage1.r1")])
def test_a_corpse_reads_as_the_first_fault_only_past_the_stall_margin(
        gap_s, want, tmp_path):
    """After a kill the fan-in's ``replica_lost`` (which names no victim)
    is the first fatal event, so the corpse is blamed only once its
    journal stops ``STALL_MARGIN_US`` (1 s) before the survivors'.  Read
    0.9 s after the corpse's last record, neither package names a fault;
    why the port's failover supervisor waits 2.5 s (the JAX one 0.75 s)."""
    root = tmp_path / "j"
    base = time.time_ns() // 1_000
    last = base + int(gap_s * 1e6)
    for proc, t_end in (("stage1.r1", base), ("stage0", last),
                        ("stage2", last)):
        evs = ([_ev(proc, 0, base + 10, kind="replica_lost",
                    hop="stage2", error="peer closed")]
               if proc == "stage2" else [])
        _journal(tjournal, root, proc,
                 {"rec": "events", "t_us": base, "events": evs,
                  "dropped": 0},
                 {"rec": "snapshot", "t_us": t_end, "payload": {}})
    b = collect_both(root, tmp_path)
    assert b["verdict"]["first_fault"] == want
    assert b["verdict"]["fatal_event"]["kind"] == "replica_lost"


def test_maybe_autopsy_needs_a_journal_and_rate_limits(tmp_path,
                                                       monkeypatch):
    assert active_journal() is None
    assert maybe_autopsy("no journal here") is None
    _journal(tjournal, tmp_path, "stage0", {"rec": "events", "t_us": 1,
                                            "events": [], "dropped": 0})
    monkeypatch.setattr(tpm, "_LAST_AUTOPSY", 0.0)
    assert maybe_autopsy("unit", journal_dir=str(tmp_path), sync=True,
                         delay_s=0.0) is None
    bundles = list(tmp_path.glob("bundle-*/bundle.json"))
    assert len(bundles) == 1
    doc = json.loads(bundles[0].read_text())
    assert doc["reason"] == "unit" and doc["version"] == \
        "defer_tpu.postmortem.v1"
    # a second failure inside the interval assembles nothing
    t = maybe_autopsy("again", journal_dir=str(tmp_path))
    assert t is None and len(list(tmp_path.glob("bundle-*"))) == 1


@pytest.mark.timeout(300)
def test_chain_cli_journals_and_both_postmortem_clis_read_it(tmp_path):
    """``chain --journal-dir`` (pinned to tcp: it holds no shm segment)
    journals every node process and the dispatcher; ``--metrics-out``,
    ``--trace-out`` and ``--prom-port`` write and serve the process's
    telemetry; both packages' ``postmortem`` CLIs read the journals into
    the same summary."""
    jdir = tmp_path / "journals"
    metrics, trace = tmp_path / "metrics.json", tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "defer_tpu_torch", "chain", "--model",
         "resnet_tiny", "--stages", "2", "--count", "3", "--device", "cpu",
         "--tier", "tcp", "--journal-dir", str(jdir), "--metrics-out",
         str(metrics), "--trace-out", str(trace), "--prom-port", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["max_abs_err_vs_single_program"] < 1e-4
    assert "prometheus exposition on http://127.0.0.1:" in out.stderr
    assert "registry" in json.loads(metrics.read_text())
    assert json.loads(trace.read_text())["traceEvents"]
    summaries = []
    for pkg in ("defer_tpu_torch", "defer_tpu"):
        res = subprocess.run(
            [sys.executable, "-m", pkg, "postmortem", str(jdir), "--out",
             str(tmp_path / f"bundle_{pkg}"), "--reason", "cli"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
        doc = json.loads(res.stdout.strip().splitlines()[-1])
        assert doc.pop("out_dir").endswith(f"bundle_{pkg}")
        summaries.append(doc)
    assert summaries[0] == summaries[1]
    assert sorted(summaries[0]["procs"]) == ["dispatcher", "stage0",
                                             "stage1"]
    # a clean run emits no fatal event (the first node to exit may still
    # read as an early stopper when teardown takes over a second)
    assert not any("first fatal event" in e
                   for e in summaries[0]["evidence"])
