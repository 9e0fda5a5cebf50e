"""Port parity: ``Defer.run_defer`` and ``Defer.serve_endpoint`` over a ring
across ``torch.distributed`` processes.

One spawn of ``scripts/torch_ring_procs.py --cases serve`` (four gloo CPU
processes, a deadline of 120 s) runs every serving case of
``R.SERVE_CASES``; the tests read its results.  The workers map the
weights and frames this process hands them: ``resnet_tiny``'s JAX
weights carried over with ``params_from_jax`` and the seeded frames of
``R.make_inputs``.  The ring is ``resnet_tiny`` in 8 stages on (stage 8),
two a process, and in 4 on (data 2, stage 4) for ``dp_int8``; process 0
is the leader, which feeds the queue and runs the endpoint's clients.

* Against the port's one-process services (``R.ServeRun`` with
  ``mesh=None``, the same extents, inputs and weights): rows bit-equal,
  on every process (the same ops on the same rows, one thread
  everywhere); the quantizer calls of each process equal the one
  process's, one a process and int8 step.
* Against the JAX forward (``tests/test_torch_dispatcher.py``'s 2e-4) on
  the buffer wire; the int8 wire within one quant step of the JAX int8
  ring (max |output| / 127, ``tests/test_torch_multiproc_ring.py``'s
  bound); ``bf8`` replies within blockfloat's 8-bit bound of the forward
  (``tests/test_torch_endpoint.py``).
* Failures end every process's stream with ``END_OF_STREAM`` and leave no
  thread behind; a wedge on the leader recovers once and replays.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline
from defer_tpu import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu_torch import models, params_from_jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_ring_procs as R  # noqa: E402

torch.set_num_threads(1)

PROCS = 4
SC = R.SERVE["cpu"]
FRAMES = SC["frames"]
#: the spawn's deadline (the other multi-process files' too)
DEADLINE_S = 120.0
#: against the JAX forward (tests/test_torch_dispatcher.py)
JAX_TOL = 2e-4
QUEUE = [c for c, (k, _, _) in R.SERVE_CASES.items() if k == "queue"]
EP = [c for c, (k, _, _) in R.SERVE_CASES.items() if k == "ep"]
#: cases whose streams fail on every process
FAILING = ("bad_input", "stage_error", "preflight", "dead_leader",
           "dead_follower", "dead_peer_left")
RECOVERING = ("recover_mid", "recover_drain", "recover_after_leader",
              "recover_after_follower", "recover_drain_after_leader",
              "recover_drain_after_follower")
INT8_QUEUE = ("queue_int8", "bf16_int8", "dp_int8")


@pytest.fixture(scope="module")
def tiny():
    jg = jax_models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    return jg, np_params, params_from_jax(models.resnet_tiny(), np_params)


@pytest.fixture(scope="module")
def given(tiny):
    """The spawn's inputs: the JAX weights in the port's layout and the
    seeded frames."""
    return {"serve_params": tiny[2],
            "serve_x": R.make_inputs("cpu", ("serve",))["serve_x"]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, given):
    t0 = time.perf_counter()
    res = R.spawn(PROCS, "cpu", "cpu", tmp_path_factory.mktemp("serve"),
                  given, cases=("serve",), deadline_s=DEADLINE_S,
                  timeout_s=60.0)
    return res, time.perf_counter() - t0


@pytest.fixture(scope="module")
def one(given):
    """Per referenced case: the one-process service's ``(arrays, meta)``,
    its kernel calls counted as the workers count theirs."""
    counts = R.Counts("cpu")
    try:
        run = R.ServeRun(torch, models, SC, given, "cpu")
        return {c: run.case(c, counts) for c in R.SERVE_REFERENCED}
    finally:
        counts.close()


def _meta(res, case):
    return [r["meta"]["serve"][case] for r in res]


def _rows(r, case, key="rows"):
    return r[f"sv_{case}__{key}"]


def _uncounted(case) -> list[int]:
    """Per process, the dispatches of the abandoned generation it left
    uncounted beside the others: a wedge mid-stream after the push
    (``"after"``) held one process once the push's rows were gathered
    everywhere, so the others completed that dispatch before their
    watchdogs fired, and it did not."""
    w = R.SERVE_CASES[case][2].get("wedge")
    if not w or w[2:] != ("after",) or w[1] == "drain":
        return [0] * PROCS
    return [int(i == w[0]) for i in range(PROCS)]


def _jax_forward(tiny, frames) -> np.ndarray:
    jg, np_params, _ = tiny
    fwd = jax.jit(jg.apply)
    return np.stack([np.asarray(fwd(np_params, x)) for x in frames])


def _frames(given, mb=1):
    x = np.asarray(given["serve_x"])
    flat = x.reshape((-1,) + x.shape[2:])
    return flat.reshape((-1, mb) + flat.shape[1:])


def test_spawn_within_its_deadline(spawned):
    res, seconds = spawned
    assert len(res) == PROCS and seconds < DEADLINE_S, seconds
    assert [r["meta"]["worker"] for r in res] == list(range(PROCS))


def test_the_guards_of_the_two_services_are_gone():
    assert "run_defer" not in R.GUARDS and "serve_endpoint" not in R.GUARDS
    assert R.GUARDS["mpmd"] == "by design"


# ---------------------------------------------------------------------------
# run_defer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["queue_buffer", "queue_int8", "bf16_int8",
                                  "dp_int8"])
def test_queue_rows_bit_equal_to_one_process(spawned, one, case):
    """Every frame, in order, then ``END_OF_STREAM``, on every process:
    the one-process service's rows bit for bit."""
    res, _ = spawned
    want = one[case][0]["rows"]
    for r, m in zip(res, _meta(res, case)):
        assert m["end"] and m["healthy"] and m["outputs"] == len(want)
        np.testing.assert_array_equal(_rows(r, case), want)


def test_queue_buffer_within_bound_of_jax_forward(spawned, tiny, given):
    res, _ = spawned
    want = _jax_forward(tiny, _frames(given))
    for case in ("queue_buffer", "stop_follower", *RECOVERING):
        for r in res:
            np.testing.assert_allclose(_rows(r, case), want, rtol=JAX_TOL,
                                       atol=JAX_TOL)


@pytest.mark.parametrize("case", ["queue_int8", "dp_int8"])
def test_int8_queue_within_a_quant_step_of_jax(spawned, tiny, given, case):
    jg, np_params, _ = tiny
    _, cfg, opts = R.SERVE_CASES[case]
    mb = cfg.get("microbatch", 1)
    dp = 2 if opts.get("dp") else 1
    n = 8 // dp
    want = np.asarray(JaxSpmdPipeline(
        jax_partition(jg, num_stages=n), np_params,
        mesh=jax_pipeline_mesh(n, dp), microbatch=mb, chunk=SC["chunk"],
        wire="int8").run(_frames(given, mb)))
    got = _rows(spawned[0][0], case)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= np.abs(want).max() / 127


def test_bf16_service_equals_defer_run(spawned):
    """bf16 compute on the int8 wire: the service's rows equal
    ``Defer(mesh=).run`` of the same frames on every process."""
    res, _ = spawned
    for r in res:
        np.testing.assert_array_equal(_rows(r, "bf16_int8"),
                                      _rows(r, "bf16_int8", "run"))


@pytest.mark.parametrize("case", QUEUE)
def test_every_process_agrees(spawned, case):
    """The same rows, stream end, health, recoveries, dispatches and
    inferences on every process; no serve thread is left running."""
    res, _ = spawned
    metas = _meta(res, case)
    for k in ("end", "healthy", "recoveries", "inferences",
              "outputs", "steps", "pushes", "generations",
              "dispatches_registry"):
        assert len({str(m[k]) for m in metas}) == 1, (k, metas)
    assert len({m["dispatches"] + u for m, u in zip(
        metas, _uncounted(case))}) == 1, metas
    assert all(m["end"] and m["threads_left"] == [] for m in metas)
    if metas[0]["outputs"]:
        for r in res[1:]:
            np.testing.assert_array_equal(_rows(r, case), _rows(res[0], case))


@pytest.mark.parametrize("case", INT8_QUEUE)
def test_one_quantizer_call_per_process_and_step(spawned, one, case):
    """Per process one quantizer call over its slots each int8 step,
    preflight and drain included: the one process's count, four times
    over the processes."""
    res, _ = spawned
    want = one[case][1]["launches"]["quant_int8"]
    got = [m["launches"]["quant_int8"] for m in _meta(res, case)]
    assert got == [want] * PROCS and sum(got) == PROCS * want
    assert all(m["launches"]["quant_int8"] == m["steps"]
               for m in _meta(res, case))
    assert one[case][1]["steps"] == want


@pytest.mark.parametrize("case", ["queue_buffer", "queue_int8", "dp_int8"])
def test_boundary_bytes_are_the_rings_slots_only(spawned, case):
    """One send a step per process, of the ring's slot: the serve steps
    and the dealt rows are not counted."""
    res, _ = spawned
    _, cfg, opts = R.SERVE_CASES[case]
    rows = cfg.get("microbatch", 1) // (2 if opts.get("dp") else 1)
    for m in _meta(res, case):
        buf = m["buf_elems"]
        hop = (rows * (buf + 4 * (buf // 256)) if cfg.get("wire") == "int8"
               else rows * buf * 4)
        assert m["boundary_sends"] == m["steps"]
        assert m["boundary_bytes"] == hop * m["steps"]


@pytest.mark.parametrize("case", ["queue_buffer", "dp_int8"])
def test_each_process_holds_its_block(spawned, case):
    res, _ = spawned
    per = 2
    n = 4 if R.SERVE_CASES[case][2].get("dp") else 8
    for i, m in enumerate(_meta(res, case)):
        first = (i * per) % n
        assert m["local_stages"] == list(range(first, first + per))


@pytest.mark.parametrize("case", FAILING)
def test_a_failure_ends_every_processs_stream(spawned, case):
    """A bad input or a stage error (the leader's validation fails, and
    it tells the others), a failing preflight (each process's stages run
    alone, then they agree) and a hung dispatch declared dead (wedged on
    the leader or on a follower; or on a follower whose wedge lets go as
    soon as it was declared dead, before the others' longer watchdogs
    fired: they complete the step with it, and at the next step they learn
    that it abandoned the generation and are declared dead too, within a
    watchdog poll, not their 60 s): every process's queue ends with
    ``END_OF_STREAM`` and nothing else, its ``join`` raises, and no serve
    thread is left running."""
    res, _ = spawned
    metas = _meta(res, case)
    for i, m in enumerate(metas):
        assert m["end"] and m["outputs"] == 0 and not m["healthy"], m
        assert "dispatcher thread failed" in m["joined"], m
        assert m["threads_left"] == [], m
    errors = [m["error"] for m in metas]
    if case.startswith("dead"):
        assert errors == ["TimeoutError"] * PROCS
        assert all(m["events"] == ["watchdog"] for m in metas)
        if R.SERVE_CASES[case][2].get("early"):
            assert all(m["seconds"] < 30 for m in metas), metas
            wedged = R.SERVE_CASES[case][2]["wedge"][0]
            assert all("peer process abandoned" in m["joined"]
                       for i, m in enumerate(metas) if i != wedged), metas
        wedged = R.SERVE_CASES[case][2]["wedge"][0]
        assert [m["wedged"] for m in metas] == [i == wedged
                                                for i in range(PROCS)]
    elif case == "preflight":
        assert all(m["dispatches"] == 0 for m in metas)
    else:
        assert errors == ["ValueError"] + ["RuntimeError"] * (PROCS - 1)
        assert "leader" in metas[1]["joined"]


@pytest.mark.parametrize("case", RECOVERING)
def test_recovery_replays_the_unemitted_frames(spawned, one, case):
    """A dispatch wedged mid-stream or in the drain after the END was
    consumed: on the leader before its push, or on the leader or a
    follower after its push's rows were gathered on every process (the
    others emitted them, the wedged one not).  Every process's watchdog
    fires once, each rebuilds its ring on new groups, the new generation
    starts from the fewest outputs any process emitted, and every
    process's stream completes in order, each output once, bit-equal to
    the one-process service; one watchdog and one failover event on each
    process; the abandoned generation leaves at one step on every process
    and no thread is left."""
    res, _ = spawned
    want = one["queue_buffer"][0]["rows"]
    metas = _meta(res, case)
    wedged = R.SERVE_CASES[case][2]["wedge"][0]
    assert [m["wedged"] for m in metas] == [i == wedged
                                            for i in range(PROCS)]
    for r, m in zip(res, metas):
        assert m["recoveries"] == 1 and m["healthy"] and m["end"], m
        assert m["generations"] == 2 and m["threads_left"] == [], m
        assert m["outputs"] == FRAMES, m
        np.testing.assert_array_equal(_rows(r, case), want)
        assert m["events"] == ["watchdog", "failover"], m


def test_stop_on_the_leader_drains_what_it_fed(spawned, one):
    """The leader feeds half the frames and stops once it consumed them:
    every process drains them and ends."""
    res, _ = spawned
    want = one["queue_buffer"][0]["rows"][:FRAMES // 2]
    for r, m in zip(res, _meta(res, "stop_leader")):
        assert m["end"] and m["healthy"] and m["outputs"] == FRAMES // 2
        np.testing.assert_array_equal(_rows(r, "stop_leader"), want)


def test_stop_on_a_follower_alone_does_not_split_the_ring(spawned, one):
    res, _ = spawned
    want = one["queue_buffer"][0]["rows"]
    for r, m in zip(res, _meta(res, "stop_follower")):
        assert m["end"] and m["healthy"] and m["outputs"] == FRAMES
        np.testing.assert_array_equal(_rows(r, "stop_follower"), want)


# ---------------------------------------------------------------------------
# serve_endpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", EP)
def test_endpoint_same_address_and_every_thread_ends(spawned, case):
    """Every process returns the leader's address and a thread that ends;
    only the leader counts samples."""
    res, _ = spawned
    metas = _meta(res, case)
    assert len({tuple(m["address"]) for m in metas}) == 1
    assert not any(m["alive"] for m in metas)
    assert all(m["samples_in"] == m["samples_out"] == 0 for m in metas[1:])
    assert all(m["errors"] == [] for m in metas[1:])
    for k in ("steps", "pushes", "inferences"):
        assert len({m[k] for m in metas}) == 1, (k, metas)


@pytest.mark.parametrize("case,keys", [
    ("ep_order", ("a",)), ("ep_pair", ("a", "b")),
    ("ep_pair_int8", ("a", "b")), ("ep_bf8", ("a",)),
    ("ep_bf16", ("a",)), ("ep_reweight", ("a", "b")),
    ("ep_reconnect", ("a",))])
def test_endpoint_replies_bit_equal_to_one_process(spawned, one, case, keys):
    res, _ = spawned
    lead = _meta(res, case)[0]
    assert lead["client_errors"] == []
    for k in keys:
        np.testing.assert_array_equal(_rows(res[0], case, k),
                                      one[case][0][k])


def test_endpoint_streams_in_order_within_bound_of_jax(spawned, tiny, given):
    """One client, then two concurrent clients (frames 0-3 and 4-7), each
    getting its own rows in order; the counters at one sample a frame."""
    res, _ = spawned
    want = _jax_forward(tiny, _frames(given))
    np.testing.assert_allclose(_rows(res[0], "ep_order", "a"), want,
                               rtol=JAX_TOL, atol=JAX_TOL)
    half = FRAMES // 2
    for i, k in enumerate("ab"):
        np.testing.assert_allclose(_rows(res[0], "ep_pair", k),
                                   want[i * half:(i + 1) * half],
                                   rtol=JAX_TOL, atol=JAX_TOL)
    for case in ("ep_order", "ep_pair"):
        m = _meta(res, case)[0]
        assert (m["samples_in"], m["samples_out"]) == (FRAMES, FRAMES)
        assert m["errors"] == []


def test_microbatched_bf8_replies(spawned, tiny, given):
    """Microbatch 2: replies within blockfloat's 8-bit bound of the
    forward, the counters at two samples a frame."""
    res, _ = spawned
    want = _jax_forward(tiny, _frames(given, 2))
    got = _rows(res[0], "ep_bf8", "a")
    assert got.shape == want.shape
    for y, w in zip(got, want):
        assert np.abs(y - w).max() <= np.abs(w).max() / 127
    m = _meta(res, "ep_bf8")[0]
    assert (m["samples_in"], m["samples_out"]) == (FRAMES, FRAMES)


def test_bf16_int8_endpoint_equals_defer_run(spawned):
    """bfloat16 request frames into a bf16 ring under the int8 wire: the
    replies equal ``Defer(mesh=).run`` of the rounded frames."""
    res, _ = spawned
    np.testing.assert_array_equal(_rows(res[0], "ep_bf16", "a"),
                                  _rows(res[0], "ep_bf16", "run"))


@pytest.mark.parametrize("case", ["ep_bf16", "ep_pair_int8"])
def test_int8_endpoint_one_quantizer_call_per_process_and_step(spawned,
                                                               case):
    """Each process made one quantizer call a step of the endpoint's ring
    (its pushes follow the traffic, so their count is the run's own)."""
    for m in _meta(spawned[0], case):
        assert m["launches"]["quant_int8"] == m["steps"] > 0
        assert m["captures"] == 0


def test_operator_stop_ends_every_process(spawned):
    res, _ = spawned
    metas = _meta(res, "ep_stop")
    assert metas[0]["samples_out"] == 3 and metas[0]["client_errors"] == []
    assert _rows(res[0], "ep_stop", "a").shape[0] == 3
    assert not any(m["alive"] for m in metas)


def test_live_reweight_between_clients(spawned, one):
    """Every process installs the new weights at the leader's step: the
    second client's rows are the scaled weights', the first's the
    original's."""
    res, _ = spawned
    a, b = (_rows(res[0], "ep_reweight", k) for k in "ab")
    np.testing.assert_array_equal(a, one["queue_buffer"][0]["rows"][:3])
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(b, one["ep_reweight"][0]["b"])


def test_client_death_then_reconnect(spawned, one):
    res, _ = spawned
    m = _meta(res, "ep_reconnect")[0]
    assert m["errors"] == ["ConnectionError"] and m["samples_in"] == 7
    np.testing.assert_array_equal(_rows(res[0], "ep_reconnect", "a"),
                                  one["queue_buffer"][0]["rows"][:5])


@pytest.mark.parametrize("case,error", [("ep_stall", "RuntimeError"),
                                        ("ep_bad", "ValueError")])
def test_endpoint_failures_abort_the_connection(spawned, case, error):
    """A staging ring that never accepts, or a bad sample: the client's
    connection is cut without an END (it raises), the leader's errors
    name it, and every process's thread ends."""
    res, _ = spawned
    metas = _meta(res, case)
    assert error in metas[0]["errors"] and metas[0]["client_errors"]
    assert not any(m["alive"] for m in metas)
