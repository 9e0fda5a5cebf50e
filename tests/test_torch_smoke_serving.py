"""The port's serving smokes on the CPU: ``scripts/torch_serve_smoke.py``,
``scripts/torch_request_obs_smoke.py`` and
``scripts/torch_decode_profile_smoke.py``, each run ``--quick --device cpu``
as a subprocess.  Each must exit 0 and print its JAX script's row (metric
and keys); the offered load of each burst is held to the JAX package's
``poisson_trace`` on the same seed, the decoder's dispatches to the JAX
decoder's schedule, and the ``slow`` pair test runs each JAX script beside
its port and compares every clock-free field."""

import math

import jax
import pytest

from defer_tpu.models.gpt import gpt
from defer_tpu.runtime.decode import PipelinedDecoder
from defer_tpu.serve import poisson_trace

import torch_smoke_harness as H

#: the burst both serving smokes play: 0.6 of the width-4 door's
#: capacity at a 25 ms delay, 6 s, a 2x burst from 1.5 to 3.5 s, seed 1
BURST = dict(rate=0.6 * 4 / 0.025, duration=6.0, seed=1,
             bursts=[(1.5, 3.5, 2.0)])


def _offered():
    return len(poisson_trace(BURST["rate"], BURST["duration"],
                             seed=BURST["seed"], bursts=BURST["bursts"]))


# slow: the script's admitted-p99 SLO under the burst, kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_serve_smoke_quick_cpu():
    row, _ = H.run("serve", timeout=200)
    H.check_row("serve", row)
    assert row["trace"] == {"base_rate_hz": 96.0,
                            "burst": [[1.5, 3.5, 2.0]], "duration_s": 6.0,
                            "offered": _offered()}
    assert row["byte_identical"] is True and row["value"] >= 1.5
    assert row["shed_p99_ms"] <= row["slo_ms"] < row["noshed_p99_ms"]
    assert row["shed_rate"] > 0


# slow: the script's 5% telemetry-overhead bound, kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_request_obs_smoke_quick_cpu():
    row, _ = H.run("request_obs", timeout=200)
    H.check_row("request_obs", row)
    assert row["burst"]["offered"] == _offered()
    assert row["burst"]["shed"] > 0 and row["burst"]["slo_ms"] == 250.0
    ev = row["events"]
    assert ev["sheds"] == row["burst"]["shed"] and ev["dropped"] == 0
    assert ev["stragglers"] >= 1
    assert row["overhead_frac"] < 0.05
    for which in ("p50_attrib", "p99_attrib"):
        rep = row[which]
        assert abs(rep["residual_ms"]) <= 0.10 * rep["wall_ms"], rep


@pytest.mark.timeout(240)
def test_decode_profile_smoke_quick_cpu():
    row, _ = H.run("decode_profile", timeout=200)
    H.check_row("decode_profile", row)
    cfg = row["config"]
    assert cfg == {"layers": 4, "d_model": 64, "heads": 2, "vocab": 128,
                   "prompt_len": 8, "new_tokens": 16, "microbatch": 4,
                   "token_chunk": 32}
    # the JAX decoder's schedule for the same shapes
    g = gpt(4, 64, 2, 48, vocab=128)
    dec = PipelinedDecoder(g, g.init(jax.random.key(0)), num_stages=1,
                           microbatch=4, max_len=48)
    steps, unit = dec._schedule(8 + 16, 0, 32)
    assert row["chunk_steps"] == unit
    assert row["dispatches"] == math.ceil(steps / unit)
    assert row["recompiles_steady"] == row["recompile_events_steady"] == 0
    assert row["dispatch_share"] <= 1.02


def test_burst_trace_equals_the_jax_package():
    """The burst both serving smokes offer: the port's ``poisson_trace``
    gives the JAX package's arrival offsets on the same seed."""
    from defer_tpu_torch.serve import poisson_trace as tpoisson_trace

    want = poisson_trace(BURST["rate"], BURST["duration"],
                         seed=BURST["seed"], bursts=BURST["bursts"])
    got = tpoisson_trace(BURST["rate"], BURST["duration"],
                         seed=BURST["seed"], bursts=BURST["bursts"])
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.slow
@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", ["serve", "request_obs", "decode_profile"])
def test_pair_with_the_jax_script(name):
    jrow, _ = H.run(name, jax=True, timeout=400)
    prow, _ = H.run(name, timeout=400)
    H.check_row(name, jrow)
    H.check_row(name, prow)
    assert H.clock_free(name, prow) == H.clock_free(name, jrow)
