"""Deterministic open-loop arrival traces: seeded Poisson + burst phases.

The port's copy of ``defer_tpu.serve.arrivals`` (numpy only): the same
seed and bursts give the same trace as the JAX package's, exactly.

Closed-loop load generators (send, wait, send again) cannot measure
queueing behavior — the generator slows down exactly when the system
does, hiding the p99 the user would have seen.  An OPEN-loop trace fixes
the arrival times up front (exponential inter-arrivals from a seeded
RNG), so a serving benchmark pays real queueing delay under overload and
its p99 means something (``serve/client.py`` ``LoadGenerator``).

Burst phases multiply the base rate over declared windows — the
"2x-overload burst" of the shedding acceptance test is
``bursts=[(t0, t1, 2.0)]``.
"""

from __future__ import annotations

import numpy as np


def poisson_trace(rate_hz: float, duration_s: float, *, seed: int = 0,
                  bursts: list[tuple[float, float, float]] | None = None,
                  max_events: int = 100_000) -> list[float]:
    """Arrival offsets (seconds, sorted, within ``[0, duration_s)``).

    Exponential inter-arrivals at ``rate_hz``, thinned/boosted by burst
    phases via the standard time-rescaling construction: draw a
    unit-rate Poisson process in *integrated-intensity* time and map
    each event back through the (piecewise-constant) rate function, so
    the same seed yields the same trace regardless of how bursts are
    arranged, and events inside a ``(t0, t1, mult)`` window arrive
    ``mult`` times as fast.
    """
    if rate_hz <= 0 or duration_s <= 0:
        return []
    bursts = sorted(bursts or [])
    for t0, t1, mult in bursts:
        if t1 <= t0 or mult <= 0:
            raise ValueError(f"bad burst phase ({t0}, {t1}, {mult})")

    def rate_at(t: float) -> float:
        for t0, t1, mult in bursts:
            if t0 <= t < t1:
                return rate_hz * mult
        return rate_hz

    rng = np.random.default_rng(seed)
    out: list[float] = []
    t = 0.0
    while len(out) < max_events:
        # integrated-intensity step: advance through the piecewise-
        # constant rate until the unit-exponential budget is spent
        budget = float(rng.exponential())
        while True:
            r = rate_at(t)
            # next rate-change boundary after t (or the horizon)
            nxt = duration_s
            for t0, t1, _ in bursts:
                for edge in (t0, t1):
                    if t < edge < nxt:
                        nxt = edge
            span = (nxt - t) * r
            if budget <= span:
                t += budget / r
                break
            budget -= span
            t = nxt
            if t >= duration_s:
                return out
        if t >= duration_s:
            return out
        out.append(t)
    return out
