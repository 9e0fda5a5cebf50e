"""Continuous batching: coalesce admitted units across tenants into
dynamic microbatches of up to ``width`` rows.

The port's copy of ``defer_tpu.serve.batcher``.  A chain's stage programs
run at a fixed frame batch ``W``, so a formed microbatch always ships
exactly ``W`` rows — what varies frame to frame is the COMPOSITION:
however many admitted units are waiting (from any mix of tenants, in
weighted-fair order) ride the next frame, and the rest of the rows are
zero padding.  Under light load a unit never waits for company
(latency-optimal singles); under heavy load frames fill and the
per-frame cost amortizes over W units (throughput-optimal).  This is the
fixed-width slot form of continuous batching, and it is what keeps
per-request outputs byte-identical to a solo run: every frame executes
the SAME program, and stage programs are row-independent, so a row's
bytes do not depend on who shares its frame.

``W`` itself can come from the planner:
:func:`~defer_tpu_torch.plan.cost.max_batch_within_budget` (re-exported
here, as the JAX package does) picks the largest width whose slowest
stage stays inside a per-stage latency budget.
"""

from __future__ import annotations

import time
from typing import Any

from ..plan.cost import max_batch_within_budget  # noqa: F401  (re-export)
from .admission import WeightedFairQueue


class BatchFormer:
    """Forms dynamic microbatches from a :class:`WeightedFairQueue`.

    ``gather_s`` bounds how long a PARTIALLY filled frame waits for
    company after its first unit arrived (0 = never wait: whatever is
    queued right now forms the frame).  Waiting trades first-unit
    latency for fill — with a delay-bound chain the default of 0 is
    right (the pipeline itself provides the batching window: units
    arriving while a frame is in flight batch into the next one).
    """

    def __init__(self, queue: WeightedFairQueue, width: int, *,
                 gather_s: float = 0.0):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.queue = queue
        self.width = width
        self.gather_s = max(0.0, gather_s)

    def form(self, *, timeout: float | None = 0.25
             ) -> list[tuple[str, Any]]:
        """Collect up to ``width`` (tenant, unit) pairs in weighted-fair
        order: block up to ``timeout`` for the first unit, then drain
        greedily (plus the optional ``gather_s`` fill window).  Returns
        ``[]`` when nothing arrived."""
        first = self.queue.pop(timeout=timeout)
        if first is None:
            return []
        _stamp_popped(first)
        out = [first]
        deadline = time.monotonic() + self.gather_s if self.gather_s \
            else None
        while len(out) < self.width:
            nxt = self.queue.pop(timeout=0.0)
            if nxt is not None:
                _stamp_popped(nxt)
                out.append(nxt)
                continue
            if deadline is None or time.monotonic() >= deadline:
                break
            nxt = self.queue.pop(
                timeout=max(0.0, deadline - time.monotonic()))
            if nxt is None:
                break
            _stamp_popped(nxt)
            out.append(nxt)
        return out


def _stamp_popped(entry) -> None:
    """Stamp the popped unit with the instant it left the admission
    queue — the admission/gather boundary of per-request latency
    attribution (``obs/attrib.py``).  Best-effort: units without the
    slot (foreign test objects) simply go unstamped."""
    try:
        entry[1].popped_at = time.perf_counter()
    except (AttributeError, TypeError, IndexError):
        pass
