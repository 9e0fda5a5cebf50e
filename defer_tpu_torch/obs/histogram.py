"""Log-bucketed latency histogram: constant-time recording.

The port's copy of ``defer_tpu.obs.histogram``.

Buckets are geometric with 8 sub-buckets per power of two (~6% relative
resolution), indexed straight off ``math.frexp`` — no log() call, no
bucket-boundary search on the hot path.  Counts live in a sparse dict, so
a histogram that has only ever seen microsecond-scale pushes costs a
handful of entries, while the same type can absorb multi-second compile
outliers without preallocating thousands of buckets.

The same shape (log buckets + exact min/max/sum) is what HdrHistogram and
Prometheus native histograms use; this is the dependency-free core of it.
"""

from __future__ import annotations

import math

#: sub-buckets per octave; 8 -> bucket width ~9%, mid-point error ~6%
_SUB = 8
#: values below this clamp into the bottom bucket (1 ns for seconds data)
_FLOOR = 1e-9


def _bucket_index(v: float) -> int:
    """Bucket index of ``v`` (> 0): octave from frexp, linear sub-bucket."""
    m, e = math.frexp(v)          # v = m * 2**e, m in [0.5, 1)
    return (e << 3) | int((m - 0.5) * 16.0)


def _bucket_value(idx: int) -> float:
    """Representative (mid-point) value of bucket ``idx``."""
    e, sub = idx >> 3, idx & 7
    return math.ldexp((8 + sub + 0.5) / 16.0, e)


class LatencyHistogram:
    """Log-bucketed histogram with exact count/sum/min/max.

    ``record`` is an int increment in a dict (atomic enough under the GIL
    for the concurrent-writer case: a lost update costs one count, never a
    corrupt structure).  Quantiles interpolate inside the winning bucket,
    and are clamped to the exact observed [min, max] so p99 of a constant
    distribution is that constant.
    """

    __slots__ = ("_counts", "count", "sum", "min", "max", "__weakref__")

    def __init__(self):
        self._counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.count += 1
        self.sum += v
        idx = _bucket_index(v if v > _FLOOR else _FLOOR)
        c = self._counts
        c[idx] = c.get(idx, 0) + 1

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (a fan-out's per-channel shards)."""
        for idx, n in other._counts.items():
            self._counts[idx] = self._counts.get(idx, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        target = q * self.count
        seen = 0.0
        for idx in sorted(self._counts):
            n = self._counts[idx]
            if seen + n >= target:
                # linear interpolation inside the bucket
                e, sub = idx >> 3, idx & 7
                lo = math.ldexp((8 + sub) / 16.0, e)
                hi = math.ldexp((8 + sub + 1) / 16.0, e)
                frac = (target - seen) / n
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += n
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def percentiles(self) -> dict:
        """The headline view: p50/p95/p99/max (0.0s when empty)."""
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "max": self.max if self.count else 0.0}

    def summary(self, scale: float = 1.0, ndigits: int = 6) -> dict:
        """JSON-ready summary; ``scale`` converts units (1e3: s -> ms)."""
        if self.count == 0:
            return {"count": 0}
        r = lambda v: round(v * scale, ndigits)  # noqa: E731
        return {
            "count": self.count,
            "sum": r(self.sum),
            "mean": r(self.mean),
            "min": r(self.min),
            "p50": r(self.quantile(0.50)),
            "p95": r(self.quantile(0.95)),
            "p99": r(self.quantile(0.99)),
            "max": r(self.max),
        }

    def clear(self) -> None:
        self._counts.clear()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def __repr__(self):
        if self.count == 0:
            return "LatencyHistogram(empty)"
        p = self.percentiles
        return (f"LatencyHistogram(n={self.count}, p50={p['p50']:.6g}, "
                f"p99={p['p99']:.6g}, max={p['max']:.6g})")
