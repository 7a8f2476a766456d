"""Fixed-memory streaming latency histograms (log-bucketed).

A :class:`StreamingHistogram` is the distribution-valued sibling of the
bus's counters and gauges: ``record(value)`` lands the sample in one of
a FIXED number of logarithmic buckets (8 sub-buckets per power of two,
so quantile estimates carry <= ~9% relative error by construction),
``quantile(q)``/``snapshot()`` read p50/p90/p99/max at any time, and
``merge(other)`` folds two histograms bucket-wise — the property that
lets per-shard or per-incarnation histograms aggregate into one fleet
view without ever shipping raw samples.

Memory is O(buckets) forever — a week-long stream costs exactly the
same bytes as the first window — which is why the serving plane records
distributions here instead of appending samples anywhere.

Threading: ``record`` takes a short lock around two integer adds; the
cadence is per pipeline unit / window close / checkpoint (never per
edge), so the lock is uncontended in practice. Reads snapshot under the
same lock. The zero-cost-when-disabled contract lives at the CALL
sites, not here: engine/ingest code binds ``bus.observe`` only when a
tracer is installed or :func:`gelly_torch.obs.bus.recording` is on, so a
disabled run never reaches this module (not even for a clock read).
"""

from __future__ import annotations

import math
import threading

# Bucket geometry: SUB sub-buckets per octave (power of two), exponents
# spanning 2^MIN_EXP .. 2^MAX_EXP. With values in milliseconds that is
# ~1 ns .. ~17 years — anything outside clamps into the edge buckets
# (counted, never dropped).
_SUB = 8
_MIN_EXP = -20
_MAX_EXP = 44
_N_BUCKETS = (_MAX_EXP - _MIN_EXP) * _SUB


def _bucket_of(value: float) -> int:
    """Log-bucket index of ``value``: octave from ``frexp``, linear
    sub-bucket from the mantissa (HdrHistogram's trick — no log() call
    on the record path)."""
    if value <= 0.0 or value != value:  # <= 0 and NaN land in bucket 0
        return 0
    m, e = math.frexp(value)  # value = m * 2**e, m in [0.5, 1)
    idx = (e - 1 - _MIN_EXP) * _SUB + int((m - 0.5) * 2 * _SUB)
    if idx < 0:
        return 0
    if idx >= _N_BUCKETS:
        return _N_BUCKETS - 1
    return idx


def _bucket_upper(idx: int) -> float:
    """Upper edge of bucket ``idx`` — the quantile estimate returned
    for samples that fell in it (a conservative bound: the reported
    pXX is never below the true one by more than one bucket width)."""
    octave, sub = divmod(idx, _SUB)
    return math.ldexp(0.5 + (sub + 1) / (2 * _SUB), octave + 1 + _MIN_EXP)


class StreamingHistogram:
    """Mergeable fixed-memory log-bucketed histogram.

    - :meth:`record` — O(1), no allocation (bucket array pre-built);
    - :meth:`quantile` — bucket-walk estimate, upper-edge convention;
    - :meth:`merge` — bucket-wise sum (associative + commutative);
    - :meth:`snapshot` — ``{count, sum, min, max, p50, p90, p99}``,
      plain floats (JSON-ready — the STATS endpoint and trace
      ``otherData`` embed it verbatim).

    ``min``/``max`` are EXACT (tracked outside the buckets); quantiles
    are bucket-resolution estimates. Non-positive and NaN samples clamp
    into the lowest bucket rather than raising — telemetry must never
    fault the path it measures.
    """

    __slots__ = ("_lock", "_counts", "count", "total", "vmin", "vmax")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        value = float(value)
        idx = _bucket_of(value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            if value < self.vmin:
                self.vmin = value
            if value > self.vmax:
                self.vmax = value

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other`` into this histogram (bucket-wise); returns
        self. Lock order: other's counts are snapshotted first, so two
        cross-merges cannot deadlock."""
        with other._lock:
            counts = list(other._counts)
            ocount, ototal = other.count, other.total
            omin, omax = other.vmin, other.vmax
        with self._lock:
            for i, c in enumerate(counts):
                if c:
                    self._counts[i] += c
            self.count += ocount
            self.total += ototal
            if omin < self.vmin:
                self.vmin = omin
            if omax > self.vmax:
                self.vmax = omax
        return self

    @staticmethod
    def _quantile_of(counts, count, vmin, vmax, q: float) -> float:
        """Quantile estimate over one consistent (counts, count, min,
        max) view — callers take it under the lock so a snapshot's
        quantiles describe exactly the population its count reports."""
        if count == 0:
            return 0.0
        rank = q * count
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c:
                # Clamp the bucket-edge estimate to the exact
                # extrema: a one-sample histogram reports its value.
                return float(min(max(_bucket_upper(i), vmin), vmax))
        return float(vmax)

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (0 <= q <= 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            return self._quantile_of(self._counts, self.count,
                                     self.vmin, self.vmax, q)

    def snapshot(self) -> dict:
        # ONE lock acquisition covers every field read AND the quantile
        # walks: the STATS endpoint reads this live mid-stream, and a
        # record() interleaving between per-field reads would otherwise
        # report e.g. a count over one population and a p99 over
        # another.
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "p50": 0.0, "p90": 0.0, "p99": 0.0}
            counts = list(self._counts)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        return {
            "count": count,
            "sum": round(total, 6),
            "min": round(vmin, 6),
            "max": round(vmax, 6),
            "p50": round(self._quantile_of(counts, count, vmin, vmax,
                                           0.50), 6),
            "p90": round(self._quantile_of(counts, count, vmin, vmax,
                                           0.90), 6),
            "p99": round(self._quantile_of(counts, count, vmin, vmax,
                                           0.99), 6),
        }

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:  # debugging aid only
        s = self.snapshot()
        return (f"StreamingHistogram(count={s['count']}, p50={s['p50']}, "
                f"p99={s['p99']}, max={s['max']})")
