"""Stage timers for the pipelined executor.

Counterpart of ``gelly_tpu/utils/metrics.py`` (:class:`StageTimer` and
:func:`overlap_stats`). The engine times its stages (``ingest_compress``
on the codec workers, ``h2d`` on the transfer thread, ``fold_dispatch``
and ``merge_emit`` on the consumer) into one timer, exposed as
``SummaryStream.timer``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock per named stage: ``with timer("fold"): ...``

    Thread-safe: ingest stages are timed from prefetch worker threads
    while the consumer times fold/merge.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[stage] += dt
                self.counts[stage] += 1

    def report(self) -> dict[str, dict[str, float]]:
        with self._lock:  # snapshot: workers may add a stage meanwhile
            totals = dict(self.totals)
            counts = dict(self.counts)
        return {
            s: {
                "total_s": round(totals[s], 6),
                "calls": counts[s],
                "mean_ms": round(1e3 * totals[s] / counts[s], 3),
            }
            for s in totals
        }

    def busy(self) -> dict[str, float]:
        """Per-stage BUSY seconds, summed across whichever threads ran the
        stage. Stages overlap, so these do not add up to the wall."""
        with self._lock:
            return {s: round(t, 6) for s, t in self.totals.items()}

    def reattribute(self, src: str, dst: str, seconds: float) -> None:
        """Move ``seconds`` from ``src`` to ``dst`` (lock wait measured
        inside a work stage). ``dst`` is booked even at 0.0 seconds;
        ``src`` clamps at zero."""
        if seconds < 0:
            seconds = 0.0
        with self._lock:
            self.totals[src] = max(0.0, self.totals[src] - seconds)
            self.totals[dst] += seconds
            self.counts[dst] += 1


def overlap_stats(stage_busy: dict, total_wall: float,
                  exclude: tuple = ("total_wall",)) -> dict:
    """Overlap-aware pipeline accounting: ``overlap_efficiency`` =
    ``total_wall / max(stage_busy)`` (1.0: the wall collapsed onto the
    slowest stage), ``serial_stage_sum_s`` = what the same work costs
    serially."""
    busy = {k: float(v) for k, v in stage_busy.items() if k not in exclude}
    mx = max(busy.values(), default=0.0)
    return {
        "stage_busy": {k: round(v, 4) for k, v in busy.items()},
        "stage_busy_max_s": round(mx, 4),
        "serial_stage_sum_s": round(sum(busy.values()), 4),
        "overlap_efficiency": round(total_wall / mx, 3) if mx else None,
    }
