"""Observability: stage timers, throughput meters, profiler hook.

Counterpart of ``gelly_tpu/utils/metrics.py``:

- :class:`StageTimer` — named accumulated wall-clock per pipeline stage.
  The engine times its stages (``ingest_compress`` on the codec
  workers, ``h2d`` on the transfer thread, ``fold_dispatch`` and
  ``merge_emit`` on the consumer) into one timer, exposed as
  ``SummaryStream.timer`` and published to the bus at the end of a run;
- :class:`ThroughputMeter` — edges/sec over a window of samples;
- :func:`metered` — wrap any chunk iterator to count edges + time
  without touching the pipeline;
- :func:`trace` — context manager around ``torch.profiler`` for device
  traces (``gelly_tpu``'s wraps ``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Iterable, Iterator


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

    def publish(self, bus, prefix: str = "stage") -> None:
        """Feed the per-stage busy seconds into an ``obs`` registry as
        gauges (``<prefix>.<stage>.busy_s``) — the pipelined executor
        calls this at teardown so tests read stage accounting off the
        bus instead of holding the timer object."""
        for s, t in self.busy().items():
            bus.gauge(f"{prefix}.{s}.busy_s", t)

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


class ThroughputMeter:
    """Running edges/sec: ``meter.record(n)`` after each batch."""

    def __init__(self):
        self.edges = 0
        self.start = None
        self.last = None
        # Construction time: the elapsed fallback for a single-sample
        # meter (first-sample time alone spans no interval).
        self._created = time.perf_counter()

    def record(self, n: int):
        now = time.perf_counter()
        if self.start is None:
            self.start = now
        self.edges += int(n)
        self.last = now

    @property
    def elapsed(self) -> float:
        if self.last is None:
            return 0.0
        span = self.last - self.start
        if span > 0:
            return span
        # A single record() leaves start == last: fall back to the time
        # since the meter was created, the interval the one sample
        # actually covers, so nonzero edges never read as 0 edges/sec.
        return self.last - self._created

    @property
    def edges_per_sec(self) -> float:
        return self.edges / self.elapsed if self.elapsed > 0 else 0.0

    def snapshot(self) -> dict:
        """Point-in-time reading for heartbeats and report lines."""
        return {
            "edges": self.edges,
            "elapsed_s": round(self.elapsed, 6),
            "edges_per_sec": round(self.edges_per_sec, 1),
        }

    def publish(self, bus, prefix: str = "throughput") -> None:
        """Feed the current reading into an ``obs`` registry as gauges."""
        bus.gauge(f"{prefix}.edges", self.edges)
        bus.gauge(f"{prefix}.edges_per_sec", round(self.edges_per_sec, 1))


def metered(chunks: Iterable, meter: ThroughputMeter) -> Iterator:
    """Pass-through chunk iterator feeding ``meter`` with valid-edge counts."""
    for c in chunks:
        meter.record(int(c.valid.count_nonzero()))
        yield c


@contextlib.contextmanager
def trace(log_dir: str | None, tracer=None):
    """Device-level profiling via ``torch.profiler``; no-op when
    ``log_dir`` is None.

    Profiles the host, and the card when ``torch.cuda.is_available()``,
    and writes one Chrome-trace JSON file
    (``torch_profiler.<pid>.<ns>.json``) into ``log_dir`` at the end.

    Exception-safe: a body that raises never leaves a dangling profiler
    session — the stop always runs, and a failing stop (or export) is
    logged rather than allowed to MASK the body's exception. When the
    profiler cannot start (unavailable, or a session is already
    running), the block degrades to a logged no-op: observability must
    never kill the measured run.

    ``tracer`` (an ``obs.SpanTracer``) records ``torch_profiler_start``
    and ``torch_profiler_stop`` instants carrying its ``trace_id``, so
    the exported span trace and the device-side profile captured around
    the same run can be aligned in Perfetto.
    """
    if log_dir is None:
        yield
        return
    log = logging.getLogger("gelly_torch.obs")
    try:
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 — profiler absent/busy: no-op
        log.warning("torch.profiler trace unavailable (%s: %s); running "
                    "untraced", type(e).__name__, e)
        yield
        return
    if tracer is not None:
        tracer.instant("torch_profiler_start", log_dir=log_dir,
                       trace_id=tracer.trace_id)
    try:
        yield
    finally:
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                log_dir, f"torch_profiler.{os.getpid()}.{time.time_ns()}.json"))
        except Exception as e:  # noqa: BLE001
            # Never mask the body's exception with a failed stop.
            log.warning("torch.profiler stop/export failed (%s: %s)",
                        type(e).__name__, e)
        if tracer is not None:
            tracer.instant("torch_profiler_stop", log_dir=log_dir,
                           trace_id=tracer.trace_id)
