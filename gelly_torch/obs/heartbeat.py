"""Periodic progress heartbeat for long streams.

A multi-hour stream gives no sign of life between merge windows; the
heartbeat is the bounded, cheap answer: the executor calls
:meth:`Heartbeat.tick` once per retired unit, and at most once per
``every_s`` seconds the call actually emits — one structured line via
``logging`` (``gelly_torch.obs`` INFO), a copy into :attr:`lines` (tests
and callers read it programmatically), and an instant event on the
active span tracer so exported traces show the beats on the timeline.

The line carries: edges/sec so far, the
pipeline queue depths (read from the bus gauges the prefetch legs
publish), and the last-retired chunk position (the exactly-once resume
point — what a crash right now would resume from). Every line also
carries HOST IDENTITY (``process_index`` / ``process_count`` /
``coordinator_address`` from ``parallel/mesh.host_info``, plus the
live ``leader`` flag when a coordinated-recovery ``Coordinator`` is
active) so interleaved multi-host logs and Perfetto captures are
attributable per host.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger("gelly_torch.obs")


def host_fields() -> dict:
    """Static host identity plus the live leadership flag — merged into
    every heartbeat line and into exported traces' ``otherData``.
    Lazy imports keep ``obs`` importable standalone; leadership comes
    from the active ``engine/coordination.Coordinator`` (absent → the
    ``leader`` key is omitted, single-host logs stay unchanged)."""
    from ..parallel.mesh import host_info

    fields = host_info()
    from ..engine.coordination import leader_flag

    leader = leader_flag()
    if leader is not None:
        fields["leader"] = leader
    return fields


class Heartbeat:
    """Rate-limited progress reporter. ``tick(**fields)`` is safe to
    call per unit: it is a clock read + compare except when a beat is
    due. ``every_s <= 0`` beats on every tick (tests)."""

    def __init__(self, every_s: float = 10.0, max_lines: int = 256,
                 clock=time.monotonic):
        from collections import deque

        self.every_s = every_s
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()
        self.beats = 0
        self.lines: "deque[dict]" = deque(maxlen=max_lines)

    def due(self) -> bool:
        """Lock-free pre-check: callers on a hot path guard with this so
        the per-tick cost is ONE clock compare — building tick()'s field
        dict only when a beat will actually emit. Racy by design (tick
        re-checks under the lock); a false positive costs one discarded
        dict, never a duplicate beat."""
        return self._clock() - self._last >= self.every_s

    def tick(self, **fields) -> bool:
        """Maybe emit a beat; returns True when one was emitted."""
        now = self._clock()
        with self._lock:
            if now - self._last < self.every_s:
                return False
            self._last = now
            self.beats += 1
            # Captured INSIDE the lock: building the line from
            # self.beats after release let two threads that both won a
            # beat stamp the same number (every_s<=0, or ticks straddling
            # the cadence boundary) — lines must be attributable 1:1.
            beat_no = self.beats
        # Host identity rides every line (beats are rate-limited, so the
        # two lazy imports + leadership read cost nothing on the hot
        # path — tick() returns above long before this).
        line = dict(host_fields(), **fields, beat=beat_no)
        self.lines.append(line)
        logger.info(
            "heartbeat %s",
            " ".join(f"{k}={v}" for k, v in sorted(line.items())),
        )
        from .tracing import active_tracer

        tr = active_tracer()
        if tr is not None:
            tr.instant("heartbeat", **line)
        return True
