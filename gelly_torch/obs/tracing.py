"""Per-unit span tracing with a bounded ring buffer.

A :class:`SpanTracer` records COMPLETE spans (recorded once, at span
end) and instant events into a ``collections.deque(maxlen=...)`` — a
bounded ring, so a long stream can trace forever and keep the newest
window. Records are plain dicts; timestamps are seconds on the tracer's
monotonic clock, zeroed at construction (the exporter converts to the
microseconds Chrome/Perfetto expect).

Overhead contract: tracer NOT installed ⇒ zero allocations on
the pipeline's unit path. The engine binds ``tracer = active_tracer()``
once per run and guards every site with ``if tracer is not None`` — no
span objects, no kwargs dicts, not even a clock read when disabled.
Installed ⇒ one dict + one deque append per span (``chip_smoke.py``
phase M1 prints the traced and untraced walls on the card).

Threading: spans are recorded from compress workers, the H2D thread and
the consumer concurrently; ``deque.append`` is atomic under the GIL and
the record is fully built before the append, so no lock is needed on
the hot path.

**Wire trace propagation**: the tracer also owns the two
pieces the causal chain across the wire needs — a monotonic span-id
allocator (:meth:`SpanTracer.next_span_id`; ids are per-tracer, stamped
into span ``args`` as ``span=``/``parent=`` so an exported trace links
client-send → wire recv → staging → fold → checkpoint), and a BOUNDED
position→context registry (:meth:`bind_ctx` / :meth:`ctx`): the ingest
server binds each staged chunk position to its staging span's context,
and the engine's fold/checkpoint sites look the context up by position
to parent their spans on it. The registry is a plain dict plus an
insertion-order eviction deque capped at :data:`CTX_CAPACITY` entries —
a long stream cannot grow it, and an evicted position simply yields an
unlinked (but still recorded) span.

**Flight recorder** (rotating-segment mode): construct with
``SpanTracer(segment_s=K, segments=N)`` and the ring becomes a bounded
ring of N TIME segments — the newest ``N * K`` seconds of spans are
retained regardless of record rate (eviction is whole oldest segments,
counted in ``dropped``; ``capacity`` bounds records per segment as a
memory backstop). :meth:`dump` exports the retained window as a valid
Chrome trace at any moment, and :meth:`dump_on` subscribes to the event
bus so an INCIDENT — an injected fault, a watchdog timeout, a
degradation — automatically exports the spans surrounding it to a file,
after the fact, with no debugger attached. ``EventBus.emit`` records
the triggering instant into the tracer BEFORE the subscriber fan-out,
so every flight dump contains its own incident marker.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator

# Bound on the position→trace-context registry (bind_ctx/ctx): oldest
# bindings evict first. 4096 positions is far past any staging queue +
# in-flight fold window, so a linked span only loses its parent when
# the pipeline is tens of thousands of chunks behind — at which point
# backlog, not trace linkage, is the story.
CTX_CAPACITY = 4096


class SpanTracer:
    """Bounded-ring span recorder.

    - :meth:`now` — monotonic seconds since tracer start (span starts);
    - :meth:`span` — record a completed span: stage name, ``track``
      (the export lane, e.g. ``"compress/w3"``), start + now as the
      interval, plus arbitrary attribution fields (unit id, worker,
      queue depth, bytes/edges);
    - :meth:`instant` — a point event (retry, fault, window close);
    - :attr:`trace_id` — shared correlation id: stamp it into a
      ``torch.profiler`` device trace captured around the same run
      (``utils.metrics.trace(log_dir, tracer=...)`` does this) and the
      two timelines can be laid side by side in Perfetto.
    """

    def __init__(self, capacity: int = 1 << 16,
                 heartbeat_every_s: float | None = 10.0,
                 segment_s: float | None = None, segments: int = 8,
                 clock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        from collections import deque

        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self.capacity = capacity
        self.trace_id = os.urandom(8).hex()
        self._clock = clock if clock is not None else time.perf_counter
        self.t0 = self._clock()
        # The engine starts a Heartbeat at this cadence when the tracer
        # is installed; None disables it.
        self.heartbeat_every_s = heartbeat_every_s
        self.dropped = 0  # ring evictions are counted, never silent
        self._drop_lock = threading.Lock()
        # Flight-recorder (rotating-segment) mode: retain the newest
        # ``segments * segment_s`` seconds instead of the newest
        # ``capacity`` records. ``capacity`` stays as the per-segment
        # record bound (memory backstop against a record storm).
        if segment_s is not None and segment_s <= 0:
            raise ValueError(f"segment_s must be > 0, got {segment_s}")
        if segments < 2:
            raise ValueError(f"segments must be >= 2, got {segments}")
        self.segment_s = segment_s
        self.segments = segments
        self._seg_lock = threading.Lock()
        self._sealed: "deque[list]" = deque()
        self._cur: list = []
        self._seg_start = 0.0
        self.dumps: list = []  # flight-dump paths, newest last
        # Wire-propagation state: the span-id allocator (itertools.count
        # — next() on it is GIL-atomic, so concurrent stages allocate
        # without a lock) and the bounded position→context registry.
        import itertools

        self._span_ids = itertools.count(1)
        self._ctx: dict = {}
        self._ctx_order: "deque" = deque()
        self._ctx_lock = threading.Lock()

    # ------------------------------------------------------------ hot path

    def now(self) -> float:
        return self._clock() - self.t0

    def _append(self, rec: dict) -> None:
        if self.segment_s is None:
            if len(self._ring) == self.capacity:
                with self._drop_lock:
                    self.dropped += 1
            self._ring.append(rec)
            return
        ts = rec["ts"]
        if ts - self._seg_start >= self.segment_s:
            with self._seg_lock:
                if ts - self._seg_start >= self.segment_s:
                    # Seal the current segment; appenders that read the
                    # old list reference land their record in the sealed
                    # segment — retained either way.
                    self._sealed.append(self._cur)
                    self._cur = []
                    self._seg_start = ts
                    while len(self._sealed) > self.segments - 1:
                        old = self._sealed.popleft()
                        with self._drop_lock:
                            self.dropped += len(old)
        cur = self._cur
        if len(cur) >= self.capacity:
            with self._drop_lock:
                self.dropped += 1
            return
        cur.append(rec)

    def span(self, stage: str, track: str, t0: float, **attrs) -> None:
        """Record ``[t0, now]`` as a completed span on ``track``."""
        t1 = self.now()
        self._append({
            "ph": "X", "name": stage, "track": track,
            "ts": t0, "dur": max(0.0, t1 - t0),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "args": attrs,
        })

    def instant(self, name: str, track: str = "events", **attrs) -> None:
        self._append({
            "ph": "i", "name": name, "track": track,
            "ts": self.now(),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "args": attrs,
        })

    # ------------------------------------------------- wire trace context

    def next_span_id(self) -> int:
        """Allocate a span id for cross-span linkage (stamped into span
        ``args`` as ``span=``; children record it as ``parent=``). Ids
        are unique per tracer and never reused."""
        return next(self._span_ids)

    def bind_ctx(self, key, trace: str, span: int) -> None:
        """Bind ``key`` (a chunk position, or any hashable stage key)
        to a trace context ``(trace_id_hex, span_id)`` so a later stage
        that only knows the position can parent its span on it. The
        registry holds at most :data:`CTX_CAPACITY` bindings — oldest
        evict first, so a stalled consumer can never grow it."""
        with self._ctx_lock:
            if key not in self._ctx:
                self._ctx_order.append(key)
                while len(self._ctx_order) > CTX_CAPACITY:
                    self._ctx.pop(self._ctx_order.popleft(), None)
            self._ctx[key] = (trace, span)

    def ctx(self, key) -> tuple[str, int] | None:
        """The bound ``(trace_id_hex, span_id)`` for ``key``, or None
        (never bound, or evicted — the caller records an unlinked
        span)."""
        with self._ctx_lock:
            return self._ctx.get(key)

    # ------------------------------------------------------------- reading

    def records(self) -> list[dict]:
        """Snapshot of the ring, oldest → newest. (``list(deque)`` is a
        GIL-atomic copy; readers must go through it — a comprehension
        over the LIVE deque raises "deque mutated during iteration"
        when in-flight pipeline workers are still appending.)"""
        if self.segment_s is None:
            return list(self._ring)
        with self._seg_lock:
            out: list = []
            for seg in self._sealed:
                out.extend(seg)
            out.extend(self._cur)
            return out

    def spans(self, stage: str | None = None) -> list[dict]:
        return [r for r in self.records()
                if r["ph"] == "X" and (stage is None or r["name"] == stage)]

    def instants(self, name: str | None = None) -> list[dict]:
        return [r for r in self.records()
                if r["ph"] == "i" and (name is None or r["name"] == name)]

    # ------------------------------------------------------ flight recorder

    # The default incident set dump_on() wires when called without
    # event names: every injected fault, watchdog fire and
    # native->fallback degradation exports the surrounding spans.
    INCIDENT_EVENTS = ("faults.injected", "resilience.watchdog_timeouts",
                       "resilience.degradations")

    def dump(self, path: str, bus=None, extra: dict | None = None) -> dict:
        """Export the currently retained ring as a validated Chrome
        trace to ``path`` (works in both ring modes); returns the trace
        dict. This is the after-the-fact read: the last
        ``segments * segment_s`` seconds of spans around an incident,
        without a debugger attached."""
        from .export import write_chrome_trace

        return write_chrome_trace(path, self, bus=bus, extra=extra)

    def dump_on(self, *events: str, out_dir: str, bus=None,
                limit: int = 8):
        """Wire incident-triggered dumps: subscribe to ``bus`` (default:
        the current :func:`~gelly_torch.obs.bus.get_bus`) and, whenever
        one of ``events`` (default :data:`INCIDENT_EVENTS` — injected
        faults, watchdog timeouts, degradations) is emitted, export the
        ring to ``out_dir/flight-<n>-<event>.json``. At most ``limit``
        dumps per wiring (an incident storm must not turn the recorder
        into a disk-filling incident of its own); paths land in
        :attr:`dumps` and each dump bumps the ``obs.flight_dumps``
        counter. Returns the unsubscribe callable."""
        from . import bus as bus_mod

        want = frozenset(events) if events else frozenset(
            self.INCIDENT_EVENTS)
        target_bus = bus if bus is not None else bus_mod.get_bus()
        state = {"n": 0}
        state_lock = threading.Lock()

        def on_incident(name: str, fields: dict) -> None:
            if name not in want:
                return
            with state_lock:
                if state["n"] >= limit:
                    return
                n = state["n"]
                state["n"] += 1
            path = os.path.join(
                out_dir, f"flight-{n:03d}-{name.replace('.', '_')}.json"
            )
            try:
                self.dump(path, bus=target_bus, extra={
                    "incident": name,
                    "incident_fields": {k: repr(v)
                                        for k, v in fields.items()},
                })
            except Exception:  # noqa: BLE001 — never fault the emitter
                import logging

                logging.getLogger("gelly_torch.obs").exception(
                    "flight-recorder dump for %r failed", name)
                return
            self.dumps.append(path)
            # Count on the SUBSCRIBED bus: with an explicit ``bus=``
            # the current bus at dump time may be a different scope —
            # the counter must land next to the incident it counts.
            target_bus.inc("obs.flight_dumps")

        return target_bus.subscribe(on_incident)


_ACTIVE: SpanTracer | None = None
_ACTIVE_LOCK = threading.Lock()


def active_tracer() -> SpanTracer | None:
    """The installed tracer, or None — THE disabled-path check: callers
    bind the result once and guard every record site with it."""
    return _ACTIVE


@contextlib.contextmanager
def install(tracer: SpanTracer) -> Iterator[SpanTracer]:
    """Activate ``tracer`` for the dynamic extent (same install shape as
    ``engine/faults.py``). Tracers do not nest — a second install inside
    an active one raises instead of silently splitting the timeline."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a SpanTracer is already installed")
        _ACTIVE = tracer
    try:
        yield tracer
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
