"""Process-wide event bus: counters, gauges, histograms, events.

One default :class:`EventBus` exists per process (:func:`get_bus`) so
runtime modules can publish without any wiring — the same stance as the
fault registry in ``engine/faults.py``. Publishing is a locked dict
update (no I/O, no allocation beyond the event dict for :meth:`emit`),
cheap enough to stay always-on at the cadences the runtime publishes at
(per retry, per window close, per checkpoint — never per edge).

Counters and gauges are ALWAYS-ON; histograms (:meth:`EventBus.observe`
into a fixed-memory :class:`~gelly_torch.obs.histogram.
StreamingHistogram`) and the end-to-end latency watermarks
(``bus.watermarks``, a :class:`~gelly_torch.obs.watermarks.Watermarks`
ledger) are GUARDED: the engine/ingest hot paths bind them only when a
span tracer is installed or :func:`recording` is on (enable with
:func:`record_metrics` scoped, or :func:`set_recording` for a
long-running server) — the exact ``active_tracer() is not None``
zero-cost-when-disabled discipline the tracer established, so a
disabled run performs no histogram work, not even a clock read.

Counter/gauge names are dotted, ``<subsystem>.<what>``:

====================================  =================================
``resilience.retries``                guarded-boundary retries
``resilience.watchdog_timeouts``      watchdog fires (hung calls)
``resilience.degradations``           native→fallback ladder trips
``resilience.source_restarts``        chunk-source reopenings
``resilience.checkpoints``            completed checkpoint writes
``resilience.checkpoint_misses``      tolerated mid-stream ckpt failures
``resilience.rotation_skipped``       torn-newest prune refusals
``resilience.checkpoint_bytes``       cumulative checkpoint file bytes
``resilience.checkpoint_write_s``     last write latency (gauge)
``faults.injected``                   FaultPlan faults that fired
``coordination.barrier_agreed``       checkpoint barriers resolved
``coordination.prepared``             2PC shard votes written
``coordination.committed``            leader manifest commits
``coordination.leader_elected``       observed leadership changes
``coordination.rejoins``              restart-time re-joins
``coordination.degradations``         degraded-capacity takeovers
``ingest.frames_received``            wire frames decoded by the server
``ingest.frames_rejected``            CRC-mismatch / gap / malformed
``ingest.frames_truncated``           torn frames (conn died mid-frame)
``ingest.frames_duplicate``           reconnect replays dropped+re-acked
``ingest.chunks_enqueued``            payloads staged for the consumer
``ingest.bytes_received``             cumulative wire bytes in
``ingest.acks_sent``                  durability acks pushed to clients
``ingest.backpressure_engaged``       PAUSE engagements (event)
``ingest.staged_depth``               server staging queue depth (gauge)
``ingest.paused``                     1 while PAUSEd (gauge)
``ingest.data_frames_raw``            raw-edge DATA frames staged
``ingest.data_frames_compressed``     client-side-compressed
                                      DATA_COMPRESSED frames staged
                                      (zero server-side compress)
``ingest.frames_sent``                client DATA frames transmitted
``ingest.frames_resent``              client retransmits after rewind
``ingest.pauses_received``            PAUSE frames seen by the client
``ingest.rejects_received``           REJECT frames seen by the client
``ingest.reshards``                   routing-table re-shard events
``ingest.chunks_unroutable``          tenant-router payloads dropped
                                      (unknown tenant, no default)
``ingest.chunks_invalid``             tenant-router payloads dropped
                                      (bad ids/shapes/finished tenant)
``ingest.stats_requests``             STATS introspection frames
                                      answered (read-only; never
                                      advances DATA sequencing)
``ingest.auth_challenges``            AUTH_CHALLENGE nonces issued to
                                      unauthenticated HELLOs
``ingest.auth_failures``              connections refused by the
                                      pre-shared-key gate (bad/missing
                                      proof, or data before auth)
``ingest.nacks_sent``                 terminal NACK frames sent (QoS
                                      shed streams; seq = durable pos)
``ingest.nacks_received``             NACK frames seen by the client
                                      (its stream was shed server-side)
``ingest.frames_shed``                DATA frames dropped on arrival
                                      because their tenant's stream is
                                      shed (never staged, never acked)
``ingest.frames_stacked``             STACKED frames admitted (K
                                      payloads behind one header/CRC,
                                      staged as ONE unit)
``ingest.stack_flush_size``           client stack flushes fired by the
                                      count ceiling (buffer hit
                                      ``stack=K``)
``ingest.stack_flush_bytes``          client stack flushes fired by the
                                      byte ceiling (``stack_bytes=``)
``ingest.stack_flush_age``            client stack flushes fired by the
                                      age deadline (``stack_ms=``);
                                      tail drains on flush()/close()
                                      are untagged
``engine.units_folded``               pipeline units retired by a fold
``engine.chunks_folded``              chunks inside those units
``engine.edges_folded``               valid edges (tracer-enabled runs)
``engine.windows_closed``             merge windows closed
``engine.window_dirty_rows``          dirty count at last delta close
``engine.dirty_rows_gathered``        delta-close rows moved (S*bucket),
                                      cumulative
``engine.checkpoint_bytes``           aggregate-path checkpoint bytes
``engine.throughput.edges``           pipelined-run edges folded (gauge)
``engine.throughput.edges_per_sec``   running fold rate (gauge)
``stage.fold_dispatch.busy_s``        per-stage busy seconds at executor
                                      teardown — one
                                      ``<prefix>.<stage>.busy_s`` gauge
                                      per StageTimer stage
``pipeline.staged_depth``             compress→H2D queue depth (gauge)
``pipeline.h2d_depth``                H2D→fold queue depth (gauge)
``tenants.active``                    live (not-done) tenants (gauge)
``tenants.queue_depth``               total queued tenant chunks (gauge)
``tenants.starved_windows``           live-tenant lanes dispatched as
                                      masked no-ops (tenant had no
                                      pending chunk at batch build)
``tenants.dispatches``                vmapped tenant-batch dispatches
``tenants.chunks_folded``             tenant chunks those advanced
``tenants.windows_closed``            tenant merge windows closed
``tenants.checkpoints``               per-tenant checkpoint writes
``tenants.checkpoint_bytes``          cumulative tenant ckpt bytes
``tenants.compressed_dispatches``     vmapped fold_codec dispatches
                                      (compressed tiers folding
                                      producer-compressed payloads)
``tenants.reclaims``                  idle-lane reclamation events
                                      (tier lane stack halved)
``tenants.lanes_reclaimed``           lanes freed by idle-lane
                                      reclamation, cumulative
``qos.rate_limited``                  ladder OK→LIMITED transitions
                                      (tenant over its backlog budget)
``qos.limit_cleared``                 LIMITED→OK recoveries (backlog
                                      back under budget)
``qos.parked``                        LIMITED→PARKED transitions (lane
                                      freed at the next safe window
                                      boundary; snapshots stay live)
``qos.unparked``                      PARKED→LIMITED re-admissions
                                      (active pressure drained below
                                      the un-park threshold)
``qos.shed``                          PARKED→SHED terminations (parked
                                      queue exceeded shed_queue_depth;
                                      typed NACK on the wire)
``qos.chunks_dropped``                queued chunks discarded by shed
                                      transitions, cumulative
``qos.admissions_refused``            admit() calls refused at the
                                      backlog-age ceiling
                                      (admission="refuse")
``qos.admissions_queued``             admit() calls parked in the
                                      waiting line (admission="queue")
``qos.admissions_resumed``            queued admissions completed once
                                      pressure fell under the ceiling
``qos.limited_tenants``               tenants at LIMITED (gauge)
``qos.parked_tenants``                tenants at PARKED (gauge)
``qos.shed_tenants``                  tenants at SHED (gauge)
``multiquery.runs``                   fused multi-query runs started
``multiquery.fused_queries``          queries riding the active fused
                                      plan (gauge)
``multiquery.compressed_chunks``      chunks through the fused
                                      shared-compress stage (one
                                      multi-query payload per chunk)
``multiquery.emissions``              per-query emissions published
                                      (Q per window close)
``multiquery.snapshot_reads``         live per-query snapshot reads
                                      answered
``sharded_cc.window_dirty_rows``      dirty entries at last emission
``sharded_cc.window_dirty_max_shard`` max per-shard dirty count (gauge)
``sharded_cc.emissions_dense``        window closes emitting full labels
``sharded_cc.emissions_sparse``       window closes emitting dirty pairs
``sharded_cc.dirty_rows_gathered``    dirty rows pulled D2H, cumulative
``engine.backlog_age_s``              oldest unretired ingress stamp's
                                      age — the single-stream low
                                      watermark (gauge; per-tenant
                                      twins publish as
                                      ``tenants.t<tid>.backlog_age_s``)
``tenants.backlog_age_max_s``         worst per-tenant backlog age
                                      (gauge — the QoS admission
                                      headline)
``obs.flight_dumps``                  flight-recorder trace dumps
                                      written (dump_on triggers)
``windows.panes_closed``              pane closes on the windowed ring
                                      (one per merge-window boundary)
``windows.combine_dispatches``        two-stack ``combine`` dispatches
                                      paid by the ring — O(1) amortized
                                      per pane close regardless of W
``windows.evicted_slots``             compact-id slots reclaimed by TTL
                                      decay, cumulative
``windows.snapshot_reads``            windowed ``snapshot()`` epoch
                                      handles served
``windows.ring_live``                 panes currently live in the ring
                                      (gauge; ≤ W)
``windows.live_slots``                compact-id slots assigned after
                                      the pane's TTL sweep (gauge — the
                                      bounded steady-state capacity)
``slo.breaching``                     SLO instances currently in breach
                                      (gauge; the heartbeat's
                                      ``slo_breaching=`` source)
``slo.fold_p99_ms.burn_rate``         breaching fraction of the spec's
                                      rolling window, 0..1 (gauge; one
                                      ``slo.<key>.burn_rate`` per spec
                                      instance, ``<key>`` suffixed
                                      ``.t<tid>`` for per-tenant SLOs)
``slo.breach``                        healthy→breach crossings (event;
                                      fields ``slo``/``tenant``/
                                      ``value``/``threshold``/
                                      ``burn_rate`` — the push-alert
                                      and QoS admission signal)
``slo.recovered``                     breach→healthy crossings (event,
                                      same fields)
``alerts.component_merge``            summary-delta watch saw the
                                      component count drop — a merge
                                      happened (event)
``alerts.degree_spike``               max degree jumped past
                                      ``spike_factor`` × its trailing
                                      EMA (event)
``alerts.subscriptions``              SUBSCRIBE filters accepted,
                                      cumulative
``alerts.subscribers``                live alert subscriptions across
                                      all connections (gauge)
``alerts.pushed``                     ALERT frames written to
                                      subscribed clients
``alerts.dropped``                    ALERT frames lost to a dead
                                      connection — the best-effort
                                      delivery contract's loss counter
``ingest.alerts_received``            ALERT frames consumed by a
                                      client's reader loop
====================================  =================================

Histogram names (``bus.observe(name, value_ms)`` — latency
distributions in MILLISECONDS, snapshot as p50/p90/p99/max; recorded
only when a tracer is installed or :func:`recording` is on):

====================================  =================================
``engine.fold_dispatch_ms``           per-unit fold dispatch wall
``engine.merge_emit_ms``              merge-window close + emission
                                      barrier wall
``engine.e2e_ingress_to_fold_ms``     chunk ingress (wire receive /
                                      reader parse) → fold dispatch;
                                      per-tenant twins publish as
                                      ``tenants.t<tid>.…`` via the
                                      same suffix
``engine.e2e_ingress_to_durable_ms``  chunk ingress → covering
                                      checkpoint durable (window close
                                      on runs without a checkpoint
                                      path); per-tenant twins as above
``resilience.checkpoint_write_ms``    checkpoint write wall — one
                                      ``<prefix>.checkpoint_write_ms``
                                      histogram per checkpoint writer
                                      (engine/resilience/tenants), via
                                      :func:`publish_checkpoint`
``ingest.receive_to_stage_ms``        wire frame fully received →
                                      staged for the consumer
``ingest.chunks_per_stacked_frame``   payload COUNT (not ms) carried by
                                      each admitted STACKED frame — the
                                      realized coalescing factor K
                                      (flush-policy tails drag it below
                                      the configured ``stack=``)
``tenants.round_ms``                  one multi-tenant scheduling
                                      round's batched fold dispatch
``multiquery.emit_ms``                fused emission snapshot
                                      publication at a window close
                                      (lock wait + swap — the reader-
                                      contention signal; the window's
                                      compute wall is merge_emit_ms)
``windows.pane_close_ms``             windowed pane close wall — pane
                                      capture + ring push + suffix
                                      query + transform (scales with
                                      pane size, not window length)
====================================  =================================

Tests that need isolation wrap the block in :func:`scope`, which swaps
a fresh bus in for the dynamic extent — publishers always resolve the
bus at call time (``get_bus()``), so the swap is complete.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Iterator

import contextlib


class EventBus:
    """Thread-safe counters + gauges + histograms + subscriber fan-out.

    - :meth:`inc` — add to a (float-valued) counter;
    - :meth:`gauge` — set a last-value gauge;
    - :meth:`observe` — record a sample into a named
      :class:`~gelly_torch.obs.histogram.StreamingHistogram` (created on
      first observation; fixed memory forever after);
    - :meth:`emit` — publish a structured event: bumps the
      ``<name>`` counter, records an instant event into the active span
      tracer (if one is installed — BEFORE the subscriber fan-out, so a
      flight-recorder dump triggered by the event captures its own
      instant), and forwards the event dict to subscribers.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.histograms: dict = {}
        from .watermarks import Watermarks

        # The e2e-latency ledger rides the bus so scope() isolates it
        # with the counters (see obs/watermarks.py).
        self.watermarks = Watermarks()
        self._subs: list[Callable[[str, dict], None]] = []

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named histogram. Call sites on
        hot paths must be guarded (tracer installed or
        :func:`recording` on) — see the module docstring."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                from .histogram import StreamingHistogram

                h = self.histograms[name] = StreamingHistogram()
        h.record(value)

    def histogram(self, name: str):
        """The named :class:`StreamingHistogram`, or None if nothing
        was ever observed into it."""
        with self._lock:
            return self.histograms.get(name)

    def quantile(self, name: str, q: float, default: float = 0.0) -> float:
        """Convenience quantile read (``default`` when the histogram
        does not exist) — the heartbeat's p99 source."""
        h = self.histogram(name)
        return h.quantile(q) if h is not None else default

    def emit(self, name: str, **fields) -> None:
        with self._lock:
            self.counters[name] += 1
            subs = list(self._subs)
        # Mirror onto the trace timeline FIRST: a flight-recorder dump
        # subscribed to this event must find the event's own instant in
        # the ring it exports. Imported lazily (bus must stay importable
        # first — tracing imports nothing back from here).
        from .tracing import active_tracer

        tr = active_tracer()
        if tr is not None:
            tr.instant(name, **fields)
        for fn in subs:
            try:
                fn(name, fields)
            except Exception:  # noqa: BLE001
                # A raising subscriber must never turn observability into
                # a runtime fault at the PUBLISHER's call site (the
                # watchdog/retry/fault-injection paths all emit).
                import logging

                logging.getLogger("gelly_torch.obs").exception(
                    "event-bus subscriber failed on %r", name)

    def subscribe(self, fn: Callable[[str, dict], None]) -> Callable[[], None]:
        """Register ``fn(name, fields)`` for every :meth:`emit`; returns
        an unsubscribe callable."""
        with self._lock:
            self._subs.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._subs:
                    self._subs.remove(fn)

        return unsubscribe

    def snapshot(self) -> dict:
        """Point-in-time copy: counters, gauges, histogram quantile
        snapshots and per-stream watermark states — all plain JSON
        types (trace ``otherData`` and the STATS endpoint embed it
        verbatim)."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.histograms)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.snapshot() for k, h in hists.items()},
            "watermarks": self.watermarks.snapshot(),
        }


def publish_checkpoint(bus: EventBus, prefix: str, path: str,
                       t0: float | None = None) -> int:
    """Shared checkpoint-durability publishing (used by ALL checkpoint
    writers — ``engine/resilience.CheckpointManager``, the aggregate
    path's ``maybe_checkpoint`` and the tenant engine): bump
    ``<prefix>.checkpoints`` and ``<prefix>.checkpoint_bytes`` (file
    size; 0 when unreadable), and when ``t0`` (``time.perf_counter()``
    at write start) is given, gauge ``<prefix>.checkpoint_write_s`` —
    plus, when telemetry recording is on (tracer installed or
    :func:`recording`), the ``<prefix>.checkpoint_write_ms``
    write-latency HISTOGRAM. Returns the byte count."""
    import os
    import time

    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    bus.inc(f"{prefix}.checkpoints")
    bus.inc(f"{prefix}.checkpoint_bytes", size)
    if t0 is not None:
        dt = time.perf_counter() - t0
        bus.gauge(f"{prefix}.checkpoint_write_s", round(dt, 6))
        if telemetry_on():
            bus.observe(f"{prefix}.checkpoint_write_ms", dt * 1e3)
    return size


_DEFAULT = EventBus()
_CURRENT: EventBus = _DEFAULT
_SWAP_LOCK = threading.Lock()
# Histogram/watermark recording enable (see module docstring): a
# nesting count for record_metrics() scopes plus an absolute switch for
# long-running servers (the example's --serve --stats).
_RECORD_DEPTH = 0
_RECORD_FORCED = False


def recording() -> bool:
    """True when histogram/watermark recording is enabled — THE
    disabled-path check next to ``active_tracer() is not None``: hot
    paths bind ``bus.observe``/``bus.watermarks`` once per run only
    when one of the two is on."""
    return _RECORD_DEPTH > 0 or _RECORD_FORCED


def telemetry_on() -> bool:
    """THE serving-plane telemetry guard, shared by every recording
    site (engine/resilience/tenants/ingest): histograms and watermarks
    record when :func:`recording` is on OR a span tracer is installed.
    One definition, so a future change to the enablement rule cannot
    silently split the zero-cost-when-disabled contract across
    hand-copied guards."""
    from .tracing import active_tracer

    return recording() or active_tracer() is not None


def set_recording(on: bool) -> None:
    """Absolute recording switch (idempotent) for long-running
    processes; scoped code should prefer :func:`record_metrics`."""
    global _RECORD_FORCED
    with _SWAP_LOCK:
        _RECORD_FORCED = bool(on)


@contextlib.contextmanager
def record_metrics() -> Iterator[None]:
    """Enable histogram/watermark recording for the dynamic extent
    (nests; same shape as :func:`scope`)."""
    global _RECORD_DEPTH
    with _SWAP_LOCK:
        _RECORD_DEPTH += 1
    try:
        yield
    finally:
        with _SWAP_LOCK:
            _RECORD_DEPTH -= 1


def get_bus() -> EventBus:
    """The process-wide bus (or the innermost :func:`scope` bus)."""
    return _CURRENT


@contextlib.contextmanager
def scope(bus: EventBus | None = None) -> Iterator[EventBus]:
    """Swap a fresh (or given) bus in for the dynamic extent — test
    isolation without publishers needing to thread a bus parameter."""
    global _CURRENT
    new = bus if bus is not None else EventBus()
    with _SWAP_LOCK:
        prev, _CURRENT = _CURRENT, new
    try:
        yield new
    finally:
        with _SWAP_LOCK:
            _CURRENT = prev
