"""gelly_torch's obs core (event bus, span tracer, Chrome export,
histograms, watermarks, heartbeat, flight recorder) on the CPU.

Mirrors ``tests/test_obs.py`` case for case against the port: an
exported trace of a small run is valid Chrome-trace JSON with a span per
pipeline stage per unit and worker/slot attribution, every injected
fault of a seeded FaultPlan is an instant event, and runtime behaviour
(retries, faults, windows) is read off the event bus. Then holds the
port to ``gelly_tpu`` across the two packages: the same seeded stream
through raw, compact, sparse and windowed CC, the fused pair, the
resilient runner and ``ShardedCC`` gives equal span counts per (stage,
track), equal non-timing span arguments, equal instants, bus counters,
histogram sample counts and watermark positions (exact; timing values
are not compared), and each package's validator accepts the other's
exported trace.
"""

import collections
import importlib
import json

import numpy as np
import pytest

from gelly_torch import edge_stream_from_edges, obs
from gelly_torch.engine import faults
from gelly_torch.library.connected_components import (
    connected_components,
    labels_to_components,
)

EDGES = [(1, 2), (2, 3), (4, 5), (1, 3), (5, 6), (7, 8), (2, 4), (6, 9)]
EXPECTED = [[1, 2, 3, 4, 5, 6, 9], [7, 8]]


def _stream(chunk_size=2, edges=EDGES, n=32):
    return edge_stream_from_edges(edges, vertex_capacity=n,
                                  chunk_size=chunk_size, device="cpu")


def _run_cc(tracer=None, chunk_size=2, merge_every=2, **agg_kw):
    s = _stream(chunk_size)
    agg = connected_components(32)
    if tracer is None:
        labels = s.aggregate(agg, merge_every=merge_every, **agg_kw).result()
    else:
        with obs.install(tracer):
            labels = s.aggregate(agg, merge_every=merge_every,
                                 **agg_kw).result()
    assert labels_to_components(labels, s.ctx) == EXPECTED
    return labels


# --------------------------------------------------------------------- #
# event bus


def test_bus_counters_gauges_and_snapshot():
    bus = obs.EventBus()
    bus.inc("a.count")
    bus.inc("a.count", 2.5)
    bus.gauge("a.depth", 7)
    snap = bus.snapshot()
    assert snap["counters"]["a.count"] == 3.5
    assert snap["gauges"]["a.depth"] == 7
    # snapshot is a copy, not a view
    bus.inc("a.count")
    assert snap["counters"]["a.count"] == 3.5


def test_bus_emit_counts_notifies_and_traces():
    bus = obs.EventBus()
    seen = []
    unsub = bus.subscribe(lambda name, fields: seen.append((name, fields)))
    tr = obs.SpanTracer()
    with obs.install(tr):
        bus.emit("x.fired", boundary="h2d", index=3)
    unsub()
    bus.emit("x.fired", boundary="h2d", index=4)  # after unsubscribe
    assert bus.snapshot()["counters"]["x.fired"] == 2
    assert seen == [("x.fired", {"boundary": "h2d", "index": 3})]
    inst = tr.instants("x.fired")
    assert len(inst) == 1 and inst[0]["args"]["index"] == 3


def test_bus_scope_isolates_and_restores():
    outer = obs.get_bus()
    outer_count = outer.snapshot()["counters"].get("scoped.c", 0)
    with obs.scope() as inner:
        assert obs.get_bus() is inner
        obs.get_bus().inc("scoped.c")
        assert inner.snapshot()["counters"]["scoped.c"] == 1
    assert obs.get_bus() is outer
    assert outer.snapshot()["counters"].get("scoped.c", 0) == outer_count


# --------------------------------------------------------------------- #
# span tracer


def test_tracer_ring_is_bounded_and_counts_drops():
    tr = obs.SpanTracer(capacity=4)
    for i in range(10):
        tr.instant("e", i=i)
    recs = tr.records()
    assert len(recs) == 4
    assert [r["args"]["i"] for r in recs] == [6, 7, 8, 9]  # newest kept
    assert tr.dropped == 6


def test_tracer_span_interval_and_attribution():
    tr = obs.SpanTracer()
    t0 = tr.now()
    tr.span("compress", "compress/w1", t0, unit=5, edges=100)
    (sp,) = tr.spans("compress")
    assert sp["dur"] >= 0 and sp["ts"] == t0
    assert sp["args"] == {"unit": 5, "edges": 100}
    assert sp["track"] == "compress/w1"
    assert isinstance(sp["tid"], int) and sp["thread"]


def test_tracer_install_does_not_nest():
    t1, t2 = obs.SpanTracer(), obs.SpanTracer()
    assert obs.active_tracer() is None  # disabled is the default state
    with obs.install(t1):
        assert obs.active_tracer() is t1
        with pytest.raises(RuntimeError, match="already installed"):
            with obs.install(t2):
                pass
    assert obs.active_tracer() is None


# --------------------------------------------------------------------- #
# chrome trace export


def test_chrome_export_golden_shape(tmp_path):
    tr = obs.SpanTracer()
    bus = obs.EventBus()
    bus.inc("engine.units_folded", 3)
    t0 = tr.now()
    tr.span("fold", "fold", t0, unit=0)
    tr.instant("window_close", window=1)
    trace = obs.write_chrome_trace(str(tmp_path / "t.json"), tr, bus=bus,
                                   extra={"capture": "test"})
    on_disk = json.loads((tmp_path / "t.json").read_text())
    assert on_disk == trace
    assert on_disk["displayTimeUnit"] == "ms"
    assert on_disk["otherData"]["trace_id"] == tr.trace_id
    assert on_disk["otherData"]["capture"] == "test"
    assert on_disk["otherData"]["counters"]["engine.units_folded"] == 3
    phases = {e["ph"] for e in on_disk["traceEvents"]}
    assert phases == {"M", "X", "i"}
    # one named track per distinct track string + process_name
    names = [e for e in on_disk["traceEvents"] if e["ph"] == "M"]
    assert {e["args"]["name"] for e in names} >= {"fold", "events"}


def test_chrome_validate_rejects_malformed():
    ok = {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}
    obs.validate_chrome_trace(ok)
    with pytest.raises(ValueError, match="traceEvents"):
        obs.validate_chrome_trace({"otherData": {}})
    with pytest.raises(ValueError, match="lacks required key"):
        obs.validate_chrome_trace({"traceEvents": [{"ph": "X"}]})
    with pytest.raises(ValueError, match="dur"):
        obs.validate_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0},
        ]})
    with pytest.raises(ValueError, match="thread_name"):
        obs.validate_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "X", "pid": 1, "tid": 9, "ts": 0.0,
             "dur": 1.0},
        ]})
    with pytest.raises(ValueError, match="serializable"):
        obs.validate_chrome_trace({"traceEvents": [], "otherData": {
            "bad": object()}})


# --------------------------------------------------------------------- #
# pipelined-executor integration (the tentpole acceptance)


def test_pipeline_spans_per_unit_with_attribution(tmp_path):
    tr = obs.SpanTracer(heartbeat_every_s=None)
    with obs.scope() as bus:
        _run_cc(tracer=tr, chunk_size=2, merge_every=2)
        trace = obs.write_chrome_trace(str(tmp_path / "cc.json"), tr,
                                       bus=bus)
    # 8 edges / chunk_size 2 -> 4 units (fold_batch=1). EVERY pipeline
    # stage recorded >= 1 span PER UNIT, each carrying the unit id.
    n_units = 4
    for stage in ("produce", "compress", "h2d", "fold"):
        spans = tr.spans(stage)
        units = {sp["args"]["unit"] for sp in spans}
        assert units == set(range(n_units)), (stage, units)
    # worker/slot attribution: compress tracks name their pool worker,
    # h2d tracks their double-buffer slot.
    assert all(sp["track"].startswith("compress/")
               for sp in tr.spans("compress"))
    assert all(sp["track"].startswith("h2d/slot")
               for sp in tr.spans("h2d"))
    slots = {sp["args"]["slot"] for sp in tr.spans("h2d")}
    assert slots <= {0, 1}  # default h2d_depth=2 rotation
    # compress spans carry payload/edge sizes and queue depth
    for sp in tr.spans("compress"):
        assert sp["args"]["payload_bytes"] > 0
        assert sp["args"]["edges"] >= 0
        assert "queue_depth" in sp["args"]
    # window closes: 4 units / merge_every=2 -> 2 closes, as instants
    # AND merge_emit spans.
    assert len(tr.instants("window_close")) == 2
    assert len(tr.spans("merge_emit")) == 2
    # the export validated (write_chrome_trace validates) and carries
    # the shared trace id
    assert trace["otherData"]["trace_id"] == tr.trace_id
    # bus counters observed the run
    counters = bus.snapshot()["counters"]
    assert counters["engine.units_folded"] == n_units
    assert counters["engine.chunks_folded"] == 8 / 2
    assert counters["engine.edges_folded"] == len(EDGES)
    assert counters["engine.windows_closed"] == 2


def test_disabled_tracer_default_and_counters_still_flow():
    # No tracer installed: active_tracer() is None (the zero-allocation
    # guard every engine site checks) — and the always-on counters still
    # land on the bus.
    assert obs.active_tracer() is None
    with obs.scope() as bus:
        _run_cc(tracer=None)
        counters = bus.snapshot()["counters"]
        assert counters["engine.units_folded"] == 4
        assert "engine.edges_folded" not in counters  # tracer-only currency
        gauges = bus.snapshot()["gauges"]
        assert "stage.fold_dispatch.busy_s" in gauges  # timer published


def test_checkpoint_spans_and_bytes(tmp_path):
    tr = obs.SpanTracer(heartbeat_every_s=None)
    s = _stream()
    agg = connected_components(32)
    ck = str(tmp_path / "ck.npz")
    with obs.scope() as bus:
        with obs.install(tr):
            s.aggregate(agg, merge_every=2, checkpoint_path=ck).result()
        counters = bus.snapshot()["counters"]
    spans = tr.spans("checkpoint")
    assert spans, "checkpoint stage recorded no spans"
    assert all(sp["args"]["bytes"] > 0 for sp in spans)
    assert counters["engine.checkpoints"] == len(spans)
    assert counters["engine.checkpoint_bytes"] >= sum(
        sp["args"]["bytes"] for sp in spans) > 0


def test_heartbeat_rate_limits_and_records():
    clock = [0.0]
    hb = obs.Heartbeat(every_s=10.0, clock=lambda: clock[0])
    assert not hb.tick(position=1)  # within the interval
    clock[0] = 10.5
    tr = obs.SpanTracer()
    with obs.install(tr):
        assert hb.tick(position=2, eps=123.0)
    clock[0] = 11.0
    assert not hb.tick(position=3)
    assert hb.beats == 1
    (line,) = list(hb.lines)
    assert line["position"] == 2 and line["eps"] == 123.0
    (inst,) = tr.instants("heartbeat")
    assert inst["args"]["position"] == 2


def test_heartbeat_emitted_from_pipeline():
    tr = obs.SpanTracer(heartbeat_every_s=0.0)  # beat on every retired unit
    with obs.scope():
        _run_cc(tracer=tr)
    beats = tr.instants("heartbeat")
    assert beats, "no heartbeat instants on an every-unit cadence"
    last = beats[-1]["args"]
    assert last["position"] == 4          # last-retired CHUNK position
    assert "eps" in last and "staged_depth" in last and "h2d_depth" in last


# --------------------------------------------------------------------- #
# fault-injection visibility


@pytest.mark.faults
def test_every_injected_fault_is_an_instant_event():
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
        RetryPolicy,
    )

    def step(s, c):
        return s + np.int64(c), None

    plan = faults.FaultPlan([
        faults.Fault("step", at=1, count=2),
        faults.Fault("h2d", at=3, count=1),
    ])
    tr = obs.SpanTracer()
    with obs.scope() as bus:
        with obs.install(tr), faults.install(plan):
            runner = ResilientRunner(
                step, list(range(10)), np.int64(0),
                stage=lambda c: c,
                config=ResilienceConfig(
                    retry=RetryPolicy(max_attempts=4, base_delay=0.001,
                                      max_delay=0.01),
                    watchdog_timeout=None,
                ),
            )
            assert int(runner.run()) == sum(range(10))
        counters = bus.snapshot()["counters"]
    assert len(plan.fired) == 3
    instants = tr.instants("faults.injected")
    assert len(instants) == len(plan.fired)
    assert ([(i["args"]["boundary"], i["args"]["index"]) for i in instants]
            == [(b, idx) for b, idx, _k in plan.fired])
    assert counters["faults.injected"] == 3
    # the retries that recovered from them are counters too, not log text
    assert counters["resilience.retries"] == 3
    retry_instants = tr.instants("resilience.retries")
    assert {i["args"]["boundary"] for i in retry_instants} == {"step", "h2d"}


@pytest.mark.faults
def test_pipeline_codec_fault_instant_in_trace():
    # A seeded fault at the engine's codec boundary: the injection is
    # visible on the trace/bus even though the pipelined executor
    # propagates it (no retry inside the pipeline).
    plan = faults.FaultPlan([faults.Fault("codec", at=1, count=1)])
    tr = obs.SpanTracer(heartbeat_every_s=None)
    with obs.scope() as bus:
        with obs.install(tr), faults.install(plan):
            s = _stream()
            agg = connected_components(32)
            with pytest.raises(faults.FaultInjected):
                s.aggregate(agg, merge_every=2).result()
        assert bus.snapshot()["counters"]["faults.injected"] == 1
    (inst,) = tr.instants("faults.injected")
    assert inst["args"]["boundary"] == "codec"


# --------------------------------------------------------------------- #
# sharded-state gauges


def test_sharded_cc_dirty_row_gauges():
    from gelly_torch.parallel.mesh import make_mesh
    from gelly_torch.parallel.sharded_cc import ShardedCC

    with obs.scope() as bus:
        # The reference's default mesh on the test host: 8 CPU devices.
        cc = ShardedCC(64, mesh=make_mesh(8, devices=["cpu"] * 8))
        cc.fold(np.array([1, 2, 3]), np.array([2, 3, 4]))
        labels = cc.labels()
        snap = bus.snapshot()
    assert labels[1] == labels[4] == 1
    assert snap["gauges"]["sharded_cc.window_dirty_rows"] >= 4
    assert snap["gauges"]["sharded_cc.window_dirty_max_shard"] >= 1
    assert snap["counters"]["sharded_cc.dirty_rows_gathered"] >= 4
    assert (snap["counters"].get("sharded_cc.emissions_dense", 0)
            + snap["counters"].get("sharded_cc.emissions_sparse", 0)) == 1


# --------------------------------------------------------------------- #
# overhead smoke (the card's traced and untraced walls are chip_smoke.py
# phase M1's; a CPU host is too noisy for a tight bound — this smoke
# asserts the plumbing costs little and the results stay bit-identical)


def test_tracer_overhead_smoke():
    import time

    rng = np.random.default_rng(3)
    n_e, n_v = 60_000, 1 << 12
    edges = list(zip(rng.integers(0, n_v, n_e).tolist(),
                     rng.integers(0, n_v, n_e).tolist()))

    def run(tracer):
        s = _stream(8192, edges, n_v)
        agg = connected_components(n_v)
        t0 = time.perf_counter()
        if tracer is None:
            labels = s.aggregate(agg, merge_every=4).result()
        else:
            with obs.install(tracer):
                labels = s.aggregate(agg, merge_every=4).result()
        return np.asarray(labels), time.perf_counter() - t0

    # Warm compile, then best-of-3 each way.
    run(None)
    off = min(run(None)[1] for _ in range(3))
    with obs.scope():
        l_off = run(None)[0]
        best_on, l_on = float("inf"), None
        for _ in range(3):
            tr = obs.SpanTracer(heartbeat_every_s=None)
            l_on, dt = run(tr)
            best_on = min(best_on, dt)
    assert np.array_equal(l_off, l_on)  # tracing never changes results
    overhead = best_on / off - 1.0
    assert overhead < 0.5, f"tracer overhead {overhead:.1%} on smoke run"


@pytest.mark.racecheck
def test_heartbeat_concurrent_ticks_stamp_unique_beat_numbers():
    """Regression (racecheck RC001 class): the beat line used to read
    self.beats AFTER releasing the lock, so two threads that both won a
    beat could stamp the same number. Beats must be attributable 1:1."""
    import threading

    from gelly_torch.obs.heartbeat import Heartbeat

    hb = Heartbeat(every_s=0, max_lines=4096)
    n_threads, per_thread = 8, 50

    def hammer():
        for _ in range(per_thread):
            assert hb.tick(src=threading.get_ident())

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = n_threads * per_thread
    assert hb.beats == total
    beat_nos = [line["beat"] for line in hb.lines]
    assert len(beat_nos) == total
    assert sorted(beat_nos) == list(range(1, total + 1))


# --------------------------------------------------------------------- #
# streaming histograms (fixed-memory log-bucketed latency distributions
# on the bus, zero-cost when disabled)


def test_histogram_quantiles_and_extrema():
    h = obs.StreamingHistogram()
    for v in range(1, 101):  # 1..100 ms
        h.record(float(v))
    s = h.snapshot()
    assert s["count"] == 100
    assert s["min"] == 1.0 and s["max"] == 100.0
    # Log-bucket estimate: within one bucket (<= ~9% relative error).
    assert 45.0 <= s["p50"] <= 60.0
    assert 85.0 <= s["p90"] <= 100.0
    assert s["p99"] <= 100.0  # clamped at the exact max
    assert s["p50"] <= s["p90"] <= s["p99"]


def test_histogram_merge_and_edge_values():
    a, b = obs.StreamingHistogram(), obs.StreamingHistogram()
    a.record(1.0)
    a.record(2.0)
    b.record(1000.0)
    b.record(-5.0)   # clamps into the lowest bucket, never raises
    b.record(float("nan"))
    a.merge(b)
    s = a.snapshot()
    assert s["count"] == 5
    assert s["max"] == 1000.0
    assert a.quantile(1.0) == 1000.0
    e = obs.StreamingHistogram()
    assert e.quantile(0.5) == 0.0 and e.snapshot()["count"] == 0
    with pytest.raises(ValueError, match="q must be"):
        e.quantile(1.5)


def test_histogram_single_sample_reports_its_value():
    h = obs.StreamingHistogram()
    h.record(3.7)
    s = h.snapshot()
    assert s["p50"] == s["p99"] == 3.7  # clamped to exact extrema


@pytest.mark.racecheck
def test_histogram_concurrent_records_lose_nothing():
    import threading

    h = obs.StreamingHistogram()
    n_threads, per_thread = 8, 500

    def hammer(i):
        for j in range(per_thread):
            h.record(float(i * per_thread + j + 1))

    ts = [threading.Thread(target=hammer, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert h.snapshot()["count"] == n_threads * per_thread


def test_bus_observe_snapshot_and_scope_isolation():
    with obs.scope() as bus:
        bus.observe("engine.fold_dispatch_ms", 2.0)
        bus.observe("engine.fold_dispatch_ms", 4.0)
        snap = bus.snapshot()
        assert snap["histograms"]["engine.fold_dispatch_ms"]["count"] == 2
        assert bus.quantile("engine.fold_dispatch_ms", 1.0) == 4.0
        assert bus.quantile("missing", 0.5, default=-1.0) == -1.0
    # scope isolation: the outer bus never saw the histogram
    assert "engine.fold_dispatch_ms" not in obs.get_bus().snapshot()[
        "histograms"]


def test_recording_flag_scoped_and_forced():
    assert not obs.recording()
    with obs.record_metrics():
        assert obs.recording()
        with obs.record_metrics():
            assert obs.recording()
        assert obs.recording()
    assert not obs.recording()
    obs.set_recording(True)
    try:
        assert obs.recording()
    finally:
        obs.set_recording(False)
    assert not obs.recording()


def test_histograms_and_watermarks_zero_work_when_disabled():
    # Neither a tracer nor recording: the run must not create a single
    # histogram or watermark entry (the zero-cost contract's observable
    # half; the guard itself is `telemetry`-bound once per run).
    assert obs.active_tracer() is None and not obs.recording()
    with obs.scope() as bus:
        _run_cc(tracer=None)
        snap = bus.snapshot()
    assert snap["histograms"] == {}
    assert snap["watermarks"] == {}


def test_recording_without_tracer_populates_histograms_and_watermarks(
        tmp_path):
    ck = str(tmp_path / "ck.npz")
    with obs.scope() as bus, obs.record_metrics():
        s = _stream()
        agg = connected_components(32)
        s.aggregate(agg, merge_every=2, checkpoint_path=ck).result()
        snap = bus.snapshot()
    hists = snap["histograms"]
    # The hot boundaries: fold dispatch, merge close, checkpoint write,
    # plus the e2e ingress→fold/durable pair.
    for name in ("engine.fold_dispatch_ms", "engine.merge_emit_ms",
                 "engine.checkpoint_write_ms",
                 "engine.e2e_ingress_to_fold_ms",
                 "engine.e2e_ingress_to_durable_ms"):
        assert hists[name]["count"] >= 1, name
        assert hists[name]["p99"] >= hists[name]["p50"] >= 0.0
    # 4 units folded -> 4 fold-dispatch samples
    assert hists["engine.fold_dispatch_ms"]["count"] == 4
    # End of stream: every stamp retired durable, backlog age is zero.
    assert snap["watermarks"]["stream"]["pending"] == 0
    assert snap["gauges"]["engine.backlog_age_s"] == 0.0


def test_watermarks_ledger_semantics():
    clock = [100.0]
    wm = obs.Watermarks(clock=lambda: clock[0])
    wm.seed("s", 2)
    wm.stamp("s", 1)           # below the seed base: dropped
    wm.stamp("s", 2)
    clock[0] = 101.0
    wm.stamp("s", 3)
    wm.stamp("s", 2, t=999.0)  # first stamp wins
    assert wm.oldest_position("s") == 2
    clock[0] = 104.0
    assert wm.backlog_age("s") == pytest.approx(4.0)
    assert wm.max_backlog_age() == pytest.approx(4.0)
    bus = obs.EventBus()
    wm.retire_fold("s", 3, bus=bus, prefix="engine")
    wm.retire_fold("s", 3, bus=bus, prefix="engine")  # once per position
    assert bus.snapshot()["histograms"][
        "engine.e2e_ingress_to_fold_ms"]["count"] == 1
    wm.retire_durable("s", 3, bus=bus, prefix="engine")
    assert wm.oldest_position("s") == 3
    assert bus.snapshot()["histograms"][
        "engine.e2e_ingress_to_durable_ms"]["count"] == 1
    wm.retire_durable("s", 4, bus=bus, prefix="engine")
    assert wm.backlog_age("s") == 0.0
    assert wm.snapshot()["s"]["pending"] == 0
    # unknown streams read as empty, never raise
    assert wm.backlog_age("nope") == 0.0
    assert wm.oldest_position("nope") is None
    wm.drop("s")
    assert wm.snapshot() == {}


def test_watermarks_rekey_moves_and_merges_ledgers():
    """Regression: TenantRouter.attach re-keys a started server's
    watermark stream — stamps recorded under the old key must follow
    (left behind they read as permanently growing backlog nobody
    retires)."""
    clock = [10.0]
    wm = obs.Watermarks(clock=lambda: clock[0])
    wm.stamp("stream", 0)
    wm.stamp("stream", 1)
    wm.rekey("stream", "wire:1234")
    assert wm.snapshot() == {
        "wire:1234": {"backlog_age_s": 0.0, "oldest_position": 0,
                      "pending": 2, "base": 0},
    }
    # Retirement under the NEW key reaches the moved stamps.
    wm.retire_durable("wire:1234", 2)
    assert wm.backlog_age("wire:1234") == 0.0
    assert wm.max_backlog_age() == 0.0
    # Merge semantics: first-stamp-wins into an existing ledger,
    # bases maxed, sub-base stragglers dropped.
    wm.seed("a", 2)
    wm.stamp("a", 3, t=1.0)
    wm.stamp("b", 1, t=5.0)  # below a's base: dropped by the merge
    wm.stamp("b", 3, t=9.0)  # position collision: a's stamp wins
    wm.stamp("b", 4, t=2.0)
    wm.rekey("b", "a")
    snap = wm.snapshot()["a"]
    assert snap["pending"] == 2 and snap["base"] == 2
    clock[0] = 11.0
    assert wm.backlog_age("a") == pytest.approx(10.0)  # t=1.0 survived
    # rekey of an absent stream is a no-op, never raises
    wm.rekey("ghost", "a")
    assert wm.snapshot()["a"]["pending"] == 2


def test_heartbeat_carries_serving_plane_fields():
    tr = obs.SpanTracer(heartbeat_every_s=0.0)  # beat on every unit
    with obs.scope():
        _run_cc(tracer=tr)
    beats = tr.instants("heartbeat")
    assert beats
    last = beats[-1]["args"]
    # The serving-plane fields: backlog-age watermark, p99 fold
    # dispatch, staged-depth high-water since the last beat.
    assert last["backlog_age_max_s"] >= 0.0
    assert last["fold_p99_ms"] >= 0.0
    assert last["staged_hw"] >= 0


# --------------------------------------------------------------------- #
# flight recorder (rotating segments + incident-triggered dumps)


def test_tracer_segment_rotation_retains_newest_window():
    clock = [0.0]
    tr = obs.SpanTracer(segment_s=1.0, segments=3,
                        clock=lambda: clock[0])
    for i in range(10):
        clock[0] = float(i)
        tr.instant("e", i=i)
    kept = [r["args"]["i"] for r in tr.records()]
    # 3 segments x 1s: the newest 3 seconds survive; evictions counted.
    assert kept == [7, 8, 9]
    assert tr.dropped == 7
    with pytest.raises(ValueError, match="segment_s"):
        obs.SpanTracer(segment_s=0.0)
    with pytest.raises(ValueError, match="segments"):
        obs.SpanTracer(segment_s=1.0, segments=1)


def test_tracer_segment_capacity_backstop():
    clock = [0.0]
    tr = obs.SpanTracer(capacity=4, segment_s=100.0, segments=2,
                        clock=lambda: clock[0])
    for i in range(10):
        tr.instant("e", i=i)
    assert len(tr.records()) == 4  # per-segment record bound
    assert tr.dropped == 6


@pytest.mark.faults
def test_flight_recorder_dumps_on_injected_fault(tmp_path):
    plan = faults.FaultPlan([faults.Fault("codec", at=1, count=1)])
    tr = obs.SpanTracer(heartbeat_every_s=None, segment_s=10.0,
                        segments=4)
    with obs.scope() as bus:
        unsub = tr.dump_on(out_dir=str(tmp_path), bus=bus)
        with obs.install(tr), faults.install(plan):
            s = _stream()
            agg = connected_components(32)
            with pytest.raises(faults.FaultInjected):
                s.aggregate(agg, merge_every=2).result()
        unsub()
        counters = bus.snapshot()["counters"]
    assert len(tr.dumps) == 1
    trace = json.loads(open(tr.dumps[0]).read())
    obs.validate_chrome_trace(trace)  # the acceptance bar: valid trace
    names = {e["name"] for e in trace["traceEvents"]}
    # The spans surrounding the incident AND the incident marker itself
    # (emit() records the instant BEFORE the subscriber fan-out).
    assert "faults.injected" in names
    assert names & {"produce", "compress", "fold"}
    assert trace["otherData"]["incident"] == "faults.injected"
    assert counters["obs.flight_dumps"] == 1


def test_flight_recorder_dump_limit_and_default_events(tmp_path):
    tr = obs.SpanTracer(segment_s=10.0, segments=2)
    with obs.scope() as bus:
        unsub = tr.dump_on(out_dir=str(tmp_path), bus=bus, limit=2)
        # Default incident set: faults, watchdog timeouts, degradations.
        bus.emit("resilience.watchdog_timeouts", boundary="step")
        bus.emit("resilience.degradations", stem="x")
        bus.emit("faults.injected", boundary="h2d")  # over the limit
        bus.emit("unrelated.event")
        unsub()
        bus.emit("faults.injected", boundary="h2d")  # after unsubscribe
    assert len(tr.dumps) == 2  # limit honored; storms never fill disk
    for p in tr.dumps:
        obs.validate_chrome_trace(json.loads(open(p).read()))
    assert "watchdog" in tr.dumps[0]


def test_emit_records_instant_before_subscriber_fanout():
    tr = obs.SpanTracer()
    seen = []
    bus = obs.EventBus()
    bus.subscribe(
        lambda name, fields: seen.append(len(tr.instants(name))))
    with obs.install(tr):
        bus.emit("x.incident", k=1)
    # By the time the subscriber (a flight-recorder dump) runs, the
    # incident's own instant is already in the ring it would export.
    assert seen == [1]


def test_publish_checkpoint_histogram_gated_on_recording(tmp_path):
    import time as _t

    from gelly_torch.obs import bus as bus_mod

    p = tmp_path / "f.bin"
    p.write_bytes(b"x" * 64)
    with obs.scope() as bus:
        bus_mod.publish_checkpoint(bus, "engine", str(p),
                                   t0=_t.perf_counter())
        assert bus.snapshot()["histograms"] == {}  # recording off
        with obs.record_metrics():
            bus_mod.publish_checkpoint(bus, "engine", str(p),
                                       t0=_t.perf_counter())
        snap = bus.snapshot()
    assert snap["histograms"]["engine.checkpoint_write_ms"]["count"] == 1
    assert snap["counters"]["engine.checkpoints"] == 2


# --------------------------------------------------------------------- #
# across the packages: the same runs traced in gelly_tpu and gelly_torch

from gelly_torch.core.io import EdgeChunkSource as TSource  # noqa: E402
from gelly_torch.core.stream import (  # noqa: E402
    edge_stream_from_source as t_stream,
)
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity  # noqa
from gelly_torch.engine import aggregation as tagg  # noqa: E402
from gelly_tpu import obs as jobs  # noqa: E402
from gelly_tpu.core.io import EdgeChunkSource as JSource  # noqa: E402
from gelly_tpu.core.stream import (  # noqa: E402
    edge_stream_from_source as j_stream,
)
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity  # noqa
from gelly_tpu.engine import aggregation as jagg  # noqa: E402
from gelly_tpu.parallel import mesh as jmesh  # noqa: E402

from _torch_native import load_jax_native  # noqa: E402

OBS = {"t": obs, "j": jobs}
CC = {"t": importlib.import_module("gelly_torch.library.connected_components"),
      "j": importlib.import_module("gelly_tpu.library.connected_components")}
LIB = {"t": importlib.import_module("gelly_torch.library"),
       "j": importlib.import_module("gelly_tpu.library")}
N_V, N_E, CHUNK = 256, 4096, 256
# The span/instant arguments compared across packages: every one that
# carries no time, size of a host buffer or queue depth.
ARG_KEYS = ("unit", "chunks", "edges", "queries", "query", "window",
            "final", "slot", "position", "windows", "mode", "ring_live",
            "combines", "boundary", "index", "kind", "attempt")
# Checkpoint files differ in their header's treedef string (ROADMAP.md,
# "Divergences kept by design"), so their byte counters do.
BYTE_COUNTERS = ("engine.checkpoint_bytes", "resilience.checkpoint_bytes")


@pytest.fixture(scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _zipf(seed=3):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.3, N_E) % N_V).astype(np.int32)
    dst = (rng.zipf(1.3, N_E) % N_V).astype(np.int32)
    return src, dst, np.arange(N_E, dtype=np.int64)


def _source(pkg):
    src, dst, ts = _zipf()
    if pkg == "t":
        return t_stream(TSource(src, dst, timestamps=ts, chunk_size=CHUNK,
                                table=TIdentity(N_V)), N_V, device="cpu")
    return j_stream(JSource(src, dst, timestamps=ts, chunk_size=CHUNK,
                            table=JIdentity(N_V)), N_V)


def _args(rec):
    return tuple(sorted((k, v) for k, v in rec["args"].items()
                        if k in ARG_KEYS))


def _summary(tr, bus):
    """Everything a traced run shows that carries no time."""
    recs = tr.records()
    snap = bus.snapshot()
    return {
        "span_counts": collections.Counter(
            (r["name"], r["track"]) for r in recs if r["ph"] == "X"),
        "span_args": sorted((r["name"], r["track"], _args(r))
                            for r in recs if r["ph"] == "X"),
        "instants": sorted((r["name"], _args(r))
                           for r in recs if r["ph"] == "i"),
        "counters": {k: v for k, v in snap["counters"].items()
                     if k not in BYTE_COUNTERS},
        "histogram_counts": {k: h["count"]
                             for k, h in snap["histograms"].items()},
        "watermarks": {k: {f: w[f] for f in ("oldest_position", "pending",
                                             "base")}
                       for k, w in snap["watermarks"].items()},
    }


def _traced(pkg, fn):
    """``fn()`` under a fresh bus and an installed tracer (no heartbeat:
    its cadence is the clock's); returns (result, summary, tracer, bus)."""
    o = OBS[pkg]
    with o.scope() as bus:
        tr = o.SpanTracer(heartbeat_every_s=None)
        with o.install(tr):
            out = fn()
        return out, _summary(tr, bus), tr, bus


def _emissions(res):
    out = []
    for x in res:
        if isinstance(x, dict):
            out.append({k: np.asarray(v if not hasattr(v, "numpy")
                                      else v.numpy())
                        for k, v in x.items()
                        if not isinstance(v, (tuple, dict))})
        else:
            out.append(np.asarray(x))
    return out


_PIPE = dict(ingest_workers=1, h2d_depth=1, fold_batch=2, merge_every=4)
_QUIET = dict(ingest_workers=0, prefetch_depth=0, h2d_depth=0)


def _cc(**kw):
    return lambda pkg: CC[pkg].connected_components(N_V, **kw)


def _fused(codec):
    def queries(pkg):
        lib = LIB[pkg]
        if codec:
            return [lib.cc_query(N_V, compressed=True, codec="sparse"),
                    lib.degrees_query(N_V, compressed=True, codec="sparse"),
                    lib.bipartiteness_query(N_V, compressed=True,
                                            codec="sparse")]
        return [lib.cc_query(N_V), lib.degrees_query(N_V)]
    return queries


# name -> (plan builder, queries builder, run knobs)
CASES = {
    "raw": (_cc(), None, _PIPE),
    "sparse": (_cc(codec="sparse"), None, _PIPE),
    "compact": (_cc(codec="compact", compact_capacity=N_V), None, _PIPE),
    "windowed": (_cc(windowed=3), None, dict(_QUIET, merge_every=2)),
    "windowed_compact_ttl": (
        _cc(codec="compact", compact_capacity=N_V, windowed=3, ttl_panes=4),
        None, dict(_QUIET, merge_every=2)),
    "event_time": (_cc(), None, dict(_QUIET, window_ms=700)),
    "event_time_sparse": (_cc(codec="sparse"), None,
                          dict(_QUIET, window_ms=700)),
    "fused_pair": (None, _fused(False), dict(_QUIET, merge_every=4)),
    "fused_codec_trio": (None, _fused(True), _PIPE),
}


def _run_case(pkg, case, **over):
    plan, queries, kw = CASES[case]
    kw = dict(kw, **over)
    if pkg == "j":
        kw["mesh"] = jmesh.make_mesh(1)
    run = tagg.run_aggregation if pkg == "t" else jagg.run_aggregation
    return _traced(pkg, lambda: _emissions(run(
        plan(pkg) if plan else None, _source(pkg),
        queries=queries(pkg) if queries else None, **kw)))


def _same_emissions(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                assert np.array_equal(g[k], w[k]), k
        else:
            assert np.array_equal(g, w)


def _same_summary(t, j):
    for key in t:
        assert t[key] == j[key], key


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_run_equals_jax(case, _jax_native_loaded):
    t_out, t_sum, _, _ = _run_case("t", case)
    j_out, j_sum, _, _ = _run_case("j", case)
    _same_emissions(t_out, j_out)
    assert t_sum["span_counts"]  # the run was traced at all
    _same_summary(t_sum, j_sum)


def test_traced_checkpointed_and_resumed_runs_equal_jax(tmp_path):
    # A run checkpointed at every window, stopped after its second
    # emission, then resumed traced: the spans, the checkpoint spans,
    # the counters and the watermarks re-seeded at the resume position
    # (never a stamp below it) are equal.
    got = {}
    for pkg in ("t", "j"):
        path = str(tmp_path / f"{pkg}.npz")
        kw = dict(_QUIET, merge_every=4, checkpoint_path=path)
        if pkg == "j":
            kw["mesh"] = jmesh.make_mesh(1)
        run = tagg.run_aggregation if pkg == "t" else jagg.run_aggregation
        plan = _cc()

        def first():
            it = iter(run(plan(pkg), _source(pkg), **kw))
            out = [np.asarray(next(it)) for _ in range(2)]
            next(it)  # the consumer asks on: window 2's checkpoint lands
            it.close()
            return out

        _, first_sum, _, _ = _traced(pkg, first)
        out, resumed_sum, _, _ = _traced(pkg, lambda: _emissions(
            run(plan(pkg), _source(pkg), resume=True, **kw)))
        got[pkg] = (first_sum, out, resumed_sum)
    _same_summary(got["t"][0], got["j"][0])
    _same_emissions(got["t"][1], got["j"][1])
    _same_summary(got["t"][2], got["j"][2])
    # Resumed at chunk 8: 8 chunks folded, every stamp retired.
    resumed = got["t"][2]
    assert resumed["counters"]["engine.chunks_folded"] == 8
    assert resumed["counters"]["engine.checkpoints"] == 2
    wm = resumed["watermarks"]["stream"]
    assert wm["base"] == N_E // CHUNK and wm["pending"] == 0


def _fold_step(s, c):
    return s + np.int64(c), None


@pytest.mark.faults
def test_resilient_runner_bus_equals_jax(tmp_path):
    # Step and h2d faults retried under a tracer, checkpoints every 3
    # chunks: the instants (faults, retries), the resilience.* counters
    # and the runner's watermarks are equal.
    from gelly_torch.engine import resilience as tres
    from gelly_tpu.engine import faults as jfaults
    from gelly_tpu.engine import resilience as jres

    got = {}
    for pkg, res, fl in (("t", tres, faults), ("j", jres, jfaults)):
        plan = fl.FaultPlan([fl.Fault("step", at=1, count=2),
                             fl.Fault("h2d", at=3, count=1)])

        def run():
            with fl.install(plan):
                r = res.ResilientRunner(
                    _fold_step, list(range(10)), np.int64(0),
                    stage=lambda c: c,
                    checkpoint_dir=str(tmp_path / pkg),
                    config=res.ResilienceConfig(
                        checkpoint_every_chunks=3,
                        retry=res.RetryPolicy(max_attempts=4,
                                              base_delay=0.001,
                                              max_delay=0.01),
                        watchdog_timeout=None),
                )
                return int(r.run()), dict(r.stats)

        (final, stats), summ, _, _ = _traced(pkg, run)
        got[pkg] = (final, stats, summ, plan.fired)
    assert got["t"][0] == got["j"][0] == sum(range(10))
    assert got["t"][3] == got["j"][3]
    _same_summary(got["t"][2], got["j"][2])
    counters = got["t"][2]["counters"]
    # JAX's currencies: the bus counts retries as the runner does, and
    # completed checkpoint writes.
    assert counters["resilience.retries"] == got["t"][1]["retries"] == 3
    assert counters["faults.injected"] == 3
    assert counters["resilience.checkpoints"] == got["t"][1][
        "checkpoint_writes"]


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_cc_bus_equals_jax(S):
    from gelly_torch.parallel.mesh import make_mesh
    from gelly_torch.parallel.sharded_cc import ShardedCC as TShardedCC
    from gelly_tpu.parallel.sharded_cc import ShardedCC as JShardedCC

    n = 1 << 12
    rng = np.random.default_rng(9)
    # A capacity-wide first window (a dense close), then small ones.
    folds = [(rng.integers(0, n, 3000).astype(np.int32),
              rng.integers(0, n, 3000).astype(np.int32))]
    folds += [((rng.zipf(1.4, 40) % n).astype(np.int32),
               (rng.zipf(1.4, 40) % n).astype(np.int32)) for _ in range(2)]
    got = {}
    for pkg, cls, mesh in (
            ("t", TShardedCC, make_mesh(S, devices=["cpu"] * S)),
            ("j", JShardedCC, jmesh.make_mesh(S))):
        snaps = []
        with OBS[pkg].scope() as bus:
            cc = cls(n, mesh=mesh)
            labels = []
            for a, b in folds:
                cc.fold(a, b)
                labels.append(np.asarray(cc.labels()))
                snaps.append(bus.snapshot())
        got[pkg] = (labels, snaps)
    for g, w in zip(got["t"][0], got["j"][0]):
        assert np.array_equal(g, w)
    for t_snap, j_snap in zip(got["t"][1], got["j"][1]):
        assert t_snap["counters"] == j_snap["counters"]
        assert t_snap["gauges"] == j_snap["gauges"]
    last = got["t"][1][-1]["counters"]
    assert last["sharded_cc.emissions_dense"] >= 1
    assert last["sharded_cc.emissions_sparse"] >= 1


def test_each_validator_accepts_the_others_trace(tmp_path,
                                                 _jax_native_loaded):
    from gelly_torch.obs import export as texport
    from gelly_tpu.obs import export as jexport

    traces = {}
    for pkg, exp in (("t", texport), ("j", jexport)):
        _, _, tr, bus = _run_case(pkg, "compact")
        traces[pkg] = exp.write_chrome_trace(
            str(tmp_path / f"{pkg}.json"), tr, bus=bus)
    for trace in traces.values():
        texport.validate_chrome_trace(trace)
        jexport.validate_chrome_trace(trace)
    names = {pkg: next(e["args"]["name"] for e in t["traceEvents"]
                       if e["name"] == "process_name")
             for pkg, t in traces.items()}
    assert names["t"].startswith("gelly_torch:")
    assert names["j"].startswith("gelly_tpu:")
    # The same tracks, named the same way in both exports.
    tracks = {pkg: sorted(e["args"]["name"] for e in t["traceEvents"]
                          if e["name"] == "thread_name")
              for pkg, t in traces.items()}
    assert tracks["t"] == tracks["j"]
    # Stitched together, the two are one valid multi-process timeline.
    stitched = texport.stitch_traces([traces["t"], traces["j"]])
    jexport.validate_chrome_trace(stitched)
