"""gelly_torch's SLO plane, Prometheus exposition, summary-delta alert
sources and multi-host trace stitcher on the CPU.

Mirrors ``tests/test_slo.py`` case for case against the port: a
deliberately blown ``backlog_age_max_s`` SLO raises its burn-rate gauge
and breach event, burn rates decay over the rolling window, per-tenant
instances evaluate independently, the Prometheus text covers every bus
counter/gauge/histogram, and ``stitch_traces`` merges per-host rings into
one validated timeline with flow arrows at barrier boundaries. Then holds
``prometheus_text`` of the same bus contents, an SLO plane's published
state, and the stitched timeline equal across the two packages (exact).
"""

import json
import time

import pytest

from gelly_torch.obs import bus as obs_bus
from gelly_torch.obs import export, slo

# --------------------------------------------------------------------- #
# specs


def test_spec_builders_and_validation():
    s = slo.fold_p99_ms(25.0)
    assert (s.metric, s.quantile) == ("engine.fold_dispatch_ms", 0.99)
    s = slo.e2e_durable_p90_ms(100.0)
    assert (s.metric, s.quantile) == ("engine.e2e_ingress_to_durable_ms",
                                      0.90)
    s = slo.backlog_age_max_s(5.0)
    assert s.metric == slo.WATERMARK_BACKLOG and s.quantile is None
    s = slo.tenant_backlog_age_s(2.0)
    assert s.per_tenant and "{tenant}" in s.metric
    with pytest.raises(ValueError, match="tenant"):
        slo.SloSpec("bad", "tenants.backlog_age_s", 1.0, per_tenant=True)


# --------------------------------------------------------------------- #
# evaluation: breach / recover / burn-rate window


def test_breach_and_recover_transitions():
    with obs_bus.scope() as bus:
        events = []
        bus.subscribe(lambda n, f: events.append((n, f)))
        clk = [0.0]
        spec = slo.SloSpec("fold_p99_ms", "engine.fold_dispatch_ms",
                           10.0, quantile=0.99, window_s=60.0)
        plane = slo.SloPlane([spec], bus=bus, clock=lambda: clk[0])
        # Unpopulated histogram: absence of data is not a breach.
        assert plane.tick() == 0
        assert bus.gauges["slo.fold_p99_ms.burn_rate"] == 0.0
        bus.observe("engine.fold_dispatch_ms", 50.0)
        clk[0] = 1.0
        assert plane.tick() == 1
        assert bus.gauges["slo.breaching"] == 1
        breaches = [f for n, f in events if n == "slo.breach"]
        assert len(breaches) == 1
        assert breaches[0]["slo"] == "fold_p99_ms"
        assert breaches[0]["value"] > 10.0
        assert breaches[0]["threshold"] == 10.0
        # Breach is edge-triggered: staying in breach emits no second
        # event, but the burn rate climbs.
        clk[0] = 2.0
        assert plane.tick() == 1
        assert len([1 for n, _ in events if n == "slo.breach"]) == 1
        # Recover: a healthy p99 (new bus scope resets the histogram is
        # overkill — swap the spec threshold via a fresh plane sharing
        # state is wrong too; recover by raising the threshold spec on
        # a gauge-backed spec instead).
    with obs_bus.scope() as bus:
        events = []
        bus.subscribe(lambda n, f: events.append((n, f)))
        clk = [0.0]
        spec = slo.SloSpec("depth", "pipeline.staged_depth", 4.0,
                           window_s=60.0)
        plane = slo.SloPlane([spec], bus=bus, clock=lambda: clk[0])
        bus.gauge("pipeline.staged_depth", 9)
        assert plane.tick() == 1
        bus.gauge("pipeline.staged_depth", 1)
        clk[0] = 1.0
        assert plane.tick() == 0
        names = [n for n, _ in events]
        assert names.count("slo.breach") == 1
        assert names.count("slo.recovered") == 1
        rec = [f for n, f in events if n == "slo.recovered"][0]
        assert rec["slo"] == "depth" and rec["value"] == 1.0
        assert bus.gauges["slo.breaching"] == 0
        assert bus.gauges["slo.depth.burn_rate"] == 0.5  # 1 of 2 samples


def test_burn_rate_rolls_off_the_window():
    with obs_bus.scope() as bus:
        clk = [0.0]
        spec = slo.SloSpec("depth", "pipeline.staged_depth", 4.0,
                           window_s=10.0)
        plane = slo.SloPlane([spec], bus=bus, clock=lambda: clk[0])
        bus.gauge("pipeline.staged_depth", 9)
        plane.tick()  # t=0: breach
        bus.gauge("pipeline.staged_depth", 1)
        for t in (4.0, 8.0):
            clk[0] = t
            plane.tick()
        assert bus.gauges["slo.depth.burn_rate"] == pytest.approx(
            1 / 3, abs=1e-3)  # gauge is published rounded to 4 places
        # t=12: the t=0 breach sample ages out of the 10s window.
        clk[0] = 12.0
        plane.tick()
        assert bus.gauges["slo.depth.burn_rate"] == 0.0


def test_blown_backlog_slo_raises_burn_gauge_and_breach_event():
    """The acceptance scenario: stamp ingress with no retire, so the
    watermark ledger's backlog age climbs past a deliberately tiny
    threshold — the burn gauge and the breach event must both fire."""
    with obs_bus.scope() as bus:
        events = []
        bus.subscribe(lambda n, f: events.append((n, f)))
        plane = slo.SloPlane([slo.backlog_age_max_s(0.005)], bus=bus)
        bus.watermarks.stamp("stream", 0)
        time.sleep(0.02)  # age the un-retired chunk past 5 ms
        assert plane.tick() == 1
        assert bus.gauges["slo.backlog_age_max_s.burn_rate"] == 1.0
        assert bus.gauges["slo.breaching"] == 1
        breach = [f for n, f in events if n == "slo.breach"]
        assert breach and breach[0]["slo"] == "backlog_age_max_s"
        assert breach[0]["value"] >= 0.005


def test_per_tenant_instances_evaluate_independently():
    with obs_bus.scope() as bus:
        events = []
        bus.subscribe(lambda n, f: events.append((n, f)))
        plane = slo.SloPlane([slo.tenant_backlog_age_s(1.0)], bus=bus,
                             tenants=[3, 7])
        bus.gauge("tenants.t3.backlog_age_s", 0.2)
        bus.gauge("tenants.t7.backlog_age_s", 4.5)
        assert plane.tick() == 1
        assert bus.gauges["slo.backlog_age_s.t3.burn_rate"] == 0.0
        assert bus.gauges["slo.backlog_age_s.t7.burn_rate"] == 1.0
        breach = [f for n, f in events if n == "slo.breach"]
        assert len(breach) == 1 and breach[0]["tenant"] == 7
        assert breach[0]["key"] == "backlog_age_s.t7"
        # set_tenants reshapes the evaluated set (the tenant scheduler
        # syncs this every gauge refresh).
        plane.set_tenants([3])
        assert plane.tick() == 0


def test_plane_thread_lifecycle():
    with obs_bus.scope() as bus:
        plane = slo.SloPlane(
            [slo.SloSpec("depth", "pipeline.staged_depth", 4.0)], bus=bus)
        bus.gauge("pipeline.staged_depth", 9)
        plane.start(period_s=0.01)
        try:
            with pytest.raises(RuntimeError, match="already started"):
                plane.start(period_s=0.01)
            deadline = time.monotonic() + 5
            while ("slo.breaching" not in bus.gauges
                    and time.monotonic() < deadline):
                time.sleep(0.01)
            assert bus.gauges.get("slo.breaching") == 1
        finally:
            plane.stop()
        assert plane._thread is None


# --------------------------------------------------------------------- #
# summary-delta alert sources


def test_summary_delta_watch_emits_merge_and_spike():
    with obs_bus.scope() as bus:
        events = []
        bus.subscribe(lambda n, f: events.append((n, f)))
        watch = slo.SummaryDeltaWatch(bus=bus, spike_factor=3.0,
                                      min_degree=5)
        watch.observe(components=10, max_degree=2, tenant=4, position=0)
        watch.observe(components=10, max_degree=2, tenant=4, position=1)
        assert events == []  # steady state is silent
        watch.observe(components=7, max_degree=2, tenant=4, position=2)
        watch.observe(components=7, max_degree=40, tenant=4, position=3)
        names = [n for n, _ in events]
        assert names == ["alerts.component_merge", "alerts.degree_spike"]
        merge = events[0][1]
        assert merge["components"] == 7 and merge["merged"] == 3
        assert merge["tenant"] == 4
        spike = events[1][1]
        assert spike["degree"] == 40.0 and spike["tenant"] == 4
        # Small absolute degrees never spike regardless of ratio.
        watch2 = slo.SummaryDeltaWatch(bus=bus, spike_factor=2.0,
                                       min_degree=100)
        watch2.observe(max_degree=1)
        watch2.observe(max_degree=50)
        assert [n for n, _ in events].count("alerts.degree_spike") == 1


# --------------------------------------------------------------------- #
# Prometheus exposition


def test_prometheus_text_covers_every_bus_metric():
    with obs_bus.scope() as bus:
        bus.inc("ingest.frames_sent", 3)
        bus.gauge("tenants.backlog_age_max_s", 1.25)
        bus.observe("engine.fold_dispatch_ms", 10.0)
        bus.observe("engine.fold_dispatch_ms", 30.0)
        bus.watermarks.stamp("stream", 0)
        text = slo.prometheus_text(bus)
    assert "# TYPE gelly_ingest_frames_sent_total counter" in text
    assert "gelly_ingest_frames_sent_total 3" in text
    assert "# TYPE gelly_tenants_backlog_age_max_s gauge" in text
    assert "gelly_tenants_backlog_age_max_s 1.25" in text
    assert "# TYPE gelly_engine_fold_dispatch_ms summary" in text
    assert 'gelly_engine_fold_dispatch_ms{quantile="0.99"}' in text
    assert "gelly_engine_fold_dispatch_ms_count 2" in text
    assert 'gelly_watermarks_backlog_age_s{stream="stream"}' in text
    # Text format: every non-comment line is "name[{labels}] value".
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        assert name and float(value) is not None


# --------------------------------------------------------------------- #
# multi-host trace stitcher


def _host_trace(pidx: int, shift_us: float, trace_id: str) -> dict:
    """A minimal per-host trace: one span track plus two barrier
    instants, timestamps offset by ``shift_us`` (simulating hosts whose
    monotonic clocks started at different epochs)."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": f"gelly_torch:{trace_id}"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "events"}},
        {"ph": "X", "name": "fold", "cat": "gelly", "pid": 1, "tid": 1,
         "ts": 100.0 + shift_us, "dur": 10.0, "args": {"unit": pidx}},
        {"ph": "i", "name": "coordination.barrier_agreed", "cat": "gelly",
         "pid": 1, "tid": 1, "s": "g", "ts": 200.0 + shift_us,
         "args": {"epoch": 0, "position": 4, "host": pidx}},
        {"ph": "i", "name": "coordination.barrier_agreed", "cat": "gelly",
         "pid": 1, "tid": 1, "s": "g", "ts": 350.0 + shift_us,
         "args": {"epoch": 1, "position": 8, "host": pidx}},
    ]
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id,
                          "host": {"process_index": pidx,
                                   "process_count": 2}}}


def test_stitch_traces_aligns_hosts_and_draws_flow_arrows(tmp_path):
    h0 = _host_trace(0, 0.0, "aa00")
    h1 = _host_trace(1, 123456.0, "bb11")
    p1 = tmp_path / "trace_host1.json"
    p1.write_text(json.dumps(h1))
    out = tmp_path / "trace_stitched.json"
    stitched = export.stitch_traces([h0, str(p1)], out_path=str(out))
    export.validate_chrome_trace(stitched)
    assert stitched["otherData"]["stitched_hosts"] == 2
    assert stitched["otherData"]["barrier_epochs"] == [0, 1]
    # One pid per host, both with process_name metadata.
    pids = {e["pid"] for e in stitched["traceEvents"]}
    assert pids == {1, 2}
    names = {e["pid"]: e["args"]["name"]
             for e in stitched["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names[1].startswith("host0") and names[2].startswith("host1")
    # Clock alignment: host 1's first shared barrier lands at host 0's
    # timestamp, and the relative spacing of its OWN events is kept.
    h1_barriers = [e["ts"] for e in stitched["traceEvents"]
                   if e["pid"] == 2
                   and e.get("name") == "coordination.barrier_agreed"]
    assert h1_barriers == [200.0, 350.0]
    # Flow arrows: an "s"/"f" pair per shared epoch, ids matching.
    flows = [e for e in stitched["traceEvents"] if e["ph"] in ("s", "f")]
    assert {(e["ph"], e["id"]) for e in flows} == {
        ("s", "barrier-0"), ("f", "barrier-0"),
        ("s", "barrier-1"), ("f", "barrier-1")}
    assert all(e["bp"] == "e" for e in flows if e["ph"] == "f")
    # The file written to out_path round-trips through validation.
    export.validate_chrome_trace(json.loads(out.read_text()))


def test_stitch_traces_without_shared_barriers_merges_unaligned():
    h0 = _host_trace(0, 0.0, "aa00")
    h1 = _host_trace(1, 5000.0, "bb11")
    for ev in h1["traceEvents"]:
        if ev.get("name") == "coordination.barrier_agreed":
            ev["args"]["epoch"] += 100  # disjoint epochs
    stitched = export.stitch_traces([h0, h1])
    assert stitched["otherData"]["barrier_epochs"] == []
    assert not [e for e in stitched["traceEvents"]
                if e["ph"] in ("s", "f")]
    # Unaligned: host 1 keeps its own clock.
    h1_first = [e["ts"] for e in stitched["traceEvents"]
                if e["pid"] == 2 and e["ph"] == "X"]
    assert h1_first == [5100.0]


def test_validator_rejects_malformed_flow_events():
    base = _host_trace(0, 0.0, "aa00")
    ok = dict(base, traceEvents=base["traceEvents"] + [
        {"ph": "s", "name": "barrier_flow", "cat": "gelly", "pid": 1,
         "tid": 1, "id": "x", "ts": 1.0},
        {"ph": "f", "name": "barrier_flow", "cat": "gelly", "pid": 1,
         "tid": 1, "id": "x", "ts": 2.0, "bp": "e"},
    ])
    export.validate_chrome_trace(ok)
    missing_id = dict(base, traceEvents=base["traceEvents"] + [
        {"ph": "s", "name": "f", "pid": 1, "tid": 1, "ts": 1.0}])
    with pytest.raises(ValueError, match="needs an 'id'"):
        export.validate_chrome_trace(missing_id)
    missing_bp = dict(base, traceEvents=base["traceEvents"] + [
        {"ph": "f", "name": "f", "pid": 1, "tid": 1, "id": "x",
         "ts": 1.0}])
    with pytest.raises(ValueError, match="bp"):
        export.validate_chrome_trace(missing_bp)


# --------------------------------------------------------------------- #
# across the packages

from gelly_tpu.obs import bus as j_bus  # noqa: E402
from gelly_tpu.obs import export as j_export  # noqa: E402
from gelly_tpu.obs import slo as j_slo  # noqa: E402


def _fill(bus, seed):
    """The same seeded bus contents: counters, gauges, histograms and
    watermark ledgers (a fixed clock, so ages are equal too)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for i in range(40):
        bus.inc(f"engine.c{i % 7}", int(rng.integers(1, 9)))
        bus.gauge(f"pipeline.g{i % 5}", float(rng.integers(0, 100)) / 4)
        bus.observe(f"engine.h{i % 3}_ms", float(rng.exponential(20.0)))
    bus.inc("ingest.frames_sent", 3)
    for p in range(6):
        bus.watermarks.stamp("stream", p, t=100.0 + p)
        bus.watermarks.stamp("t7", p, t=90.0 + p)
    bus.watermarks.retire_durable("stream", 4)


@pytest.mark.parametrize("seed", [11, 12])
def test_prometheus_text_equals_jax(seed):
    texts = {}
    for key, mod, bmod in (("t", slo, obs_bus), ("j", j_slo, j_bus)):
        # Ages are read off the ledger's clock: pin it.
        with bmod.scope() as bus:
            bus.watermarks._clock = lambda: 200.0
            _fill(bus, seed)
            texts[key] = mod.prometheus_text(bus)
    assert texts["t"] == texts["j"]
    assert "gelly_engine_h0_ms_count" in texts["t"]


def test_slo_plane_state_equals_jax():
    # The same spec set, ticked over the same observations on a fixed
    # clock: the burn-rate gauges, the breaching gauge and the breach /
    # recovery events are equal.
    got = {}
    for key, mod, bmod in (("t", slo, obs_bus), ("j", j_slo, j_bus)):
        with bmod.scope() as bus:
            events = []
            bus.subscribe(lambda n, f: events.append(
                (n, {k: v for k, v in f.items() if k != "value"})))
            clk = [0.0]
            specs = [mod.fold_p99_ms(10.0, window_s=5.0),
                     mod.backlog_age_max_s(3.0, window_s=5.0)]
            plane = mod.SloPlane(specs, bus=bus, clock=lambda: clk[0])
            bus.watermarks._clock = lambda: clk[0]
            for step in range(12):
                clk[0] = float(step)
                bus.observe("engine.fold_dispatch_ms",
                            50.0 if 3 <= step < 6 else 1.0)
                bus.watermarks.stamp("stream", step, t=0.0)
                if step == 8:
                    bus.watermarks.retire_durable("stream", step + 1)
                plane.tick()
            got[key] = (dict(bus.gauges), events)
    assert got["t"] == got["j"]
    assert any(n == "slo.breach" for n, _ in got["t"][1])


def test_stitched_timeline_equals_jax(tmp_path):
    hosts = [_host_trace(0, 0.0, "aa00"), _host_trace(1, 777.0, "bb11")]
    t = export.stitch_traces(hosts)
    j = j_export.stitch_traces(hosts)
    assert t == j
    export.validate_chrome_trace(j)
    j_export.validate_chrome_trace(t)
