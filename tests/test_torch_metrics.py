"""gelly_torch's ``utils/metrics`` on the CPU: stage timers, throughput
meters, ``metered`` and ``trace`` on ``torch.profiler``.

Mirrors the meter, timer-publish, ``metered`` and ``trace`` tests of
``tests/test_utils.py`` against the port. ``torch.profiler.profile`` is
stubbed where the JAX tests stub ``jax.profiler``, and one real CPU
profile round trip writes its Chrome JSON. The meters and the timer
publish the same gauges as ``gelly_tpu``'s on the same samples, and
``metered`` counts the same edges over the same stream (exact).
"""

import glob
import json
import os
import time

import pytest
import torch

from gelly_torch.utils.metrics import (
    StageTimer,
    ThroughputMeter,
    metered,
    trace,
)


def test_stage_timer_and_meter():
    t = StageTimer()
    with t("fold"):
        pass
    with t("fold"):
        pass
    rep = t.report()
    assert rep["fold"]["calls"] == 2
    m = ThroughputMeter()
    m.record(100)
    m.record(200)
    assert m.edges == 300


def test_throughput_meter_single_record_has_rate():
    # A single record() would leave elapsed == 0 and report 0.0
    # edges/sec despite nonzero edges: the meter falls back to the time
    # since it was created for the one-sample case.
    m = ThroughputMeter()
    time.sleep(0.02)
    m.record(1000)
    assert m.edges == 1000
    assert m.elapsed >= 0.02
    assert m.edges_per_sec > 0.0
    snap = m.snapshot()
    assert snap["edges"] == 1000
    assert snap["edges_per_sec"] == round(m.edges_per_sec, 1) > 0
    assert snap["elapsed_s"] > 0


def test_throughput_meter_empty_and_multi_sample():
    m = ThroughputMeter()
    assert m.elapsed == 0.0 and m.edges_per_sec == 0.0  # no samples: no rate
    m.record(100)
    time.sleep(0.01)
    m.record(200)
    # Two samples: the ordinary first-to-last span, not the fallback.
    assert 0.01 <= m.elapsed < 10.0
    assert m.edges == 300


def test_throughput_meter_publishes_gauges():
    from gelly_torch.obs import EventBus

    bus = EventBus()
    m = ThroughputMeter()
    m.record(50)
    m.publish(bus, prefix="t")
    snap = bus.snapshot()["gauges"]
    assert snap["t.edges"] == 50
    assert snap["t.edges_per_sec"] > 0


class _StubProfile:
    """Stands in for ``torch.profiler.profile``: records start, stop and
    export calls, and can fail at any of them."""

    def __init__(self, calls, fail=()):
        self.calls = calls
        self.fail = fail

    def __call__(self, activities=None, **kw):
        self.calls.append(("make", tuple(activities)))
        return self

    def _step(self, name, *args):
        self.calls.append((name,) + args)
        if name in self.fail:
            raise RuntimeError(f"profiler {name} failed")

    def start(self):
        self._step("start")

    def stop(self):
        self._step("stop")

    def export_chrome_trace(self, path):
        self._step("export", os.path.dirname(path))


def test_trace_is_exception_safe(tmp_path, monkeypatch):
    # A body that raises must propagate ITS exception (never a masked
    # stop error) and must always stop the started profiler — no
    # dangling session.
    calls = []
    monkeypatch.setattr(torch.profiler, "profile", _StubProfile(calls))
    d1 = str(tmp_path / "t1")
    with pytest.raises(RuntimeError, match="boom"):
        with trace(d1):
            raise RuntimeError("boom")
    assert [c[0] for c in calls] == ["make", "start", "stop", "export"]
    assert calls[-1] == ("export", d1)
    assert calls[0][1][0] == torch.profiler.ProfilerActivity.CPU

    # A stop that itself fails must not MASK the body's exception.
    calls.clear()
    monkeypatch.setattr(torch.profiler, "profile",
                        _StubProfile(calls, fail=("stop",)))
    with pytest.raises(RuntimeError, match="body error"):
        with trace(str(tmp_path / "t2")):
            raise RuntimeError("body error")
    assert calls[-1] == ("stop",)


def test_trace_noops_when_profiler_unavailable(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "profile",
                        _StubProfile(calls, fail=("start",)))
    ran = []
    with trace(str(tmp_path / "t")):
        ran.append(1)  # body still runs; no exception escapes
    assert ran == [1]
    assert [c[0] for c in calls] == ["make", "start"]  # never stopped


def test_trace_none_is_a_plain_block(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "profile", _StubProfile(calls))
    with trace(None):
        pass
    assert calls == []


def test_trace_records_alignment_instants(tmp_path, monkeypatch):
    from gelly_torch.obs import SpanTracer

    monkeypatch.setattr(torch.profiler, "profile", _StubProfile([]))
    tr = SpanTracer()
    with trace(str(tmp_path / "t"), tracer=tr):
        pass
    names = [i["name"] for i in tr.instants()]
    assert names == ["torch_profiler_start", "torch_profiler_stop"]
    for inst in tr.instants():
        assert inst["args"]["trace_id"] == tr.trace_id
        assert inst["args"]["log_dir"] == str(tmp_path / "t")


def test_trace_real_profiler_roundtrip(tmp_path):
    # The real CPU profiler: each block leaves one Chrome JSON holding
    # the body's operators, and a raising body leaves no dangling
    # session (the next block starts cleanly).
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones(64).add_(1)
    with pytest.raises(RuntimeError, match="boom"):
        with trace(d):
            raise RuntimeError("boom")
    with trace(d):
        torch.ones(64).mul_(2)
    files = sorted(glob.glob(os.path.join(d, "torch_profiler.*.json")))
    assert len(files) == 3
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)


def test_stage_timer_publish_gauges():
    from gelly_torch.obs import EventBus

    bus = EventBus()
    t = StageTimer()
    t.totals["fold_dispatch"] = 1.25
    t.publish(bus)
    assert bus.snapshot()["gauges"]["stage.fold_dispatch.busy_s"] == 1.25


def test_metered_stream_counts_valid_edges(reference_edges):
    from gelly_torch import edge_stream_from_edges

    s = edge_stream_from_edges(reference_edges, vertex_capacity=16,
                               chunk_size=3, device="cpu")
    m = ThroughputMeter()
    n = sum(1 for _ in metered(iter(s), m))
    assert n == 3  # ceil(7/3) chunks
    assert m.edges == 7


# --------------------------------------------------------------------- #
# across the packages


def test_timer_and_meter_gauges_equal_jax():
    from gelly_torch.obs import EventBus as TBus
    from gelly_tpu.obs import EventBus as JBus
    from gelly_tpu.utils import metrics as jmetrics

    gauges = {}
    for key, mod, bus_cls in (("t", None, TBus), ("j", jmetrics, JBus)):
        timer = (StageTimer if mod is None else mod.StageTimer)()
        for stage, secs in (("h2d", 0.5), ("fold_dispatch", 1.25),
                            ("ingest_compress", 2.0)):
            timer.totals[stage] += secs
            timer.counts[stage] += 1
        timer.reattribute("ingest_compress", "codec_wait", 0.75)
        bus = bus_cls()
        timer.publish(bus)
        timer.publish(bus, prefix="engine.stage")
        meter = (ThroughputMeter if mod is None else mod.ThroughputMeter)()
        meter.record(300)
        meter.publish(bus, prefix="engine.throughput")
        g = bus.snapshot()["gauges"]
        g.pop("engine.throughput.edges_per_sec")  # a rate: timing
        gauges[key] = g
    assert gauges["t"] == gauges["j"]
    assert gauges["t"]["engine.throughput.edges"] == 300


def test_metered_counts_equal_jax(reference_edges):
    from gelly_torch import edge_stream_from_edges as t_edges
    from gelly_tpu import edge_stream_from_edges as j_edges
    from gelly_tpu.utils import metrics as jmetrics

    t_meter, j_meter = ThroughputMeter(), jmetrics.ThroughputMeter()
    t_n = [int(c.valid.sum()) for c in metered(iter(t_edges(
        reference_edges, vertex_capacity=16, chunk_size=2, device="cpu")),
        t_meter)]
    j_n = [int(c.valid.sum()) for c in jmetrics.metered(iter(j_edges(
        reference_edges, vertex_capacity=16, chunk_size=2)), j_meter)]
    assert t_n == j_n
    assert t_meter.edges == j_meter.edges == len(reference_edges)
