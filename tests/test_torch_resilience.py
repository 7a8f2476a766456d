"""gelly_torch's resilient runner and fault harness (CPU).

Mirrors ``tests/test_resilience.py`` on the port: retry and backoff,
the watchdog, checkpoint rotation, torn files, stale-tmp reaping, fault
injection at every boundary this slice fires, degradation to the fallback
step, source restarts, hung checkpoint writes and the time cadence. Where
``gelly_tpu`` reads its ``obs`` bus, these read the port's bus and
``runner.stats`` beside it (equal where ``gelly_tpu`` says they are). The CC
fold cases hold the port's resumed forests to an uninterrupted run and to
``gelly_tpu``'s resilient fold over the same stream, bit for bit.
"""

import importlib
import os
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gelly_torch import edge_stream_from_edges, obs
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine import faults
from gelly_torch.engine import resilience as res_mod
from gelly_torch.engine.checkpoint import load_checkpoint
from gelly_torch.engine.resilience import (
    CheckpointManager,
    ResilienceConfig,
    ResilientRunner,
    RetriesExhausted,
    RetryPolicy,
    StreamFault,
    Watchdog,
    WatchdogTimeout,
    resilient_fold,
)
from gelly_torch.library import connected_components as tcc
from gelly_torch.utils import native
from gelly_torch.utils.prefetch import restartable_prefetch
from gelly_tpu.engine import faults as jfaults
from gelly_tpu.engine import resilience as jres

jcc = importlib.import_module("gelly_tpu.library.connected_components")

pytestmark = pytest.mark.faults


# ---------------------------------------------------------------------- #
# a tiny order-sensitive fold: state' = state * 3 + chunk. Any skipped,
# duplicated, or reordered chunk changes the final value, so equality with
# an uninterrupted run is an exactly-once proof.


def _step(s, c):
    return np.int64(s * 3 + c), int(c)


def _clean_run(n):
    s = np.int64(0)
    for c in range(n):
        s, _ = _step(s, c)
    return s


def _fast(**kw):
    kw.setdefault("retry", RetryPolicy(max_attempts=4, base_delay=0.01,
                                       max_delay=0.05))
    kw.setdefault("watchdog_timeout", None)
    kw.setdefault("prefetch_depth", 2)
    return ResilienceConfig(**kw)


# ---------------------------------------------------------------------- #
# units


def test_retry_policy_backoff_and_determinism():
    p = RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.5, jitter=0.5)
    d0 = [p.delay(i, random.Random(7)) for i in range(5)]
    d1 = [p.delay(i, random.Random(7)) for i in range(5)]
    assert d0 == d1  # seeded jitter is reproducible
    bases = [0.1, 0.2, 0.4, 0.5, 0.5]
    for d, b in zip(d0, bases):
        assert b <= d <= b * 1.5  # exponential growth, capped, jitter-bounded
    # The same schedule as gelly_tpu's policy.
    jp = jres.RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.5,
                          jitter=0.5)
    assert d0 == [jp.delay(i, random.Random(7)) for i in range(5)]


def test_watchdog_passes_results_and_errors_and_times_out():
    w = Watchdog(timeout=5.0)
    assert w.call(lambda: 42, "t") == 42
    with pytest.raises(KeyError):
        w.call(lambda: {}["x"], "t")
    w = Watchdog(timeout=0.1)
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout):
        w.call(lambda: time.sleep(3.0), "t")
    assert time.monotonic() - t0 < 1.0
    assert w.stats["watchdog_timeouts"] == 1


def test_checkpoint_manager_rotation_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for pos in (2, 4, 6, 8):
        mgr.save(np.int64(pos * 10), pos)
    files = mgr.list()
    assert [os.path.basename(f) for f in files] == [
        "ckpt-000000000006.npz", "ckpt-000000000008.npz"
    ]
    state, pos, _, path = mgr.load_latest(like=np.int64(0))
    assert pos == 8 and int(state) == 80 and path == files[-1]
    assert mgr.stats["checkpoint_writes"] == 4
    assert mgr.stats["checkpoint_bytes"] > 0


@pytest.mark.parametrize("tear", ["truncate", "fault"])
def test_checkpoint_manager_skips_torn_newest(tmp_path, tear):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(np.int64(1), 1)
    if tear == "fault":
        plan = faults.FaultPlan([
            faults.Fault("checkpoint_corrupt", at=0, kind="corrupt")])
        with faults.install(plan):
            mgr.save(np.int64(2), 2)
        assert plan.fired == [("checkpoint_corrupt", 0, "corrupt")]
    else:
        mgr.save(np.int64(2), 2)
        newest = mgr.list()[-1]
        with open(newest, "r+b") as f:  # tear the newest file
            f.truncate(os.path.getsize(newest) // 2)
    newest = mgr.list()[-1]
    state, pos, _, path = mgr.load_latest(like=np.int64(0))
    assert pos == 1 and int(state) == 1 and path != newest


def test_rotation_keeps_fallbacks_when_the_newest_is_torn(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_write=False)
    mgr.save(np.int64(1), 1)
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_corrupt", at=0, kind="corrupt")])
    with faults.install(plan):
        mgr.save(np.int64(2), 2)
    assert len(mgr.list()) == 2  # the torn newest did not prune its fallback
    assert mgr.stats["rotation_skipped"] == 1
    state, pos, _, _ = mgr.load_latest(like=np.int64(0))
    assert pos == 1 and int(state) == 1


def test_stale_tmp_reap_is_prefix_scoped(tmp_path):
    mine = tmp_path / "a-000000000005-x1y2.npz.tmp"
    theirs = tmp_path / "b-000000000009-q3r4.npz.tmp"
    mine.write_bytes(b"torn leftover")
    theirs.write_bytes(b"write in flight")
    CheckpointManager(str(tmp_path), prefix="a", async_write=False)
    assert not mine.exists()  # own leftover reaped at takeover
    assert theirs.exists()  # the other rotation's tmp untouched
    CheckpointManager(str(tmp_path), prefix="b", async_write=False)
    assert not theirs.exists()
    for bad in ("", "t-1", "a/b"):
        with pytest.raises(ValueError, match="prefix"):
            CheckpointManager(str(tmp_path), prefix=bad)


def test_checkpoint_tmp_name_matches_reap_scope(tmp_path, monkeypatch):
    import fnmatch

    from gelly_torch.engine import checkpoint as ckpt_mod

    seen = []
    real_mkstemp = ckpt_mod.tempfile.mkstemp

    def spy(**kw):
        fd, p = real_mkstemp(**kw)
        seen.append(p)
        return fd, p

    monkeypatch.setattr(ckpt_mod.tempfile, "mkstemp", spy)
    mgr = CheckpointManager(str(tmp_path), prefix="t9", async_write=False)
    mgr.save(np.int64(3), 4)
    assert seen and fnmatch.fnmatch(
        os.path.basename(seen[0]), "t9-*.npz.tmp"
    )


def test_checkpoint_manager_async_write_error_surfaces(tmp_path):
    mgr = CheckpointManager(
        str(tmp_path), keep=2,
        retry=RetryPolicy(max_attempts=2, base_delay=0.01),
    )
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_write", at=0, count=10,
                     exc=lambda: PermissionError("disk said no")),
    ])
    with faults.install(plan):
        mgr.save(np.int64(5), 5)
        with pytest.raises(RetriesExhausted) as ei:
            mgr.close()
    assert ei.value.boundary == "checkpoint_write"


def test_fault_plan_matches_gelly_tpu():
    # Same boundaries and kinds; a seeded rate plan fires at the same calls.
    assert faults.BOUNDARIES == jfaults.BOUNDARIES
    assert faults.KINDS == jfaults.KINDS
    fired = []
    for mod in (faults, jfaults):
        plan = mod.FaultPlan([mod.Fault("step", rate=0.3)], seed=11)
        for _ in range(40):
            try:
                plan.fire("step")
            except mod.FaultInjected:
                pass
        fired.append(plan.fired)
    assert fired[0] == fired[1] and fired[0]
    for bad in (dict(boundary="nope", at=0), dict(boundary="step"),
                dict(boundary="step", at=0, rate=0.5),
                dict(boundary="step", at=0, kind="melt")):
        with pytest.raises(ValueError):
            faults.Fault(**bad)
    with faults.install(faults.FaultPlan([])):
        with pytest.raises(RuntimeError, match="already installed"):
            with faults.install(faults.FaultPlan([])):
                pass
    with pytest.raises(ValueError, match="path"):
        faults.FaultPlan([faults.Fault("step", at=0, kind="corrupt")]) \
            .fire("step")


# ---------------------------------------------------------------------- #
# runner: retry / watchdog / degradation at each boundary


def test_transient_step_fault_is_retried_to_success():
    plan = faults.FaultPlan([faults.Fault("step", at=3, count=2)])
    with faults.install(plan):
        r = ResilientRunner(_step, list(range(10)), np.int64(0),
                            config=_fast())
        final = r.run()
    assert int(final) == int(_clean_run(10))
    assert r.stats["retries"] == 2
    assert plan.fired == [("step", 3, "raise"), ("step", 4, "raise")]


def test_permanent_fault_is_not_retried():
    plan = faults.FaultPlan([
        faults.Fault("step", at=2, retryable=False),
    ])
    with faults.install(plan):
        r = ResilientRunner(_step, list(range(10)), np.int64(0),
                            config=_fast())
        with pytest.raises(faults.FaultInjected):
            r.run()
    assert r.stats["retries"] == 0


def test_retries_exhausted_is_actionable():
    plan = faults.FaultPlan([faults.Fault("step", at=1, count=50)])
    with faults.install(plan):
        r = ResilientRunner(_step, list(range(10)), np.int64(0),
                            config=_fast())
        with pytest.raises(RetriesExhausted) as ei:
            r.run()
    assert ei.value.boundary == "step"
    assert "attempts" in str(ei.value)


def test_hang_hits_watchdog_and_is_retried():
    plan = faults.FaultPlan([
        faults.Fault("step", at=2, kind="hang", hang_seconds=10.0),
    ])
    t0 = time.monotonic()
    with faults.install(plan):
        r = ResilientRunner(_step, list(range(6)), np.int64(0),
                            config=_fast(watchdog_timeout=0.2))
        final = r.run()
    assert time.monotonic() - t0 < 5.0  # did not sit out the 10s hang
    assert int(final) == int(_clean_run(6))
    assert r.stats["retries"] == 1
    assert r.stats["watchdog_timeouts"] == 1


def test_h2d_boundary_fault_is_retried():
    staged = []
    plan = faults.FaultPlan([faults.Fault("h2d", at=1, count=1)])
    with faults.install(plan):
        r = ResilientRunner(
            _step, list(range(5)), np.int64(0), config=_fast(),
            stage=lambda c: (staged.append(c), c)[1],
        )
        final = r.run()
    assert int(final) == int(_clean_run(5))
    assert r.stats["retries"] == 1
    assert staged == list(range(5))  # retried chunk staged exactly once more


def test_native_boundary_fires_through_hook():
    assert native.available("chunk_combiner")
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)

    def step(s, c):
        labels = native.cc_chunk_combine(src, dst, None, 4)
        return np.int64(s + labels[0] + c), None

    plan = faults.FaultPlan([faults.Fault("native", at=1, count=1)])
    with faults.install(plan):
        r = ResilientRunner(step, list(range(4)), np.int64(0),
                            config=_fast())
        r.run()
    assert plan.calls("native") >= 4
    assert r.stats["retries"] == 1
    assert native._fault_hook is None  # uninstalled with the plan


@pytest.mark.parametrize("fn", ["cc_chunk_combine", "cc_chunk_combine_sparse",
                                "cc_chunk_combine_sparse_idx",
                                "cc_unit_forest_segments"])
def test_every_bound_native_entry_fires_the_hook(fn):
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)
    plan = faults.FaultPlan([faults.Fault("native", at=0)])
    with faults.install(plan):
        with pytest.raises(faults.FaultInjected) as ei:
            getattr(native, fn)(src, dst, None, 4)
    assert native.classify_native(ei.value) == "unknown"
    assert native.classify_native(ValueError("plain")) is None
    assert native.classify_native(
        native._stamp(MemoryError("x"), "chunk_combiner")) == "chunk_combiner"
    assert native.classify_error(MemoryError()) == "transient"
    assert native.classify_error(ValueError()) == "permanent"


def test_repeated_native_errors_degrade_to_fallback():
    def boom():
        e = MemoryError("native alloc failed")
        e.stem = "fake_stem"
        return e

    calls = {"native": 0, "fallback": 0}

    def native_step(s, c):
        calls["native"] += 1
        faults.inject("native")
        return _step(s, c)

    def fallback_step(s, c):
        calls["fallback"] += 1
        return _step(s, c)

    plan = faults.FaultPlan([
        faults.Fault("native", at=2, count=100, exc=boom),
    ])
    try:
        with faults.install(plan):
            r = ResilientRunner(
                native_step, list(range(8)), np.int64(0),
                config=_fast(degrade_after=2),
                fallback_step=fallback_step,
            )
            final = r.run()
        assert int(final) == int(_clean_run(8))
        assert r.stats["degraded"] is True
        assert r.stats["degradations"] == 1
        assert calls["fallback"] == 6  # chunks 2..7 on the numpy path
        assert native.disabled_reason("fake_stem") is not None
        assert not native.available("fake_stem")
    finally:
        native.reenable("fake_stem")
    assert native.disabled_reason("fake_stem") is None


def test_disable_sends_the_codec_probes_to_numpy():
    try:
        native.disable("chunk_combiner", reason="operator")
        assert native.disabled_reason("chunk_combiner") == "operator"
        assert not native.available("chunk_combiner")
        assert not native.unit_segments_available()
        agg = tcc.connected_components(64, codec="compact",
                                       compact_capacity=64)
        assert agg.wire == "pairs"  # the numpy codecs
    finally:
        native.reenable("chunk_combiner")
    assert native.available("chunk_combiner")
    assert native.disabled_reason("chunk_combiner") is None


def test_stats_count_the_injection_matrix(tmp_path):
    # One run drives all three ladders — a retried step fault, a native
    # degradation, and a hung checkpoint write — and the obs bus counts
    # every one of them (plus the injections), as runner.stats does.
    def boom():
        e = MemoryError("native alloc failed")
        e.stem = "stats_stem"
        return e

    def native_step(s, c):
        faults.inject("native")
        return _step(s, c)

    plan = faults.FaultPlan([
        faults.Fault("step", at=1, count=1),            # retried to success
        faults.Fault("native", at=4, count=100, exc=boom),  # degrades
        faults.Fault("checkpoint_write", at=1, kind="hang",
                     hang_seconds=10.0),                # one tolerated miss
    ])
    try:
        with obs.scope() as bus:
            with faults.install(plan):
                r = ResilientRunner(
                    native_step, list(range(10)), np.int64(0),
                    checkpoint_dir=str(tmp_path),
                    config=_fast(degrade_after=2, checkpoint_every_chunks=3,
                                 watchdog_timeout=0.3),
                    fallback_step=_step,
                )
                final = r.run()
            counters = bus.snapshot()["counters"]
            gauges = bus.snapshot()["gauges"]
    finally:
        native.reenable("stats_stem")
    assert int(final) == int(_clean_run(10))
    # every ladder is countable off the bus, matching the runner's stats
    assert counters["resilience.retries"] == r.stats["retries"] >= 1
    assert counters["resilience.degradations"] == 1
    assert counters["resilience.checkpoint_misses"] \
        == r.stats["checkpoint_failures"] == 1
    # The bus counts COMPLETED writes (the hung one never completes);
    # runner stats count non-raising save() initiations — both present,
    # deliberately different currencies.
    assert counters["resilience.checkpoints"] \
        == r.stats["checkpoint_writes"] >= 1
    assert counters["faults.injected"] == len(plan.fired) >= 4
    # durability currency rides along: bytes written + last write latency
    assert counters["resilience.checkpoint_bytes"] \
        == r.stats["checkpoint_bytes"] > 0
    assert gauges["resilience.checkpoint_write_s"] >= 0
    assert r.stats["retries"] >= 1
    assert r.stats["degradations"] == 1
    assert r.stats["checkpoint_failures"] == 1
    # Completed writes (the hung one never completes) against initiated.
    assert r.stats["checkpoint_writes"] >= 1
    assert r.stats["checkpoint_writes"] <= r.stats["checkpoints"]
    assert r.stats["checkpoint_bytes"] > 0
    assert r.stats["checkpoint_write_s"] >= 0
    assert len(plan.fired) >= 4


def test_stats_count_watchdog_fires_and_source_restarts():
    fails = {"n": 0}

    def make_iter(pos):
        def gen():
            for i in range(pos, 8):
                if i == 5 and fails["n"] == 0:
                    fails["n"] = 1
                    raise OSError("source hiccup")
                yield i
        return gen()

    plan = faults.FaultPlan([
        faults.Fault("step", at=2, kind="hang", hang_seconds=5.0),
    ])
    with obs.scope() as bus:
        with faults.install(plan):
            r = ResilientRunner(
                _step, make_iter, np.int64(0),
                config=_fast(watchdog_timeout=0.2),
            )
            final = r.run()
        counters = bus.snapshot()["counters"]
    assert int(final) == int(_clean_run(8))
    assert r.stats["watchdog_timeouts"] >= 1
    assert r.stats["restarts"] == 1
    assert counters["resilience.watchdog_timeouts"] \
        == r.stats["watchdog_timeouts"]
    assert counters["resilience.source_restarts"] == r.stats["restarts"] == 1


@pytest.mark.parametrize("where", ["mid-stream", "open"])
def test_source_failure_restarts_without_loss(where):
    fails = {"n": 0}

    def make_iter(pos):
        def gen():
            for i in range(pos, 12):
                if i == 7 and fails["n"] == 0:
                    fails["n"] = 1
                    raise OSError("source hiccup")
                yield i
        return gen()

    plan = faults.FaultPlan(
        [faults.Fault("source", at=0)] if where == "open" else [])
    if where == "open":
        fails["n"] = 1
    with faults.install(plan):
        r = ResilientRunner(_step, make_iter, np.int64(0), config=_fast())
        emitted = [c for _, c in r.emissions()]
    assert emitted == list(range(12))  # no loss, no duplicates
    assert int(r.state) == int(_clean_run(12))
    assert r.stats["restarts"] == 1


def test_restartable_prefetch_reopens_at_the_next_undelivered_index():
    opened = []

    def make_iter(i):
        opened.append(i)

        def gen():
            for j in range(i, 10):
                if j == 6 and len(opened) == 1:
                    raise OSError("worker died")
                yield j
        return gen()

    restarts = []
    got = list(restartable_prefetch(
        make_iter, depth=3, start=2,
        on_restart=lambda e, at: restarts.append(at)))
    assert got == list(range(2, 10)) and opened == [2, 6]
    assert restarts == [6]

    def failing(exc):
        def make(i):
            opened.append(i)
            raise exc
        return make

    opened.clear()
    with pytest.raises(OSError):
        list(restartable_prefetch(failing(OSError("x")), max_restarts=2))
    assert len(opened) == 3  # the first open and two restarts
    opened.clear()
    with pytest.raises(ValueError):  # not restartable: raised at once
        list(restartable_prefetch(
            failing(ValueError("bad")),
            should_restart=lambda e: isinstance(e, OSError)))
    assert len(opened) == 1


def test_checkpoint_write_fault_retried_inside_manager(tmp_path):
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_write", at=0, count=1,
                     exc=lambda: OSError("EIO")),
    ])
    with faults.install(plan):
        r = ResilientRunner(
            _step, list(range(6)), np.int64(0),
            checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=2),
        )
        final = r.run()
    assert int(final) == int(_clean_run(6))
    _, pos, _ = load_checkpoint(
        os.path.join(tmp_path, "ckpt-000000000006.npz"), like=np.int64(0)
    )
    assert pos == 6


def test_checkpoint_writer_retries_are_counted_on_the_bus(tmp_path):
    # The port counts the checkpoint writer's own retries in
    # runner.stats["retries"] (ROADMAP.md, "Divergences kept by
    # design"), so its bus counts them too: the two stay equal, and the
    # retry shows as an instant naming the checkpoint_write boundary.
    plan = faults.FaultPlan([
        faults.Fault("step", at=2, count=1),
        faults.Fault("checkpoint_write", at=0, count=1,
                     exc=lambda: OSError("EIO")),
    ])
    tr = obs.SpanTracer(heartbeat_every_s=None)
    with obs.scope() as bus:
        with obs.install(tr), faults.install(plan):
            r = ResilientRunner(
                _step, list(range(6)), np.int64(0),
                checkpoint_dir=str(tmp_path),
                config=_fast(checkpoint_every_chunks=2),
            )
            final = r.run()
        counters = bus.snapshot()["counters"]
    assert int(final) == int(_clean_run(6))
    assert counters["resilience.retries"] == r.stats["retries"] == 2
    assert sorted(i["args"]["boundary"]
                  for i in tr.instants("resilience.retries")) == [
        "checkpoint_write", "step"]
    assert counters["faults.injected"] == len(plan.fired) == 2
    assert len(tr.instants("faults.injected")) == 2


def test_time_based_checkpoint_cadence(tmp_path):
    fake = {"t": 0.0}

    def step_tick(s, c):
        fake["t"] += 1.0  # each chunk "takes" one fake second
        return _step(s, c)

    r = ResilientRunner(
        step_tick, list(range(9)), np.int64(0),
        checkpoint_dir=str(tmp_path),
        config=_fast(
            checkpoint_every_chunks=10 ** 9,  # count cadence never fires
            checkpoint_every_seconds=3.0,
            clock=lambda: fake["t"],
        ),
    )
    final = r.run()
    assert int(final) == int(_clean_run(9))
    mgr = CheckpointManager(str(tmp_path))
    positions = [int(os.path.basename(p)[5:-4]) for p in mgr.list()]
    assert positions == [3, 6, 9]


def test_hung_checkpoint_write_degrades_then_recovers(tmp_path):
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_write", at=1, kind="hang",
                     hang_seconds=10.0),
    ])
    t0 = time.monotonic()
    with faults.install(plan):
        r = ResilientRunner(
            _step, list(range(10)), np.int64(0),
            checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=2, watchdog_timeout=0.3),
        )
        final = r.run()
    assert time.monotonic() - t0 < 5.0  # never sat out the 10s hang
    assert int(final) == int(_clean_run(10))
    assert r.stats["checkpoint_failures"] == 1
    mgr = CheckpointManager(str(tmp_path))
    state, pos, _, _ = mgr.load_latest(like=np.int64(0))
    assert pos == 10  # end-of-stream checkpoint is durable


def test_persistently_hung_checkpoint_writes_abort(tmp_path):
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_write", at=1, count=10 ** 6, kind="hang",
                     hang_seconds=10.0),
    ])
    t0 = time.monotonic()
    with faults.install(plan):
        r = ResilientRunner(
            _step, list(range(40)), np.int64(0),
            checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=2, watchdog_timeout=0.2,
                         max_checkpoint_failures=2),
        )
        with pytest.raises(WatchdogTimeout) as ei:
            r.run()
    assert ei.value.boundary == "checkpoint_write"
    assert time.monotonic() - t0 < 8.0
    assert r.stats["checkpoint_failures"] == 2


def test_checkpoint_read_fault_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(np.int64(1), 1)
    mgr.save(np.int64(2), 2)
    plan = faults.FaultPlan([faults.Fault("checkpoint_read", at=0)])
    with faults.install(plan):
        state, pos, _, _ = mgr.load_latest(like=np.int64(0))
    assert pos == 1 and int(state) == 1  # newest unreadable -> previous


# ---------------------------------------------------------------------- #
# exactly-once resume


def _interrupt_then_resume(tmp_path, n, crash_at, **runner_kw):
    plan = faults.FaultPlan([
        faults.Fault("step", at=crash_at, count=100, retryable=False),
    ])
    with faults.install(plan):
        r1 = ResilientRunner(
            _step, list(range(n)), np.int64(0),
            checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=3), **runner_kw,
        )
        with pytest.raises(faults.FaultInjected):
            r1.run()
    r2 = ResilientRunner(
        _step, list(range(n)), np.int64(0),
        checkpoint_dir=str(tmp_path),
        config=_fast(checkpoint_every_chunks=3), **runner_kw,
    )
    return r2, r2.run()


def test_resume_is_bit_identical_to_uninterrupted(tmp_path):
    r2, final = _interrupt_then_resume(tmp_path, n=20, crash_at=11)
    assert r2.stats["resumed_from"] is not None
    assert r2.stats["resume_load_s"] >= 0
    assert r2.stats["chunks"] < 20  # genuinely skipped the folded prefix
    want = _clean_run(20)
    assert int(final) == int(want)
    assert np.asarray(final).dtype == want.dtype


def test_resume_survives_torn_newest_checkpoint(tmp_path):
    plan = faults.FaultPlan([
        faults.Fault("step", at=11, count=100, retryable=False),
        faults.Fault("checkpoint_corrupt", at=2, count=100, kind="corrupt"),
    ])
    with faults.install(plan):
        r1 = ResilientRunner(
            _step, list(range(20)), np.int64(0),
            checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=2, keep_checkpoints=4),
        )
        with pytest.raises(faults.FaultInjected):
            r1.run()
    r2 = ResilientRunner(
        _step, list(range(20)), np.int64(0),
        checkpoint_dir=str(tmp_path), config=_fast(),
    )
    final = r2.run()
    assert int(final) == int(_clean_run(20))


CC_N = 64


def _cc_edges():
    rng = np.random.default_rng(3)
    return [(int(a), int(b)) for a, b in rng.integers(0, CC_N, (512, 2))]


@pytest.mark.parametrize("flatten", [False, True])
def test_resume_with_edge_stream_cc_fold(tmp_path, flatten):
    """A CC fold over an EdgeStream, interrupted and resumed, matches the
    uninterrupted summary bit for bit — and gelly_tpu's resilient fold
    over the same stream."""
    from gelly_tpu import edge_stream_from_edges as j_edges

    edges = _cc_edges()

    def stream():
        return edge_stream_from_edges(edges, vertex_capacity=CC_N,
                                      chunk_size=16, device="cpu")

    agg = tcc.connected_components(CC_N)
    step = lambda s, c: (agg.fold(s, c), None)  # noqa: E731
    init = lambda: agg.init("cpu")  # noqa: E731
    kw = {"flatten_state": agg.flatten} if flatten else {}
    clean = ResilientRunner(step, stream(), init, config=_fast()).run()

    plan = faults.FaultPlan([
        faults.Fault("step", at=20, count=100, retryable=False),
    ])
    with faults.install(plan):
        r1 = ResilientRunner(
            step, stream(), init, checkpoint_dir=str(tmp_path),
            config=_fast(checkpoint_every_chunks=4), **kw,
        )
        with pytest.raises(faults.FaultInjected):
            r1.run()
    r2 = ResilientRunner(
        step, stream(), init, checkpoint_dir=str(tmp_path),
        config=_fast(checkpoint_every_chunks=4), **kw,
    )
    resumed = r2.run()
    assert r2.stats["resumed_from"] is not None
    assert isinstance(resumed.parent, torch.Tensor)
    jagg = jcc.connected_components(CC_N)
    jfold = jax.jit(jagg.fold)
    jkw = {"flatten_state": jax.jit(jagg.flatten)} if flatten else {}
    jfinal = jres.ResilientRunner(
        lambda s, c: (jfold(s, c), None),
        j_edges(edges, vertex_capacity=CC_N, chunk_size=16), jagg.init,
        checkpoint_dir=str(tmp_path / "jax"),
        config=jres.ResilienceConfig(checkpoint_every_chunks=4,
                                     watchdog_timeout=None), **jkw).run()
    if not flatten:
        for a, b in zip(clean, resumed):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    for a, b in zip(jax.tree.leaves(jfinal), resumed):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_resume_raw_fold_with_the_kernel_backend(tmp_path, monkeypatch):
    # The kernel backend's plain version on the CPU, under two injected
    # faults (a step and a checkpoint write): bit-identical forest.
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 256)
    n = 1 << 12
    rng = np.random.default_rng(13)
    src = (rng.zipf(1.3, 4096) % n).astype(np.int32)
    dst = (rng.zipf(1.3, 4096) % n).astype(np.int32)

    def stream():
        return t_stream(TSource(src, dst, chunk_size=256,
                                table=TIdentity(n)), n, device="cpu")

    agg = tcc.connected_components(n, merge="gather", ingest_combine=False,
                                   fold_backend="kernel")
    step = lambda s, c: (agg.fold(s, c.to("cpu")), None)  # noqa: E731
    want = resilient_fold(step, stream(), lambda: agg.init("cpu"),
                          config=_fast())
    plan = faults.FaultPlan([faults.Fault("step", at=5),
                             faults.Fault("checkpoint_write", at=1)])
    with faults.install(plan):
        r = ResilientRunner(step, stream(), lambda: agg.init("cpu"),
                            checkpoint_dir=str(tmp_path),
                            config=_fast(checkpoint_every_chunks=4),
                            flatten_state=agg.flatten)
        got = r.run()
    assert r.stats["retries"] == 2  # the step and the checkpoint write
    assert r.stats["checkpoint_writes"] == 4
    assert torch.equal(tcc.unionfind.pointer_jump(got.parent),
                       tcc.unionfind.pointer_jump(want.parent))
    assert torch.equal(got.seen, want.seen)


# ---------------------------------------------------------------------- #
# the engine's own fault boundaries


@pytest.mark.parametrize("boundary", ["codec", "h2d"])
def test_engine_boundaries_fire_and_reach_the_consumer(boundary):
    rng = np.random.default_rng(3)
    src = (rng.zipf(1.3, 700) % 256).astype(np.int32)
    dst = (rng.zipf(1.3, 700) % 256).astype(np.int32)
    agg = tcc.connected_components(256, codec="compact",
                                   compact_capacity=256)

    def run():
        return [x.numpy() for x in t_stream(
            TSource(src, dst, chunk_size=32, table=TIdentity(256)), 256,
            device="cpu").aggregate(agg, merge_every=4, fold_batch=2,
                                    ingest_workers=2, h2d_depth=2)]

    want = run()
    plan = faults.FaultPlan([])
    with faults.install(plan):
        assert len(run()) == len(want)
    assert plan.calls(boundary) == 11  # one a unit: 22 chunks, units of 2
    before = threading.active_count()
    plan = faults.FaultPlan([faults.Fault(boundary, at=3)])
    with faults.install(plan):
        with pytest.raises(faults.FaultInjected, match=boundary):
            run()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before


# ---------------------------------------------------------------------- #
# review regressions


def test_single_shot_iterator_restart_fails_loudly():
    def gen():
        yield from range(5)

    r = ResilientRunner(_step, gen(), np.int64(0), config=_fast())
    assert int(r.run()) == int(_clean_run(5))  # one pass works

    def gen_flaky():
        yield 0
        yield 1
        raise OSError("transient mid-stream")

    r2 = ResilientRunner(_step, gen_flaky(), np.int64(0), config=_fast())
    with pytest.raises(StreamFault, match="single-shot"):
        r2.run()


def test_load_latest_survives_header_meta_damage(tmp_path):
    import json

    def rewrite(path, mutate):
        with np.load(path) as z:
            header = json.loads(bytes(z["__header__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__header__"}
        mutate(header)
        with open(path, "wb") as f:
            np.savez(f, __header__=np.frombuffer(
                json.dumps(header).encode(), dtype=np.uint8
            ), **arrays)

    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(np.int64(1), 1)
    mgr.save(np.int64(2), 2)
    newest = mgr.list()[-1]

    rewrite(newest, lambda h: h.pop("meta"))
    state, pos, meta, _ = mgr.load_latest(like=np.int64(0))
    assert pos == 2 and int(state) == 2 and meta == {}

    rewrite(newest, lambda h: h.__setitem__("meta", "garbage"))
    state, pos, _, _ = mgr.load_latest(like=np.int64(0))
    assert pos == 1 and int(state) == 1  # fell back, no raw exception


def test_checkpoint_failure_accounting_is_exact_under_contention(
        tmp_path, monkeypatch):
    import sys

    def failing_save(*a, **kw):
        raise ValueError("disk on fire")  # permanent: no retry sleeps

    monkeypatch.setattr(res_mod, "save_checkpoint", failing_save)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    n_threads, per_thread = 8, 25

    def hammer():
        for i in range(per_thread):
            with pytest.raises(ValueError):
                mgr._write({}, i, None)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert mgr.consecutive_failures == n_threads * per_thread
