"""gelly_torch's end-to-end latency watermarks and STATS snapshot on
the CPU.

Mirrors the ``Watermarks`` min-queue tests of ``tests/test_telemetry.py``
(the O(1)-amortized backlog age against the ledger scan, rekey merges,
in-order traffic never rebuilding) and its STATS-shape test against the
port, then runs one seeded sequence of seed, stamp, retire, rekey and
drop operations through both packages' ``Watermarks`` on the same fake
clock and holds every snapshot, backlog age and retirement histogram
equal (exact). It also mirrors the tenant engine's submit-stamp
regression and the coordinated runner's watermark retirement. The file's
other tests drive the ingest server, which the port does not have yet.
"""

import json

import numpy as np
import pytest

from gelly_torch import obs
from gelly_torch.obs.status import build_stats, fetch_stats


# --------------------------------------------------------------------- #
# watermark min-deque: O(1)-amortized backlog_age vs the ledger scan


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scan_age(wm, stream, now):
    """The reference implementation the deque replaced: one O(pending)
    min-scan over the raw ledger."""
    st = wm._streams.get(stream)
    if st is None or not st.stamps:
        return 0.0
    return max(0.0, now - min(st.stamps.values()))


def test_watermark_minq_parity_hammer_vs_scan():
    from gelly_torch.obs.watermarks import Watermarks

    rng = np.random.default_rng(7)
    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    streams = ["a", "b"]
    base = {s: 0 for s in streams}
    nxt = {s: 0 for s in streams}
    reads = 0
    for _ in range(4000):
        ck.t += float(rng.random()) * 0.01
        s = streams[int(rng.integers(0, 2))]
        nxt[s] = max(nxt[s], base[s])
        op = float(rng.random())
        if op < 0.55:
            if rng.random() < 0.05 and nxt[s] > base[s]:
                p = int(rng.integers(base[s], nxt[s]))  # out-of-order
            else:
                p = nxt[s]
                nxt[s] += 1
            wm.stamp(s, p)
        elif op < 0.72:
            upto = int(rng.integers(base[s], nxt[s] + 2))
            wm.retire_durable(s, upto)
            base[s] = max(base[s], upto)
        elif op < 0.82:
            wm.retire_fold(s, int(rng.integers(base[s], nxt[s] + 2)))
        elif op < 0.90:
            pos = int(rng.integers(base[s], nxt[s] + 2))
            wm.seed(s, pos)
            base[s] = max(base[s], pos)
        else:
            reads += 1
            now = ck.t
            assert wm.backlog_age(s) == pytest.approx(
                _scan_age(wm, s, now), abs=1e-12)
            want = max((_scan_age(wm, x, now) for x in streams),
                       default=0.0)
            assert wm.max_backlog_age() == pytest.approx(want, abs=1e-12)
    assert reads > 200  # the hammer actually exercised the read path


def test_watermark_minq_rekey_and_snapshot_parity():
    from gelly_torch.obs.watermarks import Watermarks

    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    for p, t in [(0, 1.0), (1, 2.0), (2, 3.0)]:
        ck.t = t
        wm.stamp("pre", p)
    ck.t = 4.0
    wm.stamp("dst", 1)
    wm.rekey("pre", "dst")  # arbitrary-order merge -> lazy rebuild
    ck.t = 10.0
    assert wm.backlog_age("dst") == pytest.approx(9.0)
    assert wm.backlog_age("pre") == 0.0
    assert wm.snapshot()["dst"]["backlog_age_s"] == pytest.approx(9.0)
    wm.retire_durable("dst", 2)
    assert wm.backlog_age("dst") == pytest.approx(7.0)
    wm.retire_durable("dst", 100)
    assert wm.backlog_age("dst") == 0.0
    assert wm.max_backlog_age() == 0.0


def test_watermark_minq_in_order_reads_never_rebuild():
    from gelly_torch.obs.watermarks import Watermarks

    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    for p in range(512):
        ck.t += 0.001
        wm.stamp("s", p)
        if p % 7 == 0:
            wm.backlog_age("s")
        if p % 64 == 63:
            wm.retire_durable("s", p - 32)
    st = wm._streams["s"]
    # The hot path stays incremental: in-position-order traffic never
    # flips the dirty bit (no O(n log n) rebuild), and the deque never
    # outgrows the ledger — each entry is pushed once and popped once.
    assert st.dirty is False
    assert len(st.minq) <= len(st.stamps)
    assert wm.backlog_age("s") == pytest.approx(
        _scan_age(wm, "s", ck.t), abs=1e-12)


# --------------------------------------------------------------------- #
# the STATS snapshot


def test_build_stats_shape_is_json_ready():
    with obs.scope() as bus, obs.record_metrics():
        bus.inc("ingest.frames_received")
        bus.observe("engine.fold_dispatch_ms", 1.5)
        bus.watermarks.stamp("stream", 0)
        st = json.loads(json.dumps(build_stats(bus)))
    assert st["counters"]["ingest.frames_received"] == 1
    assert st["histograms"]["engine.fold_dispatch_ms"]["count"] == 1
    assert st["watermarks"]["stream"]["pending"] == 1
    assert "process_index" in st["host"]


def test_fetch_stats_waits_for_the_ingest_port():
    # The STATS wire comes with the ingest slice: until then the fetch
    # raises naming its ROADMAP.md item, and the CLI still validates its
    # target before it tries.
    from gelly_torch.obs import status as status_mod

    with pytest.raises(NotImplementedError, match="12b"):
        fetch_stats("127.0.0.1", 1)
    assert status_mod.main(["not-a-target"]) == 2


# --------------------------------------------------------------------- #
# across the packages: one seeded operation sequence, both ledgers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watermarks_sequence_equals_jax(seed):
    from gelly_torch.obs.bus import EventBus as TBus
    from gelly_torch.obs.watermarks import Watermarks as TWatermarks
    from gelly_tpu.obs.bus import EventBus as JBus
    from gelly_tpu.obs.watermarks import Watermarks as JWatermarks

    rng = np.random.default_rng(seed)
    ck = _FakeClock()
    t_wm, j_wm = TWatermarks(clock=ck), JWatermarks(clock=ck)
    t_bus, j_bus = TBus(), JBus()
    streams = ["stream", "t3", "wire:9"]
    nxt = {s: 0 for s in streams}
    for step in range(1500):
        ck.t += float(rng.random()) * 0.01
        s = streams[int(rng.integers(0, len(streams)))]
        op = float(rng.random())
        if op < 0.5:
            if rng.random() < 0.1 and nxt[s]:
                p = int(rng.integers(0, nxt[s]))  # out of order / stale
            else:
                p = nxt[s]
                nxt[s] += 1
            args = ("stamp", s, p)
        elif op < 0.65:
            args = ("retire_durable", s, int(rng.integers(0, nxt[s] + 2)))
        elif op < 0.8:
            args = ("retire_fold", s, int(rng.integers(0, nxt[s] + 2)))
        elif op < 0.88:
            pos = int(rng.integers(0, nxt[s] + 2))
            nxt[s] = max(nxt[s], pos)
            args = ("seed", s, pos)
        elif op < 0.95:
            dst = streams[int(rng.integers(0, len(streams)))]
            nxt[dst] = max(nxt[dst], nxt[s])
            args = ("rekey", s, dst)
        else:
            args = ("drop", s)
        for wm, bus in ((t_wm, t_bus), (j_wm, j_bus)):
            fn = getattr(wm, args[0])
            if args[0].startswith("retire"):
                fn(*args[1:], bus=bus, prefix="engine")
            else:
                fn(*args[1:])
        assert t_wm.snapshot() == j_wm.snapshot(), (step, args)
        assert t_wm.max_backlog_age() == j_wm.max_backlog_age()
        assert t_wm.oldest_position(s) == j_wm.oldest_position(s)
    t_h = t_bus.snapshot()["histograms"]
    j_h = j_bus.snapshot()["histograms"]
    assert t_h == j_h
    assert t_h["engine.e2e_ingress_to_fold_ms"]["count"] > 0
    assert t_h["engine.e2e_ingress_to_durable_ms"]["count"] > 0


# --------------------------------------------------------------------- #
# tenant engine: submit stamps keyed by a monotonic position


def test_tenant_submit_stamp_survives_mid_dispatch_submit():
    """Submit-side stamp positions come from the tenant's monotonic
    ``submitted`` counter, not ``consumed + len(queue)``, which
    under-counts by one between the scheduler's queue pop and its
    ``consumed`` bump: a submit landing there must stamp a new
    position, not re-stamp the previous chunk's."""
    from gelly_torch import edge_stream_from_edges
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library.connected_components import cc_tenant_tier

    n_v = 128

    def chunks(seed, n=3):
        rng = np.random.default_rng(seed)
        stream = edge_stream_from_edges(
            [(int(a), int(b)) for a, b in rng.integers(0, n_v, (n * 8, 2))],
            vertex_capacity=n_v, chunk_size=8, device="cpu",
        )
        return list(stream)[:n]

    with obs.scope() as bus, obs.record_metrics():
        agg, cap = cc_tenant_tier(n_v, chunk_capacity=8)
        eng = MultiTenantEngine(merge_every=1, device="cpu")
        eng.add_tier("small", agg, cap)
        eng.admit(7, "small")
        c1, c2, c3 = chunks(31)
        eng.submit(7, c1)
        eng.submit(7, c2)
        # The dispatch window: the chunk is popped, ``consumed`` not yet
        # bumped.
        with eng._lock:
            eng._tenants[7].queue.popleft()
        eng.submit(7, c3)  # must stamp position 2, not re-stamp 1
        snap = bus.watermarks.snapshot()["7"]
        assert snap["pending"] == 3, snap
        assert snap["oldest_position"] == 0


# --------------------------------------------------------------------- #
# coordinated runner: every barrier commit is a durability point


def test_coordinated_runner_watermarks_fully_retire(tmp_path):
    """Every committed barrier epoch retires the e2e ledger, and the end
    of the stream drains it: with telemetry on, a healthy coordinated run
    ends with no pending stamp, a backlog age of 0 and one
    ingress-to-durable sample a chunk."""
    from gelly_torch.engine.coordination import (
        CoordinationConfig,
        Coordinator,
        HostIdentity,
    )
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
    )

    co = Coordinator(
        str(tmp_path / "store"), HostIdentity(0, 1),
        CoordinationConfig(lease_ttl=2.0, poll_s=0.005,
                           barrier_timeout=10.0, lease_thread=False),
    )
    with obs.scope() as bus, obs.record_metrics():
        r = ResilientRunner(
            lambda s, c: (s + np.int64(c), None), list(range(10)),
            np.int64(0), coordinator=co,
            config=ResilienceConfig(checkpoint_every_chunks=4,
                                    watchdog_timeout=30.0),
        )
        assert int(r.run()) == sum(range(10))
        assert r.stats["checkpoints"] == 3  # 4, 8, final 10
        snap = bus.watermarks.snapshot()["stream"]
        assert snap["pending"] == 0, snap
        assert snap["base"] == 10
        assert bus.watermarks.backlog_age("stream") == 0.0
        h = bus.snapshot()["histograms"]
        assert h["resilience.e2e_ingress_to_durable_ms"]["count"] == 10
        assert bus.gauges["engine.backlog_age_s"] == 0.0
