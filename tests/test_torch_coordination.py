"""gelly_torch's coordinated multi-host recovery protocol vs gelly_tpu's
(CPU, in process).

Mirrors the 33 tests of ``tests/test_coordination.py`` on the port:
several "hosts" are plain :class:`Coordinator` instances with explicit
:class:`HostIdentity` sharing one store directory (threads where the
protocol needs concurrency), with the same ``FaultPlan`` s and the same
error texts. The 2-process gloo tier (SIGKILL mid-stream) lives in
``tests/test_torch_coordinated_recovery.py``.

Then it holds the port to ``gelly_tpu`` across the packages:

- a store written by either package's coordinated hosts is recovered by
  the other's at the same position, with its own shard leaves bit-equal;
- the same coordinated run under the same plan gives the same
  ``FaultPlan.fired`` records, the same ``coordination.*`` and
  ``faults.injected`` bus events (wall-clock stamps aside) and the same
  error text;
- the two stores hold the same files, the manifests are equal apart from
  their times, the rendezvous records apart from times and run ids, and
  the shard files' leaves bit for bit;
- a ``Fault("collective", at=k)`` fires at the same window close of a
  Merger plan, and at the same pane close of a pane ring, in both.

Inputs are made from seeds with numpy; tolerance: none.
"""

import importlib
import json
import os
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gelly_torch import edge_stream_from_edges as t_edges
from gelly_torch.engine import coordination as coord_mod
from gelly_torch.engine import faults
from gelly_torch.engine.checkpoint import load_checkpoint
from gelly_torch.engine.coordination import (
    CheckpointStore,
    CoordinationError,
    Coordinator,
    HostIdentity,
    LeaseBoard,
    ManifestCorruptError,
    MixedEpochError,
)
from gelly_torch.engine.resilience import (
    CheckpointManager,
    ResilienceConfig,
    ResilientRunner,
    Watchdog,
    WatchdogTimeout,
)
from gelly_torch.obs import bus as obs_bus
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.engine import coordination as jcoord
from gelly_tpu.engine import faults as jfaults
from gelly_tpu.engine import resilience as jres
from gelly_tpu.obs import bus as jbus

tcc = importlib.import_module("gelly_torch.library.connected_components")
jcc = importlib.import_module("gelly_tpu.library.connected_components")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_active_coordinator():
    """Coordinators register themselves for heartbeat/trace leadership
    attribution; tests here construct many without closing — clear both
    packages' registries so no leadership flag leaks across tests."""
    yield
    coord_mod._ACTIVE = None
    jcoord._ACTIVE = None


def _cfg(mod=coord_mod, **kw):
    kw.setdefault("lease_ttl", 2.0)
    kw.setdefault("poll_s", 0.005)
    kw.setdefault("barrier_timeout", 10.0)
    # In-process tests simulate silent host death by STOPPING a
    # coordinator's calls, so the background lease thread (which would
    # keep the "dead" host alive) is opted out; its semantics get a
    # dedicated test, and the gloo subprocess tier runs with it on.
    kw.setdefault("lease_thread", False)
    return mod.CoordinationConfig(**kw)


def _fast(res=None, **kw):
    kw.setdefault("checkpoint_every_chunks", 4)
    kw.setdefault("watchdog_timeout", 30.0)
    return (res.ResilienceConfig if res is not None
            else ResilienceConfig)(**kw)


def _run_hosts(n, body):
    """Run ``body(k)`` for each host index on its own thread; re-raise
    the first failure (one host erroring usually strands the others in
    a bounded wait)."""
    errs = []

    def wrapped(k):
        try:
            body(k)
        except BaseException as e:  # noqa: BLE001
            errs.append((k, e))

    ts = [threading.Thread(target=wrapped, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    if errs:
        raise errs[0][1]


# ---------------------------------------------------------------------- #
# identities, leases, store plumbing


def test_host_identity_validation():
    with pytest.raises(ValueError):
        HostIdentity(2, 2)
    with pytest.raises(ValueError):
        HostIdentity(-1, 2)
    with pytest.raises(ValueError):
        HostIdentity(0, 0)
    ident = coord_mod.detect_host_identity()
    assert ident.process_index == 0 and ident.process_count == 1


def test_lease_board_liveness_and_expiry(tmp_path):
    store = CheckpointStore(str(tmp_path))
    now = [100.0]
    b0 = LeaseBoard(store, 0, ttl=1.0, clock=lambda: now[0])
    b1 = LeaseBoard(store, 1, ttl=1.0, clock=lambda: now[0])
    assert b0.beat() and b1.beat()
    assert b0.live() == {0, 1}
    assert not b0.expired(1)
    assert not b0.expired(7)  # absent lease = unknown, never "dead"
    now[0] += 0.2
    assert not b1.beat()  # rate-limited to ttl/3
    now[0] += 2.0
    b0.beat()
    assert b0.live() == {0}
    assert b0.expired(1)


def test_store_atomic_writes_leave_no_tmp(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.write_intent(1, 0, 5)
    store.write_prepared(1, 0, 5)
    store.commit(1, 5, 1)
    leftovers = [
        f for _, _, files in os.walk(tmp_path) for f in files
        if f.endswith(".tmp")
    ]
    assert leftovers == []
    man = store.read_manifest()
    assert man["epoch"] == 1 and man["position"] == 5
    assert man["hosts"] == [0]


def test_torn_manifest_rejected(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.commit(3, 12, 2)
    with open(store.manifest_path, "r+") as f:
        f.truncate(os.path.getsize(store.manifest_path) // 2)
    with pytest.raises(ManifestCorruptError, match="torn|unparsable"):
        store.read_manifest()
    # schema damage is rejected too, distinctly from a tear
    with open(store.manifest_path, "w") as f:
        json.dump({"version": 1, "epoch": 3}, f)
    with pytest.raises(ManifestCorruptError, match="position"):
        store.read_manifest()


def test_mixed_epoch_store_rejected(tmp_path):
    """Validation targets the SHARDS: a committed epoch missing any host's
    shard at the manifest position is rejected."""
    store = CheckpointStore(str(tmp_path))
    state = {"x": np.arange(4, dtype=np.int64)}
    store.write_shard(2, 0, state, 8)
    store.write_shard(2, 1, state, 4)
    store.commit(2, 8, 2)  # a manifest 2PC would never have written
    man = store.read_manifest()
    with pytest.raises(MixedEpochError, match="missing"):
        store.validate_epoch(man)
    store.write_shard(2, 1, state, 8)
    store.validate_epoch(man)  # consistent at last
    state2, pos, _ = store.load_shard(2, 1, 8)
    assert pos == 8


# ---------------------------------------------------------------------- #
# barrier + 2PC


def test_barrier_agrees_on_max_and_commits(tmp_path):
    results = {}

    def body(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), _cfg())
        epoch, agreed = co.agree_position(3 + k)  # proposals 3 and 4
        man = co.publish(epoch, {"x": np.arange(4) + k}, agreed)
        results[k] = (epoch, agreed, man["epoch"], man["position"])

    with obs_bus.scope() as bus:
        _run_hosts(2, body)
    assert results[0] == results[1] == (1, 4, 1, 4)
    counters = bus.snapshot()["counters"]
    assert counters["coordination.barrier_agreed"] == 2
    assert counters["coordination.prepared"] == 2
    assert counters["coordination.committed"] == 1


def test_epoch_aborts_when_host_dies_before_preparing(tmp_path):
    """2PC phase-1 death: the missing host's lease expires, the leader
    aborts the epoch, and NO manifest exists."""
    cfg = _cfg(lease_ttl=0.5, barrier_timeout=5.0)
    co0 = Coordinator(str(tmp_path), HostIdentity(0, 2), cfg)
    co1 = Coordinator(str(tmp_path), HostIdentity(1, 2), cfg)
    out = {}

    def body(k):
        out[k] = (co0, co1)[k].agree_position(6)

    _run_hosts(2, body)
    assert out[0] == out[1]
    epoch, agreed = out[0]
    time.sleep(0.7)  # host 1 dies before writing its shard
    with pytest.raises(CoordinationError, match="died before preparing"):
        co0.publish(epoch, {"x": np.arange(2)}, agreed)
    assert CheckpointStore(str(tmp_path)).read_manifest() is None


def test_leader_rotation_commits_after_leader_death(tmp_path):
    """Leader dies BETWEEN phases: the next-lowest live host takes the
    commit over — rotation, not abort; published on the bus."""
    cfg = _cfg(lease_ttl=0.4, barrier_timeout=10.0)
    with obs_bus.scope() as bus:
        co0 = Coordinator(str(tmp_path), HostIdentity(0, 2), cfg)
        co1 = Coordinator(str(tmp_path), HostIdentity(1, 2), cfg)
        out = {}

        def body(k):
            out[k] = (co0, co1)[k].agree_position(9)

        _run_hosts(2, body)
        epoch, agreed = out[0]
        co0.store.write_shard(epoch, 0, {"x": np.arange(3)}, agreed)
        co0.store.write_prepared(epoch, 0, agreed)
        time.sleep(0.6)  # let the leader's lease lapse
        man = co1.publish(epoch, {"x": np.arange(3) + 1}, agreed)
    assert man["epoch"] == epoch and man["position"] == agreed
    assert man["meta"]["committed_by"] == 1
    assert co1.is_leader
    counters = bus.snapshot()["counters"]
    assert counters["coordination.leader_elected"] >= 3
    assert counters["coordination.committed"] == 1
    CheckpointStore(str(tmp_path)).validate_epoch(man)


def test_lease_thread_keeps_host_alive_through_stalls(tmp_path):
    cfg = _cfg(lease_ttl=0.45, lease_thread=True)
    co = Coordinator(str(tmp_path), HostIdentity(0, 2), cfg)
    observer = LeaseBoard(CheckpointStore(str(tmp_path)), 1, ttl=0.45)
    time.sleep(0.7)  # stall with no protocol calls, longer than ttl
    assert not observer.expired(0)
    co.close()
    time.sleep(0.7)
    assert observer.expired(0)


def test_epoch_numbering_derives_from_committed_state(tmp_path):
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    e1, _ = co.agree_position(2)
    assert e1 == 1
    co.publish(e1, {"x": np.arange(2)}, 2)
    os.makedirs(co.store.epoch_dir(7), exist_ok=True)
    co.store.write_intent(2, 1, 999, run_id="e0-stale")
    co2 = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    e2, p2 = co2.agree_position(4)
    assert (e2, p2) == (2, 4)
    co3 = Coordinator(str(tmp_path), HostIdentity(0, 2),
                      _cfg(barrier_timeout=0.8))
    with pytest.raises(CoordinationError, match="incomplete"):
        co3.agree_position(6)


def test_reattempted_epoch_converges_over_stale_records(tmp_path):
    _committed_two_host_store(tmp_path, position=8)
    store = CheckpointStore(str(tmp_path))
    man = store.read_manifest()
    run_id = f"e{man['epoch']}-{man['wall_time']}"
    for h, pos in ((0, 99), (1, 98), (2, 97)):
        store.write_intent(2, h, pos, run_id=run_id)
        store.write_prepared(2, h, pos, run_id=run_id)
    out = {}
    # The hosts restart together (the protocol's restart-time
    # coordination): each scrubs its own leftovers before any host
    # barriers. A thread started late on a loaded box would otherwise
    # read as a host that restarted long after its peer, whose stale
    # intent the peer's barrier takes as fresh.
    restarted = threading.Barrier(2)

    def body(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), _cfg())
        _, pos, _ = co.recover(like={"x": np.zeros(4, dtype=np.int64)})
        restarted.wait(timeout=30)
        epoch, agreed = co.agree_position(pos + 4)
        man2 = co.publish(
            epoch, {"x": np.arange(4, dtype=np.int64)}, agreed
        )
        out[k] = (epoch, agreed, man2["position"])

    _run_hosts(2, body)
    assert out[0] == out[1] == (2, 12, 12)


def test_prune_keeps_committed_window(tmp_path):
    store = CheckpointStore(str(tmp_path))
    for e in (1, 2, 3, 4, 5):
        os.makedirs(store.epoch_dir(e), exist_ok=True)
    store.prune(committed=5, keep=2)
    assert store.list_epochs() == [4, 5]


# ---------------------------------------------------------------------- #
# recover: re-join + the degradation rung


def _committed_two_host_store(tmp_path, position=8, mod=coord_mod):
    def body(k):
        co = mod.Coordinator(str(tmp_path), mod.HostIdentity(k, 2),
                             _cfg(mod))
        epoch, agreed = co.agree_position(position)
        co.publish(
            epoch, {"x": np.arange(4, dtype=np.int64) * (k + 1)}, agreed
        )

    _run_hosts(2, body)


def test_rejoin_loads_own_shard_at_barrier_position(tmp_path):
    _committed_two_host_store(tmp_path)
    with obs_bus.scope() as bus:
        co = Coordinator(str(tmp_path), HostIdentity(1, 2), _cfg())
        state, pos, _meta = co.recover(
            like={"x": np.zeros(4, dtype=np.int64)}
        )
    assert pos == 8
    np.testing.assert_array_equal(state["x"], np.arange(4) * 2)
    assert bus.snapshot()["counters"]["coordination.rejoins"] == 1


def test_degraded_rejoin_adopts_orphan_shards(tmp_path):
    _committed_two_host_store(tmp_path)
    events = []
    with obs_bus.scope() as bus:
        bus.subscribe(lambda name, f: events.append((name, f)))
        co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
        state, pos, _meta = co.recover(
            like={"x": np.zeros(4, dtype=np.int64)},
            adopt=lambda a, b: {"x": a["x"] + b["x"]},
        )
    assert pos == 8
    np.testing.assert_array_equal(state["x"], np.arange(4) * 3)
    degr = [f for name, f in events if name == "coordination.degradations"]
    assert len(degr) == 1
    assert degr[0]["previous_process_count"] == 2
    assert degr[0]["process_count"] == 1
    assert degr[0]["adopted"] == [1]
    assert degr[0]["capacity_frac"] == 0.5


def test_degraded_rejoin_without_adopt_refuses(tmp_path):
    _committed_two_host_store(tmp_path)
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    with pytest.raises(CoordinationError, match="adopt"):
        co.recover(like={"x": np.zeros(4, dtype=np.int64)})


def test_recover_rejects_mixed_epoch(tmp_path):
    _committed_two_host_store(tmp_path)
    store = CheckpointStore(str(tmp_path))
    man = store.read_manifest()
    os.unlink(store.shard_path(man["epoch"], 1, man["position"]))
    co = Coordinator(str(tmp_path), HostIdentity(0, 2), _cfg())
    with pytest.raises(MixedEpochError):
        co.recover(like={"x": np.zeros(4, dtype=np.int64)})


# ---------------------------------------------------------------------- #
# fault injection inside the protocol (the "barrier" boundary)


@pytest.mark.faults
def test_barrier_fault_raises_inside_agree(tmp_path):
    plan = faults.FaultPlan([faults.Fault("barrier", at=0)])
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    with faults.install(plan):
        with pytest.raises(faults.FaultInjected):
            co.agree_position(3)
    assert ("barrier", 0, "raise") in plan.fired


@pytest.mark.faults
def test_barrier_hang_is_caught_by_watchdog(tmp_path):
    plan = faults.FaultPlan([
        faults.Fault("barrier", at=0, kind="hang", hang_seconds=5.0),
    ])
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    wd = Watchdog(0.3)
    with faults.install(plan):
        with pytest.raises(WatchdogTimeout):
            wd.call(lambda: co.agree_position(3), "barrier")


@pytest.mark.faults
def test_barrier_corrupt_fault_tears_manifest(tmp_path):
    # single host: barrier indices are 0=agree, 1=publish, 2=post-commit
    plan = faults.FaultPlan([
        faults.Fault("barrier", at=2, kind="corrupt"),
    ])
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    with faults.install(plan):
        epoch, agreed = co.agree_position(5)
        co.publish(epoch, {"x": np.arange(2)}, agreed)
    assert ("barrier", 2, "corrupt") in plan.fired
    with pytest.raises(ManifestCorruptError):
        CheckpointStore(str(tmp_path)).read_manifest()


def _degree_stream(edges_fn):
    rng = np.random.default_rng(5)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 32, (64, 2))]
    return edges_fn(edges)


@pytest.mark.faults
def test_collective_boundary_fires_at_window_merge():
    """The cross-shard window-close merge is a fault boundary: a seeded
    plan raises inside the engine's merge (``gelly_tpu``'s default mesh
    in the test harness has 8 shards; so does this one)."""
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.library.degrees import degree_aggregate
    from gelly_torch.parallel.mesh import make_mesh

    stream = _degree_stream(lambda e: t_edges(
        e, vertex_capacity=32, chunk_size=16, device="cpu"))
    plan = faults.FaultPlan([faults.Fault("collective", at=0)])
    with faults.install(plan):
        with pytest.raises(faults.FaultInjected):
            run_aggregation(
                degree_aggregate(32), stream, merge_every=2,
                mesh=make_mesh(8, devices=["cpu"] * 8),
            ).result()
    assert ("collective", 0, "raise") in plan.fired


# ---------------------------------------------------------------------- #
# coordinated ResilientRunner (threads = in-process hosts)


def _add_step(s, chunk):
    return s + np.int64(chunk), None


def test_coordinated_runner_end_to_end_and_resume(tmp_path):
    finals = {}

    def body(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), _cfg())
        r = ResilientRunner(
            _add_step, list(range(k * 100, k * 100 + 10)), np.int64(0),
            coordinator=co, config=_fast(),
        )
        finals[k] = (int(r.run()), r.stats["checkpoints"])

    _run_hosts(2, body)
    assert finals[0] == (sum(range(10)), 3)          # 4, 8, final 10
    assert finals[1] == (sum(range(100, 110)), 3)
    man = CheckpointStore(str(tmp_path)).read_manifest()
    assert man["position"] == 10 and man["process_count"] == 2

    def body2(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), _cfg())
        r = ResilientRunner(
            _add_step, list(range(k * 100, k * 100 + 10)), np.int64(0),
            coordinator=co, config=_fast(),
        )
        finals[k] = (int(r.run()), r.stats["chunks"],
                     r.stats["resumed_from"])

    _run_hosts(2, body2)
    for k in (0, 1):
        total, chunks, resumed_from = finals[k]
        assert total == sum(range(k * 100, k * 100 + 10))
        assert chunks == 0  # nothing re-folded
        assert resumed_from and resumed_from.endswith("MANIFEST.json")


def test_coordinated_runner_rejects_checkpoint_dir(tmp_path):
    co = Coordinator(str(tmp_path / "store"), HostIdentity(0, 1), _cfg())
    jco = jcoord.Coordinator(str(tmp_path / "jstore"),
                             jcoord.HostIdentity(0, 1), _cfg(jcoord))
    with pytest.raises(ValueError, match="not both") as te:
        ResilientRunner(
            _add_step, [1, 2], np.int64(0), coordinator=co,
            checkpoint_dir=str(tmp_path / "local"),
        )
    with pytest.raises(ValueError) as je:
        jres.ResilientRunner(
            _add_step, [1, 2], np.int64(0), coordinator=jco,
            checkpoint_dir=str(tmp_path / "jlocal"),
        )
    assert str(te.value) == str(je.value)


def test_coordinated_runner_unequal_partitions_fail_loudly(tmp_path):
    cfg = _cfg(barrier_timeout=2.0)
    errs = {}

    def body(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), cfg)
        r = ResilientRunner(
            _add_step, list(range(8 if k == 0 else 10)), np.int64(0),
            coordinator=co,
            config=_fast(checkpoint_every_chunks=100),
        )
        try:
            r.run()
        except CoordinationError as e:
            errs[k] = str(e)

    _run_hosts(2, body)
    assert errs, "at least one host must observe the skew"
    assert any("equal chunk counts" in v or "incomplete" in v
               for v in errs.values())


def test_degraded_runner_continues_at_reduced_capacity(tmp_path):
    def body(k):
        co = Coordinator(str(tmp_path), HostIdentity(k, 2), _cfg())
        ResilientRunner(
            _add_step, [k * 10 + i for i in range(8)], np.int64(0),
            coordinator=co, config=_fast(),
        ).run()

    _run_hosts(2, body)
    man = CheckpointStore(str(tmp_path)).read_manifest()
    assert man["position"] == 8
    events = []
    reshards = []
    with obs_bus.scope() as bus:
        bus.subscribe(lambda name, f: events.append((name, f)))
        co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
        r = ResilientRunner(
            _add_step, lambda pos: iter(range(100, 100 + 12 - pos)),
            np.int64(0), coordinator=co, config=_fast(),
            adopt_state=lambda a, b: a + b,
            reshard_source=lambda old, new: reshards.append((old, new)),
        )
        final = int(r.run())
    both = sum(i for i in range(8)) + sum(10 + i for i in range(8))
    assert final == both + sum(range(100, 104))
    assert reshards == [(2, 1)]
    degr = [f for name, f in events
            if name == "coordination.degradations"]
    assert len(degr) == 1 and degr[0]["capacity_frac"] == 0.5
    man2 = CheckpointStore(str(tmp_path)).read_manifest()
    assert man2["position"] == 12 and man2["process_count"] == 1


# ---------------------------------------------------------------------- #
# atomic checkpoint publish: rotation can never strand zero valid files


@pytest.mark.faults
def test_rotation_never_prunes_fallback_of_torn_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_write=False)
    mgr.save(np.int64(10), 4)
    plan = faults.FaultPlan([
        faults.Fault("checkpoint_corrupt", at=0, count=100,
                     kind="corrupt"),
    ])
    with obs_bus.scope() as bus:
        with faults.install(plan):
            mgr.save(np.int64(20), 8)
    files = [os.path.basename(p) for p in mgr.list()]
    assert "ckpt-000000000004.npz" in files  # fallback survived
    state, pos, _, path = mgr.load_latest(like=np.int64(0))
    assert pos == 4 and int(state) == 10
    assert bus.snapshot()["counters"]["resilience.rotation_skipped"] == 1


def test_save_checkpoint_fsyncs_before_rename(tmp_path, monkeypatch):
    from gelly_torch.engine.checkpoint import save_checkpoint

    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd))
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, np.arange(4), position=1)
    assert len(synced) >= 1  # file fsync (dir fsync is best-effort)
    monkeypatch.setattr(os, "fsync", real_fsync)
    synced.clear()
    save_checkpoint(path, np.arange(4), position=2, fsync=False)
    assert synced == []


# ---------------------------------------------------------------------- #
# the cadenced path flatten


def _chain_depth_stream(n_pairs):
    """Chunks that force union_pairs_rooted chase depth to grow: each
    union hangs a deep tree one level deeper."""
    from gelly_torch.core.chunk import make_chunk

    return [
        make_chunk(np.array([2 ** (level + 1)], np.int64),
                   np.array([2 ** level], np.int64), capacity=1,
                   device="cpu")
        for level in range(n_pairs - 1, -1, -1)
    ]


def test_flatten_state_bounds_chase_depth_bit_identical(tmp_path):
    from gelly_torch.ops import unionfind

    cap = 64
    chunks = _chain_depth_stream(5)

    def step(p, c):
        return unionfind.union_pairs_rooted(p, c.src, c.dst, c.valid), None

    def run(flatten, ckpt_dir):
        r = ResilientRunner(
            step, chunks, lambda: unionfind.fresh_forest(cap, CPU),
            checkpoint_dir=ckpt_dir, config=_fast(),
            flatten_state=flatten,
        )
        return r, r.run()

    _, plain = run(None, None)
    assert unionfind.chase_depth(plain) > 2  # the test actually bites

    depths = []

    def spy_flatten(p):
        out = unionfind.pointer_jump(p)
        depths.append(unionfind.chase_depth(out))
        return out

    r2, flat = run(spy_flatten, str(tmp_path))
    assert depths and max(depths) <= 2
    assert unionfind.chase_depth(flat) <= 2
    labels_a = unionfind.pointer_jump(plain).numpy()
    labels_b = unionfind.pointer_jump(flat).numpy()
    assert labels_a.tobytes() == labels_b.tobytes()
    state, _, _ = load_checkpoint(r2.manager.list()[-1])
    assert unionfind.chase_depth(torch.from_numpy(state[0])) <= 2


def test_engine_flatten_at_checkpoint_cadence(tmp_path):
    from gelly_torch.engine.aggregation import (
        SummaryAggregation,
        run_aggregation,
    )
    from gelly_torch.ops import unionfind
    from gelly_torch.parallel import mesh as mesh_lib

    cap = 64
    chunks = _chain_depth_stream(5)

    def mk_agg(flatten):
        return SummaryAggregation(
            init=lambda device: unionfind.fresh_forest(cap, device),
            fold=lambda p, c: unionfind.union_pairs_rooted(
                p, c.src, c.dst, c.valid
            ),
            combine=unionfind.merge_forests,
            transform=None,
            fold_accumulates=True,
            flatten=flatten,
            name="chain-uf",
        )

    mesh = mesh_lib.make_mesh(1, devices=["cpu"])
    plain = run_aggregation(
        mk_agg(None), list(chunks), mesh=mesh, merge_every=1,
    ).result()
    assert unionfind.chase_depth(plain) > 2

    ckpt = str(tmp_path / "flat.npz")
    flat = run_aggregation(
        mk_agg(unionfind.pointer_jump), list(chunks), mesh=mesh,
        merge_every=1, checkpoint_path=ckpt, checkpoint_every=2,
    ).result()
    state, _, _ = load_checkpoint(ckpt)
    assert unionfind.chase_depth(torch.from_numpy(state[0])) <= 2
    labels_a = unionfind.pointer_jump(plain).numpy()
    labels_b = unionfind.pointer_jump(flat).numpy()
    assert labels_a.tobytes() == labels_b.tobytes()


def test_cc_plans_supply_flatten():
    from gelly_torch.ops import unionfind

    agg = tcc.connected_components(64)
    assert agg.flatten is not None
    deep = unionfind.fresh_forest(64, CPU)
    deep[torch.tensor([3, 2, 1])] = torch.tensor([2, 1, 0],
                                                 dtype=torch.int32)
    flat = agg.flatten(tcc.CCSummary(parent=deep,
                                     seen=torch.zeros(64, dtype=torch.bool)))
    assert unionfind.chase_depth(flat.parent) <= 1
    compact = tcc.connected_components(1 << 21, codec="compact")
    assert compact.flatten is not None


# ---------------------------------------------------------------------- #
# host identity on heartbeat lines + exported traces


def test_heartbeat_lines_carry_host_identity(tmp_path):
    from gelly_torch.obs.heartbeat import Heartbeat

    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    try:
        hb = Heartbeat(every_s=0)
        assert hb.tick(position=7)
        line = hb.lines[-1]
        assert line["process_index"] == 0
        assert line["process_count"] == 1
        assert "coordinator_address" in line
        assert line["leader"] is True  # active coordinator, sole host
        assert line["position"] == 7
    finally:
        co.close()
    hb2 = Heartbeat(every_s=0)
    assert hb2.tick(position=8)
    assert "leader" not in hb2.lines[-1]  # no coordinator active


def test_chrome_trace_otherdata_carries_host_identity(tmp_path):
    from gelly_torch.obs.export import to_chrome_trace, validate_chrome_trace
    from gelly_torch.obs.tracing import SpanTracer

    tr = SpanTracer(capacity=16)
    tr.span("fold", "fold", tr.now(), unit=0)
    co = Coordinator(str(tmp_path), HostIdentity(0, 1), _cfg())
    try:
        trace = to_chrome_trace(tr)
    finally:
        co.close()
    validate_chrome_trace(trace)
    host = trace["otherData"]["host"]
    assert host["process_index"] == 0
    assert host["process_count"] == 1
    assert "coordinator_address" in host
    assert host["leader"] is True


# ---------------------------------------------------------------------- #
# concurrency: LeaseBoard.beat from the lease thread AND protocol paths


@pytest.mark.racecheck
def test_lease_beat_concurrent_force_beats_lose_no_updates(tmp_path):
    store = CheckpointStore(str(tmp_path))
    board = LeaseBoard(store, host=0, ttl=5.0)
    n_threads, per_thread = 8, 25

    def hammer():
        for _ in range(per_thread):
            assert board.beat(force=True)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert board.beats == n_threads * per_thread
    assert board.wall(0) is not None
    assert not board.expired(0)


@pytest.mark.racecheck
def test_lease_beat_rate_limit_still_rate_limits(tmp_path):
    now = [100.0]
    board = LeaseBoard(CheckpointStore(str(tmp_path)), host=0, ttl=3.0,
                       clock=lambda: now[0])
    assert board.beat()            # first write
    assert not board.beat()        # inside ttl/3
    now[0] += 1.01                 # past ttl/3 = 1.0
    assert board.beat()
    assert board.beats == 2


# ---------------------------------------------------------------------- #
# across the packages


N_V = 64
CHUNK = 16
HOST_EDGES = 192  # 12 chunks a host


def _host_edges(k):
    rng = np.random.default_rng(40 + k)
    return [(int(a), int(b)) for a, b in rng.integers(0, N_V,
                                                       (HOST_EDGES, 2))]


class _Pkg:
    """One package's handles for the same coordinated CC run."""

    def __init__(self, torch_side: bool):
        self.torch = torch_side
        self.coord = coord_mod if torch_side else jcoord
        self.res = None if torch_side else jres
        self.runner = ResilientRunner if torch_side else jres.ResilientRunner
        self.faults = faults if torch_side else jfaults
        self.bus = obs_bus if torch_side else jbus
        if torch_side:
            agg = tcc.connected_components(N_V)
            self.init = lambda: agg.init(CPU)
            self.fold = agg.fold
            self.flatten = agg.flatten
            self.combine = agg.combine
        else:
            agg = jcc.connected_components(N_V)
            self.init = agg.init
            self.fold = jax.jit(agg.fold)
            self.flatten = jax.jit(agg.flatten)
            self.combine = jax.jit(agg.combine)

    def stream(self, k):
        if self.torch:
            return t_edges(_host_edges(k), vertex_capacity=N_V,
                           chunk_size=CHUNK, device="cpu")
        return j_edges(_host_edges(k), vertex_capacity=N_V,
                       chunk_size=CHUNK)

    def leaves(self, state):
        return [np.asarray(x) for x in state]

    def run_hosts(self, root, n=2, cadence=4):
        """Coordinated runs of every host (threads); the final states."""
        finals = {}

        def body(k):
            co = self.coord.Coordinator(
                root, self.coord.HostIdentity(k, n), _cfg(self.coord))
            r = self.runner(
                lambda s, c: (self.fold(s, c), None), self.stream(k),
                self.init, coordinator=co,
                config=_fast(self.res, checkpoint_every_chunks=cadence),
                flatten_state=self.flatten, adopt_state=self.combine,
            )
            finals[k] = self.leaves(r.run())

        _run_hosts(n, body)
        return finals

    def recover(self, root, k, n=2):
        co = self.coord.Coordinator(
            root, self.coord.HostIdentity(k, n), _cfg(self.coord))
        try:
            state, pos, _ = co.recover(like=self.init())
        finally:
            co.close()
        return self.leaves(state), pos


@pytest.mark.parametrize("writer", ["gelly_tpu", "gelly_torch"])
def test_store_recovers_across_packages_bit_equal(tmp_path, writer):
    """A store written by one package's coordinated hosts is recovered
    by the other's at the same position, every shard leaf bit-equal to
    what the writer's own recover loads and to the writer's final
    state."""
    w = _Pkg(writer == "gelly_torch")
    r = _Pkg(writer != "gelly_torch")
    root = str(tmp_path / "store")
    finals = w.run_hosts(root)
    for k in (0, 1):
        mine, pos_w = w.recover(root, k)
        theirs, pos_r = r.recover(root, k)
        assert pos_w == pos_r == HOST_EDGES // CHUNK
        assert len(mine) == len(theirs) == len(finals[k])
        for a, b, f in zip(mine, theirs, finals[k]):
            assert a.dtype == b.dtype == f.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes() == f.tobytes()


def _scrub(fields: dict) -> dict:
    return {k: v for k, v in fields.items()
            if k not in ("t_wall", "wall_time", "run_id")}


def _events_of(pkg, root, plan_faults):
    """One single-host coordinated run under a plan: (error text, fired,
    coordination.* / faults.injected events, final leaves or None)."""
    events = []
    plan = pkg.faults.FaultPlan(plan_faults(pkg.faults))
    err = None
    final = None
    with pkg.bus.scope() as bus:
        bus.subscribe(lambda name, f: events.append((name, _scrub(f))))
        with pkg.faults.install(plan):
            co = pkg.coord.Coordinator(
                root, pkg.coord.HostIdentity(0, 1), _cfg(pkg.coord))
            r = pkg.runner(
                lambda s, c: (pkg.fold(s, c), None), pkg.stream(0),
                pkg.init, coordinator=co,
                config=_fast(pkg.res, checkpoint_every_chunks=4),
                flatten_state=pkg.flatten,
            )
            try:
                final = pkg.leaves(r.run())
            except Exception as e:  # noqa: BLE001 — compared below
                err = f"{type(e).__name__}: {e}".replace(root, "<store>")
                # A torn manifest's decode error names where the cut fell,
                # which follows the length of its wall-clock stamps.
                err = re.sub(r"line \d+ column \d+ \(char \d+\)",
                             "<where>", err)
    kept = [(n, f) for n, f in events
            if n.startswith("coordination.") or n == "faults.injected"]
    return err, list(plan.fired), kept, final


PLANS = {
    "none": lambda f: [],
    "barrier-0": lambda f: [f.Fault("barrier", at=0)],
    "barrier-1": lambda f: [f.Fault("barrier", at=1)],
    "barrier-4": lambda f: [f.Fault("barrier", at=4)],
    "barrier-7": lambda f: [f.Fault("barrier", at=7)],
    "torn-manifest": lambda f: [f.Fault("barrier", at=5, kind="corrupt")],
    "step-retried": lambda f: [f.Fault("step", at=5)],
}


@pytest.mark.faults
@pytest.mark.parametrize("name", sorted(PLANS))
def test_same_plan_same_fired_events_and_store(tmp_path, name):
    """The same coordinated run under the same plan: equal fired records,
    equal coordination bus events, equal errors, equal final states, and
    stores holding the same files — manifests equal apart from times,
    rendezvous records apart from times and run ids, shard leaves bit for
    bit."""
    roots = {}
    got = {}
    for side in ("gelly_tpu", "gelly_torch"):
        pkg = _Pkg(side == "gelly_torch")
        roots[side] = str(tmp_path / side)
        got[side] = _events_of(pkg, roots[side], PLANS[name])
    (je, jf, jev, jfin), (te, tf, tev, tfin) = (
        got["gelly_tpu"], got["gelly_torch"])
    assert te == je
    assert tf == jf
    assert tev == jev
    if jfin is None:
        assert tfin is None
    else:
        assert [x.tobytes() for x in tfin] == [x.tobytes() for x in jfin]
    files = {}
    for side, root in roots.items():
        files[side] = sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs)
    assert files["gelly_torch"] == files["gelly_tpu"]
    for rel in files["gelly_tpu"]:
        a = os.path.join(roots["gelly_tpu"], rel)
        b = os.path.join(roots["gelly_torch"], rel)
        if rel.endswith(".npz"):
            la, pa, ma = load_checkpoint(a)
            lb, pb, mb = load_checkpoint(b)
            assert pa == pb and _scrub(ma) == _scrub(mb)
            assert [x.tobytes() for x in la] == [x.tobytes() for x in lb]
        elif rel.startswith("members"):
            continue  # lease files: beat counts and clocks
        else:
            with open(a) as fa, open(b) as fb:
                try:
                    ja, jb = json.load(fa), json.load(fb)
                except json.JSONDecodeError:
                    continue  # the torn manifest of a corrupt fault
            assert _scrub(ja) == _scrub(jb), rel


@pytest.mark.faults
@pytest.mark.parametrize("at", [0, 1, 2])
@pytest.mark.parametrize("kind", ["merger", "pane-ring"])
def test_collective_fault_fires_at_the_same_close(kind, at):
    """``Fault("collective", at=k)`` raises at the same close in both
    packages: the k-th window merge of a Merger plan (a transient degree
    plan on one shard) and the k-th pane close of a pane ring; both
    packages emit the same windows before it."""
    from gelly_torch.engine.aggregation import run_aggregation as t_run
    from gelly_torch.library.degrees import degree_aggregate as t_deg
    from gelly_torch.parallel.mesh import make_mesh as t_mesh
    from gelly_tpu.engine.aggregation import run_aggregation as j_run
    from gelly_tpu.library.degrees import degree_aggregate as j_deg
    from gelly_tpu.parallel.mesh import make_mesh as j_mesh

    rng = np.random.default_rng(7)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 32, (128, 2))]
    out = {}
    for side in ("gelly_tpu", "gelly_torch"):
        torch_side = side == "gelly_torch"
        fmod = faults if torch_side else jfaults
        if kind == "merger":
            agg = (t_deg if torch_side else j_deg)(32)
            agg.transient = True
            knobs = {"merge_every": 2}
        else:
            agg = (tcc.connected_components(32, codec="dense", windowed=2)
                   if torch_side else
                   jcc.connected_components(32, codec="dense", windowed=2))
            knobs = {"merge_every": 2}
        stream = (t_edges(edges, vertex_capacity=32, chunk_size=16,
                          device="cpu") if torch_side else
                  j_edges(edges, vertex_capacity=32, chunk_size=16))
        mesh = (t_mesh(1, devices=["cpu"]) if torch_side else j_mesh(1))
        run = t_run if torch_side else j_run
        plan = fmod.FaultPlan([fmod.Fault("collective", at=at)])
        emitted = []
        with fmod.install(plan):
            with pytest.raises(fmod.FaultInjected) as ei:
                for x in run(agg, stream, mesh=mesh, **knobs):
                    emitted.append(x)
        out[side] = (list(plan.fired), str(ei.value), len(emitted))
    assert out["gelly_torch"] == out["gelly_tpu"]
    assert out["gelly_torch"][0] == [("collective", at, "raise")]
    assert out["gelly_torch"][2] == at
