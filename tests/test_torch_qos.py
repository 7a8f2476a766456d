"""gelly_torch's QoS policy plane and its engine wiring vs gelly_tpu's (CPU).

Mirrors ``tests/test_qos.py`` on the port: the controller alone under an
injected clock (DRR grants, the token bucket, the ladder), then the port's
``MultiTenantEngine`` with a stubbed backlog signal through weighted fair
share, admission control, park / un-park / shed and the ``on_qos`` hooks,
every tenant bit-identical to its single-stream port run. Cross-package:
one seeded sequence of ``plan_round`` and ``evaluate`` calls gives the same
grants, actions, states and counts in both controllers. The kill -9 case is
``tests/_qos_crash_child.py``'s scenario without the wire (which is ported
with the ingest slice): a degree tier with per-tenant checkpoints, fed in
push mode from each tenant's resume position, killed once every tenant has
a checkpoint and resumed; the degrees (a non-idempotent count) equal the
unkilled run's and ``np.bincount``'s.

Child: ``python tests/test_torch_qos.py <ckpt_dir> <out.npz> <sleep_s>``
with the repository root on ``PYTHONPATH``. Tolerance: none.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_V = 128
CHUNK = 32
CHILD_TENANTS = 3
CHILD_NV = 96
CHILD_CHUNK = 16
CHILD_CHUNKS = 24


def _edges(seed: int, n_edges: int = 96, n_v: int = N_V):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n_v, (n_edges, 2))
    return [(int(a), int(b)) for a, b in pairs]


def _child_edges(tid: int) -> np.ndarray:
    rng = np.random.default_rng(100 + tid)
    return rng.integers(0, CHILD_NV, (CHILD_CHUNKS * CHILD_CHUNK, 2))


def child(ckpt_dir: str, out: str, sleep_s: float) -> None:
    """The kill -9 child: a degree tier over CHILD_TENANTS push-mode
    tenants, checkpointed every window and resumed, each tenant fed from
    its own resume position."""
    from gelly_torch import IdentityVertexTable, edge_stream_from_edges
    from gelly_torch.engine.checkpoint import save_checkpoint
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library.degrees import degree_aggregate

    eng = MultiTenantEngine(merge_every=2, checkpoint_dir=ckpt_dir,
                            checkpoint_every=1, resume=True, device="cpu")
    eng.add_tier("deg", degree_aggregate(CHILD_NV, ingest_combine=False),
                 CHILD_CHUNK)
    for tid in range(CHILD_TENANTS):
        eng.admit(tid, "deg")
    chunks = {tid: list(edge_stream_from_edges(
        [(int(a), int(b)) for a, b in _child_edges(tid)],
        vertex_capacity=CHILD_NV, chunk_size=CHILD_CHUNK,
        table=IdentityVertexTable(CHILD_NV), device="cpu"))
        for tid in range(CHILD_TENANTS)}
    base = {tid: eng.position(tid) for tid in range(CHILD_TENANTS)}
    eng.start()
    try:
        for k in range(CHILD_CHUNKS):
            for tid in range(CHILD_TENANTS):
                if k >= base[tid]:  # push mode replays from the resume
                    eng.submit(tid, chunks[tid][k])
            if sleep_s:
                time.sleep(sleep_s)
        for tid in range(CHILD_TENANTS):
            eng.finish(tid)
        deadline = time.time() + 120
        while time.time() < deadline and not all(
                row["done"] for row in eng.telemetry().values()):
            time.sleep(0.01)
        time.sleep(0.3)  # an idle round flushes the last partial window
    finally:
        eng.stop()
    rows = [np.asarray(eng.degree(t)) for t in range(CHILD_TENANTS)]
    save_checkpoint(out, rows,
                    position=sum(eng.position(t)
                                 for t in range(CHILD_TENANTS)))


if __name__ == "__main__":
    child(sys.argv[1], sys.argv[2], float(sys.argv[3]))
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

from gelly_torch import edge_stream_from_edges  # noqa: E402
from gelly_torch.engine.checkpoint import load_checkpoint  # noqa: E402
from gelly_torch.engine.qos import (  # noqa: E402
    QOS_LIMITED,
    QOS_OK,
    QOS_PARKED,
    QOS_SHED,
    AdmissionRefused,
    QosController,
    QosPolicy,
)
from gelly_torch.engine.tenants import MultiTenantEngine  # noqa: E402
from gelly_torch.library.connected_components import (  # noqa: E402
    connected_components,
)
from gelly_torch.obs import bus as obs_bus  # noqa: E402
from gelly_tpu.engine import qos as jqos  # noqa: E402

pytestmark = pytest.mark.tenants


def _stream(seed: int, n_edges: int = 96, n_v: int = N_V,
            chunk: int = CHUNK):
    return edge_stream_from_edges(
        _edges(seed, n_edges, n_v), vertex_capacity=n_v, chunk_size=chunk,
        device="cpu",
    )


def _cc_plan(n_v: int = N_V):
    return connected_components(n_v, merge="gather", ingest_combine=False)


def _engine(**kw):
    return MultiTenantEngine(device="cpu", **kw)


def _oracle(seed, n_edges=96, cc=None):
    cc = cc if cc is not None else _cc_plan()
    return _stream(seed, n_edges=n_edges).aggregate(
        cc, merge_every=1).result().numpy()


def _wait(pred, timeout=20.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# --------------------------------------------------------------------- #
# policy validation


def test_policy_validation_rejects_nonsense():
    with pytest.raises(ValueError, match="weight"):
        QosPolicy(weight=0)
    with pytest.raises(ValueError, match="rate_limit_cps"):
        QosPolicy(rate_limit_cps=-5)
    with pytest.raises(ValueError, match="backlog_budget_s"):
        QosPolicy(backlog_budget_s=0)
    with pytest.raises(ValueError, match="limit_after"):
        QosPolicy(limit_after=0)
    with pytest.raises(ValueError, match="limited_weight_factor"):
        QosPolicy(limited_weight_factor=0)
    with pytest.raises(ValueError, match="limited_weight_factor"):
        QosPolicy(limited_weight_factor=1.5)
    with pytest.raises(ValueError, match="shed_queue_depth"):
        QosPolicy(shed_queue_depth=0)
    with pytest.raises(ValueError, match="burst"):
        QosPolicy(burst=0.5)
    with pytest.raises(ValueError, match="unpark_grace_s"):
        QosPolicy(unpark_grace_s=-1)


def test_unpark_threshold_defaults_to_half_budget():
    assert QosPolicy(backlog_budget_s=2.0).unpark_threshold() == 1.0
    assert QosPolicy(backlog_budget_s=2.0,
                     unpark_below_s=0.3).unpark_threshold() == 0.3
    assert QosPolicy().unpark_threshold() is None


def test_controller_validation():
    with pytest.raises(ValueError, match="admission"):
        QosController(admission="drop")
    with pytest.raises(ValueError, match="admission_ceiling_s"):
        QosController(admission_ceiling_s=0)
    qos = QosController()
    with pytest.raises(TypeError, match="QosPolicy"):
        qos.set_policy("t", {"weight": 2})
    qos.set_policy("t", QosPolicy(weight=2))
    assert qos.policy_for("t").weight == 2
    assert qos.policy_for("unknown") is qos.default
    assert qos.state("never-seen") == QOS_OK


# --------------------------------------------------------------------- #
# deficit-round-robin fairness


def test_drr_grants_follow_weights_exactly():
    clk = [0.0]
    qos = QosController(
        per_tenant={
            "a": QosPolicy(weight=1),
            "b": QosPolicy(weight=2),
            "c": QosPolicy(weight=4),
        },
        clock=lambda: clk[0],
    )
    R = 400
    grants = {"a": 0, "b": 0, "c": 0}
    for _ in range(R):
        clk[0] += 0.01
        for tid in qos.plan_round(["a", "b", "c"]):
            grants[tid] += 1
    assert grants["c"] == R
    for tid, w in (("a", 1), ("b", 2), ("c", 4)):
        assert grants[tid] >= (R * w) // 4 - 1
        assert grants[tid] <= (R * w) // 4 + 1


def test_drr_credit_carries_but_never_banks_unbounded():
    clk = [0.0]
    qos = QosController(
        per_tenant={"lo": QosPolicy(weight=1), "hi": QosPolicy(weight=4)},
        clock=lambda: clk[0],
    )
    lo = 0
    for _ in range(40):
        clk[0] += 0.01
        lo += "lo" in qos.plan_round(["lo", "hi"])
    assert lo == 10
    for _ in range(100):
        clk[0] += 0.01
        qos.plan_round(["hi"])
    burst = sum(
        "lo" in qos.plan_round(["lo", "hi"]) for _ in range(8)
    )
    assert burst <= 3


def test_token_bucket_caps_rate():
    clk = [0.0]
    qos = QosController(
        per_tenant={"t": QosPolicy(rate_limit_cps=10, burst=2)},
        clock=lambda: clk[0],
    )
    granted = 0
    for _ in range(100):  # 1 simulated second
        clk[0] += 0.01
        granted += len(qos.plan_round(["t"]))
    assert 10 <= granted <= 13


def test_parked_and_shed_tenants_never_granted():
    clk = [0.0]
    pol = QosPolicy(backlog_budget_s=1.0, limit_after=1, park_after=1,
                    shed_queue_depth=2)
    qos = QosController(default=pol, clock=lambda: clk[0])
    ev = lambda **kw: qos.evaluate("t", **kw)  # noqa: E731
    assert ev(backlog_age_s=5, queue_depth=0,
              active_backlog_max_s=5) == "limit"
    assert ev(backlog_age_s=5, queue_depth=0,
              active_backlog_max_s=5) == "park"
    assert qos.plan_round(["t"]) == set()
    assert ev(backlog_age_s=5, queue_depth=3,
              active_backlog_max_s=5) == "shed"
    assert qos.plan_round(["t"]) == set()
    assert qos.state("t") == QOS_SHED
    assert ev(backlog_age_s=0, queue_depth=0,
              active_backlog_max_s=0) is None


# --------------------------------------------------------------------- #
# the degradation ladder


def test_ladder_limit_park_unpark_grace_and_clear():
    clk = [0.0]
    pol = QosPolicy(backlog_budget_s=1.0, limit_after=2, park_after=2,
                    unpark_below_s=0.5, unpark_grace_s=5.0)
    qos = QosController(default=pol, clock=lambda: clk[0])

    def ev(age, depth=0, amax=None):
        return qos.evaluate(
            "t", backlog_age_s=age, queue_depth=depth,
            active_backlog_max_s=age if amax is None else amax,
        )

    assert ev(2.0) is None
    assert ev(2.0) == "limit"
    assert qos.state("t") == QOS_LIMITED
    assert ev(0.7) is None
    assert qos.state("t") == QOS_LIMITED
    assert ev(2.0) is None
    assert ev(2.0) == "park"
    assert qos.state("t") == QOS_PARKED
    assert ev(9.0, amax=2.0) is None
    assert ev(9.0, amax=0.1) == "unpark"
    assert qos.state("t") == QOS_LIMITED
    clk[0] += 1.0
    assert ev(9.0) is None
    assert ev(9.0) is None
    assert qos.state("t") == QOS_LIMITED
    clk[0] += 10.0
    assert ev(9.0) is None
    assert ev(9.0) == "park"
    assert ev(9.0, amax=0.0) == "unpark"
    clk[0] += 10.0
    assert ev(0.1) == "clear"
    assert qos.state("t") == QOS_OK


def test_ladder_never_engages_without_budget():
    qos = QosController(default=QosPolicy())
    for _ in range(10):
        assert qos.evaluate("t", backlog_age_s=1e9, queue_depth=10,
                            active_backlog_max_s=1e9) is None
    assert qos.state("t") == QOS_OK


def test_forget_drops_ladder_state():
    pol = QosPolicy(backlog_budget_s=1.0, limit_after=1)
    qos = QosController(default=pol)
    assert qos.evaluate("t", backlog_age_s=5, queue_depth=0,
                        active_backlog_max_s=5) == "limit"
    assert qos.counts()[QOS_LIMITED] == 1
    qos.forget("t")
    assert qos.state("t") == QOS_OK
    assert qos.counts()[QOS_LIMITED] == 0


def test_controllers_agree_across_packages():
    """One seeded sequence of plan_round / evaluate calls under an
    injected clock: the same grants, actions, states and counts in
    gelly_tpu's controller and the port's."""
    rng = np.random.default_rng(7)
    tids = ["a", "b", "c", "d"]

    def make(mod):
        clk = [0.0]
        per = {
            "a": mod.QosPolicy(weight=1, backlog_budget_s=1.0,
                               limit_after=1, park_after=2,
                               unpark_below_s=0.4, unpark_grace_s=0.3,
                               shed_queue_depth=6),
            "b": mod.QosPolicy(weight=3, rate_limit_cps=20, burst=2),
            "c": mod.QosPolicy(weight=2, backlog_budget_s=0.5,
                               limit_after=2, park_after=1,
                               degraded_rate_cps=5),
        }
        return clk, mod.QosController(per_tenant=per, clock=lambda: clk[0],
                                      admission_ceiling_s=2.0)

    (jclk, jc), (tclk, tc) = make(jqos), make(
        __import__("gelly_torch.engine.qos", fromlist=["QosController"]))
    for step in range(600):
        dt = float(rng.uniform(0.0, 0.05))
        jclk[0] += dt
        tclk[0] += dt
        backlogged = [t for t in tids if rng.random() < 0.7]
        assert sorted(jc.plan_round(backlogged)) == \
            sorted(tc.plan_round(backlogged)), step
        if step % 3 == 0:
            amax = float(rng.uniform(0.0, 3.0))
            for t in tids:
                age = float(rng.uniform(0.0, 3.0))
                depth = int(rng.integers(0, 9))
                kw = dict(backlog_age_s=age, queue_depth=depth,
                          active_backlog_max_s=amax)
                assert jc.evaluate(t, **kw) == tc.evaluate(t, **kw), step
        assert jc.states() == tc.states(), step
        assert jc.counts() == tc.counts(), step


# --------------------------------------------------------------------- #
# engine integration: weighted fair share


def test_weighted_fair_share_paces_dispatch_rounds():
    cc = _cc_plan()
    qos = QosController(per_tenant={
        "heavy": QosPolicy(weight=4), "light": QosPolicy(weight=1),
    })
    with obs_bus.scope():
        eng = _engine(merge_every=1, qos=qos)
        eng.add_tier("cc", cc, CHUNK)
        eng.admit("heavy", "cc", chunks=_stream(1, n_edges=256))
        eng.admit("light", "cc", chunks=_stream(2, n_edges=256))
        out = eng.drain()
    assert eng.stats["chunks"] == 16
    assert eng.stats["dispatches"] == 14
    for tid, seed in (("heavy", 1), ("light", 2)):
        want = _oracle(seed, n_edges=256, cc=cc)
        assert out[tid].tobytes() == want.tobytes()


# --------------------------------------------------------------------- #
# engine integration: admission control


def test_admission_refused_over_ceiling():
    cc = _cc_plan()
    qos = QosController(admission_ceiling_s=1.0)
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1, qos=qos)
        eng.add_tier("cc", cc, CHUNK)
        eng._active_backlog_age = lambda: 7.5
        with pytest.raises(AdmissionRefused) as ei:
            eng.admit("t", "cc")
        assert ei.value.tenant_id == "t"
        assert ei.value.backlog_age_s == 7.5
        assert ei.value.ceiling_s == 1.0
        assert bus.counters["qos.admissions_refused"] == 1
        assert "t" not in eng.tenant_ids()
        eng._active_backlog_age = lambda: 0.1
        assert eng.admit("t", "cc") >= 0


def test_admission_queue_resumes_when_pressure_drains():
    cc = _cc_plan()
    qos = QosController(admission_ceiling_s=1.0, admission="queue",
                        eval_every_s=0.01)
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1, qos=qos, poll_s=0.01)
        eng.add_tier("cc", cc, CHUNK)
        eng._active_backlog_age = lambda: 7.5
        assert eng.admit("t", "cc", chunks=_stream(3)) == -1
        assert bus.counters["qos.admissions_queued"] == 1
        with pytest.raises(ValueError, match="already admitted or queued"):
            eng.admit("t", "cc")
        assert "t" not in eng.tenant_ids()
        eng.start()
        try:
            time.sleep(0.2)
            assert "t" not in eng.tenant_ids()
            eng._active_backlog_age = lambda: 0.1
            assert _wait(lambda: "t" in eng.tenant_ids())
            assert _wait(lambda: bus.snapshot()["counters"].get(
                "qos.admissions_resumed", 0) == 1)
            assert _wait(lambda: eng.position("t") == 3)
            want = _oracle(3, cc=cc)
            assert _wait(
                lambda: eng.labels("t") is not None
                and eng.labels("t").tobytes() == want.tobytes()
            )
        finally:
            eng.stop()


# --------------------------------------------------------------------- #
# engine integration: park / un-park / shed end-to-end


def _park_victim(bus, eng, ages, victim="victim", other="other"):
    ages[victim] = 10.0
    ages[other] = 10.0
    assert _wait(lambda: eng.qos_state(victim) == QOS_PARKED)
    assert _wait(lambda: eng._tenants[victim].lane == -1)
    assert bus.counters["qos.parked"] >= 1


def test_park_frees_lane_unpark_restores_bit_identical():
    cc = _cc_plan()
    pol = QosPolicy(backlog_budget_s=0.5, limit_after=1, park_after=1,
                    unpark_below_s=0.25, unpark_grace_s=0.0)
    qos = QosController(default=QosPolicy(), eval_every_s=0.01,
                        per_tenant={"victim": pol})
    with obs_bus.scope() as bus:
        ages = {}
        bus.watermarks.backlog_age = lambda tid: ages.get(tid, 0.0)
        eng = _engine(merge_every=1, qos=qos, poll_s=0.01)
        eng.add_tier("cc", cc, CHUNK)
        eng.admit("victim", "cc")
        eng.admit("other", "cc")
        vic = list(_stream(1, n_edges=256))  # 8 chunks
        oth = list(_stream(2, n_edges=256))
        eng.start()
        try:
            for ch in vic[:2]:
                eng.submit("victim", ch)
            for ch in oth[:2]:
                eng.submit("other", ch)
            assert _wait(lambda: eng.position("victim") == 2
                         and eng.position("other") == 2)
            _park_victim(bus, eng, ages)
            assert bus.counters["qos.rate_limited"] >= 1
            assert eng.labels("victim") is not None
            assert eng.telemetry()["victim"]["qos_state"] == QOS_PARKED
            eng.submit("victim", vic[2])
            assert eng.queue_depth("victim") == 1
            ages["other"] = 0.0
            ages["victim"] = 0.0
            assert _wait(lambda: eng.qos_state("victim") != QOS_PARKED)
            assert _wait(lambda: bus.snapshot()["counters"].get(
                "qos.unparked", 0) == 1)
            assert _wait(lambda: eng._tenants["victim"].lane >= 0)
            for ch in vic[3:]:
                eng.submit("victim", ch)
            for ch in oth[2:]:
                eng.submit("other", ch)
            eng.finish("victim")
            eng.finish("other")
            for tid, seed in (("victim", 1), ("other", 2)):
                want = _oracle(seed, n_edges=256, cc=cc)
                assert _wait(
                    lambda t=tid, w=want: eng.labels(t) is not None
                    and eng.labels(t).tobytes() == w.tobytes()
                ), tid
        finally:
            eng.stop()


def test_overload_sheds_parked_tenant_and_bounds_backlog():
    cc = _cc_plan()
    pol = QosPolicy(backlog_budget_s=0.5, limit_after=1, park_after=1,
                    unpark_below_s=0.25, shed_queue_depth=3)
    qos = QosController(default=QosPolicy(), eval_every_s=0.01,
                        per_tenant={"victim": pol})
    with obs_bus.scope() as bus:
        ages = {}
        bus.watermarks.backlog_age = lambda tid: ages.get(tid, 0.0)
        eng = _engine(merge_every=1, qos=qos, poll_s=0.01)
        eng.add_tier("cc", cc, CHUNK)
        eng.admit("victim", "cc")
        eng.admit("other", "cc")
        vic = list(_stream(1, n_edges=256))
        oth = list(_stream(2, n_edges=256))
        eng.start()
        try:
            for ch in vic[:2]:
                eng.submit("victim", ch)
            for ch in oth[:2]:
                eng.submit("other", ch)
            assert _wait(lambda: eng.position("victim") == 2
                         and eng.position("other") == 2)
            _park_victim(bus, eng, ages)
            # Hold the QoS pass off for the burst: a pass landing between
            # two submits sheds the victim at 4 queued chunks, not 6.
            with eng._lock:
                eng._qos_next_eval = float("inf")
            for ch in vic[2:8]:  # 6 queued > shed_queue_depth=3
                eng.submit("victim", ch)
            with eng._lock:
                eng._qos_next_eval = 0.0
            # The ladder turns SHED inside the pass before the pass drops
            # the queue and emits; its shed gauge is published after both.
            assert _wait(lambda: eng.qos_state("victim") == QOS_SHED
                         and bus.gauges.get("qos.shed_tenants") == 1)
            assert bus.counters["qos.shed"] == 1
            assert bus.counters["qos.chunks_dropped"] == 6
            assert eng.queue_depth("victim") == 0
            with pytest.raises(ValueError, match="finished"):
                eng.submit("victim", vic[2])
            want_prefix = edge_stream_from_edges(
                _edges(1, 256)[:64], vertex_capacity=N_V,
                chunk_size=CHUNK, device="cpu",
            ).aggregate(cc, merge_every=1).result().numpy()
            assert eng.labels("victim").tobytes() == want_prefix.tobytes()
            ages["other"] = 0.0
            for ch in oth[2:]:
                eng.submit("other", ch)
            eng.finish("other")
            want = _oracle(2, n_edges=256, cc=cc)
            assert _wait(
                lambda: eng.labels("other") is not None
                and eng.labels("other").tobytes() == want.tobytes()
            )
            assert bus.gauges.get("qos.shed_tenants") == 1
        finally:
            eng.stop()


def test_on_qos_hooks_see_every_transition():
    cc = _cc_plan()
    pol = QosPolicy(backlog_budget_s=0.5, limit_after=1, park_after=1,
                    unpark_below_s=0.25, unpark_grace_s=0.0)
    qos = QosController(default=QosPolicy(), eval_every_s=0.01,
                        per_tenant={"victim": pol})
    with obs_bus.scope() as bus:
        ages = {}
        bus.watermarks.backlog_age = lambda tid: ages.get(tid, 0.0)
        eng = _engine(merge_every=1, qos=qos, poll_s=0.01)
        eng.add_tier("cc", cc, CHUNK)
        seen = []
        eng.on_qos.append(lambda tid, action, info: seen.append(
            (tid, action)))
        eng.admit("victim", "cc")
        eng.admit("other", "cc")
        vic = list(_stream(1, n_edges=256))
        eng.start()
        try:
            for ch in vic[:2]:
                eng.submit("victim", ch)
            assert _wait(lambda: eng.position("victim") == 2)
            _park_victim(bus, eng, ages)
            ages["victim"] = 0.0
            ages["other"] = 0.0
            assert _wait(
                lambda: ("victim", "unpark") in seen)
            actions = [a for t, a in seen if t == "victim"]
            assert actions[:3] == ["limit", "park", "unpark"]
        finally:
            eng.stop()


# --------------------------------------------------------------------- #
# kill -9: per-tenant exactly-once on a counting tier


def _spawn(ckpt_dir, out, sleep_s):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ckpt_dir), str(out),
         str(sleep_s)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _finish(p, timeout=300):
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.faults
def test_degree_tier_kill9_resume_exactly_once(tmp_path):
    ckpt = tmp_path / "ck"
    out_clean = tmp_path / "clean.npz"
    out_resumed = tmp_path / "resumed.npz"
    _finish(_spawn(tmp_path / "ck-clean", out_clean, 0.0))
    p = _spawn(ckpt, out_resumed, 0.05)

    def folded(t) -> bool:
        # A push-mode tenant may checkpoint position 0 at a window it was
        # starved in; kill once each one has a checkpoint past its start.
        return any(int(f.stem.split("-")[1]) > 0
                   for f in ckpt.glob(f"t{t}-*.npz"))

    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if p.poll() is not None:
            pytest.fail(f"child exited early (rc={p.returncode})")
        if ckpt.exists() and all(folded(t) for t in range(CHILD_TENANTS)):
            break
        time.sleep(0.02)
    else:
        pytest.fail("no per-tenant checkpoints appeared before deadline")
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=60) == -signal.SIGKILL
    assert not out_resumed.exists()
    for t in range(CHILD_TENANTS):
        newest = sorted(ckpt.glob(f"t{t}-*.npz"))[-1]
        _, pos, _ = load_checkpoint(str(newest))
        assert 0 < pos < CHILD_CHUNKS  # killed mid-stream for each
    _finish(_spawn(ckpt, out_resumed, 0.0))
    resumed, _, _ = load_checkpoint(str(out_resumed))
    clean, _, _ = load_checkpoint(str(out_clean))
    assert len(resumed) == len(clean) == CHILD_TENANTS
    for t in range(CHILD_TENANTS):
        e = _child_edges(t)
        want = (np.bincount(e[:, 0], minlength=CHILD_NV)
                + np.bincount(e[:, 1], minlength=CHILD_NV)).astype(np.int64)
        assert resumed[t].tobytes() == clean[t].tobytes()
        assert resumed[t].tobytes() == want.tobytes()
