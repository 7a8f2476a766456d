"""gelly_torch's multi-tenant engine vs gelly_tpu's (CPU).

Mirrors the 32 tests of ``tests/test_tenants.py`` that need no wire on the
port (``device="cpu"``; the mesh case on ``make_mesh(8, devices=["cpu"] *
8)``; the kill -9 pair with this file as its own child), then holds the
port to ``gelly_tpu`` across the packages: the same tiers, admissions and
chunks go through both ``MultiTenantEngine``\\ s round by round, and after
every round the stacked snapshots, every lane's ``state`` and ``global_``
(the plain backends), ``stats`` and the ``tenants.*`` bus counters are
equal; at the end the per-tenant checkpoint files hold equal leaves, and a
rotation written by either package resumes in the other. Tiers: raw CC,
the dense and sparse codecs, degrees (raw and sparse), a fused
``MultiQueryPlan``, CC's dedup fold, uneven streams, lane growth from 1 to
64, reclamation and a mesh of 4 shards. The fold form each plan builds is
pinned, and the lane-batched form's edge cases are held to ``gelly_tpu``
and to per-lane folds: lanes converging in different numbers of rounds, a
masked lane holding a forest that is not flat, offsets at the top of the
``i32`` range. A serving stress test runs more submitting and querying
threads than cores under a short switch interval. Inputs are made from
seeds with numpy; tolerance: none (dtype, shape and bytes of every leaf).

Child: ``python tests/test_torch_tenants.py <ckpt_dir> <out.npz> <sleep_s>
[raw|codec]`` with the repository root on ``PYTHONPATH``.
"""

import importlib
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_V = 128
CHUNK = 32
CHILD_TENANTS = 3
CHILD_EDGES = 768
CHILD_NV = 96
CHILD_CHUNK = 16


def _child_stream(tid: int):
    from gelly_torch import edge_stream_from_edges

    rng = np.random.default_rng(100 + tid)
    pairs = rng.integers(0, CHILD_NV, (CHILD_EDGES, 2))
    return edge_stream_from_edges(
        [(int(a), int(b)) for a, b in pairs],
        vertex_capacity=CHILD_NV, chunk_size=CHILD_CHUNK, device="cpu",
    )


def child(ckpt_dir: str, out: str, sleep_s: float, compressed: bool) -> None:
    """The kill -9 child: ``tests/_tenants_crash_child.py``'s run on the
    port (throttled seekable sources, a checkpoint every window, resume)."""
    from gelly_torch.engine.checkpoint import save_checkpoint
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library.connected_components import cc_tenant_tier

    agg, cap = cc_tenant_tier(
        CHILD_NV, chunk_capacity=CHILD_CHUNK, compressed=compressed,
        codec="sparse" if compressed else "auto",
    )
    eng = MultiTenantEngine(merge_every=2, checkpoint_dir=ckpt_dir,
                            checkpoint_every=1, resume=True, device="cpu")
    eng.add_tier("cc", agg, cap, compressed=compressed)
    compress = agg.host_compress if compressed else None

    def throttled(stream):
        def gen(position: int):
            for c in stream.chunks_from(position):
                if sleep_s:
                    time.sleep(sleep_s)
                yield c if compress is None else compress(c)

        return gen

    for tid in range(CHILD_TENANTS):
        eng.admit(tid, "cc", chunks=throttled(_child_stream(tid)))
    res = eng.drain()
    save_checkpoint(
        out, [np.asarray(res[tid]) for tid in range(CHILD_TENANTS)],
        position=sum(eng.position(t) for t in range(CHILD_TENANTS)),
    )


if __name__ == "__main__":
    child(sys.argv[1], sys.argv[2], float(sys.argv[3]),
          len(sys.argv) > 4 and sys.argv[4] == "codec")
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests (both packages)

import jax  # noqa: E402
import torch  # noqa: E402

from gelly_torch import EdgeChunk  # noqa: E402
from gelly_torch import IdentityVertexTable as TIdentity  # noqa: E402
from gelly_torch import convert  # noqa: E402
from gelly_torch import edge_stream_from_edges as t_edges  # noqa: E402
from gelly_torch.engine import aggregation as tagg  # noqa: E402
from gelly_torch.engine import multiquery as tmq  # noqa: E402
from gelly_torch.engine.checkpoint import (  # noqa: E402
    load_checkpoint,
    tree_flatten,
)
from gelly_torch.engine.resilience import CheckpointManager  # noqa: E402
from gelly_torch.engine.tenants import (  # noqa: E402
    MultiTenantEngine,
    TenantBatch,
    tenant_prefix,
)
from gelly_torch.library import connected_components as tcc  # noqa: E402
from gelly_torch.library import cc_query as t_cq  # noqa: E402
from gelly_torch.library import degrees_query as t_dq  # noqa: E402
from gelly_torch.library.connected_components import (  # noqa: E402
    cc_tenant_tier,
    connected_components,
)
from gelly_torch.library.degrees import degree_aggregate  # noqa: E402
from gelly_torch.obs import bus as obs_bus  # noqa: E402
from gelly_torch.ops import unionfind  # noqa: E402
from gelly_torch.parallel import mesh as tmesh  # noqa: E402
from gelly_tpu import edge_stream_from_edges as j_edges  # noqa: E402
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity  # noqa
from gelly_tpu.engine import multiquery as jmq  # noqa: E402
from gelly_tpu.engine import tenants as jten  # noqa: E402
from gelly_tpu.engine.checkpoint import load_checkpoint as j_load  # noqa
jcc = importlib.import_module("gelly_tpu.library.connected_components")
from gelly_tpu.library.connected_components import (  # noqa: E402
    cc_query as j_cq,
)
from gelly_tpu.library.degrees import (  # noqa: E402
    degree_aggregate as j_degree_aggregate,
    degrees_query as j_dq,
)
from gelly_tpu.obs import bus as j_bus  # noqa: E402
from gelly_tpu.parallel import mesh as jmesh  # noqa: E402

from _torch_native import load_jax_native  # noqa: E402

pytestmark = pytest.mark.tenants


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _edges(seed: int, n_edges: int = 96, n_v: int = N_V):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b)) for a, b in rng.integers(0, n_v, (n_edges, 2))]


def _stream(seed: int, n_edges: int = 96, n_v: int = N_V,
            chunk: int = CHUNK, identity: bool = False, pkg: str = "t"):
    edges = _edges(seed, n_edges, n_v)
    if pkg == "j":
        kw = {"table": JIdentity(n_v)} if identity else {}
        return j_edges(edges, vertex_capacity=n_v, chunk_size=chunk, **kw)
    kw = {"table": TIdentity(n_v)} if identity else {}
    return t_edges(edges, vertex_capacity=n_v, chunk_size=chunk,
                   device="cpu", **kw)


def _cc_plan(n_v: int = N_V, pkg: str = "t"):
    mod = jcc if pkg == "j" else tcc
    return mod.connected_components(n_v, merge="gather",
                                    ingest_combine=False)


def _engine(**kw):
    return MultiTenantEngine(device="cpu", **kw)


def _oracle(stream, agg, merge_every=1):
    return stream.aggregate(agg, merge_every=merge_every).result().numpy()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _leaves(tree):
    """Host leaves of either package's tree, in jax.tree order."""
    return [_host(x) for x in tree_flatten(tree)[0]]


def _same(want, got, label):
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl), (label, len(wl), len(gl))
    for i, (w, g) in enumerate(zip(wl, gl)):
        assert w.dtype == g.dtype, (label, i, w.dtype, g.dtype)
        assert w.shape == g.shape, (label, i, w.shape, g.shape)
        assert w.tobytes() == g.tobytes(), f"{label}: leaf {i} diverged"


# --------------------------------------------------------------------- #
# batched fold correctness (mirrored)


def test_mixed_workload_64_tenants_bit_identical():
    cc = _cc_plan()
    dg = degree_aggregate(N_V, ingest_combine=False)
    eng = _engine(merge_every=2)
    eng.add_tier("cc", cc, CHUNK)
    eng.add_tier("deg", dg, CHUNK)
    n_cc, n_dg = 48, 16
    for i in range(n_cc):
        eng.admit(("cc", i), "cc", chunks=_stream(i))
    for i in range(n_dg):
        eng.admit(("dg", i), "deg", chunks=_stream(1000 + i))
    out = eng.drain()
    assert len(out) == 64
    for i in range(n_cc):
        want = _oracle(_stream(i), cc, merge_every=2)
        got = out[("cc", i)]
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    for i in range(n_dg):
        want = _oracle(_stream(1000 + i), dg, merge_every=2)
        got = out[("dg", i)]
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def test_one_dispatch_advances_the_whole_tier():
    cc = _cc_plan()
    eng = _engine(merge_every=2)
    eng.add_tier("cc", cc, CHUNK)
    n, chunks_each = 8, 3
    for i in range(n):
        eng.admit(i, "cc", chunks=_stream(i))
    eng.drain()
    assert eng.stats["chunks"] == n * chunks_each
    assert eng.stats["dispatches"] == chunks_each


def test_uneven_streams_and_starvation_accounting():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    lengths = {0: 32, 1: 96, 2: 160, 3: 64}
    for tid, n in lengths.items():
        eng.admit(tid, "cc", chunks=_stream(tid, n_edges=n))
    out = eng.drain()
    for tid, n in lengths.items():
        want = _oracle(_stream(tid, n_edges=n), cc)
        assert out[tid].tobytes() == want.tobytes()
        assert eng.position(tid) == -(-n // CHUNK)
    assert eng.stats["dispatches"] == 5
    assert eng.stats["starved_lanes"] == 0


def test_starved_windows_counts_live_but_empty_lanes():
    cc = _cc_plan()
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1)
        eng.add_tier("cc", cc, CHUNK)
        eng.admit("busy", "cc")
        eng.admit("idle", "cc")
        for c in _stream(3):
            eng.submit("busy", c)
        eng.finish("busy")
        with pytest.raises(RuntimeError, match="never finish"):
            eng.drain()
        assert eng.starved_windows("idle") > 0
        assert bus.counters["tenants.starved_windows"] > 0
        eng.finish("idle")
        out = eng.drain()
        want = _oracle(_stream(3), cc)
        assert out["busy"].tobytes() == want.tobytes()


def test_lane_width_growth_preserves_admitted_state():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    eng.admit(0, "cc")
    for c in _stream(0):
        eng.submit(0, c)
    eng.finish(0)
    for tid in range(1, 5):
        eng.admit(tid, "cc", chunks=_stream(tid))
    assert eng._tiers["cc"].batch.lanes >= 5
    out = eng.drain()
    for tid in range(5):
        want = _oracle(_stream(tid), cc)
        assert out[tid].tobytes() == want.tobytes()


def test_mesh_shards_the_tenant_axis():
    cc = _cc_plan()
    m = tmesh.make_mesh(8, devices=["cpu"] * 8)
    eng = MultiTenantEngine(merge_every=2, mesh=m)
    eng.add_tier("cc", cc, CHUNK)
    n = 10  # lanes pad to 16 (multiple of the 8-shard mesh)
    for i in range(n):
        eng.admit(i, "cc", chunks=_stream(i))
    out = eng.drain()
    assert eng._tiers["cc"].batch.lanes % m.num_shards == 0
    for i in range(n):
        want = _oracle(_stream(i), cc, merge_every=2)
        assert out[i].tobytes() == want.tobytes()


# --------------------------------------------------------------------- #
# plan validation (mirrored, error texts held to gelly_tpu's)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    return None


def test_tier_refuses_stateful_codec_plans():
    compact = connected_components(N_V, codec="compact",
                                   compact_capacity=N_V)
    with pytest.raises(ValueError, match="GLOBAL STREAM order"):
        tagg._compiled_tenant_plan(compact, 2, device="cpu")
    with pytest.raises(ValueError, match="compressed=True"):
        TenantBatch(compact, CHUNK, device="cpu")
    sparse = connected_components(N_V, codec="sparse")
    plan = tagg._compiled_tenant_plan(sparse, 2, device="cpu")
    assert plan.fold_codec is not None
    # The same texts as gelly_tpu's.
    j_compact = jcc.connected_components(N_V, codec="compact",
                                         compact_capacity=N_V)
    from gelly_tpu.engine.aggregation import _compiled_tenant_plan as jplan

    assert _error(lambda: jplan(j_compact, 2)) == _error(
        lambda: tagg._compiled_tenant_plan(compact, 2, device="cpu"))
    assert _error(lambda: jten.TenantBatch(j_compact, CHUNK)) == _error(
        lambda: TenantBatch(compact, CHUNK, device="cpu"))


def test_tier_refuses_host_transforms():
    agg = _cc_plan()
    agg.jit_transform = False
    with pytest.raises(ValueError, match="host-side transform"):
        tagg._compiled_tenant_plan(agg, 2, device="cpu")


def test_tier_refusals_match_gelly_tpu_in_order():
    """Every refusal of `_compiled_tenant_plan`, in gelly_tpu's order and
    with its text: lanes < 1, a pane ring, an ordered stacker, a codec-only
    plan without fold_compressed, a host transform, a mesh that does not
    divide the lanes."""
    from gelly_tpu.engine.aggregation import _compiled_tenant_plan as jplan

    def both(make, lanes=2, S=None):
        jm = jmesh.make_mesh(S) if S else None
        tm = tmesh.make_mesh(S, devices=["cpu"] * S) if S else None
        j = _error(lambda: jplan(make("j"), lanes, mesh=jm))
        t = _error(lambda: tagg._compiled_tenant_plan(
            make("t"), lanes, mesh=tm, device="cpu"))
        assert j is not None and j == t, (j, t)

    both(lambda p: _cc_plan(pkg=p), lanes=0)
    both(lambda p: (jcc if p == "j" else tcc).connected_components(
        N_V, merge="gather", codec="dense", windowed=2))
    both(lambda p: (jcc if p == "j" else tcc).connected_components(
        N_V, codec="compact", compact_capacity=N_V))

    def codec_only(p):
        agg = _cc_plan(pkg=p)
        agg.requires_codec = True
        return agg

    both(codec_only)

    def host_transform(p):
        agg = _cc_plan(pkg=p)
        agg.jit_transform = False
        return agg

    both(host_transform)
    both(lambda p: _cc_plan(pkg=p), lanes=6, S=4)


def test_admission_validation():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    with pytest.raises(ValueError, match="already registered"):
        eng.add_tier("cc", cc, CHUNK)
    with pytest.raises(ValueError, match="unknown tier"):
        eng.admit(0, "nope")
    eng.admit(0, "cc")
    with pytest.raises(ValueError, match="already admitted"):
        eng.admit(0, "cc")
    with pytest.raises(ValueError, match="chunk capacity"):
        eng.submit(0, next(iter(_stream(0, chunk=CHUNK * 2))))
    eng.finish(0)
    with pytest.raises(ValueError, match="finished"):
        eng.submit(0, next(iter(_stream(0))))


def test_cc_tenant_tier_builder():
    agg, cap = cc_tenant_tier(N_V, chunk_capacity=CHUNK)
    assert agg.host_compress is None  # raw fold
    assert cap == CHUNK
    eng = _engine(merge_every=1)
    eng.add_tier("t", agg, cap)
    eng.admit(0, "t", chunks=_stream(0))
    out = eng.drain()
    want = _oracle(_stream(0), agg)
    assert out[0].tobytes() == want.tobytes()


def test_delta_auto_rows_knob():
    agg = connected_components(N_V, delta_auto_rows=777)
    assert agg.merge_delta_auto_rows == 777
    agg = connected_components(N_V)
    assert agg.merge_delta_auto_rows == N_V // 4
    agg = connected_components(N_V, codec="compact", compact_capacity=64,
                               delta_auto_rows=11)
    assert agg.merge_delta_auto_rows == 11


# --------------------------------------------------------------------- #
# live queries (mirrored)


def test_query_staleness_is_one_merge_window():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    eng.admit(0, "cc")
    assert eng.labels(0) is None
    assert eng.snapshot_window(0) == 0
    chunks = list(_stream(0, n_edges=160))
    seen_windows = []
    eng.start()
    try:
        for k, c in enumerate(chunks):
            eng.submit(0, c)
            deadline = time.time() + 60
            while (time.time() < deadline
                   and eng.snapshot_window(0) < k + 1):
                time.sleep(0.01)
            seen_windows.append(eng.snapshot_window(0))
            v = eng.labels(0, 0)
            assert v is not None and v.shape == ()
        eng.finish(0)
        deadline = time.time() + 20
        while time.time() < deadline and eng.position(0) < len(chunks):
            time.sleep(0.02)
    finally:
        eng.stop()
    assert seen_windows == list(range(1, len(chunks) + 1))
    want = _oracle(_stream(0, n_edges=160), cc)
    assert eng.labels(0).tobytes() == want.tobytes()


def test_queries_never_block_window_close():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    for i in range(4):
        eng.admit(i, "cc", chunks=_stream(i, n_edges=256))
    stop = threading.Event()
    errors: list = []

    def hammer():
        try:
            while not stop.is_set():
                for i in range(4):
                    eng.labels(i)
                    eng.snapshot_window(i)
                    eng.queue_depth(i)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        out = eng.drain()
    finally:
        stop.set()
        for t in threads:
            t.join(5)
    assert not errors
    for i in range(4):
        want = _oracle(_stream(i, n_edges=256), cc)
        assert out[i].tobytes() == want.tobytes()


def test_query_for_tenant_admitted_after_snapshot_returns_none():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    eng.admit("a", "cc", chunks=_stream(0))
    a_row = eng.drain()["a"]
    assert a_row is not None
    eng.admit("b", "cc")
    assert eng.labels("b") is None
    assert eng.labels("b", 0) is None
    assert eng.snapshot_window("b") == 0
    assert eng.labels("a").tobytes() == a_row.tobytes()
    for c in _stream(7):
        eng.submit("b", c)
    eng.finish("b")
    out = eng.drain()
    want = _oracle(_stream(7), cc)
    assert out["b"].tobytes() == want.tobytes()


# --------------------------------------------------------------------- #
# malformed-chunk containment (mirrored)


def _rogue(c):
    return c._replace(val=c.val.to(torch.float64))


def test_submit_rejects_template_mismatch_to_submitter():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    eng.admit("good", "cc")
    eng.admit("bad", "cc")
    chunks = list(_stream(3))
    for c in chunks:
        eng.submit("good", c)
    with pytest.raises(ValueError, match="tier template"):
        eng.submit("bad", _rogue(chunks[0]))
    eng.finish("good")
    eng.finish("bad")
    out = eng.drain()
    want = _oracle(_stream(3), cc)
    assert out["good"].tobytes() == want.tobytes()


def test_pull_mode_malformed_chunk_quarantines_one_tenant():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    rogue = [_rogue(c) for c in _stream(5, n_edges=64)]
    eng.admit("good", "cc", chunks=_stream(0))
    eng.admit("rogue", "cc", chunks=rogue)
    out = eng.drain()
    want = _oracle(_stream(0), cc)
    assert out["good"].tobytes() == want.tobytes()
    assert eng.position("rogue") == 0


def test_starved_windows_counts_only_dispatch_rounds():
    cc = _cc_plan()
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1)
        eng.add_tier("cc", cc, CHUNK)
        eng.admit("busy", "cc")
        eng.admit("idle", "cc")
        for c in _stream(3):
            eng.submit("busy", c)
        eng.finish("busy")
        with pytest.raises(RuntimeError, match="never finish"):
            eng.drain()
        assert eng.starved_windows("idle") == 3
        assert bus.counters["tenants.starved_windows"] == 3
        assert eng.stats["starved_lanes"] == 3


# --------------------------------------------------------------------- #
# per-tenant checkpoints + resume (mirrored)


def test_checkpoint_manager_prefix_isolates_rotations(tmp_path):
    a = CheckpointManager(str(tmp_path), prefix="t1", async_write=False,
                          keep=2)
    b = CheckpointManager(str(tmp_path), prefix="t11", async_write=False,
                          keep=2)
    for pos in (1, 2, 3):
        a.save({"x": np.full((4,), pos)}, pos)
    b.save({"x": np.full((4,), 99)}, 7)
    assert [os.path.basename(p) for p in a.list()] == [
        "t1-000000000002.npz", "t1-000000000003.npz",
    ]
    assert [os.path.basename(p) for p in b.list()] == [
        "t11-000000000007.npz",
    ]
    got = a.load_latest(like={"x": np.zeros((4,), np.int64)})
    assert got is not None and got[1] == 3
    with pytest.raises(ValueError, match="prefix"):
        CheckpointManager(str(tmp_path), prefix=f"a{os.sep}b")
    with pytest.raises(ValueError, match="prefix"):
        CheckpointManager(str(tmp_path), prefix="t7-0")


def test_tenant_prefixes_escape_arbitrary_ids(tmp_path):
    assert tenant_prefix(7) == "t7"
    assert tenant_prefix("7-0") == "t7%2d0"
    assert "-" not in tenant_prefix("user-42/7%x")
    assert tenant_prefix("a-b") != tenant_prefix("a_b")
    for tid in (7, "7-0", "user-42/7%x", "é", ("a", 1)):
        assert tenant_prefix(tid) == jten.tenant_prefix(tid)
    cc = _cc_plan()
    eng = _engine(merge_every=1, checkpoint_dir=str(tmp_path))
    eng.add_tier("cc", cc, CHUNK)
    eng.admit("7", "cc", chunks=_stream(0, n_edges=32))
    eng.admit("7-0", "cc", chunks=_stream(1, n_edges=64))
    eng.drain()
    t7 = eng._tenants["7"].manager.list()
    t70 = eng._tenants["7-0"].manager.list()
    assert t7 and t70 and not set(t7) & set(t70)
    assert load_checkpoint(t7[-1])[1] == 1
    assert load_checkpoint(t70[-1])[1] == 2


def test_per_tenant_checkpoints_ride_the_crc_format(tmp_path):
    cc = _cc_plan()
    eng = _engine(merge_every=2, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1)
    eng.add_tier("cc", cc, CHUNK)
    for i in range(3):
        eng.admit(i, "cc", chunks=_stream(i))
    eng.drain()
    for i in range(3):
        files = sorted(tmp_path.glob(f"t{i}-*.npz"))
        assert files, i
        state, pos, meta = load_checkpoint(str(files[-1]),
                                           like=cc.init("cpu"))
        assert pos == eng.position(i) == 3
        assert meta["tenant"] == str(i)
        assert meta["tier"] == "cc"


def test_resume_skips_folded_prefix_bit_identical(tmp_path):
    cc = _cc_plan()
    chunks = {i: list(_stream(i, n_edges=256)) for i in range(3)}
    eng = _engine(merge_every=1, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1)
    eng.add_tier("cc", cc, CHUNK)
    for i in range(3):
        eng.admit(i, "cc", chunks=chunks[i][:5])
    eng.drain()
    eng2 = _engine(merge_every=1, checkpoint_dir=str(tmp_path),
                   checkpoint_every=1, resume=True)
    eng2.add_tier("cc", cc, CHUNK)
    for i in range(3):
        eng2.admit(i, "cc", chunks=chunks[i])
    out = eng2.drain()
    assert eng2.stats["chunks"] == 3 * 3
    for i in range(3):
        want = _oracle(_stream(i, n_edges=256), cc)
        assert out[i].tobytes() == want.tobytes()


def _spawn(ckpt_dir, out, sleep_s, compressed=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ckpt_dir), str(out),
         str(sleep_s), "codec" if compressed else "raw"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _finish(p, timeout=300):
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.faults
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["raw", "codec"])
def test_multi_tenant_kill9_resume_bit_identical(tmp_path, compressed):
    out_clean = tmp_path / "clean.npz"
    out_resumed = tmp_path / "resumed.npz"
    ckpt = tmp_path / "ck"
    _finish(_spawn(tmp_path / "ck-clean", out_clean, 0.0, compressed))
    p = _spawn(ckpt, out_resumed, 0.03, compressed)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if p.poll() is not None:
            pytest.fail(f"child exited early (rc={p.returncode})")
        if ckpt.exists() and all(list(ckpt.glob(f"t{t}-*.npz"))
                                 for t in range(CHILD_TENANTS)):
            break
        time.sleep(0.02)
    else:
        pytest.fail("no per-tenant checkpoints appeared before deadline")
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=60) == -signal.SIGKILL
    assert not out_resumed.exists()
    total = -(-CHILD_EDGES // CHILD_CHUNK)
    for t in range(CHILD_TENANTS):
        newest = sorted(ckpt.glob(f"t{t}-*.npz"))[-1]
        _, pos, _ = load_checkpoint(str(newest))
        assert 0 < pos < total
    _finish(_spawn(ckpt, out_resumed, 0.0, compressed))
    resumed, _, _ = load_checkpoint(str(out_resumed))
    clean, _, _ = load_checkpoint(str(out_clean))
    assert len(resumed) == len(clean) == CHILD_TENANTS
    for t in range(CHILD_TENANTS):
        assert resumed[t].tobytes() == clean[t].tobytes()
        agg, _cap = cc_tenant_tier(CHILD_NV, chunk_capacity=CHILD_CHUNK)
        want = _oracle(_child_stream(t), agg, merge_every=2)
        assert resumed[t].tobytes() == want.tobytes()


# --------------------------------------------------------------------- #
# observability (mirrored)


def test_bus_gauges_and_counters():
    cc = _cc_plan()
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=2)
        eng.add_tier("cc", cc, CHUNK)
        for i in range(4):
            eng.admit(i, "cc", chunks=_stream(i))
        eng.drain()
        snap = bus.snapshot()
        assert snap["counters"]["tenants.dispatches"] == 3
        assert snap["counters"]["tenants.chunks_folded"] == 12
        assert snap["counters"]["tenants.windows_closed"] >= 1
        assert "tenants.active" in snap["gauges"]
        assert "tenants.queue_depth" in snap["gauges"]


def test_heartbeat_carries_tenant_fields():
    from gelly_torch.obs import SpanTracer, install

    cc = _cc_plan()
    tracer = SpanTracer(heartbeat_every_s=0.0)
    with obs_bus.scope():
        with install(tracer):
            eng = _engine(merge_every=1)
            eng.add_tier("cc", cc, CHUNK)
            for i in range(2):
                eng.admit(i, "cc", chunks=_stream(i))
            eng.drain()
    beats = [i for i in tracer.instants() if i["name"] == "heartbeat"]
    assert beats
    line = beats[-1]["args"]
    assert "tenants_active" in line
    assert "tenants_queue_depth" in line
    assert "starved" in line
    assert "backlog_age_max_s" in line
    assert line["slo_breaching"] == 0
    folds = [s for s in tracer.spans() if s["name"] == "fold"]
    assert folds and all(
        s["args"]["lanes"] >= s["args"]["advanced"] for s in folds
    )
    assert {s["track"] for s in folds} == {"tenants/cc"}


def test_attached_slo_plane_ticks_from_scheduler():
    from gelly_torch.obs import SpanTracer, install
    from gelly_torch.obs.slo import SloPlane, tenant_backlog_age_s

    cc = _cc_plan()
    tracer = SpanTracer(heartbeat_every_s=0.0)
    with obs_bus.scope() as bus:
        with install(tracer):
            eng = _engine(merge_every=1)
            eng.attach_slo_plane(
                SloPlane([tenant_backlog_age_s(1e9)], bus=bus))
            eng.add_tier("cc", cc, CHUNK)
            for i in range(2):
                eng.admit(i, "cc", chunks=_stream(i))
            eng.drain()
        snap = bus.snapshot()["gauges"]
        assert snap.get("slo.breaching") == 0
        burn = [k for k in snap if k.endswith(".burn_rate")]
        assert any(".t0" in k for k in burn) and any(
            ".t1" in k for k in burn)
    beats = [i for i in tracer.instants() if i["name"] == "heartbeat"]
    assert beats and beats[-1]["args"]["slo_breaching"] == 0


# --------------------------------------------------------------------- #
# compressed tiers (mirrored)


def _compressed_tier(codec="sparse"):
    return cc_tenant_tier(N_V, chunk_capacity=CHUNK, compressed=True,
                          codec=codec)


def test_compressed_tier_bit_identical_to_raw_tier():
    def chunk_lists(t):
        return list(_stream(300 + t))

    agg_r, cap = cc_tenant_tier(N_V, chunk_capacity=CHUNK)
    eng_r = _engine(merge_every=2)
    eng_r.add_tier("cc", agg_r, cap)
    for t in range(4):
        eng_r.admit(t, "cc", chunks=chunk_lists(t))
    raw = eng_r.drain()

    agg_c, cap = _compressed_tier()
    eng_c = _engine(merge_every=2)
    eng_c.add_tier("cc", agg_c, cap, compressed=True)
    with obs_bus.scope() as bus:
        for t in range(4):
            eng_c.admit(t, "cc", chunks=[
                agg_c.host_compress(c) for c in chunk_lists(t)
            ])
        comp = eng_c.drain()
    counters = bus.snapshot()["counters"]
    assert counters["tenants.compressed_dispatches"] >= 1
    assert counters["tenants.compressed_dispatches"] == \
        counters["tenants.dispatches"]
    for t in range(4):
        assert comp[t].dtype == raw[t].dtype
        assert comp[t].tobytes() == raw[t].tobytes()


def test_compressed_tier_push_mode_and_uneven_streams():
    agg, cap = _compressed_tier()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", agg, cap, compressed=True)
    chunks_a = list(_stream(31, n_edges=4 * CHUNK))
    chunks_b = list(_stream(32, n_edges=CHUNK))
    eng.admit("a", "cc")
    eng.admit("b", "cc")
    for c in chunks_a:
        eng.submit_payload("a", agg.host_compress(c))
    for c in chunks_b:
        eng.submit_payload("b", agg.host_compress(c))
    eng.finish("a")
    eng.finish("b")
    out = eng.drain()
    for tid, seed, n in (("a", 31, 4 * CHUNK), ("b", 32, CHUNK)):
        want = tagg.run_aggregation(
            _cc_plan(), _stream(seed, n_edges=n), merge_every=1,
            ingest_workers=0, prefetch_depth=0, h2d_depth=0,
        ).result().numpy()
        assert out[tid].tobytes() == want.tobytes()


def test_compressed_tier_guards():
    agg_c, cap = _compressed_tier()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", agg_c, cap, compressed=True)
    eng.add_tier("raw", _cc_plan(), cap)
    eng.admit("c", "cc")
    eng.admit("r", "raw")
    chunk = next(iter(_stream(5)))
    with pytest.raises(ValueError, match="compressed tier"):
        eng.submit("c", chunk)
    with pytest.raises(ValueError, match="raw tier"):
        eng.submit_payload("r", agg_c.host_compress(chunk))
    with pytest.raises(ValueError, match="EdgeChunk"):
        eng.submit_payload("c", chunk)
    eng.submit_payload("c", agg_c.host_compress(chunk))
    with pytest.raises(ValueError, match="tier template"):
        eng.submit_payload("c", {"v": np.zeros(3, np.int64),
                                 "r": np.zeros(3, np.int32)})
    with pytest.raises(ValueError, match="FLAT dict"):
        eng.submit_payload("c", {"cc": {"v": np.zeros(2, np.int32)}})
    with pytest.raises(ValueError, match="out of range"):
        eng.submit_payload("c", {"v": np.asarray([N_V + 3], np.int32),
                                 "r": np.asarray([0], np.int32)})
    big = np.arange(2 * CHUNK + 1, dtype=np.int32) % N_V
    with pytest.raises(ValueError, match="tier bound"):
        eng.submit_payload("c", {"v": big, "r": np.zeros_like(big)})
    with pytest.raises(ValueError, match="fold_compressed"):
        eng.add_tier("bad", _cc_plan(), cap, compressed=True)
    import dataclasses

    no_hc = dataclasses.replace(
        agg_c, host_compress=None, name="no-host-compress",
    )
    with pytest.raises(ValueError, match="host_compress"):
        eng.add_tier("bad2", no_hc, cap, compressed=True)


# --------------------------------------------------------------------- #
# idle-lane reclamation (mirrored)


def _feed_blocking(eng, tid, it, n):
    fed = 0
    deadline = time.time() + 60
    while fed < n and time.time() < deadline:
        c = next(it, None)
        if c is None:
            break
        while eng.queue_depth(tid) >= 2 and time.time() < deadline:
            time.sleep(0.002)
        eng.submit(tid, c)
        fed += 1
    return fed


def test_idle_lane_reclamation_halves_width(tmp_path):
    cc = _cc_plan()
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1, reclaim_after=2,
                      checkpoint_dir=str(tmp_path))
        eng.add_tier("cc", cc, CHUNK)
        for i in range(6):
            eng.admit(i, "cc", chunks=_stream(i))
        eng.admit("a", "cc")
        eng.admit("b", "cc")
        tier = eng._tiers["cc"]
        assert tier.batch.lanes == 8
        eng.start()
        try:
            chunks = {t: list(_stream(900 + ord(t), n_edges=960))
                      for t in ("a", "b")}
            feeds = {t: iter(cs) for t, cs in chunks.items()}
            fed = {"a": 0, "b": 0}
            deadline = time.time() + 90
            while time.time() < deadline and tier.batch.lanes > 4:
                for t, it in feeds.items():
                    fed[t] += _feed_blocking(eng, t, it, 1)
            assert tier.batch.lanes == 4
            eng.finish("b")
            while time.time() < deadline and tier.batch.lanes > 2:
                fed["a"] += _feed_blocking(eng, "a", feeds["a"], 1)
            assert tier.batch.lanes == 2
            assert eng.stats["reclaims"] >= 2
            assert eng.stats["lanes_reclaimed"] >= 6
            assert bus.counters["tenants.reclaims"] >= 2
            assert bus.counters["tenants.lanes_reclaimed"] >= 6
            for i in range(6):
                got = eng.labels(i)
                assert got is not None
                want = _oracle(_stream(i), cc)
                assert got.tobytes() == want.tobytes()
                assert eng.snapshot_window(i) > 0
                pos = eng.position(i)
                assert os.path.exists(
                    eng._tenants[i].manager.path_for(pos)
                )
            lane_c = eng.admit("c", "cc", chunks=_stream(777))
            assert lane_c <= 2
            eng.finish("a")
            deadline = time.time() + 60
            while time.time() < deadline and any(
                not t.done for t in eng._tenants.values()
            ):
                time.sleep(0.01)
        finally:
            eng.stop()
        for tid in ("a", "b"):
            assert eng.position(tid) == fed[tid]
            prefix = t_edges(_edges(900 + ord(tid), 960)[: fed[tid] * CHUNK],
                             vertex_capacity=N_V, chunk_size=CHUNK,
                             device="cpu")
            want = tagg.run_aggregation(
                cc, prefix, merge_every=1,
                ingest_workers=0, prefetch_depth=0, h2d_depth=0,
            ).result().numpy()
            got = eng.labels(tid)
            assert got is not None
            assert got.tobytes() == want.tobytes(), tid
        want_c = _oracle(_stream(777), cc)
        got_c = eng.labels("c")
        assert got_c is not None and got_c.tobytes() == want_c.tobytes()


def test_reclamation_respects_min_lanes_and_stays_off_by_default():
    cc = _cc_plan()
    eng = _engine(merge_every=1)
    eng.add_tier("cc", cc, CHUNK)
    for i in range(4):
        eng.admit(i, "cc", chunks=_stream(i))
    eng.drain()
    assert eng._tiers["cc"].batch.lanes == 4
    assert eng.stats["reclaims"] == 0
    eng2 = _engine(merge_every=1, reclaim_after=1)
    eng2.add_tier("cc", _cc_plan(), CHUNK, min_lanes=4)
    for i in range(3):
        eng2.admit(i, "cc", chunks=_stream(i))
    eng2.admit("live", "cc")
    eng2.start()
    try:
        it = iter(list(_stream(321, n_edges=320)))
        _feed_blocking(eng2, "live", it, 10)
        time.sleep(0.3)
        assert eng2._tiers["cc"].batch.lanes == 4
        assert eng2.stats["reclaims"] == 0
        eng2.finish("live")
        deadline = time.time() + 30
        while time.time() < deadline and any(
            not t.done for t in eng2._tenants.values()
        ):
            time.sleep(0.01)
    finally:
        eng2.stop()


def test_reclaim_after_validation():
    with pytest.raises(ValueError, match="reclaim_after"):
        _engine(reclaim_after=0)


def test_reclamation_defers_while_a_tenant_is_half_admitted():
    from gelly_torch.engine.tenants import _Tenant

    cc = _cc_plan()
    with obs_bus.scope():
        eng = _engine(merge_every=1, reclaim_after=1)
        eng.add_tier("cc", cc, CHUNK)
        for i in range(4):
            eng.admit(i, "cc", chunks=_stream(i))
        eng.admit("live", "cc")
        for c in _stream(55, n_edges=64):
            eng.submit("live", c)
        eng.finish("live")
        eng.drain()
        tier = eng._tiers["cc"]
        width0 = tier.batch.lanes
        half = _Tenant("half", "cc", width0 - 1)
        with eng._lock:
            eng._tenants["half"] = half
        tier.low_windows = 10
        tier.hw_active = 0
        eng._maybe_reclaim(tier, obs_bus.get_bus(), None)
        assert tier.batch.lanes == width0
        assert eng.stats["reclaims"] == 0
        with eng._lock:
            half.ready = True
            half.done = True
        tier.low_windows = 10
        eng._maybe_reclaim(tier, obs_bus.get_bus(), None)
        assert tier.batch.lanes < width0
        assert eng.stats["reclaims"] == 1


# --------------------------------------------------------------------- #
# cross-package: the same tenants through both engines, round by round

ENG = {"j": lambda **kw: jten.MultiTenantEngine(**kw),
       "t": lambda **kw: MultiTenantEngine(device="cpu", **kw)}
BUS = {"j": j_bus, "t": obs_bus}


def _mesh(pkg, S):
    if not S:
        return None
    if pkg == "j":
        return jmesh.make_mesh(S)
    return tmesh.make_mesh(S, devices=["cpu"] * S)


def _step(eng, bus) -> bool:
    """One scheduler pass of ``_run`` without its gauges: pull, one round,
    the done flags."""
    eng._pull_sources()
    adv = eng._round(bus, None)
    with eng._lock:
        for t in eng._tenants.values():
            if t.finished and not t.queue and not t.done:
                t.done = True
    return adv


def _counters(bus) -> dict:
    return {k: v for k, v in bus.snapshot()["counters"].items()
            if k.startswith("tenants.") and k != "tenants.checkpoint_bytes"}


def _same_engines(je, te, label, forests=True):
    assert je.stats == te.stats, (label, je.stats, te.stats)
    assert sorted(map(str, je._tenants)) == sorted(map(str, te._tenants))
    for tid, jt in je._tenants.items():
        tt = te._tenants[tid]
        assert (jt.lane, jt.consumed, jt.done, jt.starved_windows) == \
            (tt.lane, tt.consumed, tt.done, tt.starved_windows), (label, tid)
    for name, jt in je._tiers.items():
        tt = te._tiers[name]
        assert (jt.windows_closed, jt.snapshot_window, jt.snapshot_lanes,
                jt.chunks_in_window, jt.batch.lanes) == \
            (tt.windows_closed, tt.snapshot_window, tt.snapshot_lanes,
             tt.chunks_in_window, tt.batch.lanes), (label, name)
        if jt.snapshot is not None or tt.snapshot is not None:
            _same(jt.snapshot, tt.snapshot, f"{label}/{name}/snapshot")
        if forests and jt.batch.state is not None:
            _same(jt.batch.state, tt.batch.state, f"{label}/{name}/state")
            if not jt.batch.accum:
                _same(jt.batch.global_, tt.batch.global_,
                      f"{label}/{name}/global")


def _drive_pair(tiers, admissions, merge_every=2, S=None, forests=True,
                max_rounds=200, **kw):
    """Run both engines over ``tiers`` (``{name: make(pkg) -> (agg, cap,
    compressed)}``) with ``admissions`` (``{round: [(tid, tier,
    feed(pkg, agg))]}``, admitted before that round), comparing after every
    round; then drain both and compare the outputs. Returns the two
    engines and their buses' tenant counters."""
    engines, buses, aggs = {}, {}, {}
    scopes = {p: BUS[p].scope() for p in "jt"}
    for p in "jt":
        buses[p] = scopes[p].__enter__()
        engines[p] = ENG[p](merge_every=merge_every, mesh=_mesh(p, S), **kw)
        for name, make in tiers.items():
            agg, cap, compressed = make(p)
            aggs[p, name] = agg
            engines[p].add_tier(name, agg, cap, compressed=compressed)
    try:
        for r in range(max_rounds):
            for tid, tier, feed in admissions.get(r, []):
                for p in "jt":
                    lane = engines[p].admit(tid, tier,
                                            chunks=feed(p, aggs[p, tier]))
                assert engines["j"]._tenants[tid].lane == lane
            adv = [_step(engines[p], buses[p]) for p in "jt"]
            assert adv[0] == adv[1], r
            _same_engines(engines["j"], engines["t"], f"round {r}",
                          forests=forests)
            assert _counters(buses["j"]) == _counters(buses["t"]), r
            if not adv[0] and r >= max(admissions, default=0):
                break
        outs = {p: engines[p].drain() for p in "jt"}
        _same_engines(engines["j"], engines["t"], "drained",
                      forests=forests)
        assert _counters(buses["j"]) == _counters(buses["t"])
        for tid, want in outs["j"].items():
            _same(want, outs["t"][tid], f"output {tid}")
        return engines, outs
    finally:
        for p in "jt":
            scopes[p].__exit__(None, None, None)


def _raw_tier(p, n_v=N_V, chunk=CHUNK):
    return _cc_plan(n_v, pkg=p), chunk, False


def _codec_tier(codec):
    def make(p):
        mod = jcc if p == "j" else tcc
        agg, cap = mod.cc_tenant_tier(N_V, chunk_capacity=CHUNK,
                                      compressed=True, codec=codec)
        return agg, cap, True
    return make


def _deg_tier(codec=None):
    def make(p):
        f = j_degree_aggregate if p == "j" else degree_aggregate
        if codec is None:
            return f(N_V, ingest_combine=False), CHUNK, False
        return f(N_V, codec=codec), CHUNK, True
    return make


def _chunks(seed, n_edges=96, compressed=False):
    def feed(p, agg):
        cs = list(_stream(seed, n_edges=n_edges, pkg=p, identity=True))
        return [agg.host_compress(c) for c in cs] if compressed else cs
    return feed


@pytest.mark.parametrize("kind", ["raw", "dense", "sparse", "deg",
                                  "deg_sparse"])
def test_tiers_equal_gelly_tpu_every_round(kind):
    """Snapshots, forests (or degree rows), stats and tenants.* counters
    after every round, for every tier kind; tenants of uneven lengths."""
    make = {"raw": _raw_tier, "dense": _codec_tier("dense"),
            "sparse": _codec_tier("sparse"), "deg": _deg_tier(),
            "deg_sparse": _deg_tier("sparse")}[kind]
    compressed = kind in ("dense", "sparse", "deg_sparse")
    lengths = [96, 32, 160, 64, 128, 96]
    adm = {0: [(i, "x", _chunks(40 + i, n, compressed))
               for i, n in enumerate(lengths)]}
    engines, _ = _drive_pair({"x": make}, adm, merge_every=2)
    plan = engines["t"]._tiers["x"].batch.plan
    key = "fold_codec" if compressed else "fold"
    assert plan.forms[key] == "lane-batched"


def test_fused_tier_equals_gelly_tpu_every_round():
    def make(p):
        if p == "j":
            return jmq.fuse([j_cq(N_V), j_dq(N_V)]), CHUNK, False
        return tmq.fuse([t_cq(N_V), t_dq(N_V)]), CHUNK, False

    adm = {0: [(i, "mq", _chunks(60 + i, 96 + 32 * (i % 3)))
               for i in range(4)]}
    engines, _ = _drive_pair({"mq": make}, adm, merge_every=2)
    assert set(engines["t"]._tiers["mq"].batch.plan.forms.values()) == {
        "lane-by-lane"}


def test_dedup_fold_tier_equals_gelly_tpu_every_round(monkeypatch):
    """Chunks at the dedup threshold fold lane by lane through
    ``union_edges_dedup``: every lane's forest equals gelly_tpu's vmapped
    dedup fold (its per-lane branches) bit for bit."""
    monkeypatch.setattr(jcc, "RAW_DEDUP_MIN_CHUNK", CHUNK)
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", CHUNK)
    adm = {0: [(i, "x", _chunks(80 + i, 64 + 32 * i)) for i in range(3)]}
    engines, _ = _drive_pair({"x": _raw_tier}, adm, merge_every=2)
    forms = engines["t"]._tiers["x"].batch.plan.forms
    assert forms["fold"] == "lane-by-lane"
    assert forms["transform"] == "lane-batched"


def test_lane_growth_one_to_64_equals_gelly_tpu():
    adm = {}
    tid = 0
    for r, count in enumerate((1, 1, 2, 4, 8, 16, 32)):
        adm[r] = [(tid + k, "x", _chunks(200 + tid + k, 64))
                  for k in range(count)]
        tid += count
    engines, _ = _drive_pair({"x": _raw_tier}, adm, merge_every=2)
    assert engines["t"]._tiers["x"].batch.lanes == 64


def test_mesh_of_four_shards_equals_gelly_tpu():
    adm = {0: [(i, "x", _chunks(300 + i, 32 * (1 + i % 4)))
               for i in range(10)]}
    engines, _ = _drive_pair({"x": _raw_tier, "d": _deg_tier()},
                             {0: adm[0] + [(100 + i, "d",
                                            _chunks(400 + i, 64))
                                           for i in range(3)]},
                             merge_every=2, S=4)
    assert engines["t"]._tiers["x"].batch.lanes == 16


def test_reclamation_equals_gelly_tpu():
    lengths = [32, 64, 96, 320, 320, 32, 64, 32]
    adm = {0: [(i, "x", _chunks(500 + i, n))
               for i, n in enumerate(lengths)]}
    engines, outs = _drive_pair({"x": _raw_tier}, adm, merge_every=1,
                                reclaim_after=1)
    te = engines["t"]
    assert te.stats["reclaims"] >= 1
    for i in range(len(lengths)):
        assert te.snapshot_window(i) == engines["j"].snapshot_window(i)
        _same(engines["j"].labels(i), te.labels(i), f"parked {i}")


def test_masked_lane_keeps_a_forest_that_is_not_flat():
    """A lane resumed (set_lane) with a forest that is not flat, as a
    dedup-path checkpoint may hold, stays bit-unchanged while masked, and
    folds to gelly_tpu's forest once active."""
    chain = np.arange(N_V, dtype=np.int32)
    chain[1:40] = np.arange(0, 39, dtype=np.int32)  # 39 <- ... <- 1 <- 0
    seen = np.zeros(N_V, bool)
    seen[:40] = True
    engines = {p: ENG[p](merge_every=1) for p in "jt"}
    buses = {}
    scopes = {p: BUS[p].scope() for p in "jt"}
    for p in "jt":
        buses[p] = scopes[p].__enter__()
    try:
        for p, e in engines.items():
            e.add_tier("x", _cc_plan(pkg=p), CHUNK)
            e.admit("resumed", "x")
            e.admit("busy", "x")
            summary = (jcc.CCSummary if p == "j" else tcc.CCSummary)
            with e._dispatch_lock:
                e._tiers["x"].batch.set_lane(0, summary(chain, seen))
            for c in _stream(9, pkg=p):
                e.submit("busy", c)
        t_state = engines["t"]._tiers["x"].batch.state
        for r in range(3):
            assert all(_step(engines[p], buses[p]) for p in "jt")
            _same_engines(engines["j"], engines["t"], f"masked {r}")
            assert t_state.parent[0].numpy().tobytes() == chain.tobytes()
            assert unionfind.chase_depth(
                engines["t"]._tiers["x"].batch.state.parent[0]) == \
                unionfind.chase_depth(chain) > 1
        for p, e in engines.items():
            e.submit("resumed", next(iter(_stream(11, pkg=p))))
            e.finish("resumed")
            e.finish("busy")
        assert all(_step(engines[p], buses[p]) for p in "jt")
        _same_engines(engines["j"], engines["t"], "active")
        assert unionfind.chase_depth(
            engines["t"]._tiers["x"].batch.state.parent[0]) <= 1
    finally:
        for p in "jt":
            scopes[p].__exit__(None, None, None)


def test_lanes_converging_in_different_rounds_equal_per_lane_folds():
    """One lane needs many hook rounds (a long path fed far end first),
    another converges at once, a third is masked: the lane-batched fold
    equals each lane's own fold and gelly_tpu's."""
    agg = _cc_plan()
    path = [(v, v + 1) for v in range(N_V - 2, -1, -1)][:CHUNK]
    lanes = [path, [(3, 4)], None]
    from gelly_torch.core.chunk import make_chunk
    from gelly_torch.engine.tenants import _normalize_chunk

    chunks = [None if e is None else _normalize_chunk(make_chunk(
        np.asarray([a for a, _ in e]), np.asarray([b for _, b in e]),
        capacity=CHUNK, device=None), CHUNK) for e in lanes]
    plan = tagg._compiled_tenant_plan(agg, 4, device="cpu",
                                      chunk_capacity=CHUNK)
    assert plan.forms["fold"] == "lane-batched"
    batch = TenantBatch(agg, CHUNK, device="cpu")
    batch.ensure_lanes(3)
    stacked, active, on = batch.stage(chunks)
    state = plan.fold(plan.init(), stacked, active, on)
    for lane, c in enumerate(chunks):
        row = None if c is None else EdgeChunk(
            *(torch.from_numpy(f) for f in c))
        want = agg.init("cpu") if c is None else agg.fold(agg.init("cpu"),
                                                           row)
        _same(want, tagg._rows(state, lane), f"lane {lane}")
    # gelly_tpu's vmapped fold of the same three lanes.
    from gelly_tpu.engine.aggregation import _compiled_tenant_plan as jplan
    from gelly_tpu.core.chunk import make_chunk as j_make

    jagg = _cc_plan(pkg="j")
    jb = jten.TenantBatch(jagg, CHUNK)
    jb.ensure_lanes(3)
    jstacked, jactive = jb.stack_chunks([
        None if e is None else jten._normalize_chunk(j_make(
            np.asarray([a for a, _ in e]), np.asarray([b for _, b in e]),
            capacity=CHUNK, device=False), CHUNK) for e in lanes])
    jplan_ = jplan(jagg, 4)
    jstate = jplan_.fold(jplan_.init(), jax.device_put(jstacked),
                         jax.device_put(jactive))
    _same(jstate, state, "vs gelly_tpu")


def test_lane_offsets_at_the_top_of_the_i32_range():
    """The batched form holds ``lanes * slots <= 2^31 - 1`` slots: at the
    boundary the offsets and every shifted id stay exact in i32 (checked
    against int64), one lane more folds lane by lane."""
    top = (1 << 31) - 1
    lanes = 128
    n = top // lanes  # 16,777,215 slots a lane
    off = tagg.lane_offsets(lanes, n, "cpu")
    assert off.dtype == torch.int32
    want = np.arange(lanes, dtype=np.int64)[:, None] * n
    assert np.array_equal(off.numpy().astype(np.int64), want)
    ids = torch.tensor([[0, n - 1]] * lanes, dtype=torch.int32)
    shifted = ids + off
    assert np.array_equal(shifted.numpy().astype(np.int64),
                          ids.numpy().astype(np.int64) + want)
    assert int(shifted.max()) == lanes * n - 1 <= top - 1  # < INT_MAX pad
    assert np.array_equal((shifted - off).numpy(), ids.numpy())
    fits = tagg._compiled_tenant_plan(tcc.connected_components(n),
                                      lanes, device="cpu",
                                      chunk_capacity=CHUNK)
    assert fits.forms["fold"] == "lane-batched"
    over = tagg._compiled_tenant_plan(tcc.connected_components(n + 1),
                                      lanes, device="cpu",
                                      chunk_capacity=CHUNK)
    assert set(over.forms.values()) == {"lane-by-lane"}


def test_fold_form_pinned_for_each_plan(monkeypatch):
    def forms(agg, cap=CHUNK, lanes=8):
        return tagg._compiled_tenant_plan(agg, lanes, device="cpu",
                                          chunk_capacity=cap).forms

    batched = "lane-batched"
    by_lane = "lane-by-lane"
    assert forms(_cc_plan()) == {"fold": batched, "merger": batched,
                                 "transform": batched, "flatten": batched}
    for codec in ("dense", "sparse"):
        f = forms(tcc.connected_components(N_V, codec=codec))
        assert f["fold_codec"] == batched and f["fold"] == batched
    assert forms(degree_aggregate(N_V, ingest_combine=False)) == {
        "fold": batched, "merger": batched}
    assert forms(degree_aggregate(N_V, codec="sparse"))["fold_codec"] \
        == batched
    # The dedup fold: chunks of RAW_DEDUP_MIN_CHUNK lanes or more.
    big = tcc.RAW_DEDUP_MIN_CHUNK
    assert forms(_cc_plan(), cap=big)["fold"] == by_lane
    assert forms(_cc_plan(), cap=big - 1)["fold"] == batched
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", CHUNK)
    assert forms(_cc_plan())["fold"] == by_lane
    # A fused plan branches on each lane's step: lane by lane throughout.
    fused = tmq.fuse([t_cq(N_V), t_dq(N_V)])
    assert set(forms(fused).values()) == {by_lane}
    # A plan function replaced since the build is not the form's.
    agg = _cc_plan()
    plain_fold = agg.fold
    agg.fold = lambda s, c: plain_fold(s, c)
    assert forms(agg)["fold"] == by_lane
    assert forms(agg)["transform"] == batched


def test_checkpoints_equal_and_resume_across_packages(tmp_path):
    """Per-tenant checkpoint files of both packages hold equal leaves and
    metadata; a rotation written by either package resumes in the other,
    ending equal to the uninterrupted run."""
    chunks = {p: {i: list(_stream(600 + i, n_edges=256, pkg=p,
                                  identity=True)) for i in range(3)}
              for p in "jt"}
    dirs = {p: tmp_path / p for p in "jt"}
    for p in "jt":
        e = ENG[p](merge_every=2, checkpoint_dir=str(dirs[p]),
                   checkpoint_every=1)
        e.add_tier("cc", _cc_plan(pkg=p), CHUNK)
        for i in range(3):
            e.admit(i, "cc", chunks=chunks[p][i][:5])
        e.drain()
    names = {p: sorted(f.name for f in dirs[p].glob("*.npz")) for p in "jt"}
    assert names["j"] == names["t"] and names["t"]
    for name in names["t"]:
        jl, jpos, jmeta = j_load(str(dirs["j"] / name))
        tl, tpos, tmeta = load_checkpoint(str(dirs["t"] / name))
        assert (jpos, jmeta) == (tpos, tmeta)
        _same(jl, tl, name)
    want = {i: _oracle(_stream(600 + i, n_edges=256, identity=True),
                       _cc_plan(), merge_every=2) for i in range(3)}
    for writer, reader in (("j", "t"), ("t", "j")):
        e = ENG[reader](merge_every=2, checkpoint_dir=str(dirs[writer]),
                        checkpoint_every=1, resume=True)
        e.add_tier("cc", _cc_plan(pkg=reader), CHUNK)
        for i in range(3):
            e.admit(i, "cc", chunks=chunks[reader][i])
        out = e.drain()
        assert e.stats["chunks"] == 3 * 3
        for i in range(3):
            assert np.asarray(out[i]).tobytes() == want[i].tobytes(), \
                (writer, reader, i)


def test_tenant_state_converters_carry_both_ways():
    """A JAX tier's stacked state carried into the port's stack
    (``convert.tenant_state_from_numpy``) folds on to the same forests;
    ``tenant_state_to_numpy`` gives gelly_tpu's leaves back."""
    lanes = 4
    jagg, tagg_ = _cc_plan(pkg="j"), _cc_plan()
    jb, tb = jten.TenantBatch(jagg, CHUNK), TenantBatch(tagg_, CHUNK,
                                                         device="cpu")
    for b in (jb, tb):
        b.ensure_lanes(lanes)
    per = {p: [next(iter(_stream(700 + i, pkg=p, identity=True)))
               for i in range(lanes)] for p in "jt"}
    js, ja = jb.stack_chunks([jten._normalize_chunk(c, CHUNK)
                              for c in per["j"]])
    jstate = jb.plan.fold(jb.state, jax.device_put(js),
                          jax.device_put(ja))
    host = jax.tree.map(np.asarray, jstate)
    tstate = convert.tenant_state_from_numpy(tagg_, host, device="cpu")
    _same(host, tstate, "carried")
    back = convert.tenant_state_to_numpy(tstate)
    _same(jax.tree.leaves(host), back, "back")
    with pytest.raises(TypeError, match="must be"):
        convert.tenant_state_from_numpy(
            tagg_, (host.parent.astype(np.int64), host.seen), device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        convert.tenant_state_from_numpy(
            tagg_, (host.parent[:, :8], host.seen), device="cpu")


def test_serving_stress_submitters_and_queriers():
    """More threads than cores under a short switch interval: 8 submitter
    threads and 4 querying threads against a serving engine. Every answer
    is a snapshot some prefix of its tenant's stream gives, no thread
    raises, and every tenant ends equal to its single-stream run."""
    cc = _cc_plan()
    n_t = 16
    chunks = {t: list(_stream(800 + t, n_edges=192)) for t in range(n_t)}
    empty = np.full(N_V, -1, np.int32).tobytes()
    prefixes = {t: {empty} | {
        x.numpy().tobytes() for x in _stream(800 + t, n_edges=192)
        .aggregate(cc, merge_every=1)} for t in range(n_t)}
    eng = _engine(merge_every=2, poll_s=0.001)
    eng.add_tier("cc", cc, CHUNK)
    for t in range(n_t):
        eng.admit(t, "cc")
    errors, stale = [], []
    done = threading.Event()

    def submit(k):
        try:
            for t in range(k, n_t, 8):
                for c in chunks[t]:
                    eng.submit(t, c)
                eng.finish(t)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def query(k):
        rng = np.random.default_rng(k)
        try:
            while not done.is_set():
                t = int(rng.integers(0, n_t))
                row = eng.labels(t)
                if row is not None and row.tobytes() not in prefixes[t]:
                    stale.append(t)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = ([threading.Thread(target=submit, args=(k,))
                for k in range(8)]
               + [threading.Thread(target=query, args=(k,))
                  for k in range(4)])
    eng.start()
    try:
        for th in threads:
            th.start()
        for th in threads[:8]:
            th.join(60)
        deadline = time.time() + 60
        while time.time() < deadline and not (
                all(r["done"] for r in eng.telemetry().values())
                and eng._tiers["cc"].chunks_in_window == 0):
            time.sleep(0.01)
    finally:
        done.set()
        for th in threads[8:]:
            th.join(30)
        eng.stop()
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not stale
    for t in range(n_t):
        want = _oracle(_stream(800 + t, n_edges=192), cc, merge_every=2)
        assert eng.labels(t).tobytes() == want.tobytes(), t


# --------------------------------------------------------------------- #
# wire routing (the ingest front end, mirrored): a TenantRouter over the
# port's engine, fed by port and gelly_tpu clients


_WIRE_CLIENTS = pytest.mark.parametrize("client", ["torch", "tpu"])


def _wire_pkg(name):
    from _torch_wire import pkg

    return pkg(name)


def _route(client, tids, edges, compressed, agg, cap):
    from gelly_torch.ingest import IngestServer, TenantRouter

    from _torch_wire import host_chunk, wait

    C = _wire_pkg(client)
    eng = _engine(merge_every=1).start()
    router = TenantRouter(eng, "small", vertex_capacity=N_V)
    eng.add_tier("small", agg, cap, compressed=compressed)
    servers, clients = [], []
    try:
        for t in tids:
            s = IngestServer(port=0).start()
            router.attach(s)
            servers.append(s)
            clients.append((t, C.IngestClient("127.0.0.1", s.port,
                                              connect_timeout=5.0)
                            .connect()))
        for t, c in clients:
            for i in range(0, 64, 16):
                src, dst = edges[t][i:i + 16, 0], edges[t][i:i + 16, 1]
                if compressed:
                    # The client compresses before send with its own
                    # package's codec: the payload bytes are the same.
                    ccod = C.cc.cc_tenant_tier(
                        N_V, chunk_capacity=16, compressed=True,
                        codec="sparse")[0]
                    p = {k: np.asarray(v) for k, v in ccod.host_compress(
                        host_chunk(C, src, dst, 16)).items()}
                    p["tenant"] = np.array([t], np.int64)
                    c.send_compressed(p)
                else:
                    p = C.edge_payload(src, dst)
                    p["tenant"] = np.array([t], np.int64)
                    c.send(p)
            c.flush(timeout=30)

        def folded():
            try:
                return eng.queue_depth() == 0 and all(
                    eng.position(t) >= 4 for t in tids)
            except KeyError:
                return False  # auto-admission not seen yet

        assert wait(folded, 30, 0.05)
        for t in tids:
            eng.finish(t)
        assert wait(lambda: all(eng.snapshot_window(t) > 0 for t in tids),
                    10, 0.05)
        return {t: _host(eng.labels(t)) for t in tids}
    finally:
        for _t, c in clients:
            c.close(flush_timeout=None)
        eng.stop()
        for s in servers:
            s.stop()
        router.stop()


def _single_stream_labels(edges, pkg):
    plan = _cc_plan(pkg=pkg)
    kw = {} if pkg == "j" else {"device": "cpu"}
    table = JIdentity(N_V) if pkg == "j" else TIdentity(N_V)
    edges_fn = j_edges if pkg == "j" else t_edges
    st = edges_fn([(int(a), int(b)) for a, b in edges], vertex_capacity=N_V,
                  chunk_size=16, table=table, **kw)
    return _host(st.aggregate(plan, merge_every=1).result())


@pytest.mark.ingest
@_WIRE_CLIENTS
def test_tenant_router_routes_compressed_streams(client):
    """Clients compress before send (DATA_COMPRESSED with a tenant tag);
    the router submits the payloads into the compressed tier and the
    labels equal the single-stream oracle of both packages."""
    agg, cap = cc_tenant_tier(N_V, chunk_capacity=16, compressed=True,
                              codec="sparse")
    edges = {t: np.random.default_rng(200 + t).integers(0, N_V, (64, 2))
             for t in (3, 4)}
    got = _route(client, (3, 4), edges, True, agg, cap)
    for t in (3, 4):
        want = _single_stream_labels(edges[t], "j")
        assert got[t].tobytes() == want.tobytes()
        assert _single_stream_labels(edges[t], "t").tobytes() == \
            want.tobytes()


@pytest.mark.ingest
@_WIRE_CLIENTS
def test_tenant_router_routes_n_client_streams(client):
    agg, cap = cc_tenant_tier(N_V, chunk_capacity=16)
    edges = {t: np.random.default_rng(t).integers(0, N_V, (64, 2))
             for t in (7, 9)}
    got = _route(client, (7, 9), edges, False, agg, cap)
    for t in (7, 9):
        want = _single_stream_labels(edges[t], "j")
        assert got[t].tobytes() == want.tobytes()


@pytest.mark.ingest
def test_tenant_router_unroutable_payloads_counted():
    from gelly_torch.ingest import IngestClient, IngestServer, TenantRouter
    from gelly_torch.ingest.client import edge_payload

    from _torch_wire import wait

    agg, cap = cc_tenant_tier(N_V, chunk_capacity=16)
    with obs_bus.scope() as bus:
        eng = _engine(merge_every=1).start()
        eng.add_tier("small", agg, cap)
        router = TenantRouter(eng, "small", vertex_capacity=N_V,
                              auto_admit=False)
        s = IngestServer(port=0).start()
        router.attach(s)
        try:
            c = IngestClient("127.0.0.1", s.port).connect()
            p = edge_payload(np.array([1, 2]), np.array([3, 4]))
            p["tenant"] = np.array([42], np.int64)  # never admitted
            c.send(p)
            c.flush(timeout=10)
            assert wait(lambda: bus.counters.get(
                "ingest.chunks_unroutable", 0) >= 1, 10, 0.02)
            with pytest.raises(KeyError):
                eng.position(42)
            c.close(flush_timeout=None)
        finally:
            eng.stop()
            s.stop()
            router.stop()


def test_window_close_during_admission_checkpoints_ready_tenants_only(
        tmp_path, monkeypatch):
    """A window closing between ``admit``'s manager setup and its lane
    widening used to slice past the stack and kill the scheduler
    (``gelly_tpu``'s clamping slice saves another lane's state there): the
    checkpoint now covers ready tenants only, and the new tenant's first
    checkpoint holds its own lane."""
    agg, cap = cc_tenant_tier(N_V, chunk_capacity=16)
    eng = _engine(merge_every=1, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1, resume=True)
    eng.add_tier("small", agg, cap)
    eng.admit(0, "small")
    tier = eng._tiers["small"]
    load = CheckpointManager.load_latest
    closed = []

    def load_latest(self, *a, **kw):
        # admit() reads a resume checkpoint after it sets the tenant's
        # manager and before it widens the stack: a window closes here.
        if self.prefix == "t1":
            eng._checkpoint_tier(tier)
            closed.append(tier.batch.lanes)
        return load(self, *a, **kw)

    monkeypatch.setattr(CheckpointManager, "load_latest", load_latest)
    assert eng.admit(1, "small") == 1
    assert closed == [1]  # the stack was one lane wide at the close
    assert list(tmp_path.glob("t0-*.npz"))
    assert not list(tmp_path.glob("t1-*.npz"))
    eng._checkpoint_tier(tier)
    assert list(tmp_path.glob("t1-*.npz"))
