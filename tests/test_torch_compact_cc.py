"""The gelly_torch codec plans (compact, sparse, dense) vs gelly_tpu (CPU).

Same seeded Zipf streams into both packages; gelly_tpu runs on a
one-device mesh. Tolerance: exact equality, dtype included — native codec
outputs, compact-id assignments, stacked payloads, union-find forests
(``union_pairs_star`` / ``union_pairs_compact`` bit for bit, not only
labels), fold states and every emitted window.
"""

import functools
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine import aggregation as tagg
from gelly_torch.library import connected_components as tcc
from gelly_torch.ops import compact_space as tcs
from gelly_torch.ops import unionfind as tu
from gelly_torch.utils import metrics as tmetrics
from gelly_torch.utils import native as tnat
from gelly_torch.utils.prefetch import prefetch, prefetch_map
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.engine import aggregation as jagg
from gelly_tpu.ops import compact_space as jcs
from gelly_tpu.ops import unionfind as ju
from gelly_tpu.parallel.mesh import make_mesh
from gelly_tpu.utils import native as jnat

from _torch_native import load_jax_native

jcc = importlib.import_module("gelly_tpu.library.connected_components")

N = 1024
N_EDGES = 2700  # 11 chunks of 256: windows of 4, 4 and 3 chunks
CHUNK = 256
MERGE_EVERY = 4


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _zipf(seed=3, e=N_EDGES, n=N, a=1.3):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(a, e) % n).astype(np.int32)
    dst = (rng.zipf(a, e) % n).astype(np.int32)
    return src, dst


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


def _tstream(src, dst, n=N, chunk=CHUNK):
    return t_stream(TSource(src, dst, chunk_size=chunk, table=TIdentity(n)),
                    n, device="cpu")


def _jstream(src, dst, n=N, chunk=CHUNK):
    return j_stream(JSource(src, dst, chunk_size=chunk, table=JIdentity(n)),
                    n)


# --------------------------------------------------------------------- #
# native bindings: the port's own build vs gelly_tpu's


def test_native_builds_into_the_port_tree():
    assert tnat.unit_segments_available()
    assert tnat.sparse_idx_available() and tnat.compact_session_available()
    path = tnat.library_path("chunk_combiner")
    assert path.startswith(tnat.BUILD_DIR)
    assert tnat._load_combiner()._name == path


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["cc_unit_forest_segments",
                                "cc_chunk_combine_sparse",
                                "cc_chunk_combine_sparse_idx",
                                "cc_chunk_combine"])
def test_native_codec_equals_gelly_tpu(fn, masked):
    src, dst = _zipf(seed=7, e=6000, n=3000)
    valid = None
    if masked:
        valid = np.random.default_rng(1).random(src.shape[0]) < 0.8
    kw = {"block": 997} if fn == "cc_unit_forest_segments" else {}
    got = getattr(tnat, fn)(src, dst, valid, 3000, **kw)
    want = getattr(jnat, fn)(src, dst, valid, 3000, **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_unit_forest_builder_equals_gelly_tpu():
    src, dst = _zipf(seed=9, e=8000, n=2000)
    out = []
    for nat in (tnat, jnat):
        b = nat.UnitForestBuilder(2000, block=1 << 10)
        for lo in range(0, 8000, 1500):
            b.add(src[lo:lo + 1500], dst[lo:lo + 1500], None)
        out.append(b.finish())
        with pytest.raises(RuntimeError, match="already finished"):
            b.finish()
    for g, w in zip(*out):
        _same(g, w)
    m, ln = out[0]
    assert int(ln.sum()) == m.shape[0]


def test_native_range_error_matches():
    src = np.array([0, 5000], np.int32)
    dst = np.array([1, 2], np.int32)
    for nat in (tnat, jnat):
        with pytest.raises(ValueError, match="out of range"):
            nat.cc_chunk_combine_sparse(src, dst, None, 100)


# --------------------------------------------------------------------- #
# CompactIdSession: the JAX package's session scenarios, both backends


def _sessions(backend, capacity):
    """(port, jax) sessions on the same backend."""
    out = []
    for mod in (tcs, jcs):
        s = mod.CompactIdSession(capacity)
        if backend == "numpy":
            s._native = None
            s.reset()
        else:
            assert s._native is not None
        out.append(s)
    return out


BACKENDS = ["native", "numpy"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_assign_lookup_roundtrip(backend):
    s, js = _sessions(backend, 64)
    ids = np.array([9, 3, 40, 7], np.int32)
    cids, new_ids, base = s.assign(ids)
    for g, w in zip((cids, new_ids, base), js.assign(ids)):
        _same(g, w)
    assert base == 0 and sorted(new_ids) == [3, 7, 9, 40]
    cids2, new2, base2 = s.assign(np.array([3, 11, 9], np.int32))
    assert base2 == 4 and new2.tolist() == [11]
    assert cids2[0] == cids[1] and cids2[2] == cids[0] and cids2[1] == 4
    assert np.array_equal(s.lookup(np.array([40, 11])), [cids[2], 4])
    with pytest.raises(KeyError):
        s.lookup(np.array([999]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_assign_sequence_equals_gelly_tpu(backend):
    s, js = _sessions(backend, 4000)
    rng = np.random.default_rng(backend == "native")
    for _ in range(12):
        ids = np.unique(rng.integers(0, 5000, 300)).astype(np.int32)
        ids = rng.permutation(ids).astype(np.int32)
        got, want = s.assign(ids), js.assign(ids)
        for g, w in zip(got, want):
            _same(np.asarray(g), np.asarray(w))
    assert s.assigned == js.assigned


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_lookup_empty_raises_keyerror(backend):
    s, _ = _sessions(backend, 8)
    with pytest.raises(KeyError):
        s.lookup(np.array([5], np.int32))
    assert s.lookup(np.empty(0, np.int32)).shape == (0,)


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_turn_ordering(backend):
    s, _ = _sessions(backend, 64)
    order: list[int] = []

    def worker(seq, ids):
        s.await_turn(seq)
        try:
            s.assign(np.asarray(ids, np.int32))
            order.append(seq)
        finally:
            s.complete_turn(seq)

    t1 = threading.Thread(target=worker, args=(1, [7, 8]))
    t1.start()
    time.sleep(0.05)
    assert order == []  # unit 1 parked
    t0 = threading.Thread(target=worker, args=(0, [7, 9]))
    t0.start()
    t0.join(5)
    t1.join(5)
    assert order == [0, 1]
    assert np.array_equal(s.lookup(np.array([7, 9, 8])), [0, 1, 2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_turn_wait_accounting(backend):
    s, _ = _sessions(backend, 64)
    s.await_turn(0)
    s.complete_turn(0)
    assert s.wait_s == 0.0
    t2 = threading.Thread(target=lambda: (s.await_turn(2),
                                          s.complete_turn(2)))
    t2.start()
    time.sleep(0.05)
    s.await_turn(1)
    s.complete_turn(1)
    t2.join(5)
    assert not t2.is_alive()
    assert s.wait_s >= 0.04
    s.reset()
    assert s.wait_s == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_turn_release_before_turn_unparks_later_units(backend):
    s, _ = _sessions(backend, 64)
    s.complete_turn(2)  # unit 2 died early
    done = []

    def unit3():
        s.await_turn(3)
        done.append(3)
        s.complete_turn(3)

    t3 = threading.Thread(target=unit3)
    t3.start()
    for seq in (0, 1):
        s.await_turn(seq)
        s.complete_turn(seq)
    t3.join(5)
    assert done == [3] and not t3.is_alive()


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_overflow_raises_like_gelly_tpu(backend):
    msgs = []
    for s in _sessions(backend, 4):
        s.assign(np.array([1, 2, 3], np.int32))
        with pytest.raises(Exception) as e:
            s.assign(np.array([10, 11], np.int32))
        assert type(e.value).__name__ == "CompactSpaceOverflow"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_rebuild_from_vertex_of(backend):
    s, _ = _sessions(backend, 16)
    s.assign(np.array([30, 10, 20], np.int32))
    vertex_of = np.full(16, -1, np.int32)
    vertex_of[[0, 1, 2]] = [10, 20, 30]
    s2, _ = _sessions(backend, 16)
    s2.rebuild_from_vertex_of(vertex_of)
    assert np.array_equal(s2.lookup(np.array([10, 20, 30])), [0, 1, 2])
    assert s2.assigned == 3
    vertex_of[5] = 50
    s2.rebuild_from_vertex_of(vertex_of)
    _, _, base = s2.assign(np.array([60], np.int32))
    assert base == 6
    with pytest.raises(ValueError, match="compact_capacity"):
        s2.rebuild_from_vertex_of(np.full(32, -1, np.int32))


# --------------------------------------------------------------------- #
# payload stacking


def _ragged(seed, n_payloads, keys, longest):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_payloads):
        p = {k: rng.integers(0, 100, rng.integers(0, longest)).astype(np.int32)
             for k in keys}
        p["base"] = np.asarray(rng.integers(0, 9), np.int32)
        out.append(p)
    return out


@pytest.mark.parametrize("kw", [
    {},
    {"min_bucket": 16},
    {"min_bucket": 8, "quantum": 24},
    {"min_bucket": 4, "quantum": 7,
     "per_key": {"len": (2, 3), "newv": (16, 32)}},
    {"min_bucket": 1, "per_key": {"len": (1, None)}},
])
def test_bucket_stack_payloads_equals_gelly_tpu(kw):
    payloads = _ragged(len(kw), 5, ("m", "len", "newv"), 200)
    pads = {"m": -1, "len": 0, "newv": -1}
    got = tagg.bucket_stack_payloads(payloads, pads, **kw)
    want = jagg.bucket_stack_payloads(payloads, pads, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.parametrize("n_payloads,groups", [(5, 1), (6, 4), (3, 4),
                                               (7, 2)])
def test_group_combine_payloads_equals_gelly_tpu(n_payloads, groups):
    payloads = _ragged(n_payloads, n_payloads, ("v", "r"), 50)

    def combine(grp):
        return {"v": np.concatenate([q["v"] for q in grp]),
                "r": np.concatenate([q["r"] for q in grp])}

    empty = {"v": np.empty(0, np.int32), "r": np.empty(0, np.int32)}
    got = tagg.group_combine_payloads(payloads, groups, combine, empty)
    want = jagg.group_combine_payloads(payloads, groups, combine, empty)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("v", "r"):
            _same(g[k], w[k])


def test_sparse_payload_id_check_matches():
    for mod in (tagg, jagg):
        check = mod.sparse_payload_id_check(16, "v", "r")
        check({"v": np.array([0, 15], np.int32), "r": np.empty(0, np.int32)})
        with pytest.raises(ValueError, match="out of range"):
            check({"v": np.array([16], np.int32), "r": np.zeros(1, np.int32)})
        with pytest.raises(ValueError, match="missing key"):
            check({"v": np.zeros(1, np.int32)})


def test_available_cores_and_sparse_codec_rule():
    assert tagg.available_cores() == jagg.available_cores() >= 1
    for codec in ("auto", "dense", "sparse"):
        for n in (1 << 10, 1 << 20):
            assert tagg.resolve_sparse_codec(codec, n) == \
                jagg.resolve_sparse_codec(codec, n)
    with pytest.raises(ValueError):
        tagg.resolve_sparse_codec("compact", N)


# --------------------------------------------------------------------- #
# union_pairs_star / union_pairs_compact: bit-identical forests


M = 2048


def _star_rows(rng, k, cap, n_members, m=M):
    """``(v, ri, valid)`` flat: K rows of host-combined stars over cids
    (each root first in its star, padding lanes ``-1``/``0``)."""
    v = np.full((k, cap), -1, np.int32)
    ri = np.zeros((k, cap), np.int32)
    for row in range(k):
        ids = rng.choice(m, n_members, replace=False).astype(np.int32)
        pos = 0
        while pos < n_members:
            size = int(min(n_members - pos, rng.integers(1, 12)))
            v[row, pos:pos + size] = ids[pos:pos + size]
            ri[row, pos:pos + size] = pos  # the root is the star's first
            pos += size
    flat_ri = (ri + cap * np.arange(k, dtype=np.int32)[:, None]).reshape(-1)
    v = v.reshape(-1)
    return v, flat_ri, v >= 0


def _forest(kind, rng, m=M):
    if kind == "fresh":
        return np.arange(m, dtype=np.int32)
    if kind == "chain":  # deep chains: the fast rounds cannot finish
        p = np.arange(m, dtype=np.int32)
        p[1:] = np.arange(m - 1, dtype=np.int32)
        p[::97] = np.arange(0, m, 97, dtype=np.int32)
        return p
    p = np.arange(m, dtype=np.int32)  # a mid-stream forest, not flat
    for i in range(1, m):
        if rng.random() < 0.7:
            p[i] = rng.integers(max(0, i - 8), i)
    return p


def _star_case(case, rng):
    if case == "hot-vertex":
        p = _forest("mid", rng)
        v = np.zeros(600, np.int32)  # one star: every lane joins cid 0
        v[1:] = rng.choice(np.arange(1, M), 599, replace=False)
        ri = np.zeros(600, np.int32)
        return p, v, ri, np.ones(600, bool)
    if case == "chains":
        p = _forest("chain", rng)
        v, ri, valid = _star_rows(rng, 3, 512, 400)
        return p, v, ri, valid
    if case == "already-joined":
        p = np.zeros(M, np.int32)  # one flat component
        v, ri, valid = _star_rows(rng, 2, 256, 200)
        return p, v, ri, valid
    if case == "padding":
        p = _forest("mid", rng)
        v, ri, valid = _star_rows(rng, 4, 300, 120)
        return p, v, ri, valid
    p = _forest("mid", rng)  # "mid-stream"
    v, ri, valid = _star_rows(rng, 4, 512, 500)
    return p, v, ri, valid


@pytest.mark.parametrize("case", ["hot-vertex", "chains", "already-joined",
                                  "padding", "mid-stream"])
def test_union_pairs_star_forest_equals_gelly_tpu(case):
    rng = np.random.default_rng(len(case))
    p, v, ri, valid = _star_case(case, rng)
    want = ju.union_pairs_star(jnp.asarray(p), jnp.asarray(v),
                               jnp.asarray(ri), jnp.asarray(valid))
    before = tu.host_sync.count
    got = tu.union_pairs_star(_t(p), _t(v), _t(ri), _t(valid))
    syncs = tu.host_sync.count - before
    _same(got, want)
    # The forest is a forest of the same components as a numpy oracle.
    roots = tu.pointer_jump(got).numpy()
    vv = np.where(valid, v, 0)
    assert np.array_equal(roots[vv[valid]], roots[vv[ri[valid]]])
    if case == "already-joined":
        assert syncs == 1  # live0 False: the one check, no fixpoint
    if case == "chains":
        assert syncs > 1  # the fast rounds left work for the fixpoint


def test_union_pairs_star_depths_equal_gelly_tpu():
    rng = np.random.default_rng(5)
    p, v, ri, valid = _star_case("chains", rng)
    for depths, check in (((1,), 1), ((2, 3, 4), 4), ((), 2)):
        want = ju.union_pairs_star(jnp.asarray(p), jnp.asarray(v),
                                   jnp.asarray(ri), jnp.asarray(valid),
                                   fast_depths=depths, check_depth=check)
        got = tu.union_pairs_star(_t(p), _t(v), _t(ri), _t(valid),
                                  fast_depths=depths, check_depth=check)
        _same(got, want)


def _pairs_case(case, rng, n=M):
    flat = np.asarray(ju.pointer_jump(jnp.asarray(_forest("mid", rng, n))))
    if case == "hot-vertex":
        src = np.zeros(700, np.int32)
        dst = rng.integers(0, n, 700).astype(np.int32)
        valid = np.ones(700, bool)
    elif case == "chains":
        src = np.arange(0, n - 1, 3, dtype=np.int32)
        dst = src + 1
        valid = np.ones(src.shape[0], bool)
    elif case == "already-joined":
        flat = np.zeros(n, np.int32)
        src = rng.integers(0, n, 500).astype(np.int32)
        dst = rng.integers(0, n, 500).astype(np.int32)
        valid = np.ones(500, bool)
    else:  # "padding": masked lanes carry lane 0 / root 0, as the plan
        src = rng.integers(0, n, 800).astype(np.int32)
        dst = rng.integers(0, n, 800).astype(np.int32)
        valid = rng.random(800) < 0.6
        src = np.where(valid, src, 0).astype(np.int32)
        dst = np.where(valid, dst, 0).astype(np.int32)
    return flat, src, dst, valid


@pytest.mark.parametrize("case", ["hot-vertex", "chains", "already-joined",
                                  "padding"])
def test_union_pairs_compact_forest_equals_gelly_tpu(case):
    rng = np.random.default_rng(len(case) + 50)
    p, src, dst, valid = _pairs_case(case, rng)
    want = ju.union_pairs_compact(jnp.asarray(p), jnp.asarray(src),
                                  jnp.asarray(dst), jnp.asarray(valid))
    got = tu.union_pairs_compact(_t(p), _t(src), _t(dst), _t(valid))
    _same(got, want)
    assert tu.chase_depth(got) <= 1  # flat again


# --------------------------------------------------------------------- #
# the folds, fed gelly_tpu's own stacked payloads


def _jax_units(jplan, src, dst, batch=4):
    """The JAX plan's stacked payloads, unit by unit (its own session)."""
    chunks = list(JSource(src, dst, chunk_size=CHUNK, table=JIdentity(N)))
    jplan.on_run_start()
    out = []
    for seq, lo in enumerate(range(0, len(chunks), batch)):
        payloads = [jplan.host_compress(c) for c in chunks[lo:lo + batch]]
        out.append(jplan.stack_payloads(payloads, 1, seq=seq))
    return out


@pytest.mark.parametrize("wire", ["segments", "pairs"])
def test_compact_folds_equal_gelly_tpu_on_its_payloads(wire):
    src, dst = _zipf(seed=31, e=4000)
    jplan = jcc.connected_components_compact(N, compact_capacity=N,
                                             wire=wire)
    tplan = tcc.connected_components_compact(N, compact_capacity=N,
                                             wire=wire)
    assert tplan.wire == wire
    assert tplan.fold_compressed.__name__ == (
        "fold_segments" if wire == "segments" else "fold_compressed")
    jfold = jax.jit(jplan.fold_compressed)
    js = jplan.init()
    ts = tplan.init("cpu")
    for payload in _jax_units(jplan, src, dst):
        js = jfold(js, payload)
        ts = tplan.fold_compressed(ts, {k: _t(v) for k, v in payload.items()})
        _same(ts.croot, js.croot)
        _same(ts.vertex_of, js.vertex_of)
    _same(tplan.transform(ts), jplan.transform(js))
    _same(tplan.flatten(ts).croot, jplan.flatten(js).croot)
    _same(tplan.transform(ts), tcc.cc_labels_numpy(src, dst, None, N))


def test_compact_summary_convert_round_trip():
    src, dst = _zipf(seed=37, e=4000)
    jplan = jcc.connected_components_compact(N, compact_capacity=N)
    tplan = tcc.connected_components_compact(N, compact_capacity=N)
    units = _jax_units(jplan, src, dst)
    jfold = jax.jit(jplan.fold_compressed)
    js = jplan.init()
    for payload in units[:2]:
        js = jfold(js, payload)
    ts = convert.cc_compact_summary_from_numpy(
        np.asarray(js.croot), np.asarray(js.vertex_of), device="cpu")
    back = convert.cc_compact_summary_to_numpy(ts)
    _same(back[0], js.croot)
    _same(back[1], js.vertex_of)
    for payload in units[2:]:
        js = jfold(js, payload)
        ts = tplan.fold_compressed(ts, {k: _t(v) for k, v in payload.items()})
    _same(ts.croot, js.croot)
    _same(tplan.transform(ts), jplan.transform(js))
    # The other way: the port's state continues in gelly_tpu.
    croot, vof = convert.cc_compact_summary_to_numpy(ts)
    js2 = jcc.CCCompactSummary(jnp.asarray(croot), jnp.asarray(vof))
    _same(jplan.transform(js2), tplan.transform(ts))
    with pytest.raises(TypeError):
        convert.cc_compact_summary_from_numpy(
            np.zeros(4, np.int64), np.zeros(4, np.int32), device="cpu")
    with pytest.raises(ValueError):
        convert.cc_compact_summary_from_numpy(
            np.zeros(4, np.int32), np.zeros(5, np.int32), device="cpu")


# --------------------------------------------------------------------- #
# end to end: every emission equals gelly_tpu's


PLANS = {
    "compact-segments": lambda pkg, n: pkg.connected_components(
        n, merge="gather", codec="compact", compact_capacity=n),
    "compact-pairs": lambda pkg, n: pkg.connected_components_compact(
        n, compact_capacity=n, wire="pairs"),
    "sparse": lambda pkg, n: pkg.connected_components(n, codec="sparse"),
    "dense": lambda pkg, n: pkg.connected_components(n, codec="dense"),
    "default": lambda pkg, n: pkg.connected_components(n),
}
LARGE_N = 1 << 20  # connected_components(n) picks the sparse codec here


@functools.lru_cache(maxsize=None)
def _jax_emissions(plan, n=N, seed=3):
    src, dst = _zipf(seed=seed, n=n)
    agg = PLANS[plan](jcc, n)
    return [np.asarray(x) for x in _jstream(src, dst, n).aggregate(
        agg, merge_every=MERGE_EVERY, mesh=make_mesh(1))]


def _torch_emissions(plan, n=N, seed=3, **knobs):
    src, dst = _zipf(seed=seed, n=n)
    agg = PLANS[plan](tcc, n)
    out = []
    res = _tstream(src, dst, n).aggregate(agg, merge_every=MERGE_EVERY,
                                          **knobs)
    for x in res:
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        out.append(x.numpy())
    return out, agg, res


def _check_emissions(got, want, n=N):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    src, dst = _zipf(n=n)
    _same(got[-1], tcc.cc_labels_numpy(src, dst, None, n))


@pytest.mark.parametrize("h2d_depth", [0, 2])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("fold_batch", [1, 2, 4])
def test_compact_segments_emissions_equal_gelly_tpu(fold_batch, workers,
                                                    h2d_depth):
    got, agg, res = _torch_emissions(
        "compact-segments", fold_batch=fold_batch, ingest_workers=workers,
        h2d_depth=h2d_depth)
    assert agg.wire == "segments"
    _check_emissions(got, _jax_emissions("compact-segments"))
    assert agg.session.assigned == int((got[-1] >= 0).sum())
    units = -(-4 // fold_batch) * 2 + -(-3 // fold_batch)
    assert res.stats["units"] == units and res.stats["chunks"] == 11
    busy = res.timer.busy()
    for stage in ("ingest_compress", "codec_wait", "h2d", "fold_dispatch",
                  "merge_emit"):
        assert stage in busy


@pytest.mark.parametrize("fold_batch", [1, 2, 4])
@pytest.mark.parametrize("plan", ["compact-pairs", "sparse", "dense",
                                  "default"])
def test_codec_plan_emissions_equal_gelly_tpu(plan, fold_batch):
    got, agg, _ = _torch_emissions(plan, fold_batch=fold_batch,
                                   ingest_workers=2, h2d_depth=2)
    _check_emissions(got, _jax_emissions(plan))


@pytest.mark.parametrize("fold_batch", [1, 4])
def test_default_plan_at_large_capacity_equals_gelly_tpu(fold_batch):
    # At 2^20 slots both packages build the sparse codec plan by default.
    assert tcc.connected_components(LARGE_N).codec_pad_values == \
        {"v": -1, "r": 0}
    got, _, _ = _torch_emissions("default", n=LARGE_N,
                                 fold_batch=fold_batch)
    _check_emissions(got, _jax_emissions("default", n=LARGE_N), n=LARGE_N)


@pytest.mark.parametrize("threads", [False, True])
@pytest.mark.parametrize("fold_batch", [1, 2])
def test_raw_plan_fold_batch_equals_gelly_tpu(fold_batch, threads):
    # Raw plans run inline by default; the pipeline's threads on request.
    src, dst = _zipf()
    jagg_ = jcc.connected_components(N, merge="gather", ingest_combine=False)
    want = [np.asarray(x) for x in _jstream(src, dst).aggregate(
        jagg_, merge_every=MERGE_EVERY, fold_batch=fold_batch,
        mesh=make_mesh(1))]
    tagg_ = tcc.connected_components(N, merge="gather", ingest_combine=False)
    knobs = {"ingest_workers": 2, "h2d_depth": 2} if threads else {}
    got = [x.numpy() for x in _tstream(src, dst).aggregate(
        tagg_, merge_every=MERGE_EVERY, fold_batch=fold_batch, **knobs)]
    _check_emissions(got, want)


def test_rerun_same_aggregation_instance():
    src, dst = _zipf()
    agg = PLANS["compact-segments"](tcc, N)
    runs = [[x.numpy() for x in _tstream(src, dst).aggregate(
        agg, merge_every=MERGE_EVERY, fold_batch=2)] for _ in range(2)]
    _check_emissions(runs[0], _jax_emissions("compact-segments"))
    _check_emissions(runs[1], _jax_emissions("compact-segments"))


def test_ordered_staging_stress_more_workers_than_cores():
    # 16 workers (more than the cores) race for the ordered id-assign
    # turn with a tiny switch interval; an assign out of stream order
    # would leave a window's new vertices undecodable (-1), so every
    # per-unit emission must equal its prefix oracle.
    import sys

    src, dst = _zipf(seed=43, e=4000)
    agg = PLANS["compact-segments"](tcc, N)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = _tstream(src, dst, chunk=128).aggregate(
            agg, merge_every=1, ingest_workers=16, prefetch_depth=16)
        got = [x.numpy() for x in res]
    finally:
        sys.setswitchinterval(old)
    assert len(got) == res.stats["units"] == 32
    for i, lab in enumerate(got):
        n = min((i + 1) * 128, 4000)
        _same(lab, tcc.cc_labels_numpy(src[:n], dst[:n], None, N))
    assert agg.session.assigned == int((got[-1] >= 0).sum())


def _codec_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("gelly-codec", "gelly-h2d",
                                  "gelly-prefetch")) and t.is_alive()]


def _wait_threads_gone(before):
    deadline = time.monotonic() + 5.0
    while set(_codec_threads()) - before and time.monotonic() < deadline:
        time.sleep(0.01)
    return set(_codec_threads()) - before


def test_failing_host_compress_reaches_consumer_and_frees_workers():
    src, dst = _zipf()
    agg = PLANS["compact-segments"](tcc, N)
    inner = agg.host_compress
    calls = []

    def host_compress(chunk):
        n = int(chunk.valid.sum())
        calls.append(n)
        if n and np.array_equal(chunk.src.numpy()[:n],
                                src[2 * CHUNK:2 * CHUNK + n]):
            raise RuntimeError("codec failure on the third chunk")
        return inner(chunk)

    agg.host_compress = host_compress
    before = set(_codec_threads())
    got = []
    with pytest.raises(RuntimeError, match="third chunk"):
        for x in _tstream(src, dst).aggregate(
                agg, merge_every=1, ingest_workers=2, prefetch_depth=4):
            got.append(x)
    assert len(got) == 2  # units 0 and 1 folded and emitted
    assert not _wait_threads_gone(before)
    # The failed unit released its turn: the session's turn counter moved
    # past it, so a later unit never parks.
    assert agg.session._turn >= 3
    agg.host_compress = inner
    labels = _tstream(src, dst).aggregate(agg, merge_every=4).result()
    _same(labels, tcc.cc_labels_numpy(src, dst, None, N))


def test_compact_space_overflow_reaches_consumer_with_jax_message():
    # gelly_tpu's message comes from its session: its own pipeline can
    # leave a worker parked on an ordered turn after such an error (a unit
    # cancelled before it ran never releases its turn), which would hang
    # this process at exit.
    src, dst = _zipf()
    js = jcs.CompactIdSession(64)
    with pytest.raises(jcs.CompactSpaceOverflow) as e:
        js.assign(np.unique(src))
    msgs = [str(e.value)]
    before = set(_codec_threads())
    with pytest.raises(tcs.CompactSpaceOverflow) as e:
        _tstream(src, dst).aggregate(
            tcc.connected_components(N, codec="compact",
                                     compact_capacity=64),
            merge_every=MERGE_EVERY, ingest_workers=2).result()
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "raise compact_capacity" in msgs[1]
    assert not _wait_threads_gone(before)


def test_abandoned_stream_frees_workers():
    src, dst = _zipf()
    before = set(_codec_threads())
    it = iter(_tstream(src, dst).aggregate(
        PLANS["compact-segments"](tcc, N), merge_every=1, ingest_workers=2))
    next(it)
    it.close()
    assert not _wait_threads_gone(before)


def test_engine_knob_validation():
    src, dst = _zipf()
    agg = PLANS["sparse"](tcc, N)
    stream = _tstream(src, dst)
    with pytest.raises(ValueError, match="not both"):
        stream.aggregate(agg, codec_workers=2, ingest_workers=2)
    with pytest.raises(ValueError, match="h2d_depth"):
        stream.aggregate(agg, h2d_depth=-1)
    for knob, value in (("precompressed", True),
                        ("source_provider", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            stream.aggregate(agg, **{knob: value})
    # mesh= is ported: it takes a gelly_torch mesh.
    with pytest.raises(TypeError, match="Mesh"):
        stream.aggregate(agg, mesh=object())
    # The window knobs are ported (they run, or refuse as JAX does).
    assert len(list(stream.aggregate(agg, window_ms=10))) > 0
    # A plan with the dirty-delta merge refuses a pane ring as gelly_tpu's
    # does; its windowed builder variant runs.
    with pytest.raises(ValueError, match="dirty-delta"):
        stream.aggregate(agg, windowed=2, merge_every=4)
    assert len(list(stream.aggregate(
        tcc.connected_components(N, codec="sparse", windowed=2),
        merge_every=4))) > 0
    with pytest.raises(ValueError, match="window_ms"):
        stream.aggregate(agg, allowed_lateness=5)
    with pytest.raises(TypeError):
        stream.aggregate(agg, bogus_knob=1)
    with pytest.raises(ValueError, match="no chunk field"):
        stream.aggregate(tcc.connected_components(N, ingest_combine=False),
                         device_fields=("src", "bogus"))
    raw = stream.aggregate(tcc.connected_components(N, ingest_combine=False),
                           merge_every=4)
    raw.result()
    assert raw.stats["h2d_bytes"] == 11 * CHUNK * 9  # src, dst, valid
    timer = tmetrics.StageTimer()
    res = stream.aggregate(agg, merge_every=4, codec_workers=1,
                           timer=timer)
    res.result()
    assert res.timer is timer and timer.report()["h2d"]["calls"] == 11


def test_compact_plan_refusals():
    agg = PLANS["compact-segments"](tcc, N)
    assert agg.requires_codec and agg.stack_ordered
    with pytest.raises(NotImplementedError, match="compressed payloads"):
        agg.fold(agg.init("cpu"), None)
    with pytest.raises(ValueError, match="ingest_combine"):
        tcc.connected_components(N, codec="compact", ingest_combine=False)
    with pytest.raises(ValueError, match="wire"):
        tcc.connected_components_compact(N, wire="bogus")
    # The pane-ring variant is ported.
    windowed = tcc.connected_components(N, codec="compact", windowed=2)
    assert windowed.windowed_panes == 2
    assert windowed.name == "connected-components-compact-windowed"
    # The mesh merge knobs are ported: the bound is the plan's.
    assert tcc.connected_components_compact(
        N, delta_auto_rows=8).merge_delta_auto_rows == 8
    with pytest.raises(ValueError, match="codec"):
        tcc.connected_components(N, codec="bogus")


def test_merge_chunk_forest_equals_gelly_tpu():
    src, dst = _zipf(seed=41, e=500)
    lab = tcc.cc_labels_numpy(src, dst, None, N)
    glob = np.arange(N, dtype=np.int32)
    glob[5] = 2
    _same(tcc.merge_chunk_forest(glob.copy(), lab),
          jcc.merge_chunk_forest(glob.copy(), lab))


def test_overlap_stats_and_timer_equal_gelly_tpu():
    from gelly_tpu.utils import metrics as jmetrics

    busy = {"ingest_compress": 2.0, "h2d": 0.5, "total_wall": 9.0}
    assert tmetrics.overlap_stats(busy, 2.5) == \
        jmetrics.overlap_stats(busy, 2.5)
    assert tmetrics.overlap_stats({}, 1.0)["overlap_efficiency"] is None
    t = tmetrics.StageTimer()
    with t("a"):
        pass
    t.reattribute("a", "wait", 5.0)
    assert t.busy()["a"] == 0.0 and t.report()["wait"]["calls"] == 1


# --------------------------------------------------------------------- #
# prefetch and the H2D ring on the CPU


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))
    assert list(prefetch(iter(range(5)), depth=0)) == list(range(5))

    def src():
        yield 1
        raise KeyError("source failure")

    got = []
    with pytest.raises(KeyError, match="source failure"):
        for x in prefetch(src(), depth=2):
            got.append(x)
    assert got == [1]


def test_prefetch_abandon_stops_worker():
    pulled = []

    def src():
        for i in range(10_000):
            pulled.append(i)
            yield i

    it = prefetch(src(), depth=2, name="gelly-prefetch-test")
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    n = len(pulled)
    time.sleep(0.2)
    assert len(pulled) == n <= 10


def test_prefetch_map_reports_items_cancelled_before_they_ran():
    cancelled = []
    gate = threading.Event()

    def fn(x):
        if x >= 1:
            gate.wait(5)  # item 1 holds the one worker
        return x

    it = prefetch_map(fn, iter(range(40)), depth=8, workers=1,
                      on_cancel=cancelled.append)
    assert next(it) == 0
    time.sleep(0.2)
    threading.Timer(0.3, gate.set).start()
    it.close()
    # Items 2.. were submitted but never ran: each is reported once.
    assert sorted(cancelled) == list(range(2, 2 + len(cancelled)))
    assert cancelled


def test_prefetch_map_joins_running_workers():
    before = set(_codec_threads())
    it = prefetch_map(lambda x: (time.sleep(0.01), x)[1], iter(range(100)),
                      depth=4, workers=3)
    assert next(it) == 0
    it.close()
    assert not (set(_codec_threads()) - before)


def test_pinned_ring_on_cpu_wraps_without_copy():
    ring = tagg.PinnedRing(torch.device("cpu"), 3)
    a = np.arange(10, dtype=np.int32)
    out, event = ring.put({"b": np.asarray(3, np.int32), "a": a})
    assert event is None and sorted(out) == ["a", "b"]
    assert out["a"].data_ptr() == a.ctypes.data
    single, _ = ring.put(a)
    assert torch.equal(single, _t(a))
    assert ring.bytes == 2 * a.nbytes + 4
