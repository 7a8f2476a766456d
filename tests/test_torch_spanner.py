"""gelly_torch's k-spanner vs gelly_tpu's (CPU).

Holds every function of the port's ``library/spanner.py`` and
``ops/rowtable.py`` to its ``gelly_tpu`` twin on the same state (states
built by folding seeded streams through ``gelly_tpu``, then carried over
with ``convert``): the dense and capped-degree gates, the per-edge and
batched inserts (frontier truncation binding, full rows, edge-list
overflow, every ``n_valid`` case), the ``gate_batch`` fold, the row
appends. Then both plans through the engine's Merger plan (dense, sparse
general k, ``gate_batch``, the ingest codec with the native binding and
its ``payload_cap`` error), every emission equal to ``gelly_tpu``'s;
Merger checkpoints of the spanner across the packages; the native host
spanner and the ``spanner_chunk_fold`` binding; and
``tests/test_spanner.py``'s property cases on the port. On the CPU the
kernels' plain versions run (``ops/kernels.py``). gelly_tpu runs on a
one-device mesh. Tolerance: exact equality, dtype included.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch import edge_stream_from_edges as t_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine.checkpoint import read_checkpoint_header
from gelly_torch.ops import kernels as tkernels
from gelly_torch.ops import rowtable as trow
from gelly_torch.utils import native as tnative
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.ops import rowtable as jrow
from gelly_tpu.parallel.mesh import make_mesh
from gelly_tpu.utils import native as jnative

from _torch_native import load_jax_native

tsp = importlib.import_module("gelly_torch.library.spanner")
jsp = importlib.import_module("gelly_tpu.library.spanner")

_j_insert = jax.jit(jsp._sparse_insert_edges, static_argnums=(4, 5, 6))
_j_batched = jax.jit(jsp._sparse_insert_edges_batched,
                     static_argnums=(4, 5, 6, 7))
_j_k2 = jax.jit(jsp._sparse_fold_chunk_k2, static_argnums=(4, 5))
_j_dense_insert = jax.jit(jsp._insert_edges, static_argnums=(4,))
_j_dense_batched = jax.jit(jsp._insert_edges_batched, static_argnums=(4, 5))


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("spanner", "chunk_combiner")


def _j_sparse(n, D, E):
    return jsp.SparseSpannerSummary(
        jnp.full((n, D), -1, jnp.int32), jnp.zeros(n, jnp.int32),
        jnp.zeros(E, jnp.int32), jnp.zeros(E, jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
        jnp.zeros((), jnp.int32))


def _j_dense(n, E):
    return jsp.SpannerSummary(
        jnp.zeros((n, n), bool), jnp.zeros(E, jnp.int32),
        jnp.zeros(E, jnp.int32), jnp.zeros((), jnp.int32),
        jnp.zeros((), bool))


def _to_t(s):
    arrays = [np.asarray(x) for x in s]
    if isinstance(s, jsp.SparseSpannerSummary):
        return convert.sparse_spanner_summary_from_numpy(*arrays,
                                                         device="cpu")
    return convert.spanner_summary_from_numpy(*arrays, device="cpu")


def _same(t, j):
    assert type(t).__name__ == type(j).__name__
    assert t._fields == j._fields
    for name, a, b in zip(t._fields, t, j):
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def _lanes(rng, n, L, zipf=1.4, share=0.9):
    src = (rng.zipf(zipf, L) % n).astype(np.int32)
    dst = rng.integers(0, n, L).astype(np.int32)
    valid = rng.random(L) < share
    return src, dst, valid


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _folded(n, D, E, k, F, seed, L=300):
    """A sparse summary: a seeded stream folded through gelly_tpu."""
    rng = np.random.default_rng(seed)
    return _j_insert(_j_sparse(n, D, E), *_lanes(rng, n, L), k, D, F)


# ---------------------------------------------------------------------- #
# Functions against their twins on one state


# (n, D, F, k, E): F = 2 and 3 truncate the frontier; D = 1 fills rows;
# E = 16 overflows the edge list.
SHAPES = [(48, 4, 16, 3, 400), (48, 3, 2, 3, 400), (64, 1, 8, 2, 400),
          (40, 4, 16, 2, 16), (96, 6, 3, 4, 600)]


@pytest.mark.parametrize("n,D,F,k,E", SHAPES)
def test_within_k_sparse_equals_jax(n, D, F, k, E):
    s = _folded(n, D, E, k, F, seed=n + F)
    rng = np.random.default_rng(F)
    u = rng.integers(0, n, 64).astype(np.int32)
    v = rng.integers(0, n, 64).astype(np.int32)
    want = jax.vmap(lambda a, b: jsp._within_k_sparse(s.nbr, a, b, k, F))(
        u, v)
    got = tsp._within_k_sparse(_t(s.nbr)[0],
                               *_t(u, v), k, F)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_frontier_truncation_binds_on_these_states():
    """The small-F shapes must actually cut frontiers, or the cases above
    would not test the truncation: a truncated gate must differ from the
    uncut one on some pair."""
    n, D, F, k, E = SHAPES[1]
    s = _folded(n, D, E, k, F, seed=n + F)
    nbr = _t(s.nbr)[0]
    u = torch.arange(n, dtype=torch.int32).repeat_interleave(n)
    v = torch.arange(n, dtype=torch.int32).repeat(n)
    cut = tsp._within_k_sparse(nbr, u, v, k, F)
    full = tsp._within_k_sparse(nbr, u, v, k, n)
    assert bool((cut != full).any())


@pytest.mark.parametrize("n,D,F,k,E", SHAPES)
@pytest.mark.parametrize("seed", [1, 2])
def test_sparse_insert_edges_equals_jax(n, D, F, k, E, seed):
    s = _folded(n, D, E, k, F, seed=seed, L=150)
    lanes = _lanes(np.random.default_rng(seed + 10), n, 200)
    want = _j_insert(s, *lanes, k, D, F)
    got = tsp._sparse_insert_edges(_to_t(s), *_t(*lanes), k, D, F)
    _same(got, want)


@pytest.mark.parametrize("n,D,F,k,E", SHAPES)
@pytest.mark.parametrize("n_valid", ["all", "none", "part", "overflowed"])
def test_sparse_insert_edges_batched_equals_jax(n, D, F, k, E, n_valid):
    big = _folded(n, D, E, k, F, seed=3, L=200)
    small = _folded(n, D, E, k, F, seed=4, L=150)
    nv = {"all": small.n, "none": jnp.int32(0),
          "part": jnp.int32(min(37, E)),
          "overflowed": jnp.int32(E + 70)}[n_valid]
    want = _j_batched(big, small.esrc, small.edst, nv, k, D, F, 64)
    got = tsp._sparse_insert_edges_batched(
        _to_t(big), *_t(small.esrc, small.edst, nv), k, D, F)
    _same(got, want)


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_sparse_insert_edges_batched_batch_sizes_equal_jax(batch):
    n, D, F, k, E = 64, 4, 16, 2, 300
    big = _folded(n, D, E, k, F, seed=5)
    small = _folded(n, D, E, k, F, seed=6, L=120)
    want = _j_batched(big, small.esrc, small.edst, small.n, k, D, F, batch)
    got = tsp._sparse_insert_edges_batched(
        _to_t(big), *_t(small.esrc, small.edst, small.n), k, D, F, batch)
    _same(got, want)


@pytest.mark.parametrize("sub", [1, 16, 64, 300])
@pytest.mark.parametrize("D,E", [(4, 400), (2, 400), (8, 24)])
def test_sparse_fold_chunk_k2_equals_jax(sub, D, E):
    n = 64
    s = _folded(n, D, E, 2, 16, seed=7, L=100)
    rng = np.random.default_rng(sub + D)
    src, dst, valid = _lanes(rng, n, 250)
    src[100:140] = src[60:100]  # exact duplicates in and across sub-batches
    dst[100:140] = dst[60:100]
    want = _j_k2(s, src, dst, valid, D, sub)
    got = tsp._sparse_fold_chunk_k2(_to_t(s), *_t(src, dst, valid), D, sub)
    _same(got, want)


@pytest.mark.parametrize("D", [1, 3, 8])
def test_row_append_batch_equals_jax(D):
    n = 20
    s = _folded(n, D, 200, 2, 8, seed=D)
    rng = np.random.default_rng(D)
    key = rng.integers(0, n, 50).astype(np.int32)
    key[:10] = 3  # one row taking many appends
    val = rng.integers(0, n, 50).astype(np.int32)
    ok = rng.random(50) < 0.8
    over = jnp.int32(5)
    want = jsp._row_append_batch(s.nbr, s.deg, over, key, val, ok, D)
    got = tsp._row_append_batch(*_t(s.nbr, s.deg, over, key, val, ok), D)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dedupe", [True, False])
def test_row_insert_equals_jax(dedupe):
    n, D = 12, 3
    rng = np.random.default_rng(9)
    jn, jd, jo = (jnp.full((n, D), -1, jnp.int32), jnp.zeros(n, jnp.int32),
                  jnp.int32(0))
    tn, td, to = _t(jn, jd, jo)
    for a, b, ok in zip(rng.integers(0, 4, 40), rng.integers(0, n, 40),
                        rng.random(40) < 0.8):
        jn, jd, jo = jrow.row_insert(jn, jd, jo, jnp.int32(a), jnp.int32(b),
                                     jnp.bool_(ok), D, dedupe=dedupe)
        tn, td, to = trow.row_insert(
            tn, td, to, torch.tensor([a], dtype=torch.int32),
            torch.tensor([b], dtype=torch.int32), torch.tensor([bool(ok)]),
            D, dedupe=dedupe)
    for x, y in ((tn, jn), (td, jd), (to, jo)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert to.shape == ()


def test_dense_functions_equal_jax():
    n, E, k = 40, 300, 3
    rng = np.random.default_rng(12)
    lanes = _lanes(rng, n, 250)
    want = _j_dense_insert(_j_dense(n, E), *lanes, k)
    got = tsp._insert_edges(_to_t(_j_dense(n, E)), *_t(*lanes), k)
    _same(got, want)
    u = rng.integers(0, n, 30).astype(np.int32)
    v = rng.integers(0, n, 30).astype(np.int32)
    w = jax.vmap(lambda a, b: jsp._within_k(want.adj, a, b, k))(u, v)
    g = tsp._within_k(_t(want.adj)[0], *_t(u, v), k)
    assert np.array_equal(g.numpy(), np.asarray(w))
    donor = _j_dense_insert(_j_dense(n, E), *_lanes(rng, n, 200), k)
    for nv in (donor.n, jnp.int32(0), jnp.int32(E + 5)):
        want2 = _j_dense_batched(want, donor.esrc, donor.edst, nv, k, 64)
        got2 = tsp._insert_edges_batched(
            _to_t(want), *_t(donor.esrc, donor.edst, nv), k)
        _same(got2, want2)


# ---------------------------------------------------------------------- #
# The plans through the engine (the Merger plan)


def _streams(edges, n_v, chunk, zipf_seed=None):
    src = np.array([a for a, _ in edges], np.int64)
    dst = np.array([b for _, b in edges], np.int64)
    return (t_stream(TSource(src, dst, chunk_size=chunk,
                             table=TIdentity(n_v)), n_v, device="cpu"),
            j_stream(JSource(src, dst, chunk_size=chunk,
                             table=JIdentity(n_v)), n_v))


def _zipf_edges(n_e, n_v, seed, a=1.5):
    rng = np.random.default_rng(seed)
    return list(zip((rng.zipf(a, n_e) % n_v).tolist(),
                    (rng.zipf(a, n_e) % n_v).tolist()))


PLANS = {
    "dense-k2": dict(k=2),
    "dense-k3": dict(k=3, max_edges=500),
    "sparse-k3": dict(k=3, max_degree=6),
    "sparse-k2-capped": dict(k=2, max_degree=3, max_edges=400),
    "gate-batch": dict(k=2, max_degree=8, gate_batch=32),
    "codec-sparse": dict(k=2, max_degree=8, ingest_combine=True,
                         payload_cap=256),
    "codec-dense": dict(k=3, ingest_combine=True, payload_cap=256),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("merge_every,fold_batch", [(1, 1), (3, 3)])
def test_spanner_plans_equal_jax(plan, merge_every, fold_batch):
    n_v = 96
    ts, js = _streams(_zipf_edges(700, n_v, seed=len(plan)), n_v, 100)
    tagg = tsp.spanner(n_v, **PLANS[plan])
    jagg = jsp.spanner(n_v, **PLANS[plan])
    assert (tagg.host_compress is None) == (jagg.host_compress is None)
    got = list(ts.aggregate(tagg, merge_every=merge_every,
                            fold_batch=fold_batch))
    want = list(js.aggregate(jagg, mesh=make_mesh(1),
                             merge_every=merge_every, fold_batch=fold_batch))
    assert len(got) == len(want) == -(-7 // merge_every)
    for g, w in zip(got, want):
        _same(g, w)
    assert tsp.spanner_edges(got[-1], ts.ctx) == jsp.spanner_edges(
        want[-1], js.ctx)


def test_codec_payload_cap_overflow_raises_like_jax():
    n_v = 64
    edges = [(i, i + 1) for i in range(60)]  # a path: every edge kept
    ts, js = _streams(edges, n_v, 64)
    for s, mod, kw in ((ts, tsp, {}), (js, jsp, {"mesh": make_mesh(1)})):
        agg = mod.spanner(n_v, 2, max_degree=4, ingest_combine=True,
                          payload_cap=16)
        with pytest.raises(ValueError, match="payload_cap=16"):
            list(s.aggregate(agg, **kw))


def test_spanner_plan_errors_equal_jax():
    for mod in (tsp, jsp):
        with pytest.raises(ValueError, match="k == 2"):
            mod.spanner(16, 3, max_degree=8, gate_batch=8)
        with pytest.raises(ValueError, match="payload_cap"):
            mod.spanner(16, 3, ingest_combine=True)
        with pytest.raises(ValueError, match="payload_cap"):
            mod.spanner(16, 3, max_degree=4, ingest_combine=True)
    # The fused query builder is ported: it builds gelly_tpu's spec (the
    # spanner is the quartet's one non-accumulating query).
    for kw in ({}, {"name": "sp", "every": 4, "max_degree": 8,
                    "gate_batch": 16, "max_edges": 64}):
        t, j = tsp.spanner_query(16, 2, **kw), jsp.spanner_query(16, 2, **kw)
        assert (t.name, t.every, t.slot_capacity, t.accum) == (
            j.name, j.every, j.slot_capacity, j.accum)
        assert t.agg.name == j.agg.name and not t.accum


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
@pytest.mark.parametrize("plan", ["sparse-k3", "dense-k2"])
def test_spanner_checkpoint_resumes_across_packages(tmp_path, writer, reader,
                                                    plan):
    n_v = 80
    edges = _zipf_edges(600, n_v, seed=77)

    def run(pkg, path=None, stop_after=None, resume=False):
        ts, js = _streams(edges, n_v, 60)
        kw = dict(merge_every=2)
        if path:
            kw.update(checkpoint_path=path, checkpoint_every=1,
                      resume=resume)
        if pkg == "torch":
            res = ts.aggregate(tsp.spanner(n_v, **PLANS[plan]), **kw)
        else:
            res = js.aggregate(jsp.spanner(n_v, **PLANS[plan]),
                               mesh=make_mesh(1), **kw)
        out = []
        for x in res:
            out.append(tuple(np.asarray(y.numpy() if pkg == "torch" else y)
                             for y in x))
            if len(out) == stop_after:
                break
        return out

    full = run(reader)
    p = str(tmp_path / "ck.npz")
    run(writer, path=p, stop_after=3)
    assert read_checkpoint_header(p)["position"] == 4
    got = run(reader, path=p, resume=True)
    assert len(got) == len(full) - 2 == 3
    for g, w in zip(got, full[2:]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# The native host spanner and its binding


def test_spanner_chunk_fold_binding_equals_jax():
    n_v, D, k = 128, 8, 3
    rng = np.random.default_rng(2)
    src, dst, valid = _lanes(rng, n_v, 2000)
    outs = []
    for mod in (tnative, jnative):
        st = [np.full((n_v, D), -1, np.int32), np.zeros(n_v, np.int32),
              np.zeros(n_v, np.int32), np.zeros(3, np.int64),
              np.zeros(4000, np.int32), np.zeros(4000, np.int32)]
        mod.spanner_chunk_fold(src, dst, valid, n_v, k, D, *st)
        mod.spanner_chunk_fold(dst, src, None, n_v, k, D, *st)
        outs.append(st)
        with pytest.raises(ValueError, match="overflowed; raise max_edges"):
            mod.spanner_chunk_fold(src, dst, None, n_v, 2, D, *st[:4],
                                   np.zeros(3, np.int32),
                                   np.zeros(3, np.int32))
        with pytest.raises(ValueError, match="bad vertex slot"):
            mod.spanner_chunk_fold(src, dst + n_v, None, n_v, k, D, *st)
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def _host_streams(edges, n_v, chunk):
    return (t_edges(edges, vertex_capacity=n_v, chunk_size=chunk,
                    device="cpu"),
            j_edges(edges, vertex_capacity=n_v, chunk_size=chunk))


@pytest.mark.parametrize("k,D", [(2, 4), (3, 128), (4, 32)])
def test_host_spanner_equals_jax(k, D):
    rng = np.random.default_rng(k)
    n_v = 1 << 10
    raw = rng.zipf(1.4, (6000, 2)) % n_v
    edges = [(int(a), int(b), 1.0) for a, b in raw]
    ts, js = _host_streams(edges, n_v, 1000)
    th = tsp.host_spanner(ts, k, max_degree=D)
    jh = jsp.host_spanner(js, k, max_degree=D)
    assert th.final_edges() == jh.final_edges()
    assert th.deg_overflow == jh.deg_overflow


def test_host_spanner_matches_dense_device_exactly():
    rng = np.random.default_rng(21)
    n_v = 128
    edges = [(int(a), int(b), 1.0)
             for a, b in rng.integers(0, n_v, (600, 2))]
    s = t_edges(edges, vertex_capacity=n_v, chunk_size=128, device="cpu")
    dev = tsp.spanner_edges(
        s.aggregate(tsp.spanner(n_v, 3), merge_every=10 ** 6).result(),
        s.ctx)
    s = t_edges(edges, vertex_capacity=n_v, chunk_size=128, device="cpu")
    host = tsp.host_spanner(s, 3, max_degree=n_v).final_edges()
    assert host == dev


def test_host_spanner_overflow_poisons_state():
    edges = [(i, i + 1, 1.0) for i in range(40)]  # path: every edge kept
    s = t_edges(edges, vertex_capacity=64, chunk_size=8, device="cpu")
    h = tsp.host_spanner(s, 2, max_degree=8, max_edges=10)
    with pytest.raises(ValueError, match="overflow"):
        h.final_edges()
    with pytest.raises(RuntimeError, match="previously failed"):
        h.final_edges()
    with pytest.raises(RuntimeError, match="previously failed"):
        h.deg_overflow


# ---------------------------------------------------------------------- #
# tests/test_spanner.py's property cases, on the port


def bfs_dist(adj: dict, a: int, b: int) -> float:
    if a == b:
        return 0
    frontier, seen, d = {a}, {a}, 0
    while frontier:
        d += 1
        frontier = {n for f in frontier for n in adj.get(f, ())} - seen
        if b in frontier:
            return d
        seen |= frontier
    return float("inf")


def check_spanner_properties(edges, got, k):
    eset = {frozenset(e) for e in edges}
    for e in got:
        assert frozenset(e) in eset, e
    adj: dict = {}
    for a, b in got:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    for a, b in edges:
        assert bfs_dist(adj, a, b) <= k, (a, b)


def _run_port(edges, n_v, chunk, agg, **kw):
    s = t_edges([(a, b, 1.0) for a, b in edges], vertex_capacity=n_v,
                chunk_size=chunk, device="cpu")
    return tsp.spanner_edges(s.aggregate(agg, **kw).result(), s.ctx)


@pytest.mark.parametrize("k", [2, 3])
def test_spanner_properties_random_graph(k):
    rng = np.random.default_rng(9)
    edges = list({(int(a), int(b))
                  for a, b in rng.integers(0, 24, (80, 2)) if a != b})
    got = _run_port(edges, 32, 8, tsp.spanner(32, k), merge_every=2)
    check_spanner_properties(edges, got, k)
    assert len(got) <= len(edges)


def test_spanner_keeps_tree_edges():
    edges = [(i, i + 1) for i in range(10)] + [(3, 20), (20, 21)]
    got = _run_port(edges, 32, 4, tsp.spanner(32, 3), merge_every=1)
    assert {frozenset(e) for e in got} == {frozenset(e) for e in edges}


def test_spanner_prunes_dense_clique():
    edges = list(itertools.combinations(range(8), 2))
    got = _run_port(edges, 16, 4, tsp.spanner(16, 2), merge_every=1)
    check_spanner_properties(edges, got, 2)
    assert len(got) < len(edges)


def test_spanner_overflow_flag():
    edges = [(i, i + 1) for i in range(10)]
    s = t_edges([(a, b, 1.0) for a, b in edges], vertex_capacity=16,
                chunk_size=4, device="cpu")
    summary = s.aggregate(tsp.spanner(16, 2, max_edges=4),
                          merge_every=1).result()
    with pytest.raises(RuntimeError, match="overflow"):
        tsp.spanner_edges(summary, s.ctx)


def test_sparse_spanner_matches_dense_when_unconstrained():
    rng = np.random.default_rng(4)
    n_v = 64
    edges = list(zip(rng.integers(0, n_v, 200).tolist(),
                     rng.integers(0, n_v, 200).tolist()))
    sparse = _run_port(edges, n_v, 64,
                       tsp.spanner(n_v, 3, max_degree=n_v, max_edges=256),
                       merge_every=8)
    dense = _run_port(edges, n_v, 64, tsp.spanner(n_v, 3, max_edges=256),
                      merge_every=8)
    assert sparse == dense


def test_spanner_ingest_codec_single_chunk_exact():
    rng = np.random.default_rng(6)
    n_v = 64
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n_v, (400, 2))]
    plain = _run_port(edges, n_v, 512, tsp.spanner(n_v, 3), merge_every=4)
    codec = _run_port(edges, n_v, 512,
                      tsp.spanner(n_v, 3, ingest_combine=True,
                                  payload_cap=256), merge_every=4)
    assert codec == plain


@pytest.mark.parametrize("sparse", [False, True])
def test_spanner_ingest_codec_multichunk_stretch(sparse):
    rng = np.random.default_rng(15)
    n_v = 96
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n_v, (600, 2))
             if a != b]
    k = 2
    kw = dict(ingest_combine=True, max_edges=1024, payload_cap=256)
    if sparse:
        kw["max_degree"] = 32
    got = _run_port(edges, n_v, 64, tsp.spanner(n_v, k, **kw),
                    merge_every=4, fold_batch=4)
    check_spanner_properties(edges, got, k * k)


def test_batched_gate_k2_properties_and_pruning():
    rng = np.random.default_rng(21)
    n_v = 64
    edges = list({(int(a), int(b))
                  for a, b in rng.integers(0, n_v, (300, 2)) if a != b})
    got = _run_port(edges, n_v, 32, tsp.spanner(
        n_v, 2, max_degree=32, max_edges=1024, gate_batch=8), merge_every=4)
    check_spanner_properties(edges, got, 4)
    star = [(0, i) for i in range(1, 9)]
    clique = [(a, b) for a in range(1, 9) for b in range(a + 1, 9)]
    got2 = _run_port(star + clique, 16, 8, tsp.spanner(
        16, 2, max_degree=16, max_edges=64, gate_batch=8), merge_every=16)
    assert {frozenset(e) for e in got2} == {frozenset(e) for e in star}


def test_batched_gate_k2_dedups_and_matches_scan_gate_properties():
    edges = [(1, 2)] * 20 + [(2, 3)] * 20 + [(1, 3)] * 20
    got = _run_port(edges, 8, 16, tsp.spanner(8, 2, max_degree=8,
                                              max_edges=32, gate_batch=4),
                    merge_every=1)
    assert len(got) <= 3
    check_spanner_properties(edges, got, 2)


def test_sparse_gate_wrappers_check_their_inputs():
    s = tsp.sparse_spanner(16, 2, 4).init("cpu")
    lanes = [torch.zeros(3, dtype=torch.int32)] * 2 + [
        torch.ones(3, dtype=torch.bool)]
    with pytest.raises(ValueError, match="valid"):
        tkernels.sparse_insert_edges(*tsp._fields(s), *lanes[:2],
                                     lanes[2].int(), 2, 4, 16)
    with pytest.raises(ValueError, match="nbr"):
        tkernels.sparse_insert_edges(*tsp._fields(s), *lanes, 2, 5, 16)
    with pytest.raises(ValueError, match="n_valid"):
        tkernels.sparse_insert_edges_batched(
            *tsp._fields(s), *lanes[:2], torch.tensor(3), 2, 4, 16)
