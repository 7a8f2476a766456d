"""gelly_torch's SnapshotStream aggregations, neighbourhoods and stream
transforms vs gelly_tpu's (CPU).

Mirrors ``tests/test_snapshot.py`` (the TestSlice goldens for the three
aggregations in the three directions, views, windows, the buffer
overflow, both neighbourhood paths) and the transform cases of
``tests/test_core.py`` on the port, and holds every window's
``reduce_on_edges`` / ``fold_neighbors`` / ``apply_on_neighbors`` output,
every sorted view, every adjacency snapshot (dense matrix, or the row
table's ``nbr`` / ``deg``), the row table's overflow and range errors, and
the transforms' edges to ``gelly_tpu`` on the same seeded streams.
Tolerance: exact, except float ``reduce_on_edges`` sums (``rtol=1e-5``:
the port's log-step scan groups the adds unlike JAX's
``associative_scan`` tree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import TimeCharacteristic as TTime
from gelly_torch import convert
from gelly_torch import edge_stream_from_edges as t_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.neighborhood import NeighborhoodStream as TNbr
from gelly_torch.core.stream import EdgeStream as TStream
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.ops import segments as tseg
from gelly_tpu import TimeCharacteristic as JTime
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.neighborhood import NeighborhoodStream as JNbr
from gelly_tpu.core.stream import EdgeStream as JStream
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.ops import segments as jseg

EXPECTED = {
    "out": {1: 25, 2: 23, 3: 69, 4: 45, 5: 51},
    "in": {1: 51, 2: 12, 3: 36, 4: 34, 5: 80},
    "all": {1: 76, 2: 35, 3: 105, 4: 79, 5: 131},
}


def _fixture(reference_edges, chunk_size=3):
    return t_edges(reference_edges, vertex_capacity=16,
                   chunk_size=chunk_size, device="cpu")


def _drain(it, ctx):
    out = {}
    for upd in it:
        for k, v in upd.to_pairs(ctx):
            out[k] = int(v) if np.ndim(v) == 0 else v
    return out


@pytest.mark.parametrize("direction", ["out", "in", "all"])
def test_reduce_on_edges_golden(reference_edges, direction):
    s = _fixture(reference_edges)
    got = _drain(s.slice(1000, direction).reduce_on_edges(
        lambda a, b: a + b), s.ctx)
    assert got == EXPECTED[direction]


@pytest.mark.parametrize("direction", ["out", "in", "all"])
def test_fold_neighbors_golden(reference_edges, direction):
    s = _fixture(reference_edges)
    got = _drain(s.slice(1000, direction).fold_neighbors(
        torch.zeros((), dtype=torch.float32),
        lambda acc, v, nbr, val: acc + val), s.ctx)
    assert got == EXPECTED[direction]


@pytest.mark.parametrize("direction", ["out", "in", "all"])
def test_apply_on_neighbors_golden(reference_edges, direction):
    s = _fixture(reference_edges)

    def apply_fn(view):
        sums = tseg.masked_scatter_add(
            torch.zeros(16, dtype=torch.float32), view.key, view.val,
            view.valid)
        seen = tseg.mark_seen(torch.zeros(16, dtype=torch.bool), view.key,
                              view.valid)
        return sums, seen

    (_, (sums, seen)), = list(s.slice(1000, direction).apply_on_neighbors(
        apply_fn))
    got = {int(s.ctx.decode(np.array([i]))[0]): float(sums[i])
           for i in np.nonzero(seen.numpy())[0]}
    assert got == EXPECTED[direction]


def test_per_vertex_and_tuple_fold(reference_edges):
    s = _fixture(reference_edges)
    got = {}
    for _, view in s.slice(1000, "out").views():
        for vid, nbrs in view.per_vertex(s.ctx):
            got[vid] = sum(v for _, v in nbrs)
    assert got == EXPECTED["out"]
    init = (torch.zeros((), dtype=torch.int32),
            torch.zeros((), dtype=torch.float32))
    got = {}
    for upd in s.slice(1000, "out").fold_neighbors(
            init, lambda acc, v, nbr, val: (v, acc[1] + val)):
        for k, (vid, total) in upd.to_pairs(s.ctx):
            got[k] = (int(vid), int(total))
    slot_of = {int(r): i for i, r in enumerate(s.ctx.table._rev.tolist())}
    assert got == {k: (slot_of[k], v) for k, v in EXPECTED["out"].items()}


def test_neighbor_count_fold_and_buffer_overflow(reference_edges):
    s = _fixture(reference_edges)
    got = _drain(s.slice(1000, "all").fold_neighbors(
        torch.zeros((), dtype=torch.int32),
        lambda acc, v, nbr, val: acc + 1), s.ctx)
    assert got == {1: 3, 2: 2, 3: 4, 4: 2, 5: 3}
    s = _fixture(reference_edges, chunk_size=2)
    with pytest.raises(ValueError, match="window buffer overflow"):
        list(s.slice(1000, "out", window_capacity=4).reduce_on_edges(
            lambda a, b: a + b))


def _pair(n_e, seed, n_v=24, chunk=40, windows=4, float_vals=False,
          shuffle=0):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, n_e) % n_v).astype(np.int64)
    dst = rng.integers(0, n_v, n_e).astype(np.int64)
    if float_vals:
        val = rng.random(n_e).astype(np.float32) * 10
    else:
        val = rng.integers(-50, 50, n_e).astype(np.float32)
    ts = np.arange(n_e, dtype=np.int64)
    if shuffle:
        for lo in range(0, n_e, shuffle):
            rng.shuffle(ts[lo:lo + shuffle])
    window_ms = -(-n_e // windows)
    t = t_stream(TSource(src, dst, val=val, timestamps=ts, chunk_size=chunk,
                         table=TIdentity(n_v), time=TTime.EVENT), n_v,
                 device="cpu")
    j = j_stream(JSource(src, dst, val=val, timestamps=ts, chunk_size=chunk,
                         table=JIdentity(n_v), time=JTime.EVENT), n_v)
    return t, j, window_ms


@pytest.mark.parametrize("direction", ["out", "in", "all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_views_equal_jax(direction, seed):
    t, j, w = _pair(300, seed)
    tv = list(t.slice(w, direction).views())
    jv = list(j.slice(w, direction).views())
    assert [a for a, _ in tv] == [a for a, _ in jv]
    for (_, a), (_, b) in zip(tv, jv):
        for name in a._fields:
            assert np.array_equal(getattr(a, name).numpy(),
                                  np.asarray(getattr(b, name))), name
        assert np.array_equal(a.ends().numpy(), np.asarray(b.ends()))


@pytest.mark.parametrize("direction", ["out", "all"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("lateness", [0, 50])
def test_reduce_on_edges_int_exact_equal_jax(direction, op, lateness):
    t, j, w = _pair(400, 3, shuffle=40 if lateness else 0)
    fn_t = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}[op]
    fn_j = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum}[op]
    ts = t.slice(w, direction, allowed_lateness=lateness)
    js = j.slice(w, direction, allowed_lateness=lateness)
    got = list(ts.reduce_on_edges(fn_t))
    want = list(js.reduce_on_edges(fn_j))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.window == b.window
        assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
        m = a.valid.numpy()
        assert np.array_equal(a.slots.numpy()[m], np.asarray(b.slots)[m])
        assert np.array_equal(a.values.numpy()[m], np.asarray(b.values)[m])
    assert ts.stats == js.stats


def test_reduce_on_edges_float_sum_within_rtol():
    t, j, w = _pair(500, 4, float_vals=True)
    got = list(t.slice(w, "all").reduce_on_edges(lambda a, b: a + b))
    want = list(j.slice(w, "all").reduce_on_edges(lambda a, b: a + b))
    for a, b in zip(got, want):
        m = a.valid.numpy()
        assert np.array_equal(m, np.asarray(b.valid))
        np.testing.assert_allclose(a.values.numpy()[m],
                                   np.asarray(b.values)[m], rtol=1e-5)


@pytest.mark.parametrize("direction", ["out", "in", "all"])
@pytest.mark.parametrize("seed", [0, 5])
def test_fold_neighbors_every_position_equal_jax(direction, seed):
    t, j, w = _pair(300, seed)

    def fold_t(acc, v, nbr, val):
        return (acc[0] * 3 + nbr, torch.maximum(acc[1], val.to(torch.int32)))

    def fold_j(acc, v, nbr, val):
        return (acc[0] * 3 + nbr, jnp.maximum(acc[1], val.astype(jnp.int32)))

    init_t = (torch.zeros((), dtype=torch.int32),
              torch.full((), -99, dtype=torch.int32))
    init_j = (jnp.zeros((), jnp.int32), jnp.full((), -99, jnp.int32))
    got = list(t.slice(w, direction).fold_neighbors(init_t, fold_t))
    want = list(j.slice(w, direction).fold_neighbors(init_j, fold_j))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.window == b.window
        assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
        for x, y in zip(a.values, b.values):
            # Every buffer position, padding included, bit for bit.
            assert np.array_equal(x.numpy(), np.asarray(y))


def test_apply_on_neighbors_max_neighbor_equal_jax():
    t, j, w = _pair(400, 7)

    def apply_t(view):
        return tseg.masked_scatter_max(
            torch.full((24,), -1, dtype=torch.int32), view.key, view.nbr,
            view.valid)

    def apply_j(view):
        return jseg.masked_scatter_max(
            jnp.full((24,), -1, jnp.int32), view.key, view.nbr, view.valid)

    got = list(t.slice(w, "all").apply_on_neighbors(apply_t))
    want = list(j.slice(w, "all").apply_on_neighbors(apply_j))
    assert [a for a, _ in got] == [a for a, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_multiple_windows_event_time_golden():
    edges = [(1, 2, 10.0), (1, 3, 20.0), (2, 3, 5.0), (1, 2, 7.0),
             (3, 1, 2.0)]
    ts = np.array([0, 10, 50, 120, 150])
    s = t_edges(edges, vertex_capacity=8, chunk_size=2, time=TTime.EVENT,
                timestamps=ts, device="cpu")
    snap = s.slice(100, "out")
    per_window = {}
    for upd in snap.reduce_on_edges(lambda a, b: a + b):
        per_window[upd.window] = dict(upd.to_pairs(s.ctx))
    assert {int(k): int(v) for k, v in per_window[0].items()} == {1: 30, 2: 5}
    assert {int(k): int(v) for k, v in per_window[1].items()} == {1: 7, 3: 2}
    assert snap.stats["windows_closed"] == 2


# ---------------------------------------------------------------------- #
# neighbourhoods


def _nbr_pair(edges, n_v, chunk, **kw):
    t = t_edges(edges, vertex_capacity=n_v, chunk_size=chunk, device="cpu")
    j = j_edges(edges, vertex_capacity=n_v, chunk_size=chunk)
    return TNbr(t, **kw), JNbr(j, **kw)


def test_build_neighborhood_golden(reference_edges):
    s = _fixture(reference_edges)
    n = s.build_neighborhood(directed=False)
    assert n.neighbors_of(3) == [1, 2, 4, 5]
    assert n.neighbors_of(1) == [2, 3, 5]
    assert n.neighbors_of(42) == []
    d = _fixture(reference_edges).build_neighborhood(directed=True)
    assert d.neighbors_of(3) == [4, 5]
    assert d.neighbors_of(5) == [1]


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_adjacency_every_chunk_equal_jax(directed, seed):
    rng = np.random.default_rng(seed)
    edges = list(zip(rng.integers(0, 20, 120).tolist(),
                     rng.integers(0, 20, 120).tolist()))
    tn, jn = _nbr_pair(edges, 32, 16, directed=directed)
    snaps = [a.clone() for a in tn]
    want = [np.asarray(a) for a in jn]
    assert len(snaps) == len(want)
    for a, b in zip(snaps, want):
        assert np.array_equal(a.numpy(), b)


def _drain_rows(ns, to_np):
    """Snapshots until the stream ends or raises: (snapshots, message)."""
    out = []
    try:
        for a, b in ns:
            out.append((to_np(a), to_np(b)))
    except ValueError as e:
        return out, str(e)
    return out, None


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed,max_degree", [(0, 32), (2, 12), (3, 20),
                                             (4, 6)])
def test_row_table_every_chunk_equal_jax(directed, seed, max_degree):
    rng = np.random.default_rng(seed)
    edges = list(zip(rng.integers(0, 24, 150).tolist(),
                     rng.integers(0, 24, 150).tolist()))
    edges += [(5, 5), (5, 5), (6, 6)]  # self-loops and a duplicate
    tn, jn = _nbr_pair(edges, 32, 16, directed=directed,
                       max_degree=max_degree)
    got, t_err = _drain_rows(tn, lambda x: x.numpy().copy())
    want, j_err = _drain_rows(jn, np.asarray)
    assert t_err == j_err  # the same overflow, at the same chunk
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c)
        assert np.array_equal(b, d)
    if t_err is None:
        for v in range(24):
            assert tn.neighbors_of(v) == jn.neighbors_of(v)


@pytest.mark.parametrize("directed", [False, True])
def test_row_table_convert_round_trip(directed):
    """JAX's row table after two chunks continues through the port's row
    step, and the port's through JAX's: ``nbr``, ``deg`` and ``over`` stay
    JAX's at every chunk."""
    import jax

    from gelly_torch.ops import kernels
    from gelly_tpu.core.neighborhood import _row_step

    rng = np.random.default_rng(11)
    src = rng.integers(0, 24, 160).astype(np.int32)
    dst = rng.integers(0, 24, 160).astype(np.int32)
    src[:3], dst[:3] = 5, 5  # self-loops and duplicates
    n, d = 32, 8
    step = jax.jit(_row_step, static_argnums=(4, 5))
    chunks = list(JSource(src, dst, chunk_size=40, table=JIdentity(n)))
    jt = (jnp.full((n, d), -1, jnp.int32), jnp.zeros((n,), jnp.int32),
          jnp.zeros((), jnp.int32))
    for c in chunks[:2]:
        jt = step(*jt, c, directed, d)
    tt = convert.row_table_from_numpy(*(np.asarray(x) for x in jt),
                                      device="cpu")
    for c in chunks[2:]:
        jt = step(*jt, c, directed, d)
        tt = kernels.row_insert_chunk(
            *tt, *(torch.from_numpy(np.array(x))
                   for x in (c.src, c.dst, c.valid)), directed, d)
        for a, b in zip(convert.row_table_to_numpy(*tt), jt):
            assert a.dtype == np.int32 and np.array_equal(a, np.asarray(b))
    assert int(jt[2]) > 0  # some row passed the cap
    # The other way: the port's rows continue in gelly_tpu.
    back = tuple(jnp.asarray(x) for x in convert.row_table_to_numpy(*tt))
    again = step(*back, chunks[0], directed, d)
    want = step(*jt, chunks[0], directed, d)
    for a, b in zip(again, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    nbr, deg, over = convert.row_table_to_numpy(*tt)
    with pytest.raises(ValueError, match="one row count"):
        convert.row_table_from_numpy(nbr, deg[:-1], over, device="cpu")
    with pytest.raises(TypeError, match="over must be int32"):
        convert.row_table_from_numpy(nbr, deg, over.astype(np.int64),
                                     device="cpu")


def test_row_table_overflow_raises_jax_message():
    star = [(0, i) for i in range(1, 20)]
    tn, jn = _nbr_pair(star, 64, 8, max_degree=4)
    with pytest.raises(ValueError) as te:
        tn.final_adjacency()
    with pytest.raises(ValueError) as je:
        jn.final_adjacency()
    assert str(te.value) == str(je.value)
    assert "max_degree 4" in str(te.value)


def test_neighborhood_capacity_range_error_equal_jax():
    src, dst = np.array([1, 3]), np.array([2, 40])
    tn = TNbr(t_stream(TSource(src, dst, chunk_size=1, table=TIdentity(64)),
                       64, device="cpu"), capacity=32)
    jn = JNbr(j_stream(JSource(src, dst, chunk_size=1, table=JIdentity(64)),
                       64), capacity=32)
    with pytest.raises(ValueError) as te:
        tn.final_adjacency()
    with pytest.raises(ValueError) as je:
        jn.final_adjacency()
    assert str(te.value) == str(je.value)


def test_sparse_neighborhood_matches_dense():
    rng = np.random.default_rng(6)
    edges = list(zip(rng.integers(0, 32, 150).tolist(),
                     rng.integers(0, 32, 150).tolist()))

    def stream():
        return t_edges(edges, vertex_capacity=32, chunk_size=16,
                       device="cpu")

    dense = TNbr(stream())
    sparse = TNbr(stream(), max_degree=32)
    for v in {a for a, _ in edges} | {b for _, b in edges}:
        assert dense.neighbors_of(v) == sparse.neighbors_of(v), v


# ---------------------------------------------------------------------- #
# transforms


def _both(edges, chunk=3):
    return (t_edges(edges, vertex_capacity=16, chunk_size=chunk,
                    device="cpu"),
            j_edges(edges, vertex_capacity=16, chunk_size=chunk))


def test_transforms_collect_edges_equal_jax(reference_edges):
    cases = [
        (lambda s: s.map_edges(lambda a, b, v: v + 1),
         lambda s: s.map_edges(lambda a, b, v: v + 1)),
        (lambda s: s.filter_edges(lambda a, b, v: v > 30),
         lambda s: s.filter_edges(lambda a, b, v: v > 30)),
        (lambda s: s.filter_vertices(lambda v: v > 2),
         lambda s: s.filter_vertices(lambda v: v > 2)),
        (lambda s: s.reverse(), lambda s: s.reverse()),
        (lambda s: s.undirected(), lambda s: s.undirected()),
        (lambda s: s.undirected().reverse().distinct(),
         lambda s: s.undirected().reverse().distinct()),
    ]
    for ft, fj in cases:
        t, j = _both(reference_edges)
        assert ft(t).collect_edges() == fj(j).collect_edges()
    t, _ = _both(reference_edges)
    got = t.map_edges(lambda s, d, v: v + 1).collect_edges()
    assert sorted(v for _, _, v in got) == [13.0, 14.0, 24.0, 35.0, 36.0,
                                            46.0, 52.0]
    assert len(t.undirected().collect_edges()) == 14


def test_union_equal_jax(reference_edges):
    from gelly_torch.core.io import chunks_from_edges as t_chunks
    from gelly_tpu.core.io import chunks_from_edges as j_chunks

    t1, j1 = _both(reference_edges[:3])
    t_src = t_chunks(reference_edges[3:], chunk_size=4, table=t1.ctx.table)
    j_src = j_chunks(reference_edges[3:], chunk_size=4, table=j1.ctx.table)
    tu = t1.union(TStream(lambda: iter(t_src), t1.ctx)).collect_edges()
    ju = j1.union(JStream(lambda: iter(j_src), j1.ctx)).collect_edges()
    assert tu == ju
    assert sorted(tu) == sorted(reference_edges)
    t2, _ = _both(reference_edges)
    with pytest.raises(ValueError, match="sharing a StreamContext"):
        t1.union(t2)


def test_global_aggregate_emit_on_change_equal_jax(reference_edges):
    t, j = _both(reference_edges, chunk=2)

    def upd_t(state, c):
        state = state + torch.where(c.valid, c.val, 0).sum()
        return state, (state > 100).to(torch.int32)

    def upd_j(state, c):
        state = state + jnp.where(c.valid, c.val, 0).sum()
        return state, (state > 100).astype(jnp.int32)

    got = [int(x) for x in t.global_aggregate(
        upd_t, torch.zeros((), dtype=torch.float32))]
    want = [int(x) for x in j.global_aggregate(
        upd_j, jnp.zeros((), jnp.float32))]
    assert got == want == [0, 1]
