"""gelly_torch's sharded library paths vs gelly_tpu's on ``make_mesh(S)``.

On the port's S CPU shards against gelly_tpu on the conftest's 8 virtual
devices (mirrors ``tests/test_exchange.py``,
``tests/test_sharded_triangles.py`` and the mesh cases of
``tests/test_bipartiteness.py`` and ``tests/test_spanner.py``):

- ``ShardedDegrees`` in its three modes, the skew fallback
  (``stats["fallback_chunks"]``) and the strict overflow error;
- ``sampled_triangle_count(mesh=)``: every instance's state after every
  chunk equals gelly_tpu's unsharded sampler, the estimate within
  ``rtol=1e-6`` (a sum over the instance axis grouped per shard);
- ``ShardedSnapshotStream`` (``reduce_on_edges`` / ``fold_neighbors`` /
  ``apply_on_neighbors``, overflow refusals) and
  ``sharded_window_triangles``;
- ``ShardedExactTriangles``: counts, striped state, overflow, a state
  carried across packages mid-stream;
- bipartiteness and the spanner through the engine on a mesh.

Inputs are made from a seed with numpy. Tolerance: exact equality of
integer outputs and error texts; float values as stated.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.io import TimeCharacteristic as TT
from gelly_torch.core.stream import edge_stream_from_edges as t_edges
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import degrees as tdeg
from gelly_torch.library.sharded_triangles import \
    ShardedExactTriangles as TExact
from gelly_torch.parallel import mesh as tmesh
from gelly_torch.parallel.sharded_window import sharded_slice as t_slice
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.io import TimeCharacteristic as JT
from gelly_tpu.core.stream import edge_stream_from_edges as j_edges
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.library import degrees as jdeg
from gelly_tpu.library.sharded_triangles import \
    ShardedExactTriangles as JExact
from gelly_tpu.parallel import mesh as jmesh
from gelly_tpu.parallel.sharded_window import sharded_slice as j_slice

jtri = importlib.import_module("gelly_tpu.library.triangles")
ttri = importlib.import_module("gelly_torch.library.triangles")
jbip = importlib.import_module("gelly_tpu.library.bipartiteness")
tbip = importlib.import_module("gelly_torch.library.bipartiteness")
jspan = importlib.import_module("gelly_tpu.library.spanner")
tspan = importlib.import_module("gelly_torch.library.spanner")

N_V = 64


def _tm(S):
    return tmesh.make_mesh(S, devices=["cpu"] * S)


def _streams(src, dst, ts=None, chunk_size=32, val=None, n=N_V):
    jkw, tkw = {}, {}
    if ts is not None:
        jkw = dict(timestamps=ts, time=JT.EVENT)
        tkw = dict(timestamps=ts, time=TT.EVENT)
    return (j_stream(JSource(src, dst, val=val, chunk_size=chunk_size,
                             table=JIdentity(n), **jkw), n),
            t_stream(TSource(src, dst, val=val, chunk_size=chunk_size,
                             table=TIdentity(n), **tkw), n, device="cpu"))


# --------------------------------------------------------------------- #
# ShardedDegrees


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["exchange", "broadcast", "auto"])
def test_sharded_degrees_equal_jax(S, mode):
    rng = np.random.default_rng(S)
    src, dst = rng.integers(0, N_V, (2, 500)).astype(np.int64)
    for kw in ({}, {"count_in": False}):
        js_, ts_ = _streams(src, dst)
        want = jdeg.sharded_degrees(js_, mesh=jmesh.make_mesh(S), mode=mode,
                                    **kw).final_degrees()
        got = tdeg.sharded_degrees(ts_, mesh=_tm(S), mode=mode,
                                   **kw).final_degrees()
        assert got == want


def test_sharded_degrees_stripes_carry_both_ways():
    # The degree stripes after JAX's first exchange step continue in the
    # port, and the port's go back to JAX: every later step equal.
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, N_V, (2, 256)).astype(np.int64)
    js_, ts_ = _streams(src, dst, chunk_size=64)
    m = jmesh.make_mesh(4)
    jsd = jdeg.sharded_degrees(js_, mesh=m, mode="exchange")
    tsd = tdeg.sharded_degrees(ts_, mesh=_tm(4), mode="exchange")
    step = jsd._step_fn("exchange")
    jchunks, tchunks = list(js_), list(ts_)
    sh = NamedSharding(m, P("shards"))
    deg = jax.device_put(np.zeros(N_V, np.int64), sh)
    deg, _ = step(deg, jchunks[0])
    tdeg_ = convert.shards_from_numpy(
        np.asarray(deg).reshape(4, -1), _tm(4), np.int64)
    for jc, tc in zip(jchunks[1:3], tchunks[1:3]):
        deg, _ = step(deg, jc)
        tdeg_, dropped = tsd._exchange_step(tdeg_, tc)
        assert int(dropped) == 0
        np.testing.assert_array_equal(convert.shards_to_numpy(tdeg_),
                                      np.asarray(deg).reshape(4, -1))
    deg = jax.device_put(convert.shards_to_numpy(tdeg_).reshape(-1), sh)
    deg, _ = step(deg, jchunks[3])
    tdeg_, _ = tsd._exchange_step(tdeg_, tchunks[3])
    np.testing.assert_array_equal(convert.shards_to_numpy(tdeg_),
                                  np.asarray(deg).reshape(4, -1))


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_degrees_skew_fallback_and_strict_error(S):
    # A star: every endpoint buckets to vertex 0's owner.
    n = 2048
    src = np.zeros(n, np.int64)
    dst = (np.arange(n) % (N_V - 1) + 1).astype(np.int64)
    js_, ts_ = _streams(src, dst, chunk_size=1024)
    j = jdeg.sharded_degrees(js_, mesh=jmesh.make_mesh(S), mode="auto",
                             bucket_slack=1.0)
    t = tdeg.sharded_degrees(ts_, mesh=_tm(S), mode="auto",
                             bucket_slack=1.0)
    assert t.final_degrees() == j.final_degrees()
    assert t.stats == j.stats and t.stats["fallback_chunks"] > 0
    errs = []
    for mod, stream, m in ((jdeg, js_, jmesh.make_mesh(S)),
                           (tdeg, ts_, _tm(S))):
        sd = mod.sharded_degrees(stream, mesh=m, mode="exchange",
                                 bucket_slack=1.0)
        with pytest.raises(ValueError, match="overflowed") as e:
            sd.final_degrees()
        errs.append((str(e.value), sd.stats["dropped"]))
    assert errs[0] == errs[1]


# --------------------------------------------------------------------- #
# the sampler on a mesh


@pytest.mark.parametrize("S", [1, 8])
def test_sharded_sampler_states_equal_jax(S):
    rng = np.random.default_rng(40 + S)
    src, dst = rng.integers(0, 48, (2, 200))
    js_, ts_ = _streams(src, dst, chunk_size=128)
    step = jax.jit(jtri._sampler_step)
    state = jtri._fresh_sampler(64, 9)
    runs = ttri.sharded_sampler_run(ts_, 64, _tm(S), seed=9)
    for c, (states, est) in zip(js_, runs):
        state = step(state, c, jnp.int32(js_.ctx.table.num_vertices))
        for f in jtri.SamplerState._fields:
            want = np.asarray(getattr(state, f))
            if f == "edge_count":
                for st in states:  # replicated
                    assert int(st.edge_count) == int(want)
                continue
            got = np.concatenate([getattr(st, f).numpy() for st in states])
            if f == "keys":
                got = got.astype(np.uint32)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(est, jtri.sampler_estimate(state),
                                   rtol=1e-6)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_sampler_entry_point_equals_jax(S):
    rng = np.random.default_rng(40 + S)
    src, dst = rng.integers(0, 48, (2, 300))
    js_, ts_ = _streams(src, dst, chunk_size=128)
    want = list(jtri.sampled_triangle_count(js_, 64, seed=9,
                                            mesh=jmesh.make_mesh(S)))
    got = list(ttri.sampled_triangle_count(ts_, 64, seed=9, mesh=_tm(S)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sharded_sampler_refusal_equals_jax():
    errs = []
    for mod, stream, m in (
            (jtri, j_edges([(0, 1)], vertex_capacity=8),
             jmesh.make_mesh(3)),
            (ttri, t_edges([(0, 1)], vertex_capacity=8, device="cpu"),
             _tm(3))):
        with pytest.raises(ValueError) as e:
            list(mod.sampled_triangle_count(stream, 8, mesh=m))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# --------------------------------------------------------------------- #
# sharded windows


def _collect(updates):
    out = {}
    for upd in updates:
        ok = np.asarray(upd.valid).astype(bool)
        keys = np.asarray(upd.slots)[ok]
        vals = np.asarray(upd.values)[ok]
        out[upd.window] = dict(zip(keys.tolist(), vals.tolist()))
    return out


def _window_data(seed, n=400):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N_V, (2, n)).astype(np.int64)
    val = rng.integers(1, 10, n).astype(np.float32)
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    return src, dst, val, ts


@pytest.mark.parametrize("S,direction", [(1, "out"), (2, "all"),
                                         (4, "in"), (8, "all")])
def test_sharded_window_reduce_and_fold_equal_jax(S, direction):
    src, dst, val, ts = _window_data(3 + S)

    def j_fold(acc, key, nbr, v):
        return acc * 0.5 + v  # order-sensitive: the fold sequence shows

    def t_fold(acc, key, nbr, v):
        return acc * 0.5 + v

    js_, ts_ = _streams(src, dst, ts, val=val)
    kw = dict(window_capacity=2 * len(src))
    want = _collect(j_slice(js_, 1000, direction,
                            mesh=jmesh.make_mesh(S), **kw
                            ).reduce_on_edges(jnp.minimum))
    got = _collect(t_slice(ts_, 1000, direction, mesh=_tm(S), **kw
                           ).reduce_on_edges(torch.minimum))
    assert got == want, direction
    want = _collect(j_slice(js_, 1000, direction,
                            mesh=jmesh.make_mesh(S), **kw
                            ).fold_neighbors(jnp.float32(0), j_fold))
    got = _collect(t_slice(ts_, 1000, direction, mesh=_tm(S), **kw
                           ).fold_neighbors(
        torch.zeros((), dtype=torch.float32), t_fold))
    assert got == want, direction


def test_sharded_window_apply_and_overflow_equal_jax():
    src, dst, _, ts = _window_data(6, 300)
    js_, ts_ = _streams(src, dst, ts)
    want = {w: int(np.asarray(o).sum()) for w, o in j_slice(
        js_, 1000, "out", window_capacity=600, mesh=jmesh.make_mesh(8)
    ).apply_on_neighbors(lambda v: jnp.sum(v.valid.astype(jnp.int32)))}
    got = {w: int(o.sum()) for w, o in t_slice(
        ts_, 1000, "out", window_capacity=600, mesh=_tm(8)
    ).apply_on_neighbors(lambda v: v.valid.sum(dtype=torch.int32))}
    assert got == want
    # One vertex takes every edge: a tiny capacity raises on both.
    n = 256
    z = np.zeros(n, np.int64)
    errs = []
    js_, ts_ = _streams(z, np.ones(n, np.int64), z, chunk_size=16)
    for fn, stream, m, red in ((j_slice, js_, jmesh.make_mesh(8),
                                jnp.minimum),
                               (t_slice, ts_, _tm(8), torch.minimum)):
        with pytest.raises(ValueError, match="overflow|bucket") as e:
            list(fn(stream, 1000, "out", window_capacity=32, mesh=m,
                    bucket_slack=1.0).reduce_on_edges(red))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("S", [1, 2, 8])
def test_sharded_window_triangles_equal_jax(S):
    rng = np.random.default_rng(7)
    n = 600
    src, dst = rng.integers(0, N_V, (2, n)).astype(np.int64)
    src[50:100], dst[50:100] = src[:50], dst[:50]  # duplicates: dedup
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    js_, ts_ = _streams(src, dst, ts)
    want = {w: int(c) for w, c in jtri.sharded_window_triangles(
        js_, 1000, window_capacity=4 * n, mesh=jmesh.make_mesh(S))}
    got = {w: int(c) for w, c in ttri.sharded_window_triangles(
        ts_, 1000, window_capacity=4 * n, mesh=_tm(S))}
    single = {w: int(c) for w, c in ttri.window_triangles(
        ts_, 1000, window_capacity=4 * n)}
    assert got == want == single and sum(got.values()) > 0


# --------------------------------------------------------------------- #
# ShardedExactTriangles (mirrors tests/test_sharded_triangles.py)


def _exact_streams(src, dst, chunk_size=64, n=256):
    return _streams(src, dst, chunk_size=chunk_size, n=n)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_exact_equals_jax(S):
    rng = np.random.default_rng(50 + S)
    src, dst = rng.integers(0, 256, (2, 700)).astype(np.int64)
    js_, ts_ = _exact_streams(src, dst)
    j = JExact(js_, max_degree=32, mesh=jmesh.make_mesh(S)).run()
    t = TExact(ts_, max_degree=32, mesh=_tm(S)).run()
    got = t.final_counts()
    assert got == j.final_counts()
    assert got == ttri.exact_triangle_count(ts_,
                                            max_degree=32).final_counts()
    state = convert.sharded_exact_to_numpy(t)
    want = convert.sharded_exact_to_numpy(j)
    for k in ("deg", "counts", "total", "n_seen", "overflow"):
        np.testing.assert_array_equal(state[k], want[k])
    # Rows hold the same neighbours (in-row order is the append order).
    np.testing.assert_array_equal(np.sort(state["nbr"], axis=2),
                                  np.sort(want["nbr"], axis=2))
    assert [x.shape for x in t.nbr] == [(256 // S, 32)] * S


def test_sharded_exact_known_graph_and_overflow():
    edges = [(0, 1), (1, 2), (2, 0), (0, 3), (3, 1), (2, 2), (0, 1)]
    src = np.array([e[0] for e in edges], np.int64)
    dst = np.array([e[1] for e in edges], np.int64)
    _, ts_ = _exact_streams(src, dst, chunk_size=2)
    got = TExact(ts_, max_degree=8, mesh=_tm(8)).run().final_counts()
    assert got == {-1: 2, 0: 2, 1: 2, 2: 1, 3: 1}
    star = np.arange(1, 30)
    js_, ts_ = _exact_streams(np.zeros(29, np.int64), star)
    errs = []
    for cls, stream, m in ((JExact, js_, jmesh.make_mesh(8)),
                           (TExact, ts_, _tm(8))):
        with pytest.raises(ValueError, match="max_degree") as e:
            cls(stream, max_degree=4, mesh=m).run()
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_sharded_exact_state_carries_from_jax():
    # JAX folds the first chunks; the port continues from its stripes,
    # and they go back to JAX.
    rng = np.random.default_rng(60)
    src, dst = rng.integers(0, 256, (2, 640)).astype(np.int64)
    js_, ts_ = _exact_streams(src, dst)
    j = JExact(js_, max_degree=32, mesh=jmesh.make_mesh(4))
    t = TExact(ts_, max_degree=32, mesh=_tm(4))
    jchunks, tchunks = list(js_), list(ts_)
    for c in jchunks[:5]:
        j._fold_chunk(c)
    convert.sharded_exact_from_numpy(t, **convert.sharded_exact_to_numpy(j))
    for jc, tc in zip(jchunks[5:8], tchunks[5:8]):
        j._fold_chunk(jc)
        t._fold_chunk(tc)
    assert t.final_counts() == j.final_counts()
    # And back: the port's stripes into a fresh JAX instance.
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = convert.sharded_exact_to_numpy(t)
    j2 = JExact(js_, max_degree=32, mesh=jmesh.make_mesh(4))
    sh = NamedSharding(j2.mesh, P("shards"))
    j2.nbr, j2.aidx, j2.deg, j2.counts = (
        jax.device_put(state[k], sh)
        for k in ("nbr", "aidx", "deg", "counts"))
    j2.total, j2.n_seen, j2.overflow = (state[k] for k in
                                        ("total", "n_seen", "overflow"))
    for jc, tc in zip(jchunks[8:], tchunks[8:]):
        j2._fold_chunk(jc)
        t._fold_chunk(tc)
    assert t.final_counts() == j2.final_counts()


# --------------------------------------------------------------------- #
# bipartiteness and the spanner through the engine on a mesh


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("codec", ["raw", "dense", "sparse"])
def test_bipartiteness_on_mesh_equals_jax(S, codec):
    rng = np.random.default_rng(70 + S)
    # Two components, one with an odd cycle across the shards.
    cyc = [(i, i + 1) for i in range(8)] + [(8, 0)]
    even = [(int(a), int(a) + 1) for a in rng.integers(10, 14, 20) * 2]
    edges = cyc + even
    kw = (dict(ingest_combine=False) if codec == "raw"
          else dict(codec=codec))
    for sub in (edges[:9:2] + even, edges):
        s2 = np.array([e[0] for e in sub], np.int64)
        d2 = np.array([e[1] for e in sub], np.int64)
        js_, ts_ = _streams(s2, d2, chunk_size=4, n=32)
        want = js_.aggregate(jbip.bipartiteness_check(32, **kw),
                             mesh=jmesh.make_mesh(S), merge_every=S,
                             fold_batch=S).result()
        got = ts_.aggregate(tbip.bipartiteness_check(32, **kw),
                            mesh=_tm(S), merge_every=S,
                            fold_batch=S).result()
        assert bool(got.ok) == bool(want.ok)
        assert (tbip.to_candidates(got, ts_.ctx)
                == jbip.to_candidates(want, js_.ctx))


@pytest.mark.parametrize("S", [2, 8])
def test_spanner_on_mesh_equals_jax(S):
    rng = np.random.default_rng(4)
    edges = sorted({(int(a), int(b))
                    for a, b in rng.integers(0, 16, (60, 2)) if a != b})
    js_ = j_edges(edges, vertex_capacity=16, chunk_size=8)
    ts_ = t_edges(edges, vertex_capacity=16, chunk_size=8, device="cpu")
    want = js_.aggregate(jspan.spanner(16, 2), mesh=jmesh.make_mesh(S),
                         merge_every=2).result()
    got = ts_.aggregate(tspan.spanner(16, 2), mesh=_tm(S),
                        merge_every=2).result()
    assert (sorted(tspan.spanner_edges(got, ts_.ctx))
            == sorted(jspan.spanner_edges(want, js_.ctx)))
