"""gelly_torch's mesh layer vs gelly_tpu's on the CPU.

gelly_tpu runs ``shard_map`` over ``make_mesh(S)`` on the conftest's 8
virtual CPU devices; the port runs the same S shards from one controller
on ``make_mesh(S, devices=[cpu] * S)``. Mirrors ``tests/test_parallel.py``
and the exchange half of ``tests/test_exchange.py``: ``split_chunk``,
``split_chunk_host``, the butterfly, the hierarchical tree (with a
non-commutative combine, so the round schedule and the argument order
show), the gather merge, ``psum_tree``, the keyed exchange (with
overflow), ownership, ``unstripe``, the dirty-delta compaction, the
engine's merge-knob refusals and the tree-degree CC parity. Inputs are
made from a seed with numpy. Tolerance: exact equality of every integer
output and of every raised error's type and text.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gelly_torch.core.chunk import make_chunk as t_make_chunk
from gelly_torch.core.chunk import split_chunk_host as t_split_host
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import connected_components as tcc
from gelly_torch.parallel import collectives as tcol
from gelly_torch.parallel import mesh as tmesh
from gelly_torch.parallel import partition as tpart
from gelly_tpu import make_chunk as j_make_chunk
from gelly_tpu.core.chunk import split_chunk_host as j_split_host
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.parallel import collectives as jcol
from gelly_tpu.parallel import mesh as jmesh
from gelly_tpu.parallel import partition as jpart

jcc = importlib.import_module("gelly_tpu.library.connected_components")

SHARDS = [1, 2, 4, 8]


def _tm(S):
    return tmesh.make_mesh(S, devices=["cpu"] * S)


def _jrun(S, body, *args, n_out=1):
    """A shard_map of ``body`` over ``make_mesh(S)``, jitted."""
    m = jmesh.make_mesh(S)
    out_specs = P("shards") if n_out == 1 else (P("shards"),) * n_out
    f = jmesh.shard_map_fn(m, body, in_specs=(P("shards"),) * len(args),
                           out_specs=out_specs)
    return jax.jit(f)(*args)


def _rows(x):
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in np.asarray(x)]


def _stacked(xs):
    return np.stack([x.numpy() for x in xs])


def test_mesh_construction_and_refusals():
    m = tmesh.make_mesh(4, devices=[torch.device("cpu")] * 4)
    assert tmesh.num_shards(m) == 4 and m.shape == {"shards": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    # More shards than devices raises, with gelly_tpu's text.
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(9)
    with pytest.raises(ValueError) as te:
        tmesh.make_mesh(9, devices=["cpu"] * 8)
    assert str(te.value) == str(je.value)
    if not torch.cuda.is_available():
        # Nothing falls back to the CPU.
        with pytest.raises(RuntimeError, match="no"):
            tmesh.make_mesh()
    with pytest.raises(NotImplementedError, match="item 8b"):
        tmesh.initialize_multihost()
    assert tmesh.host_info() == {"process_index": 0, "process_count": 1,
                                 "coordinator_address": None}
    out = tmesh.shard_map_fn(m, lambda i, x: x + i)([torch.zeros(2)] * 4)
    assert [int(o[0]) for o in out] == [0, 1, 2, 3]
    placed = tmesh.device_put_sharded_leading(m, np.arange(8).reshape(4, 2))
    assert [p.tolist() for p in placed] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    rep = tmesh.device_put_replicated(m, {"a": np.arange(3)})
    assert all(r["a"].tolist() == [0, 1, 2] for r in rep)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("cap", [16, 13])
def test_split_chunk_equals_jax(S, cap):
    rng = np.random.default_rng(cap + S)
    n = cap - 3
    src, dst = rng.integers(0, 64, (2, n))
    j = jpart.split_chunk(j_make_chunk(src, dst, capacity=cap), S)
    t = tpart.split_chunk(t_make_chunk(src, dst, capacity=cap, device="cpu"),
                          S)
    assert len(t) == S
    for f in range(8):
        np.testing.assert_array_equal(
            np.stack([c[f].numpy() for c in t]), np.asarray(j[f]))
    jh = j_split_host(j_make_chunk(src, dst, capacity=cap, device=False), S)
    th = t_split_host(t_make_chunk(src, dst, capacity=cap, device=None), S)
    assert len(jh) == len(th) == S
    for a, b in zip(jh, th):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _noncomm(a, b):
    # Neither commutative nor associative: the result records the round
    # schedule and the argument order exactly.
    return a * 3 + b


@pytest.mark.parametrize("S", SHARDS)
def test_butterfly_merge_equals_jax(S):
    rng = np.random.default_rng(S)
    x = rng.integers(0, 5, (S, 6)).astype(np.int64)
    for combine_j, combine_t in ((jnp.maximum, torch.maximum),
                                 (_noncomm, _noncomm)):
        want = np.asarray(_jrun(S, lambda v: jcol.butterfly_merge(
            combine_j, v[0], S)[None], x))
        got = tcol.butterfly_merge(combine_t, _rows(x), S, _tm(S))
        np.testing.assert_array_equal(_stacked(got), want)
        kept = tcol.butterfly_merge(combine_t, _rows(x), S, _tm(S),
                                    keep=(0,))
        np.testing.assert_array_equal(kept[0].numpy(), want[0])
        assert all(k is None for k in kept[1:])
    if S > 1:
        with pytest.raises(ValueError, match="power-of-two"):
            tcol.butterfly_merge(_noncomm, _rows(x[:3]) * 2, 6)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_hierarchical_merge_equals_jax(S):
    rng = np.random.default_rng(10 + S)
    x = rng.integers(0, 5, (S, 4)).astype(np.int64)
    degree = 1
    while degree <= S:
        want = np.asarray(_jrun(S, lambda v, d=degree: jcol.hierarchical_merge(
            _noncomm, v[0], S, d)[None], x))
        got = tcol.hierarchical_merge(_noncomm, _rows(x), S, degree, _tm(S))
        np.testing.assert_array_equal(_stacked(got), want)
        # The replicated sum is the same at every degree.
        got_sum = tcol.hierarchical_merge(torch.add, _rows(x), S, degree)
        np.testing.assert_array_equal(_stacked(got_sum)[0], x.sum(axis=0))
        degree *= 2
    for bad in ((S, 3), (S, 2 * S), (S, 0)):
        errs = []
        for fn in (jcol.hierarchical_merge, tcol.hierarchical_merge):
            with pytest.raises(ValueError) as e:
                fn(torch.add, _rows(x), *bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("S", SHARDS)
def test_gather_merge_and_psum_equal_jax(S):
    rng = np.random.default_rng(20 + S)
    x = rng.integers(0, 100, (S, 5)).astype(np.int64)
    want = np.asarray(_jrun(S, lambda v: jcol.gather_merge(
        lambda st: st[0] * 7 + jnp.sum(st, axis=0), v[0])[None], x))
    got = tcol.gather_merge(lambda st: st[0] * 7 + st.sum(dim=0),
                            _rows(x), _tm(S))
    np.testing.assert_array_equal(_stacked(got), want)
    want = np.asarray(_jrun(S, lambda v: jcol.psum_tree(v[0])[None], x))
    got = tcol.psum_tree(_rows(x), _tm(S))
    np.testing.assert_array_equal(_stacked(got), want)


def _j_exchange(S, key, pay, valid, bucket):
    def body(k, p, v):
        k2, p2, v2, dropped = jpart.repartition_by_key(
            k[0], p[0], v[0], S, bucket)
        return k2[None], p2[None], v2[None], dropped[None]

    return [np.asarray(x) for x in _jrun(S, body, key, pay, valid, n_out=4)]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("skew", [False, True])
def test_repartition_by_key_equals_jax(S, skew):
    rng = np.random.default_rng(30 + S + skew)
    L = 24
    key = rng.integers(0, 64, (S, L)).astype(np.int32)
    if skew:
        key[:, ::2] = 3  # one owner takes half the lanes: buckets drop
    pay = rng.integers(0, 1000, (S, L)).astype(np.int32)
    valid = rng.random((S, L)) < 0.85
    bucket = (tpart.default_bucket_capacity(L, S, 1.0) if skew
              else tpart.default_bucket_capacity(L, S, 3.0))
    assert bucket == jpart.default_bucket_capacity(L, S, 1.0 if skew
                                                   else 3.0)
    jk, jp, jv, jd = _j_exchange(S, key, pay, valid, bucket)
    tk, tp, tv, td = tpart.repartition_by_key(
        _tm(S), _rows(key), _rows(pay), _rows(valid), S, bucket)
    np.testing.assert_array_equal(_stacked(tk), jk)
    np.testing.assert_array_equal(_stacked(tp), jp)
    np.testing.assert_array_equal(_stacked(tv), jv)
    assert [int(d) for d in td] == jd.tolist()
    # Every received valid key is owned by its shard; received + dropped
    # == sent.
    for d in range(S):
        assert (tk[d][tv[d]] % S == d).all()
    assert int(sum(int(v.sum()) for v in tv)) + int(td[0]) == valid.sum()


@pytest.mark.parametrize("S", SHARDS)
def test_ownership_and_unstripe_equal_jax(S):
    cap = 64
    slots = np.arange(cap, dtype=np.int32)
    want = np.asarray(_jrun(S, lambda _: jnp.sum(jpart.owned_mask(
        jnp.asarray(slots), S).astype(jnp.int32))[None],
        np.zeros((S, 1), np.int32)))
    got = [int(tpart.owned_mask(torch.from_numpy(slots), S, me).sum())
           for me in range(S)]
    assert got == want.tolist() == [tpart.slots_per_shard(cap, S)] * S
    assert int(tpart.to_local_slot(torch.tensor(3 * S + 5), S)) == \
        int(jpart.to_local_slot(jnp.int32(3 * S + 5), S))
    flat = np.arange(cap * 2).reshape(cap, 2)
    np.testing.assert_array_equal(tpart.unstripe(flat, S),
                                  np.asarray(jpart.unstripe(flat, S)))
    np.testing.assert_array_equal(
        tpart.unstripe(torch.from_numpy(flat), S).numpy(),
        np.asarray(jpart.unstripe(flat, S)))
    with pytest.raises(ValueError, match="not divisible"):
        tpart.slots_per_shard(cap + 1, 2)


@pytest.mark.parametrize("n,bucket", [(256, 256), (256, 8), (100, 16),
                                      (64, 64)])
def test_compact_delta_equals_jax(n, bucket):
    rng = np.random.default_rng(n + bucket)
    dirty = rng.random(n) < 0.2
    vals = {"r": rng.integers(0, n, n).astype(np.int32),
            "v": rng.integers(-1, n, n).astype(np.int32)}
    js, jv, jc = jax.jit(jcol.compact_delta, static_argnums=2)(
        jnp.asarray(dirty), jax.tree.map(jnp.asarray, vals), bucket)
    ts, tv, tc = tcol.compact_delta(torch.from_numpy(dirty), {
        k: torch.from_numpy(v) for k, v in vals.items()}, bucket)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for k in vals:
        np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
    assert int(tc) == int(jc)
    gs, gv = tcol.gather_delta([ts, ts], [tv, tv], torch.device("cpu"))
    assert gs.tolist() == np.asarray(js).tolist() * 2
    assert gv["r"].shape == (2 * bucket,)


def _cc_streams(src, dst, n, chunk):
    return (j_stream(JSource(src, dst, chunk_size=chunk,
                             table=JIdentity(n)), n),
            t_stream(TSource(src, dst, chunk_size=chunk,
                             table=TIdentity(n)), n, device="cpu"))


def test_engine_merge_refusals_equal_jax():
    rng = np.random.default_rng(40)
    src, dst = rng.integers(0, 64, (2, 200))
    cases = []
    for mod in (jcc, tcc):
        bad = mod.connected_components(64, ingest_combine=False)
        bad.merge_mode = "bogus"
        nodelta = mod.connected_components(64, ingest_combine=False)
        nodelta.merge_mode, nodelta.merge_delta = "delta", None
        nocount = mod.connected_components(64, ingest_combine=False)
        nocount.merge_mode, nocount.merge_dirty_count = "delta", None
        compact = mod.connected_components(64, codec="compact",
                                           compact_capacity=64)
        cases.append((bad, nodelta, nocount, compact))
    for i in range(4):
        errs = []
        for S, pkg in ((4, 0), (4, 1)):
            js_, ts_ = _cc_streams(src, dst, 64, 32)
            stream = js_ if pkg == 0 else ts_
            mesh = jmesh.make_mesh(S) if pkg == 0 else _tm(S)
            kw = dict(merge_every=3) if i == 3 else dict(merge_every=2)
            with pytest.raises(ValueError) as e:
                list(stream.aggregate(cases[pkg][i], mesh=mesh, **kw))
            errs.append(str(e.value))
        assert errs[0] == errs[1], i


def test_cc_tree_degree_knob_parity():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 64, 400).astype(np.int64)
    dst = rng.integers(0, 64, 400).astype(np.int64)
    base = None
    for degree in (None, 2, 4, 8):
        js_, ts_ = _cc_streams(src, dst, 64, 64)
        want = np.asarray(js_.aggregate(
            jcc.connected_components_tree(64, degree=degree),
            mesh=jmesh.make_mesh(8), merge_every=2).result())
        agg = tcc.connected_components_tree(64, degree=degree)
        assert agg.merge_degree == degree
        got = ts_.aggregate(agg, mesh=_tm(8), merge_every=2).result()
        np.testing.assert_array_equal(got.numpy(), want)
        base = want if base is None else base
        np.testing.assert_array_equal(want, base)
