"""gelly_torch's degree plans and degree distribution vs gelly_tpu's (CPU).

Mirrors the degree cases of ``test_codec.py`` (``test_degree_codec_parity``
with deletions and ``count_out``/``count_in``), ``test_sparse_codec.py``,
``test_pipeline.py`` (hot vertex, deletions) and ``test_examples.py``
(degree distribution final state, deletion to zero) on the port, and holds
every emission of the raw, dense and sparse plans to ``gelly_tpu``'s on the
same seeded streams, the native degree codecs to ``gelly_tpu``'s and to
both numpy fallbacks, the per-chunk histograms of the distribution stream,
and checkpoints across the two packages. gelly_tpu runs on a one-device
mesh. Tolerance: exact equality, dtype included (``int64`` degrees).
"""

import jax
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine.checkpoint import read_checkpoint_header
from gelly_torch.library import degrees as tdeg
from gelly_torch.ops import unionfind as tuf
from gelly_torch.utils import native as tnative
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.library import degrees as jdeg
from gelly_tpu.parallel.mesh import make_mesh
from gelly_tpu.utils import native as jnative

from _torch_native import load_jax_native

N_V = 64


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _edges(n_e, seed, deletions, n_v=N_V, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        src = rng.zipf(1.4, n_e) % n_v
        dst = rng.zipf(1.4, n_e) % n_v
    else:
        src = rng.integers(0, n_v, n_e)
        dst = rng.integers(0, n_v, n_e)
    ev = np.zeros(n_e, np.int8)
    if deletions:
        ev[rng.random(n_e) < 0.2] = 1
    return src.astype(np.int64), dst.astype(np.int64), ev


def _t_stream(src, dst, ev, chunk, n_v=N_V):
    return t_stream(TSource(src, dst, events=ev, chunk_size=chunk,
                            table=TIdentity(n_v)), n_v, device="cpu")


def _j_stream(src, dst, ev, chunk, n_v=N_V):
    return j_stream(JSource(src, dst, events=ev, chunk_size=chunk,
                            table=JIdentity(n_v)), n_v)


def _oracle(src, dst, ev, count_out=True, count_in=True, n_v=N_V):
    deg = np.zeros(n_v, np.int64)
    sign = np.where(ev == 1, -1, 1)
    if count_out:
        np.add.at(deg, src, sign)
    if count_in:
        np.add.at(deg, dst, sign)
    return deg


PLANS = {
    "raw": dict(ingest_combine=False),
    "dense": dict(codec="dense"),
    "sparse": dict(codec="sparse"),
}


def _both(src, dst, ev, plan, chunk=64, merge_every=4, fold_batch=1,
          n_v=N_V, jax_kw=None, **dirs):
    jagg = jdeg.degree_aggregate(n_v, **PLANS[plan], **dirs)
    tagg = tdeg.degree_aggregate(n_v, **PLANS[plan], **dirs)
    want = [np.asarray(x) for x in _j_stream(src, dst, ev, chunk, n_v)
            .aggregate(jagg, merge_every=merge_every, fold_batch=fold_batch,
                       mesh=make_mesh(1), **(jax_kw or {}))]
    res = _t_stream(src, dst, ev, chunk, n_v).aggregate(
        tagg, merge_every=merge_every, fold_batch=fold_batch)
    got = [x.numpy() for x in res]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)
    return got, res


# ---------------------------------------------------------------------- #
# test_codec.py::test_degree_codec_parity, emission by emission


@pytest.mark.parametrize("with_deletions", [False, True])
@pytest.mark.parametrize("count_out,count_in",
                         [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("plan,fold_batch", [("raw", 1), ("raw", 4),
                                             ("dense", 1), ("dense", 4),
                                             ("sparse", 1), ("sparse", 4)])
def test_degree_plans_equal_gelly_tpu(with_deletions, count_out, count_in,
                                      plan, fold_batch):
    src, dst, ev = _edges(300, 5, with_deletions)  # partial final chunk
    got, _ = _both(src, dst, ev, plan, fold_batch=fold_batch,
                   count_out=count_out, count_in=count_in)
    assert np.array_equal(got[-1], _oracle(src, dst, ev, count_out,
                                           count_in))


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("merge_every,fold_batch", [(1, 1), (3, 2), (8, 8)])
def test_degree_cadences_equal_gelly_tpu(plan, merge_every, fold_batch):
    src, dst, ev = _edges(700, 8, True, zipf=True)
    _both(src, dst, ev, plan, chunk=32, merge_every=merge_every,
          fold_batch=fold_batch)


def test_sparse_group_combine_stays_int64():
    # fold_batch chunks' i32 nets are summed by vertex in i64 on the host;
    # one chunk a unit keeps the codec's i32.
    src, dst, ev = _edges(600, 9, True, zipf=True)
    for fold_batch, want in ((4, np.int64), (1, np.int32)):
        agg = tdeg.degree_aggregate(N_V, codec="sparse")
        seen = []
        fold = agg.fold_compressed
        agg.fold_compressed = lambda s, p: (seen.append(p["d"].dtype),
                                            fold(s, p))[1]
        _t_stream(src, dst, ev, 64).aggregate(
            agg, merge_every=4, fold_batch=fold_batch).result()
        assert set(seen) == {torch.from_numpy(np.zeros(1, want)).dtype}


# ---------------------------------------------------------------------- #
# the native degree codecs against gelly_tpu's and the numpy fallbacks


def _need_native():
    if not (tnative.degree_deltas_available()
            and tnative.degree_sparse_available()
            and jnative.degree_deltas_available()
            and jnative.sparse_codecs_available()):
        pytest.skip("native degree codecs unavailable")


@pytest.mark.parametrize("deletions", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("count_out,count_in",
                         [(True, True), (True, False), (False, True)])
def test_native_degree_codecs_equal_gelly_tpu(deletions, masked, count_out,
                                              count_in):
    _need_native()
    src, dst, ev = _edges(800, 6, deletions)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    valid = (np.random.default_rng(3).random(src.size) < 0.7
             if masked else None)
    event = ev if deletions else None
    dense = tnative.degree_chunk_deltas(src, dst, event, valid, N_V,
                                        count_out, count_in)
    want = jnative.degree_chunk_deltas(src, dst, event, valid, N_V,
                                       count_out, count_in)
    assert dense.dtype == np.int32 and np.array_equal(dense, want)
    keep = np.ones(src.size, bool) if valid is None else valid
    assert np.array_equal(dense, _oracle(src[keep], dst[keep], ev[keep],
                                         count_out, count_in))
    v, d = tnative.degree_chunk_deltas_sparse(src, dst, event, valid, N_V,
                                              count_out, count_in)
    vj, dj = jnative.degree_chunk_deltas_sparse(src, dst, event, valid, N_V,
                                                count_out, count_in)
    assert np.array_equal(v, vj) and np.array_equal(d, dj)
    assert d.dtype == np.int32 and (d != 0).all()
    got = np.zeros(N_V, np.int32)
    got[v] = d
    assert np.array_equal(got, dense)
    for fallback in (tdeg.degree_pairs_numpy, jdeg.degree_pairs_numpy):
        vn, dn = fallback(src, dst, event, valid, N_V, count_out, count_in)
        got_n = np.zeros(N_V, np.int32)
        got_n[vn] = dn
        assert dn.dtype == np.int32 and np.array_equal(got_n, dense)


def test_degree_codecs_take_the_empty_identity_chunk():
    # The engine pads a short unit with the codec of an empty capacity-1
    # chunk: zero deltas in both formats.
    from gelly_torch.core.chunk import make_chunk

    empty = make_chunk(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       capacity=1, device=None)
    dense = tdeg.degree_aggregate(N_V, codec="dense").host_compress(empty)
    assert dense.dtype == np.int32 and not dense.any()
    sparse = tdeg.degree_aggregate(N_V, codec="sparse").host_compress(empty)
    assert sparse["v"].size == 0 and sparse["d"].size == 0


def test_numpy_fallbacks_give_the_native_emissions(monkeypatch):
    src, dst, ev = _edges(500, 12, True, zipf=True)
    want = {p: _both(src, dst, ev, p, fold_batch=2)[0] for p in
            ("dense", "sparse")}
    monkeypatch.setattr(tnative, "degree_deltas_available", lambda: False)
    monkeypatch.setattr(tnative, "degree_sparse_available", lambda: False)
    for p, w in want.items():
        got = [x.numpy() for x in _t_stream(src, dst, ev, 64).aggregate(
            tdeg.degree_aggregate(N_V, **PLANS[p]), merge_every=4,
            fold_batch=2)]
        assert all(np.array_equal(a, b) for a, b in zip(got, w))


# ---------------------------------------------------------------------- #
# test_pipeline.py: hot vertex and deletions through the executor


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("serial", [True, False])
def test_pipelined_hot_vertex_equals_gelly_tpu(plan, serial):
    src, dst, ev = _edges(800, 3, False, n_v=256, zipf=True)
    knobs = (dict(ingest_workers=0, prefetch_depth=0, h2d_depth=0) if serial
             else dict(codec_workers=3, h2d_depth=2))
    jagg = jdeg.degree_aggregate(256, **PLANS[plan])
    want = [np.asarray(x) for x in _j_stream(src, dst, ev, 64, 256)
            .aggregate(jagg, merge_every=8, fold_batch=8, mesh=make_mesh(1))]
    got = [x.numpy() for x in _t_stream(src, dst, ev, 64, 256).aggregate(
        tdeg.degree_aggregate(256, **PLANS[plan]), merge_every=8,
        fold_batch=8, **knobs)]
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_pipelined_deletions_retire_once(plan):
    src, dst, ev = _edges(640, 7, True, n_v=256)
    ev[:] = (np.random.default_rng(7).random(640) < 0.25)
    outs = [
        _t_stream(src, dst, ev, 64, 256).aggregate(
            tdeg.degree_aggregate(256, **PLANS[plan]), merge_every=4,
            fold_batch=4, **knobs).result().numpy()
        for knobs in (dict(ingest_workers=0, prefetch_depth=0, h2d_depth=0),
                      dict(codec_workers=2, h2d_depth=2))
    ]
    want = _oracle(src, dst, ev, n_v=256)
    assert all(np.array_equal(o, want) for o in outs)
    assert int(outs[0].sum()) == 2 * (int((ev == 0).sum())
                                      - int((ev == 1).sum()))


# ---------------------------------------------------------------------- #
# test_examples.py: the degree distribution

DEGREES_DATA = [
    (1, 2, 0), (2, 3, 0), (1, 4, 0), (2, 3, 1), (3, 4, 0), (1, 2, 1),
]
DEGREES_DATA_ZERO = DEGREES_DATA + [(2, 3, 1)]


def _event_arrays(data):
    return (np.array([e[0] for e in data]), np.array([e[1] for e in data]),
            np.array([e[2] for e in data], np.int8))


def test_degree_distribution_final_state():
    s = _t_stream(*_event_arrays(DEGREES_DATA), 2, 16)
    assert tdeg.degree_distribution(s, max_degree=8).final_distribution() \
        == {1: 2, 2: 1}


def test_degree_distribution_deletion_to_zero():
    s = _t_stream(*_event_arrays(DEGREES_DATA_ZERO), 2, 16)
    assert tdeg.degree_distribution(s, max_degree=8).final_distribution() \
        == {1: 1, 2: 1}


@pytest.mark.parametrize("max_degree", [None, 300])
@pytest.mark.parametrize("chunk", [16, 64])
def test_degree_distribution_every_chunk_equals_gelly_tpu(max_degree, chunk):
    # None: the histogram spans the 1024-slot capacity.
    src, dst, ev = _edges(400, 14, True, n_v=1024, zipf=True)
    want = [np.asarray(h) for h in jdeg.degree_distribution(
        _j_stream(src, dst, ev, chunk, 1024), max_degree)]
    before = tuf.host_sync.count
    got = [h.numpy() for h in tdeg.degree_distribution(
        _t_stream(src, dst, ev, chunk, 1024), max_degree)]
    assert tuf.host_sync.count - before == len(got)  # the peak, per chunk
    assert len(got) == len(want) == -(-400 // chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)


def test_degree_distribution_overflow_message_equals_gelly_tpu():
    src, dst, ev = _edges(400, 14, False, zipf=True)
    peak = int(_oracle(src, dst, ev).max())
    with pytest.raises(ValueError) as ej:
        list(jdeg.degree_distribution(_j_stream(src, dst, ev, 64), peak - 1))
    with pytest.raises(ValueError) as et:
        list(tdeg.degree_distribution(_t_stream(src, dst, ev, 64), peak - 1))
    assert str(et.value) == str(ej.value)
    assert "raise max_degree" in str(et.value)
    last = list(tdeg.degree_distribution(_t_stream(src, dst, ev, 64),
                                         peak))[-1].numpy()
    deg = _oracle(src, dst, ev)
    assert np.array_equal(last, np.bincount(deg[deg > 0],
                                            minlength=peak + 1))


def test_unported_knobs_name_their_item():
    # windowed= (item 10) is ported: the plan is marked for the ring.
    assert tdeg.degree_aggregate(16, windowed=2).windowed_panes == 2
    with pytest.raises(NotImplementedError, match="item 11"):
        tdeg.degrees_query(16)
    # The sharded degrees are ported (tests/test_torch_sharded_library.py
    # holds them to gelly_tpu); a bad mode raises as gelly_tpu's does.
    with pytest.raises(ValueError, match="mode must be"):
        tdeg.ShardedDegrees(None, mode="bogus")
    with pytest.raises(ValueError, match="mode must be"):
        tdeg.sharded_degrees(None, mode="bogus")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdeg.degree_aggregate(8).init()


# ---------------------------------------------------------------------- #
# checkpoints across the two packages and the numpy converters

CK_CHUNK, CK_EDGES = 32, 11 * 32 - 20


def _ck_run(pkg, plan, path=None, stop_after=None, **kw):
    src, dst, ev = _edges(CK_EDGES, 21, True, n_v=256, zipf=True)
    if pkg == "torch":
        it = iter(_t_stream(src, dst, ev, CK_CHUNK, 256).aggregate(
            tdeg.degree_aggregate(256, **PLANS[plan]), merge_every=4,
            fold_batch=2, checkpoint_path=path, **kw))
    else:
        it = iter(_j_stream(src, dst, ev, CK_CHUNK, 256).aggregate(
            jdeg.degree_aggregate(256, **PLANS[plan]), merge_every=4,
            fold_batch=2, mesh=make_mesh(1), checkpoint_path=path, **kw))
    out = []
    for x in it:
        out.append(np.asarray(x))
        if len(out) == stop_after:
            break
    if hasattr(it, "close"):
        it.close()
    return out


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("writer", ["gelly_tpu", "gelly_torch"])
def test_resume_across_packages_equals_uninterrupted(tmp_path, plan, writer):
    p = str(tmp_path / "ck.npz")
    full = _ck_run("torch", plan)
    assert all(np.array_equal(a, b) for a, b in zip(full,
                                                    _ck_run("jax", plan)))
    if writer == "gelly_tpu":
        _ck_run("jax", plan, p, stop_after=2)
        got = _ck_run("torch", plan, p, resume=True)
    else:
        _ck_run("torch", plan, p, stop_after=2)
        got = _ck_run("jax", plan, p, resume=True)
    header = read_checkpoint_header(p)
    assert header["meta"]["windows"] == 3 and header["position"] == 11
    assert len(got) == len(full) - 1
    for g, w in zip(got, full[1:]):
        assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)


def test_convert_round_trip_and_checks():
    src, dst, ev = _edges(300, 2, True)
    deg = _oracle(src, dst, ev)
    t = convert.degrees_from_numpy(deg, device="cpu")
    assert t.dtype == torch.int64
    back = convert.degrees_to_numpy(t)
    assert back.dtype == np.int64 and np.array_equal(back, deg)
    deg[0] = 123  # a copy, not a view of the caller's array
    assert int(t[0]) != 123
    with pytest.raises(TypeError, match="deg must be int64"):
        convert.degrees_from_numpy(deg.astype(np.int32), device="cpu")
    with pytest.raises(ValueError, match="1-d"):
        convert.degrees_from_numpy(deg.reshape(8, 8), device="cpu")
    # A gelly_tpu summary continues in the port's fold.
    jagg = jdeg.degree_aggregate(N_V, ingest_combine=False)
    summary = jagg.init()
    fold = jax.jit(jagg.fold)
    for c in _j_stream(src, dst, ev, 64):
        summary = fold(summary, c)
    tagg = tdeg.degree_aggregate(N_V, ingest_combine=False)
    cont = convert.degrees_from_numpy(np.asarray(summary), device="cpu")
    for c in _t_stream(src, dst, ev, 64):
        cont = tagg.fold(cont, c)
    assert np.array_equal(cont.numpy(), 2 * _oracle(src, dst, ev))
