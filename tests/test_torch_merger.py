"""gelly_torch's per-window Merger plan vs gelly_tpu's (CPU).

Mirrors ``tests/test_aggregation.py``'s transient-aggregation and
``edges_fold_adapter`` cases on the port, then holds the Merger plan to
``gelly_tpu`` on the same seeded streams: user-written aggregations with no
``fold_accumulates`` (transient and not, scalar and vector summaries,
``merge_every`` and ``fold_batch`` varied), per-edge user folds,
``host_precombine`` with ``cc_host_precombine`` on the raw CC plan, and
Merger checkpoints written by either package and resumed in the other,
mid-window and at a window boundary. gelly_tpu runs on a one-device mesh.
Tolerance: exact equality, dtype included.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import edge_stream_from_edges as t_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine import aggregation as tagg
from gelly_torch.engine.checkpoint import read_checkpoint_header
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.engine import aggregation as jagg
from gelly_tpu.parallel.mesh import make_mesh

tcc = importlib.import_module("gelly_torch.library.connected_components")
jcc = importlib.import_module("gelly_tpu.library.connected_components")

N_V = 64


def _edges(n_e, seed, n_v=N_V, deletions=False):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.4, n_e) % n_v).astype(np.int64)
    dst = rng.integers(0, n_v, n_e).astype(np.int64)
    ev = np.zeros(n_e, np.int8)
    if deletions:
        ev[rng.random(n_e) < 0.25] = 1
    return src, dst, ev


def _t_stream(src, dst, ev, chunk, n_v=N_V):
    return t_stream(TSource(src, dst, events=ev, chunk_size=chunk,
                            table=TIdentity(n_v)), n_v, device="cpu")


def _j_stream(src, dst, ev, chunk, n_v=N_V):
    return j_stream(JSource(src, dst, events=ev, chunk_size=chunk,
                            table=JIdentity(n_v)), n_v)


# ---------------------------------------------------------------------- #
# User-written aggregations with no fold_accumulates (the Merger plan).


def _t_count(transient):
    return tagg.SummaryAggregation(
        init=lambda device="cpu": torch.zeros((), dtype=torch.int32,
                                              device=device),
        fold=lambda s, c: s + c.num_valid(),
        combine=lambda a, b: a + b, transient=transient)


def _j_count(transient):
    return jagg.SummaryAggregation(
        init=lambda: jnp.zeros((), jnp.int32),
        fold=lambda s, c: s + c.num_valid().astype(jnp.int32),
        combine=lambda a, b: a + b, transient=transient)


def _t_signed_degrees(transient, n_v=N_V):
    """A window's signed degree vector: +1 an endpoint of an addition,
    -1 of a deletion; combine adds."""
    def fold(s, c):
        sign = torch.where(c.event == 1, -1, 1).to(torch.int64)
        sign = torch.where(c.valid, sign, 0)
        s = s.index_add(0, c.src.long(), sign)
        return s.index_add(0, c.dst.long(), sign)

    return tagg.SummaryAggregation(
        init=lambda device="cpu": torch.zeros(n_v, dtype=torch.int64,
                                              device=device),
        fold=fold, combine=lambda a, b: a + b, transient=transient,
        name="signed-degrees")


def _j_signed_degrees(transient, n_v=N_V):
    def fold(s, c):
        sign = jnp.where(c.event == 1, -1, 1).astype(jnp.int64)
        sign = jnp.where(c.valid, sign, 0)
        s = s.at[c.src].add(sign)
        return s.at[c.dst].add(sign)

    return jagg.SummaryAggregation(
        init=lambda: jnp.zeros((n_v,), jnp.int64), fold=fold,
        combine=lambda a, b: a + b, transient=transient,
        name="signed-degrees")


def _cc_stream(chunk_size=2):
    return t_edges([(1, 2, 1.0), (1, 3, 1.0), (2, 3, 1.0), (1, 5, 1.0),
                    (6, 7, 1.0), (8, 9, 1.0)], vertex_capacity=64,
                   chunk_size=chunk_size, device="cpu")


def test_transient_aggregation_resets_per_window():
    counts = [int(x) for x in _cc_stream().aggregate(_t_count(True),
                                                     merge_every=1)]
    assert counts == [2, 2, 2]
    counts = [int(x) for x in _cc_stream().aggregate(_t_count(False),
                                                     merge_every=1)]
    assert counts == [2, 4, 6]


def test_merger_emission_is_not_the_live_state():
    agg = _t_signed_degrees(False)
    src, dst, ev = _edges(300, 3)
    out = list(_t_stream(src, dst, ev, 50).aggregate(agg, merge_every=2))
    # Later windows' combines must not reach an earlier emission.
    assert int(out[0].sum()) == 2 * 100
    assert int(out[-1].sum()) == 2 * 300


@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("merge_every,fold_batch,chunk", [
    (1, 1, 40), (3, 1, 40), (4, 2, 25), (4, 4, 64), (5, 3, 17)])
def test_signed_degree_merger_equals_jax(transient, merge_every,
                                         fold_batch, chunk):
    src, dst, ev = _edges(700, merge_every * 10 + chunk, deletions=True)
    got = list(_t_stream(src, dst, ev, chunk).aggregate(
        _t_signed_degrees(transient), merge_every=merge_every,
        fold_batch=fold_batch))
    want = list(_j_stream(src, dst, ev, chunk).aggregate(
        _j_signed_degrees(transient), mesh=make_mesh(1),
        merge_every=merge_every, fold_batch=fold_batch))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w))
    # The oracle: each window's own counts, or the prefix's.
    bounds = list(range(0, -(-700 // chunk), merge_every)) + [
        -(-700 // chunk)]
    sign = np.where(ev == 1, -1, 1)
    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        e0 = 0 if not transient else lo * chunk
        sl = slice(e0, hi * chunk)
        deg = np.zeros(N_V, np.int64)
        np.add.at(deg, src[sl], sign[sl])
        np.add.at(deg, dst[sl], sign[sl])
        assert np.array_equal(got[i].numpy(), deg)


@pytest.mark.parametrize("transient", [True, False])
def test_count_merger_equals_jax(transient):
    src, dst, ev = _edges(230, 8)
    got = [int(x) for x in _t_stream(src, dst, ev, 20).aggregate(
        _t_count(transient), merge_every=3)]
    want = [int(x) for x in _j_stream(src, dst, ev, 20).aggregate(
        _j_count(transient), mesh=make_mesh(1), merge_every=3)]
    assert got == want


def test_edges_fold_adapter_per_edge_udf():
    def fold_edges(acc, src, dst, val):
        return acc + val

    agg = tagg.SummaryAggregation(
        init=lambda device="cpu": torch.zeros((), dtype=torch.float32),
        fold=tagg.edges_fold_adapter(fold_edges),
        combine=lambda a, b: a + b,
    )
    s = t_edges([(1, 2, 1.5), (2, 3, 2.5), (3, 4, 3.0)], vertex_capacity=16,
                chunk_size=2, device="cpu")
    assert float(s.aggregate(agg).result()) == pytest.approx(7.0)


@pytest.mark.parametrize("with_value", [True, False])
def test_edges_fold_adapter_order_equals_jax(with_value):
    """An order-dependent per-edge fold (a running hash of the edges in
    stream order, and the value) through both packages' adapters."""
    def t_fold(acc, src, dst, *val):
        h = (acc[0] * 31 + src.to(torch.int64) * 7 + dst.to(torch.int64)) \
            % 1000003
        v = acc[1] * 0.5 + (val[0] if val else 1.0)
        return (h, v)

    def j_fold(acc, src, dst, *val):
        h = (acc[0] * 31 + src.astype(jnp.int64) * 7
             + dst.astype(jnp.int64)) % 1000003
        v = acc[1] * 0.5 + (val[0] if val else 1.0)
        return (h, v)

    rng = np.random.default_rng(4)
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(
        rng.integers(0, 30, 57), rng.integers(0, 30, 57),
        rng.integers(1, 9, 57))]
    tagg_ = tagg.SummaryAggregation(
        init=lambda device="cpu": (torch.zeros((), dtype=torch.int64),
                                   torch.zeros((), dtype=torch.float32)),
        fold=tagg.edges_fold_adapter(t_fold, with_value=with_value),
        combine=lambda a, b: a)
    jagg_ = jagg.SummaryAggregation(
        init=lambda: (jnp.zeros((), jnp.int64), jnp.zeros((), jnp.float32)),
        fold=jagg.edges_fold_adapter(j_fold, with_value=with_value),
        combine=lambda a, b: a)
    got = list(t_edges(edges, vertex_capacity=32, chunk_size=8,
                       device="cpu").aggregate(tagg_, merge_every=2))
    want = list(j_edges(edges, vertex_capacity=32, chunk_size=8).aggregate(
        jagg_, mesh=make_mesh(1), merge_every=2))
    assert len(got) == len(want) == 4
    for (gh, gv), (wh, wv) in zip(got, want):
        assert int(gh) == int(wh)
        assert gv.dtype == torch.float32
        assert float(gv) == float(np.asarray(wv))


# ---------------------------------------------------------------------- #
# host_precombine with cc_host_precombine


@pytest.mark.parametrize("seed,n_e,chunk", [(1, 0, 16), (2, 5, 16),
                                            (3, 400, 64), (4, 1000, 100)])
def test_cc_host_precombine_equals_jax(seed, n_e, chunk):
    src, dst, ev = _edges(n_e, seed)
    tchunks = list(_t_stream(src, dst, ev, chunk))
    jchunks = list(_j_stream(src, dst, ev, chunk))
    for tc, jc in zip(tchunks, jchunks):
        got = tcc.cc_host_precombine(tc)
        want = jcc.cc_host_precombine(jc.to_numpy())
        for f in ("src", "dst", "raw_src", "raw_dst", "valid"):
            g = getattr(got, f).numpy()
            w = np.asarray(getattr(want, f))
            assert g.dtype == w.dtype and np.array_equal(g, w), f


def test_cc_host_precombine_needs_room_for_every_vertex():
    # A chunk's forest has a pair per unique vertex: more unique vertices
    # than lanes is an error in both packages.
    src = np.arange(8, dtype=np.int64)
    dst = src + 8
    ev = np.zeros(8, np.int8)
    tc = next(iter(_t_stream(src, dst, ev, 8)))
    jc = next(iter(_j_stream(src, dst, ev, 8)))
    with pytest.raises(ValueError):
        tcc.cc_host_precombine(tc)
    with pytest.raises(ValueError):
        jcc.cc_host_precombine(jc.to_numpy())


@pytest.mark.parametrize("merge_every,fold_batch", [(1, 1), (4, 1), (4, 2)])
def test_raw_cc_with_host_precombine_equals_jax(merge_every, fold_batch):
    src, dst, ev = _edges(900, 9)
    got = list(_t_stream(src, dst, ev, 64).aggregate(
        tcc.connected_components(N_V, ingest_combine=False),
        merge_every=merge_every, fold_batch=fold_batch,
        host_precombine=tcc.cc_host_precombine))
    want = list(_j_stream(src, dst, ev, 64).aggregate(
        jcc.connected_components(N_V, ingest_combine=False),
        mesh=make_mesh(1), merge_every=merge_every, fold_batch=fold_batch,
        host_precombine=jcc.cc_host_precombine))
    plain = list(_t_stream(src, dst, ev, 64).aggregate(
        tcc.connected_components(N_V, ingest_combine=False),
        merge_every=merge_every, fold_batch=fold_batch))
    assert len(got) == len(want) == len(plain)
    for g, w, p in zip(got, want, plain):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, p)


# ---------------------------------------------------------------------- #
# Merger checkpoints across the two packages


def _run(pkg, transient, src, dst, ev, path=None, stop_after=None,
         resume=False, n_chunks=None):
    """Emissions (numpy) of the signed-degree Merger plan over the first
    ``n_chunks`` 40-edge chunks of the stream, in ``pkg``."""
    e = len(src) if n_chunks is None else n_chunks * 40
    kw = dict(merge_every=3)
    if path:
        kw.update(checkpoint_path=path, checkpoint_every=1, resume=resume)
    if pkg == "torch":
        res = _t_stream(src[:e], dst[:e], ev[:e], 40).aggregate(
            _t_signed_degrees(transient), **kw)
    else:
        res = _j_stream(src[:e], dst[:e], ev[:e], 40).aggregate(
            _j_signed_degrees(transient), mesh=make_mesh(1), **kw)
    out = []
    for x in res:
        out.append(np.asarray(x.numpy() if pkg == "torch" else x))
        if len(out) == stop_after:
            break
    return out


@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_merger_resume_across_packages_at_a_boundary(tmp_path, transient,
                                                     writer, reader):
    src, dst, ev = _edges(800, 21, deletions=True)  # 20 chunks, 7 windows
    full = _run(reader, transient, src, dst, ev)
    p = str(tmp_path / "ck.npz")
    _run(writer, transient, src, dst, ev, path=p, stop_after=3)
    head = read_checkpoint_header(p)
    assert head["position"] == 6 and head["meta"]["windows"] == 2
    got = _run(reader, transient, src, dst, ev, path=p, resume=True)
    assert len(got) == len(full) - 2
    for g, w in zip(got, full[2:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("transient", [True, False])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_merger_resume_across_packages_mid_window(tmp_path, transient,
                                                  writer, reader):
    """The writer sees only the first 8 chunks: its last window is a
    partial one (chunks 7-8), checkpointed at position 8; the reader
    resumes the whole stream from there, so its windows run 9-11, ...
    Both packages must agree on every emission of the resumed run."""
    src, dst, ev = _edges(800, 22, deletions=True)
    p = str(tmp_path / "ck.npz")
    q = str(tmp_path / "ck_same.npz")
    _run(writer, transient, src, dst, ev, path=p, n_chunks=8)
    _run(reader, transient, src, dst, ev, path=q, n_chunks=8)
    assert read_checkpoint_header(p)["position"] == 8
    got = _run(reader, transient, src, dst, ev, path=p, resume=True)
    want = _run(reader, transient, src, dst, ev, path=q, resume=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # Not transient: the last emission covers the whole stream.
    if not transient:
        deg = np.zeros(N_V, np.int64)
        sign = np.where(ev == 1, -1, 1)
        np.add.at(deg, src, sign)
        np.add.at(deg, dst, sign)
        assert np.array_equal(got[-1], deg)
