"""gelly_torch's bipartiteness plans vs gelly_tpu's (CPU).

Mirrors ``tests/test_bipartiteness.py`` (the reference's
``BipartitenessCheckTest`` vectors; the mesh case waits for the multi-GPU
merge) and the bipartiteness cases of ``test_codec.py`` and
``test_sparse_codec.py`` on the port, then holds every emission of the
raw, dense and sparse plans to ``gelly_tpu``'s on the same seeded streams
over ``merge_every`` x ``fold_batch`` variants, both sparse-fold branches
included (the stacked payload shapes are compared, so both packages take
the same branch), the native parity codecs to ``gelly_tpu``'s and to both
numpy fallbacks, and checkpoints across the two packages. gelly_tpu runs
on a one-device mesh. Tolerance: exact equality, dtype included.
"""

import jax
import numpy as np
import pytest
import torch

from gelly_torch import convert, edge_stream_from_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine.checkpoint import (
    load_checkpoint,
    read_checkpoint_header,
)
from gelly_torch.library import bipartiteness as tbp
from gelly_torch.ops import parity_unionfind as tpuf
from gelly_torch.utils import native as tnative
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.engine import checkpoint as jck
from gelly_tpu.library import bipartiteness as jbp
from gelly_tpu.parallel.mesh import make_mesh
from gelly_tpu.utils import native as jnative

from _torch_native import load_jax_native

# BipartitenessCheckTest.getBipartiteEdges / getNonBipartiteEdges
BIPARTITE = [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)]
NON_BIPARTITE = [(1, 2), (2, 3), (3, 1), (4, 5), (5, 7), (4, 1)]


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _run_port(edges, merge_every=2, chunk_size=2, **kw):
    s = edge_stream_from_edges(edges, vertex_capacity=16,
                               chunk_size=chunk_size, device="cpu")
    return s.aggregate(tbp.bipartiteness_check(16), merge_every=merge_every,
                       **kw).result(), s.ctx


def _run_jax(edges, merge_every=2, chunk_size=2):
    s = j_edges(edges, vertex_capacity=16, chunk_size=chunk_size)
    return s.aggregate(jbp.bipartiteness_check(16), merge_every=merge_every,
                       mesh=make_mesh(1)).result(), s.ctx


def _same_result(j, t):
    assert isinstance(t, tbp.BipartitenessResult)
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# tests/test_bipartiteness.py on the port


def test_bipartite_graph_golden():
    res, ctx = _run_port(BIPARTITE)
    ok, comps = tbp.to_candidates(res, ctx)
    assert ok is True
    # BipartitenessCheckTest.java:40-44.
    assert comps == {1: {1: True, 2: False, 3: False, 4: False,
                         5: True, 7: True, 9: True}}
    jres, jctx = _run_jax(BIPARTITE)
    _same_result(jres, res)
    assert jbp.to_candidates(jres, jctx) == (ok, comps)


def test_non_bipartite_collapses():
    res, ctx = _run_port(NON_BIPARTITE)
    assert tbp.to_candidates(res, ctx) == (False, {})
    jres, jctx = _run_jax(NON_BIPARTITE)
    _same_result(jres, res)
    assert jbp.to_candidates(jres, jctx) == (False, {})


def test_failure_is_sticky_across_windows():
    edges = [(1, 2), (2, 3), (3, 1)] + [(10 + i, 20 + i) for i in range(6)]
    s = edge_stream_from_edges(edges, vertex_capacity=16, chunk_size=2,
                               device="cpu")
    oks = [bool(r.ok) for r in s.aggregate(tbp.bipartiteness_check(16),
                                           merge_every=1)]
    assert oks == [True, False, False, False, False]


def test_two_disjoint_components_colorings():
    res, ctx = _run_port([(1, 2), (2, 3), (5, 6)])
    ok, comps = tbp.to_candidates(res, ctx)
    assert ok
    assert comps == {1: {1: True, 2: False, 3: True}, 5: {5: True, 6: False}}


def test_result_dtypes_and_device():
    res, _ = _run_port(BIPARTITE)
    assert res.ok.dtype == torch.bool and res.ok.dim() == 0
    assert res.labels.dtype == torch.int32 and res.colors.dtype == torch.int32
    assert res.labels.device.type == "cpu"


def test_unported_query_names_its_item():
    # The fused query builder is ported: it builds gelly_tpu's spec.
    for kw in ({}, {"name": "bp", "compressed": True, "codec": "sparse"}):
        t, j = tbp.bipartiteness_query(16, **kw), jbp.bipartiteness_query(
            16, **kw)
        assert (t.name, t.every, t.slot_capacity, t.accum) == (
            j.name, j.every, j.slot_capacity, j.accum)
        assert t.agg.name == j.agg.name
        assert (t.agg.host_compress is None) == (j.agg.host_compress is None)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpuf.fresh_parity_forest(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbp.bipartiteness_check(8).init()


# ---------------------------------------------------------------------- #
# the native parity codecs against gelly_tpu's and the numpy fallbacks

N_V = 64


def _codec_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "bipartite":
        src = rng.integers(0, N_V // 2, 400).astype(np.int32)
        dst = (rng.integers(0, N_V // 2, 400) + N_V // 2).astype(np.int32)
    elif kind == "random":
        src = rng.integers(0, N_V, 300).astype(np.int32)
        dst = rng.integers(0, N_V, 300).astype(np.int32)
    elif kind == "triangle":
        src, dst = (np.array([0, 1, 2], np.int32),
                    np.array([1, 2, 0], np.int32))
    else:  # empty
        src = dst = np.zeros(0, np.int32)
    return src, dst


def _need_native():
    if not (tnative.parity_combine_available()
            and tnative.parity_sparse_available()
            and jnative.sparse_codecs_available()):
        pytest.skip("native parity codecs unavailable")


@pytest.mark.parametrize("kind", ["bipartite", "random", "triangle", "empty"])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_parity_codec_equals_gelly_tpu(kind, masked):
    _need_native()
    src, dst = _codec_inputs(kind, 5)
    valid = None
    if masked and src.size:
        valid = np.random.default_rng(1).random(src.size) < 0.7
    lab, par, conf = tnative.parity_chunk_combine(src, dst, valid, N_V)
    lab_j, par_j, conf_j = jnative.parity_chunk_combine(src, dst, valid,
                                                        N_V)
    assert lab.dtype == np.int32 and par.dtype == np.uint8
    assert np.array_equal(lab, lab_j) and conf == conf_j
    touched = lab >= 0
    assert np.array_equal(par[touched], par_j[touched])
    for fallback in (tbp.parity_labels_numpy, jbp.parity_labels_numpy):
        lab_n, par_n, conf_n = fallback(src, dst, valid, N_V)
        assert np.array_equal(lab_n, lab) and conf_n == conf
        if not conf:  # the coloring is unique per component
            assert np.array_equal(par_n[touched], par[touched])
    if kind == "triangle" and not masked:
        assert conf


@pytest.mark.parametrize("kind", ["bipartite", "random", "triangle", "empty"])
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_parity_codec_equals_gelly_tpu(kind, masked):
    _need_native()
    src, dst = _codec_inputs(kind, 6)
    valid = None
    if masked and src.size:
        valid = np.random.default_rng(2).random(src.size) < 0.7
    got = tnative.parity_chunk_combine_sparse(src, dst, valid, N_V)
    want = jnative.parity_chunk_combine_sparse(src, dst, valid, N_V)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]
    # The fallbacks' triples come in another order: compare by vertex.
    order = np.argsort(got[0])
    for fallback in (tbp.parity_pairs_numpy, jbp.parity_pairs_numpy):
        v, r, p, conf = fallback(src, dst, valid, N_V)
        assert np.array_equal(v, got[0][order])
        assert np.array_equal(r, got[1][order]) and conf == got[3]
        if not conf:
            assert np.array_equal(p, got[2][order])
    # The sparse triples are the dense codec's touched slots.
    lab, _, conf_d = tnative.parity_chunk_combine(src, dst, valid, N_V)
    assert np.array_equal(np.nonzero(lab >= 0)[0], got[0][order])
    assert np.array_equal(lab[got[0]], got[1]) and conf_d == got[3]


def test_sparse_codec_rejects_bad_slot():
    _need_native()
    bad = np.array([N_V], np.int32), np.array([0], np.int32)
    with pytest.raises(ValueError, match="out of range"):
        tnative.parity_chunk_combine_sparse(*bad, None, N_V)
    with pytest.raises(ValueError, match="out of range"):
        tbp.parity_pairs_numpy(*bad, None, N_V)


# ---------------------------------------------------------------------- #
# every emission of the three plans against gelly_tpu

PLANS = {
    "raw": dict(ingest_combine=False),
    "dense": dict(codec="dense"),
    "sparse": dict(codec="sparse"),
}


def _stream_arrays(kind, n, n_e, seed):
    rng = np.random.default_rng(seed)
    if kind == "bipartite":
        src = rng.integers(0, n // 2, n_e) * 2
        dst = rng.integers(0, n // 2, n_e) * 2 + 1
    else:  # Zipf with odd cycles and self-loops
        src = rng.zipf(1.3, n_e) % n
        dst = rng.zipf(1.3, n_e) % n
    return src.astype(np.int32), dst.astype(np.int32)


def _record_folds(agg):
    """Wrap the plan's compressed fold: the stacked payload shapes of every
    call (gelly_tpu's jitted fold records once per shape, when traced)."""
    shapes = []
    if agg.fold_compressed is None:
        return shapes
    fold = agg.fold_compressed

    def recorded(s, payload):
        shapes.append(tuple(sorted(
            (k, tuple(np.shape(v))) for k, v in payload.items())))
        return fold(s, payload)

    agg.fold_compressed = recorded
    return shapes


def _both(kind, plan, n, n_e, chunk, merge_every, fold_batch, seed=3):
    src, dst = _stream_arrays(kind, n, n_e, seed)
    jagg = jbp.bipartiteness_check(n, **PLANS[plan])
    tagg = tbp.bipartiteness_check(n, **PLANS[plan])
    jshapes, tshapes = _record_folds(jagg), _record_folds(tagg)
    js = j_stream(JSource(src, dst, chunk_size=chunk, table=JIdentity(n)), n)
    want = list(js.aggregate(jagg, merge_every=merge_every,
                             fold_batch=fold_batch, mesh=make_mesh(1)))
    ts = t_stream(TSource(src, dst, chunk_size=chunk, table=TIdentity(n)), n,
                  device="cpu")
    got = list(ts.aggregate(tagg, merge_every=merge_every,
                            fold_batch=fold_batch))
    assert len(got) == len(want) > 0
    for j, t in zip(want, got):
        _same_result(j, t)
    assert set(tshapes) == set(jshapes)
    return got, [dict(s) for s in tshapes]


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("kind", ["bipartite", "zipf"])
@pytest.mark.parametrize("merge_every,fold_batch", [(1, 1), (4, 2), (4, 4),
                                                    (3, 2)])
def test_every_emission_equals_gelly_tpu(plan, kind, merge_every, fold_batch):
    got, _ = _both(kind, plan, 256, 11 * 32 - 20, 32, merge_every,
                   fold_batch)
    if kind == "bipartite":
        assert all(bool(r.ok) for r in got)


@pytest.mark.parametrize("kind", ["bipartite", "zipf"])
@pytest.mark.parametrize("fold_batch", [1, 2])
def test_sparse_fold_takes_the_compact_branch_like_gelly_tpu(kind,
                                                             fold_batch):
    # 4 * (fold_batch * 1024 padded lanes) <= 2^14: the compacted-root
    # union; the recorded stacked shapes are gelly_tpu's.
    n = 1 << 14
    _, shapes = _both(kind, "sparse", n, 900, 128, 2, fold_batch)
    assert all(4 * int(np.prod(s["v"])) <= n for s in shapes)


def test_sparse_fold_takes_the_full_union_branch_like_gelly_tpu():
    _, shapes = _both("zipf", "sparse", 256, 300, 32, 4, 4)
    assert all(4 * int(np.prod(s["v"])) > 256 for s in shapes)


def test_short_unit_pads_with_identity_payloads():
    # 3 chunks, fold_batch 2: the second unit holds one chunk and one
    # identity payload (an empty capacity-1 chunk through the codec).
    for plan in ("dense", "sparse"):
        _, shapes = _both("zipf", plan, 256, 96, 32, 4, 2)
        assert len(shapes) == 2
        assert all(s["conflict"] == (2,) for s in shapes)


# ---------------------------------------------------------------------- #
# test_codec.py / test_sparse_codec.py bipartiteness cases on the port


def _port_result(src, dst, n, chunk, merge_every, fold_batch, **plan):
    s = t_stream(TSource(src.astype(np.int64), dst.astype(np.int64),
                         chunk_size=chunk, table=TIdentity(n)), n,
                 device="cpu")
    return s.aggregate(tbp.bipartiteness_check(n, **plan),
                       merge_every=merge_every,
                       fold_batch=fold_batch).result()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_codec_parity_and_odd_cycle(plan):
    rng = np.random.default_rng(9)
    left = rng.integers(0, N_V // 2, 256)
    right = rng.integers(0, N_V // 2, 256) + N_V // 2
    res = _port_result(left, right, N_V, 32, 4, 4, **PLANS[plan])
    assert bool(res.ok)
    col = res.colors.numpy()
    assert (col[left] ^ col[right]).all()
    src = np.concatenate([left, [1, 2, 3]])
    dst = np.concatenate([right, [2, 3, 1]])
    assert not bool(_port_result(src, dst, N_V, 32, 4, 4,
                                 **PLANS[plan]).ok)


def test_compact_union_branch_end_to_end():
    n = 1 << 16
    rng = np.random.default_rng(51)
    left = rng.integers(0, n // 2, 2000)
    right = rng.integers(0, n // 2, 2000) + n // 2
    res = _port_result(left, right, n, 512, 2, 2, codec="sparse")
    assert bool(res.ok)
    col = res.colors.numpy()
    assert (col[left] ^ col[right]).all()


def test_numpy_fallbacks_give_the_native_emissions(monkeypatch):
    src, dst = _stream_arrays("zipf", 256, 300, 11)
    want = {p: _port_result(src, dst, 256, 32, 4, 2, **PLANS[p])
            for p in ("dense", "sparse")}
    monkeypatch.setattr(tnative, "parity_combine_available", lambda: False)
    monkeypatch.setattr(tnative, "parity_sparse_available", lambda: False)
    for p, w in want.items():
        got = _port_result(src, dst, 256, 32, 4, 2, **PLANS[p])
        assert bool(got.ok) == bool(w.ok)
        assert torch.equal(got.labels, w.labels)


# ---------------------------------------------------------------------- #
# checkpoints across the two packages

CK_N, CK_CHUNK, CK_EDGES = 256, 32, 11 * 32 - 20


def _ck_run(pkg, plan, kind, path=None, stop_after=None, **kw):
    src, dst = _stream_arrays(kind, CK_N, CK_EDGES, 5)
    if pkg == "torch":
        s = t_stream(TSource(src, dst, chunk_size=CK_CHUNK,
                             table=TIdentity(CK_N)), CK_N, device="cpu")
        it = iter(s.aggregate(tbp.bipartiteness_check(CK_N, **PLANS[plan]),
                              merge_every=4, fold_batch=2,
                              checkpoint_path=path, **kw))
        conv = lambda r: tuple(x.numpy() for x in r)  # noqa: E731
    else:
        s = j_stream(JSource(src, dst, chunk_size=CK_CHUNK,
                             table=JIdentity(CK_N)), CK_N)
        it = iter(s.aggregate(jbp.bipartiteness_check(CK_N, **PLANS[plan]),
                              merge_every=4, fold_batch=2, mesh=make_mesh(1),
                              checkpoint_path=path, **kw))
        conv = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
    out = []
    for r in it:
        out.append(conv(r))
        if len(out) == stop_after:
            break
    if hasattr(it, "close"):
        it.close()
    return out


_FULL: dict = {}


def _ck_full(pkg, plan, kind):
    if (pkg, plan, kind) not in _FULL:
        _FULL[pkg, plan, kind] = _ck_run(pkg, plan, kind)
    return _FULL[pkg, plan, kind]


def _same_runs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("kind", ["bipartite", "zipf"])
@pytest.mark.parametrize("writer", ["gelly_tpu", "gelly_torch"])
def test_resume_across_packages_equals_uninterrupted(tmp_path, plan, kind,
                                                     writer):
    p = str(tmp_path / "ck.npz")
    full_t = _ck_full("torch", plan, kind)
    full_j = _ck_full("jax", plan, kind)
    _same_runs(full_t, full_j)
    if writer == "gelly_tpu":
        _ck_run("jax", plan, kind, p, stop_after=2)
        got = _ck_run("torch", plan, kind, p, resume=True)
    else:
        _ck_run("torch", plan, kind, p, stop_after=2)
        got = _ck_run("jax", plan, kind, p, resume=True)
    header = read_checkpoint_header(p)
    assert header["meta"]["windows"] == 3 and header["position"] == 11
    _same_runs(got, full_t[1:])


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_checkpoint_file_equals_gelly_tpu(tmp_path, plan):
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    _ck_run("torch", plan, "zipf", pt, stop_after=2)
    _ck_run("jax", plan, "zipf", pj, stop_after=2)
    ht, hj = read_checkpoint_header(pt), read_checkpoint_header(pj)
    assert (ht["position"], ht["meta"], ht["crc32"]) == (
        hj["position"], hj["meta"], hj["crc32"])
    lt, _, _ = load_checkpoint(pt)
    lj, _, _ = jck.load_checkpoint(pj)
    for a, b in zip(jax.tree.leaves(lj), jax.tree.leaves(lt)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_convert_round_trip_and_checks():
    src, dst = _stream_arrays("zipf", CK_N, CK_EDGES, 5)
    s = j_stream(JSource(src, dst, chunk_size=CK_CHUNK,
                         table=JIdentity(CK_N)), CK_N)
    agg = jbp.bipartiteness_check(CK_N)
    summary = agg.init()
    fold = jax.jit(agg.fold)
    for c in s:
        summary = fold(summary, c)
    leaves = [np.asarray(x) for x in jax.tree.leaves(summary)]
    got = convert.bipartite_summary_from_numpy(*leaves, device="cpu")
    assert isinstance(got, tbp.BipartiteSummary)
    back = convert.bipartite_summary_to_numpy(got)
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    forest = convert.parity_forest_from_numpy(*leaves[:3], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        leaves[:3], convert.parity_forest_to_numpy(forest)))
    with pytest.raises(TypeError, match="rel must be int32"):
        convert.parity_forest_from_numpy(leaves[0], leaves[1].astype(np.int64),
                                         leaves[2], device="cpu")
    with pytest.raises(ValueError, match="0-d"):
        convert.parity_forest_from_numpy(leaves[0], leaves[1],
                                         np.zeros(2, bool), device="cpu")
    with pytest.raises(ValueError, match="seen"):
        convert.bipartite_summary_from_numpy(*leaves[:3], leaves[3][:5],
                                             device="cpu")
    # The converted summary continues the stream like gelly_tpu's.
    tagg = tbp.bipartiteness_check(CK_N)
    extra = np.array([0, 2], np.int32), np.array([2, 4], np.int32)
    ts = t_stream(TSource(*extra, chunk_size=2, table=TIdentity(CK_N)), CK_N,
                  device="cpu")
    js = j_stream(JSource(*extra, chunk_size=2, table=JIdentity(CK_N)), CK_N)
    t_next = tagg.fold(got, next(iter(ts)))
    j_next = fold(summary, next(iter(js)))
    _same_result(agg.transform(j_next), tagg.transform(t_next))
