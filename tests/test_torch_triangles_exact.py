"""gelly_torch's exact streaming triangle counts (dense and capped-degree)
vs gelly_tpu (CPU).

Same numpy inputs, made from a seed, go through both packages' chunk steps
and streams; the port runs with ``device="cpu"``. Tolerance: exact
equality of every state field (``adj``, ``nbr``/``aidx`` layouts
included), every ``final_counts`` map, ``stats`` and error message.
"""

import jax
import numpy as np
import pytest

import gelly_tpu.library.triangles as jtri
from gelly_torch import convert
from gelly_torch.core.chunk import make_chunk as t_chunk
from gelly_torch.core.stream import edge_stream_from_edges as t_edges
from gelly_torch.library import exact_triangle_count as t_exact
from gelly_torch.library import triangles as ttri
from gelly_tpu.core.chunk import make_chunk as j_chunk
from gelly_tpu.core.stream import edge_stream_from_edges as j_edges
from gelly_tpu.library import exact_triangle_count as j_exact

# JAX's sparse step is jitted on (max_degree, slab); the dense one too.
_j_sparse_step = jtri._sparse_exact_step


def _edges(n_v, n_e, seed, loops=True):
    """Random edges with duplicates, reversed duplicates and self-loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n_e).astype(np.int32)
    dst = rng.integers(0, n_v, n_e).astype(np.int32)
    dup = rng.random(n_e) < 0.1
    src[1:][dup[1:]] = dst[:-1][dup[1:]]  # reversed repeats of the
    dst[1:][dup[1:]] = src[:-1][dup[1:]]  # previous edge
    if loops:
        src[::17] = dst[::17]
    return src, dst


def _chunks(src, dst, size, cap=None):
    """The same padded chunks in both packages."""
    cap = cap or size
    for lo in range(0, src.shape[0], size):
        s, d = src[lo:lo + size], dst[lo:lo + size]
        yield (j_chunk(s, d, capacity=cap),
               t_chunk(s, d, capacity=cap, device="cpu"))


def _assert_state_equal(tstate, jstate):
    assert tstate._fields == jstate._fields
    for name, a, b in zip(tstate._fields, tstate, jstate):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert np.array_equal(a.numpy(), b), name


# --------------------------------------------------------------------- #
# dense


@pytest.mark.parametrize("n_v,size,cap,seed", [
    (24, 64, 64, 8), (40, 50, 64, 1), (16, 7, 7, 2), (64, 256, 300, 3)])
def test_dense_state_after_every_chunk_equals_jax(n_v, size, cap, seed):
    src, dst = _edges(n_v, 600, seed)
    jstate = jtri.fresh_triangle_counts(n_v)
    tstate = ttri.fresh_triangle_counts(n_v, device="cpu")
    _assert_state_equal(tstate, jstate)
    for jc, tc in _chunks(src, dst, size, cap):
        jstate = jtri._exact_step(jstate, jc)
        tstate = ttri._exact_step(tstate, tc)
        _assert_state_equal(tstate, jstate)
    assert int(tstate.total) > 0


@pytest.mark.parametrize("seed", [8, 9])
def test_exact_step_equals_scan_oracle(seed):
    # The slab step against the literal per-edge scan, in the port and
    # against JAX's scan.
    src, dst = _edges(24, 300, seed)
    a = ttri.fresh_triangle_counts(24, device="cpu")
    b = ttri.fresh_triangle_counts(24, device="cpu")
    j = jtri.fresh_triangle_counts(24)
    for jc, tc in _chunks(src, dst, 64):
        a = ttri._exact_step(a, tc)
        b = ttri._exact_step_scan(b, tc)
        j = jtri._exact_step_scan(j, jc)
        _assert_state_equal(a, j)
        _assert_state_equal(b, j)


def test_exact_step_leaves_its_input_unchanged():
    src, dst = _edges(16, 64, 4)
    (_, tc), = list(_chunks(src, dst, 64))
    s0 = ttri.fresh_triangle_counts(16, device="cpu")
    s1 = ttri._exact_step(s0, tc)
    assert int(s0.n_seen) == 0 and bool((s0.adj == ttri.INT_MAX).all())
    assert int(s1.n_seen) > 0


def _stream_pair(src, dst, n_v, chunk_size):
    edges = list(zip(src.tolist(), dst.tolist()))
    return (j_edges(edges, vertex_capacity=n_v, chunk_size=chunk_size),
            t_edges(edges, vertex_capacity=n_v, chunk_size=chunk_size,
                    device="cpu"))


@pytest.mark.parametrize("budget,rebases", [(None, 0), (200, 3), (300, 2)])
def test_dense_stream_rebases_and_counts_equal_jax(budget, rebases):
    src, dst = _edges(32, 500, 11)
    j, t = _stream_pair(src, dst, 32, 64)
    kw = {} if budget is None else {"arrival_budget": budget}
    js, ts = j_exact(j, **kw), t_exact(t, **kw)
    for jstate, tstate in zip(js, ts):
        _assert_state_equal(tstate, jstate)
    assert ts.stats == js.stats == {"rebases": rebases}
    assert t_exact(_stream_pair(src, dst, 32, 64)[1], **kw).final_counts() \
        == j_exact(_stream_pair(src, dst, 32, 64)[0], **kw).final_counts()


def test_rebase_is_lossless():
    src, dst = _edges(32, 500, 12)
    counts = [t_exact(_stream_pair(src, dst, 32, 64)[1], **kw).final_counts()
              for kw in ({}, {"arrival_budget": 130})]
    assert counts[0] == counts[1] and counts[0][-1] > 0


def test_final_counts_decode_raw_ids_and_empty_stream():
    edges = [(100, 200), (200, 300), (300, 100), (300, 400), (400, 100)]
    j = j_edges(edges, vertex_capacity=16, chunk_size=2)
    t = t_edges(edges, vertex_capacity=16, chunk_size=2, device="cpu")
    want = j_exact(j).final_counts()
    assert t_exact(t).final_counts() == want
    assert want[-1] == 2
    empty = t_exact(t_edges([], vertex_capacity=8, device="cpu"))
    assert empty.final_counts() == {-1: 0}
    assert empty.final().adj.shape == (8, 8)


def test_narrowed_capacity_raises_like_jax():
    edges = [(0, 1), (1, 2), (2, 0)] + [(i, i + 1) for i in range(3, 12)]
    msgs = []
    for fn, mk in ((j_exact, j_edges), (t_exact, t_edges)):
        kw = {} if mk is j_edges else {"device": "cpu"}
        with pytest.raises(ValueError) as e:
            fn(mk(edges, vertex_capacity=16, chunk_size=4, **kw),
               capacity=8).final()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "exceeds triangle capacity 8" in msgs[0]


@pytest.mark.parametrize("split", [1, 3])
def test_dense_resume_from_jax_state(split):
    src, dst = _edges(24, 400, 13)
    pairs = list(_chunks(src, dst, 64))
    jstate = jtri.fresh_triangle_counts(24)
    for jc, _ in pairs[:split]:
        jstate = jtri._exact_step(jstate, jc)
    tstate = convert.triangle_counts_from_numpy(
        *(np.asarray(x) for x in jstate), device="cpu")
    back = convert.triangle_counts_to_numpy(tstate)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jstate))
    for jc, tc in pairs[split:]:
        jstate = jtri._exact_step(jstate, jc)
        tstate = ttri._exact_step(tstate, tc)
    _assert_state_equal(tstate, jstate)


# --------------------------------------------------------------------- #
# sparse (capped-degree)


@pytest.mark.parametrize("n_v,max_degree,size,seed", [
    (64, 64, 64, 9), (48, 16, 50, 1), (30, 32, 7, 2), (200, 8, 128, 3)])
def test_sparse_state_after_every_chunk_equals_jax(n_v, max_degree, size,
                                                   seed):
    src, dst = _edges(n_v, 500, seed)
    slab = max(8, (1 << 22) // max_degree ** 2)
    jstate = jtri.fresh_sparse_triangle_counts(n_v, max_degree)
    tstate = ttri.fresh_sparse_triangle_counts(n_v, max_degree, device="cpu")
    _assert_state_equal(tstate, jstate)
    for jc, tc in _chunks(src, dst, size):
        jstate = _j_sparse_step(jstate, jc, max_degree, slab)
        tstate = ttri._sparse_exact_step(tstate, tc, max_degree, slab)
        _assert_state_equal(tstate, jstate)
    assert int(tstate.total) > 0


@pytest.mark.parametrize("slab", [8, 24])
def test_sparse_step_small_slabs_equal_jax(slab):
    src, dst = _edges(40, 300, 5)
    jstate = jtri.fresh_sparse_triangle_counts(40, 16)
    tstate = ttri.fresh_sparse_triangle_counts(40, 16, device="cpu")
    for jc, tc in _chunks(src, dst, 48):
        jstate = _j_sparse_step(jstate, jc, 16, slab)
        tstate = ttri._sparse_exact_step(tstate, tc, 16, slab)
        _assert_state_equal(tstate, jstate)


def test_sparse_overflow_counts_dropped_inserts_like_jax():
    # A hub of degree 20 under max_degree 4: the overflow field and the
    # rows (fill = deg) equal JAX's.
    src = np.zeros(20, np.int32)
    dst = np.arange(1, 21, dtype=np.int32)
    jstate = jtri.fresh_sparse_triangle_counts(32, 4)
    tstate = ttri.fresh_sparse_triangle_counts(32, 4, device="cpu")
    for jc, tc in _chunks(src, dst, 8):
        jstate = _j_sparse_step(jstate, jc, 4, 8)
        tstate = ttri._sparse_exact_step(tstate, tc, 4, 8)
        _assert_state_equal(tstate, jstate)
    assert int(tstate.overflow) == 16


@pytest.mark.parametrize("budget,rebases", [(None, 0), (200, 3)])
def test_sparse_stream_equals_jax_and_dense(budget, rebases):
    src, dst = _edges(48, 500, 14)
    j, t = _stream_pair(src, dst, 48, 64)
    kw = {} if budget is None else {"arrival_budget": budget}
    js = j_exact(j, max_degree=48, **kw)
    ts = t_exact(t, max_degree=48, **kw)
    for jstate, tstate in zip(js, ts):
        _assert_state_equal(tstate, jstate)
    assert ts.stats == js.stats == {"rebases": rebases}
    sparse = t_exact(_stream_pair(src, dst, 48, 64)[1], max_degree=48,
                     **kw).final_counts()
    dense = t_exact(_stream_pair(src, dst, 48, 64)[1]).final_counts()
    assert sparse == dense


def _hub_edges():
    rng = np.random.default_rng(15)
    src = rng.integers(0, 64, 300).astype(np.int32)
    dst = rng.integers(0, 64, 300).astype(np.int32)
    src[100:130] = 7  # degree >= 30 in the third 64-edge chunk
    dst[100:130] = np.arange(30, 60)
    return src, dst


def _drain(it):
    out = []
    try:
        for x in it:
            out.append(x)
    except ValueError as e:
        return out, str(e)
    return out, None


def test_sparse_overflow_raises_deferred_like_jax():
    src, dst = _hub_edges()
    j, t = _stream_pair(src, dst, 64, 64)
    jout, jerr = _drain(j_exact(j, max_degree=8))
    tout, terr = _drain(t_exact(t, max_degree=8))
    assert jerr is not None and "exceeded max_degree 8" in jerr
    assert terr == jerr
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        _assert_state_equal(a, b)
    assert int(tout[-1].overflow) > 0  # the one corrupt state, gated
    with pytest.raises(ValueError, match="exceeded max_degree 8"):
        t_exact(_stream_pair(src, dst, 64, 64)[1], max_degree=8).final()


@pytest.mark.parametrize("split", [2, 4])
def test_sparse_resume_from_jax_state(split):
    src, dst = _edges(40, 400, 16)
    pairs = list(_chunks(src, dst, 64))
    jstate = jtri.fresh_sparse_triangle_counts(40, 16)
    for jc, _ in pairs[:split]:
        jstate = _j_sparse_step(jstate, jc, 16, 8)
    tstate = convert.sparse_triangle_counts_from_numpy(
        *(np.asarray(x) for x in jstate), device="cpu")
    back = convert.sparse_triangle_counts_to_numpy(tstate)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jstate))
    for jc, tc in pairs[split:]:
        jstate = _j_sparse_step(jstate, jc, 16, 8)
        tstate = ttri._sparse_exact_step(tstate, tc, 16, 8)
    _assert_state_equal(tstate, jstate)


def test_rebased_states_equal_jax():
    src, dst = _edges(24, 200, 17)
    jd = jtri.fresh_triangle_counts(24)
    td = ttri.fresh_triangle_counts(24, device="cpu")
    js = jtri.fresh_sparse_triangle_counts(24, 24)
    ts = ttri.fresh_sparse_triangle_counts(24, 24, device="cpu")
    for jc, tc in _chunks(src, dst, 64):
        jd, td = jtri._exact_step(jd, jc), ttri._exact_step(td, tc)
        js = _j_sparse_step(js, jc, 24, 8)
        ts = ttri._sparse_exact_step(ts, tc, 24, 8)
    _assert_state_equal(ttri._rebase_dense(td), jax.jit(
        jtri._rebase_dense)(jd))
    _assert_state_equal(ttri._rebase_sparse(ts), jtri._rebase_sparse(js))
