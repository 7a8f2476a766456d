"""gelly_torch's capped-degree, degree-bucketed and unpacked dense window
triangle paths vs gelly_tpu (CPU).

Same numpy inputs, made from a seed, go through both packages; the JAX
side runs as ``tests/test_triangles.py`` runs it (its Pallas wedge kernel
in interpret mode for ``method="mxu_interpret"``), the port with
``device="cpu"``. Tolerance: exact equality of every count, overflow,
payload array, dtype and error message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_tpu.library.triangles as jtri
import gelly_tpu.ops.segments as jseg
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.io import TimeCharacteristic as TTime
from gelly_torch.core.stream import edge_stream_from_edges as t_edges
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import triangles as ttri
from gelly_torch.ops import segments as tseg
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.io import TimeCharacteristic as JTime
from gelly_tpu.core.stream import edge_stream_from_edges as j_edges
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity

TRIANGLES_DATA = [
    (1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
    (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
    (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
    (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000),
]
GOLDEN = {0: 2, 1: 3, 2: 2}  # WindowTrianglesITCase, window 400 ms


def _tri_streams(chunk_size=4, capacity=32):
    rows = [(s, d, float(t)) for s, d, t in TRIANGLES_DATA]
    kw = dict(vertex_capacity=capacity, chunk_size=chunk_size,
              ts_fn=lambda s, d, v: v.astype(np.int64))
    return (j_edges(rows, time=JTime.EVENT, **kw),
            t_edges(rows, time=TTime.EVENT, device="cpu", **kw))


def _zipf(n, n_edges, seed, a=1.3):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(a, n_edges) % n).astype(np.int32)
    dst = (rng.zipf(a, n_edges) % n).astype(np.int32)
    return src, dst


def _streams(src, dst, n, chunk_size):
    ts = np.arange(src.shape[0], dtype=np.int64)
    j = j_stream(JSource(src, dst, timestamps=ts, chunk_size=chunk_size,
                         table=JIdentity(n), time=JTime.EVENT), n)
    t = t_stream(TSource(src, dst, timestamps=ts, chunk_size=chunk_size,
                         table=TIdentity(n), time=TTime.EVENT), n,
                 device="cpu")
    return j, t


def _hub_streams(n=1024, per_window=400, windows=4, hub_window=2, hub_deg=12,
                 seed=5):
    """A sparse random stream whose window ``hub_window`` gains one vertex
    of degree ``hub_deg`` (its neighbours close triangles among
    themselves too)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, windows * per_window).astype(np.int32)
    dst = rng.integers(0, n, windows * per_window).astype(np.int32)
    lo = hub_window * per_window
    hub = rng.choice(n, hub_deg + 1, replace=False).astype(np.int32)
    src[lo:lo + hub_deg] = hub[0]
    dst[lo:lo + hub_deg] = hub[1:]
    dst[lo + hub_deg:lo + 2 * hub_deg - 1] = hub[2:]
    src[lo + hub_deg:lo + 2 * hub_deg - 1] = hub[1:-1]
    return _streams(src, dst, n, 128)


# --------------------------------------------------------------------- #
# unique_pairs_mask


@pytest.mark.parametrize("n_lanes,n_slots,seed", [
    (1, 4, 0), (64, 8, 1), (500, 30, 2), (2048, 1 << 20, 3), (300, 5, 4)])
def test_unique_pairs_mask_equals_jax(n_lanes, n_slots, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_slots, n_lanes).astype(np.int32)
    dst = rng.integers(0, n_slots, n_lanes).astype(np.int32)
    valid = rng.random(n_lanes) < 0.7
    want = np.asarray(jseg.unique_pairs_mask(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), n_slots))
    got = tseg.unique_pairs_mask(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(valid), n_slots)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------- #
# the capped-degree sparse count


@pytest.mark.parametrize("max_degree,seed", [
    (4, 0), (8, 1), (16, 2), (32, 3), (64, 4)])
def test_sparse_window_count_and_overflow_equal_jax(max_degree, seed):
    rng = np.random.default_rng(seed)
    n, lanes = 64, 700
    key = rng.integers(0, n, lanes).astype(np.int32)
    nbr = rng.integers(0, n, lanes).astype(np.int32)
    valid = rng.random(lanes) < 0.8
    jc, jo = jtri._window_triangle_count_sparse(
        jnp.asarray(key), jnp.asarray(nbr), jnp.asarray(valid), n,
        max_degree)
    tc, to = ttri._window_triangle_count_sparse(
        torch.from_numpy(key), torch.from_numpy(nbr),
        torch.from_numpy(valid), n, max_degree)
    assert tc.dtype == torch.int64 and to.dtype == torch.int32
    assert np.asarray(jc).dtype == np.int64
    assert (int(tc), int(to)) == (int(jc), int(jo))
    assert int(jc) > 0
    if max_degree <= 8:
        assert int(jo) > 0


@pytest.mark.parametrize("slab", [8, 64, 1000])
def test_sparse_window_count_slab_does_not_change_it(slab):
    rng = np.random.default_rng(9)
    key = rng.integers(0, 40, 500).astype(np.int32)
    nbr = rng.integers(0, 40, 500).astype(np.int32)
    valid = np.ones(500, bool)
    want = jtri._window_triangle_count_sparse(
        jnp.asarray(key), jnp.asarray(nbr), jnp.asarray(valid), 40, 64)
    got = ttri._window_triangle_count_sparse(
        torch.from_numpy(key), torch.from_numpy(nbr),
        torch.from_numpy(valid), 40, 64, slab=slab)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 8])
def test_batched_sparse_counts_equal_jax(batch):
    rng = np.random.default_rng(21)
    src = rng.integers(0, 256, 5 * 1500).astype(np.int32)
    dst = rng.integers(0, 256, 5 * 1500).astype(np.int32)
    j, t = _streams(src, dst, 256, 256)
    kw = dict(window_capacity=4096, batch=batch, max_degree=32)
    jw, jc = zip(*jtri.window_triangle_counts_batched(j, 1500, **kw))
    tw, tc = zip(*ttri.window_triangle_counts_batched(t, 1500, **kw))
    assert jw == tw == tuple(range(5))
    got = torch.stack(tc)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(jnp.stack(jc)))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("chunk_size", [1, 3, 19])
def test_window_triangles_max_degree_golden(chunk_size):
    j, t = _tri_streams(chunk_size)
    want = dict(jtri.window_triangles(j, 400, max_degree=8))
    assert want == GOLDEN
    assert dict(ttri.window_triangles(t, 400, max_degree=8)) == want


def _drain(it):
    """Items yielded before the iterator ended, and the error it raised."""
    out = []
    try:
        for x in it:
            out.append(x)
    except ValueError as e:
        return out, str(e)
    return out, None


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_overflow_default_raises_deferred_like_jax(batch):
    j, t = _hub_streams()
    kw = dict(window_capacity=1024, batch=batch, max_degree=8)
    jout, jerr = _drain(jtri.window_triangle_counts_batched(j, 400, **kw))
    tout, terr = _drain(ttri.window_triangle_counts_batched(t, 400, **kw))
    assert jerr is not None and "max_degree=8" in jerr
    assert terr == jerr
    assert [w for w, _ in tout] == [w for w, _ in jout]
    assert [int(c) for _, c in tout] == [int(c) for _, c in jout]


@pytest.mark.parametrize("batch", [1, 4])
def test_overflow_triples_flag_exactly_the_hub_window(batch):
    j, t = _hub_streams()
    kw = dict(window_capacity=1024, batch=batch, max_degree=8,
              yield_overflow=True)
    jout, jerr = _drain(jtri.window_triangle_counts_batched(j, 400, **kw))
    tout, terr = _drain(ttri.window_triangle_counts_batched(t, 400, **kw))
    assert terr == jerr and jerr is not None
    want = [(w, int(c), int(o)) for w, c, o in jout]
    got = [(w, int(c), int(o)) for w, c, o in tout]
    assert got == want
    assert [w for w, _, o in got if o] == [2]
    assert all(o.dtype == torch.int32 for _, _, o in tout)


def test_overflow_window_triangles_raises_like_jax():
    j, t = _hub_streams()
    jout, jerr = _drain(jtri.window_triangles(j, 400, window_capacity=1024,
                                              max_degree=8))
    tout, terr = _drain(ttri.window_triangles(t, 400, window_capacity=1024,
                                              max_degree=8))
    assert terr == jerr and jerr is not None
    assert tout == jout


# --------------------------------------------------------------------- #
# the degree-bucketed path


def _window_columns(seed, n=512, lanes=3000, a=1.3):
    src, dst = _zipf(n, lanes, seed, a)
    valid = np.random.default_rng(seed + 100).random(lanes) < 0.9
    return src, dst, valid, n


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_degree", [None, 4096])
def test_bucketize_window_equals_jax_key_by_key(seed, max_degree):
    bk, bn, bo, n = _window_columns(seed)
    want = jtri._bucketize_window(bk, bn, bo, n, max_degree)
    got = ttri._bucketize_window(bk, bn, bo, n, max_degree)
    _assert_tree_equal(got, want)
    assert got["n_hot"] > 0  # a Zipf hub: the bitmap paths run


@pytest.mark.parametrize("case", ["empty", "self_loops", "one_edge"])
def test_bucketize_window_degenerate_equals_jax(case):
    bk = np.array([3, 4, 5, 6], np.int32)
    bn = {"empty": bk, "self_loops": bk,
          "one_edge": np.array([3, 2, 5, 6], np.int32)}[case]
    bo = np.array([case != "empty"] * 4)
    want = jtri._bucketize_window(bk, bn, bo, 8, None)
    got = ttri._bucketize_window(bk, bn, bo, 8, None)
    _assert_tree_equal(got, want)
    _assert_tree_equal(ttri._stack_bucketed([got]),
                       jtri._stack_bucketed([want]))


def test_stack_bucketed_equals_jax_key_by_key():
    payloads = [_window_columns(s) for s in (3, 4, 5)]
    want = jtri._stack_bucketed(
        [jtri._bucketize_window(*p, None) for p in payloads])
    got = ttri._stack_bucketed(
        [ttri._bucketize_window(*p, None) for p in payloads])
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("seeds,a", [((6,), 1.3), ((7, 8, 9), 1.3),
                                     ((10, 11), 2.0), ((12,), 1.1)])
def test_bucketed_group_counts_equal_jax(seeds, a):
    payloads = [jtri._bucketize_window(*_window_columns(s, a=a), None)
                for s in seeds]
    payload, t_cap, d, h_cap, ladder = jtri._stack_bucketed(payloads)
    want = np.asarray(jtri._window_triangle_count_bucketed_group(
        payload, t_cap, d, h_cap, ladder))
    tp = ttri._tree_map(torch.from_numpy, payload)
    got = ttri._window_triangle_count_bucketed_group(tp, t_cap, d, h_cap,
                                                     ladder)
    assert got.dtype == torch.int64 and want.dtype == np.int64
    assert np.array_equal(got.numpy(), want) and want.sum() > 0
    if a < 2:  # hot-hot and hot-sparse edges are present
        assert sum(p["hh"][0].shape[0] for p in payloads) > 0
        assert sum(p["hs"][0].shape[0] for p in payloads) > 0


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_window_triangles_bucketed_equals_jax(batch):
    src, dst = _zipf(1024, 6 * 2000, 31, 1.6)
    j, t = _streams(src, dst, 1024, 512)
    kw = dict(window_capacity=8192, batch=batch)
    jw, jc = zip(*jtri.window_triangles_bucketed(j, 2000, **kw))
    tw, tc = zip(*ttri.window_triangles_bucketed(t, 2000, **kw))
    assert jw == tw == tuple(range(6))
    assert [int(c) for c in tc] == [int(c) for c in jc]
    assert all(c.dtype == torch.int64 for c in tc)
    # and equal to the dense packed path
    _, dense = _streams(src, dst, 1024, 512)
    assert [int(c) for c in tc] == [c for _, c in ttri.window_triangles(
        dense, 2000, window_capacity=8192)]


def test_bucketed_golden_and_cap_raises_before_yield():
    j, t = _tri_streams()
    assert dict((w, int(c)) for w, c in ttri.window_triangles_bucketed(
        t, 400)) == GOLDEN
    j, t = _hub_streams()
    jout, jerr = _drain(jtri.window_triangles_bucketed(
        j, 400, window_capacity=1024, max_degree=8, batch=1))
    tout, terr = _drain(ttri.window_triangles_bucketed(
        t, 400, window_capacity=1024, max_degree=8, batch=1))
    assert jerr is not None and "exceeds max_degree=8" in jerr
    assert terr == jerr
    # batch=1: windows 0 and 1 come out, the hub window raises first
    assert [w for w, _ in tout] == [w for w, _ in jout] == [0, 1]
    assert [int(c) for _, c in tout] == [int(c) for _, c in jout]


# --------------------------------------------------------------------- #
# the unpacked dense path


def _views(src, dst, n, window_ms, capacity):
    j, t = _streams(src, dst, n, 256)
    jv = list(j.slice(window_ms, "all", window_capacity=capacity).views())
    tv = list(t.slice(window_ms, "all", window_capacity=capacity).views())
    assert [w for w, _ in jv] == [w for w, _ in tv]
    return jv, tv


@pytest.mark.parametrize("n,method", [(128, "gather"), (200, "gather"),
                                      (128, "mxu_interpret"),
                                      (256, "mxu_interpret")])
def test_unpacked_dense_count_equals_jax(n, method):
    src, dst = _zipf(n, 3 * 1200, n)
    jv, tv = _views(src, dst, n, 1200, 4096)
    for (_, jview), (_, tview) in zip(jv, tv):
        want = jtri._window_triangle_count(jview, n, method)
        got = ttri._window_triangle_count(tview, n, method)
        assert got.dtype == torch.int64
        assert int(got) == int(want)
    assert int(want) > 0


def test_unpacked_dense_gather_equals_mxu():
    src, dst = _zipf(256, 2 * 1500, 8)
    _, tv = _views(src, dst, 256, 1500, 4096)
    for _, view in tv:
        assert int(ttri._window_triangle_count(view, 256, "gather")) == int(
            ttri._window_triangle_count(view, 256, "mxu_interpret"))


@pytest.mark.parametrize("entry", ["batched", "device", "window_triangles"])
def test_route_past_2_31_takes_the_unpacked_path(monkeypatch, entry):
    # capacity^2 >= 2^31: both packages take the unpacked per-window
    # count; a spy counts it on the tiny stream's slots (a real
    # bool[2^16, 2^16] adjacency is 4 GiB).
    big = 1 << 16
    calls = {"j": [], "t": []}

    def spy(mod, key):
        real = mod._window_triangle_count

        def fake(view, capacity, method="gather"):
            calls[key].append((capacity, method))
            return real(view, 32, method)

        monkeypatch.setattr(mod, "_window_triangle_count", fake)

    spy(jtri, "j")
    spy(ttri, "t")
    j, t = _tri_streams()
    fn = {"batched": "window_triangle_counts_batched",
          "device": "window_triangle_counts_device",
          "window_triangles": "window_triangles"}[entry]
    want = {w: int(c) for w, c in getattr(jtri, fn)(j, 400, capacity=big)}
    got = {w: int(c) for w, c in getattr(ttri, fn)(t, 400, capacity=big)}
    assert got == want == GOLDEN
    assert calls["t"] == calls["j"] == [(big, "gather")] * 3


def test_pick_method_takes_the_kernel_on_a_card_at_2_16():
    pick = ttri._pick_method("auto", 1 << 16)
    assert pick(1 << 23, torch.device("cuda")) == "mxu"
    assert pick(1 << 23, torch.device("cpu")) == "gather"
