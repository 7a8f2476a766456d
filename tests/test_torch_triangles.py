"""The gelly_torch window-triangle slice vs gelly_tpu (CPU).

Same numpy inputs, made from a seed, go through both packages. The JAX side
runs its Pallas ``wedge_count_matrix`` in interpret mode, as the JAX
package's own tests do on the CPU; the port runs with ``device="cpu"``,
where the wedge wrapper takes its plain version. Tolerance: exact equality
of every count, ``W`` value, window buffer and dtype (integer counts, and
f32 ``W`` entries that are small integers).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_tpu.core.windows as jwindows
import gelly_tpu.library.triangles as jtri
from gelly_torch.core import windows as twindows
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.io import TimeCharacteristic as TTime
from gelly_torch.core.stream import edge_stream_from_edges as t_edges
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import triangles as ttri
from gelly_torch.library import window_triangles as t_window_triangles
from gelly_torch.ops import kernels as tk
from gelly_torch.utils.prefetch import prefetch_map
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.io import TimeCharacteristic as JTime
from gelly_tpu.core.stream import edge_stream_from_edges as j_edges
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.ops import pallas_kernels as pk

# ExamplesTestData.TRIANGLES_DATA: (src, dst, event-time ms), as in
# tests/test_triangles.py.
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


def _zipf_columns(n, n_edges, seed):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.3, n_edges) % n).astype(np.int32)
    dst = (rng.zipf(1.3, n_edges) % n).astype(np.int32)
    return src, dst


def _array_streams(src, dst, n, chunk_size, ts=None):
    """The same EVENT-time array stream in both packages (identity slots)."""
    ts = np.arange(src.shape[0], dtype=np.int64) if ts is None else ts
    j = j_stream(JSource(src, dst, timestamps=ts, chunk_size=chunk_size,
                         table=JIdentity(n), time=JTime.EVENT), n)
    t = t_stream(TSource(src, dst, timestamps=ts, chunk_size=chunk_size,
                         table=TIdentity(n), time=TTime.EVENT), n,
                 device="cpu")
    return j, t


# --------------------------------------------------------------------- #
# wedge kernel


def _mask(n, kind):
    rng = np.random.default_rng(n + len(kind))
    if kind == "zeros":
        return np.zeros((n, n), bool)
    if kind == "ones":
        return np.ones((n, n), bool)
    if kind == "upper":
        return np.triu(rng.random((n, n)) < 0.3, k=1)
    if kind == "block":  # one live 128 x 128 block, the last one
        m = np.zeros((n, n), bool)
        m[-128:, -128:] = rng.random((128, 128)) < 0.3
        return m
    if kind == "rows":  # whole zero block rows (every other one)
        m = rng.random((n, n)) < 0.3
        for k in range(0, n // tk.TILE, 2):
            m[k * tk.TILE:(k + 1) * tk.TILE] = False
        return m
    return rng.random((n, n)) < float(kind)


MASK_KINDS = ["0.01", "0.1", "0.5", "zeros", "ones", "upper", "block",
              "rows"]


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("n", [128, 256, 384])
def test_wedge_count_matrix_equals_pallas(n, kind):
    m = _mask(n, kind)
    want = np.asarray(pk.wedge_count_matrix(jnp.asarray(m), interpret=True))
    tm = torch.from_numpy(m)
    plain = tk.wedge_count_matrix_plain(tm)
    wrapped = tk.wedge_count_matrix(tm)
    assert want.dtype == np.float32
    for got in (plain, wrapped):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, m.T.astype(np.int64) @ m.astype(np.int64))


@pytest.mark.parametrize("n", [64, 200])
def test_wedge_size_not_multiple_of_tile_raises_in_both(n):
    m = np.ones((n, n), bool)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        pk.wedge_count_matrix(jnp.asarray(m), interpret=True)
    for fn in (tk.wedge_count_matrix, tk.wedge_count_matrix_plain):
        with pytest.raises(ValueError, match="not a multiple of 128"):
            fn(torch.from_numpy(m))


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_wedge_int_mask_equals_pallas(dtype):
    # The reference casts any mask to f32; the port takes one-byte masks
    # (0/1 entries) and counts them exactly as the reference does.
    m = (np.random.default_rng(3).random((256, 256)) < 0.2).astype(dtype)
    want = np.asarray(pk.wedge_count_matrix(jnp.asarray(m), interpret=True))
    assert want.sum() > 0
    for fn in (tk.wedge_count_matrix, tk.wedge_count_matrix_plain):
        got = fn(torch.from_numpy(m))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_wedge_wide_mask_is_a_type_error(dtype):
    m = torch.ones((128, 128), dtype=dtype)
    for fn in (tk.wedge_count_matrix, tk.wedge_count_matrix_plain):
        with pytest.raises(TypeError, match="uint8 or int8"):
            fn(m)


@pytest.mark.parametrize("t", [1, 2, 3, 8])
def test_wedge_tile_schedule_upper_tiles_once_heavy_first(t):
    sched = tk.wedge_tile_schedule(t)
    assert sched.dtype == torch.int64 and sched.shape == (t * (t + 1) // 2, 2)
    tiles = [tuple(x) for x in sched.tolist()]
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    # A triu mask gives tile (i, j) at most min(i, j) + 1 = i + 1 live
    # k-blocks: that bound never rises along the launch order.
    bound = [i + 1 for i, _ in tiles]
    assert bound == sorted(bound, reverse=True)
    assert tiles[0] == (t - 1, t - 1) and tiles[-1] == (0, t - 1)


def _brute_flags(m):
    t = m.shape[0] // tk.TILE
    return np.array([[m[k * tk.TILE:(k + 1) * tk.TILE,
                        i * tk.TILE:(i + 1) * tk.TILE].any()
                      for i in range(t)] for k in range(t)])


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("n", [256, 384])
def test_wedge_block_flags_and_ops_equal_brute_force(n, kind):
    m = _mask(n, kind)
    t = n // tk.TILE
    want = _brute_flags(m)
    flags = tk.wedge_block_flags_plain(torch.from_numpy(m))
    assert flags.dtype == torch.bool and np.array_equal(flags.numpy(), want)
    triples = sum(int(want[k, i] and want[k, j])
                  for i in range(t) for j in range(i, t) for k in range(t))
    assert tk.wedge_needed_ops(flags) == 2 * tk.TILE ** 3 * triples
    if kind == "upper":  # blocks below the block diagonal are dead
        assert not np.tril(want, -1).any()
    # The pre-pass's plain version: flags as bytes, Mt the transpose.
    mt, f8 = tk.wedge_block_prepass(torch.from_numpy(m))
    assert f8.dtype == mt.dtype == torch.uint8
    assert np.array_equal(f8.numpy(), want)
    assert np.array_equal(mt.numpy(), m.T)


def _wedge_tiled(m):
    """W assembled as the kernel assembles it: upper tiles in schedule
    order, dead k-blocks skipped, off-diagonal tiles mirrored."""
    n = m.shape[0]
    t, b = n // tk.TILE, tk.TILE
    tm = torch.from_numpy(m)
    flags = tk.wedge_block_flags_plain(tm)
    mt = tm.T.to(torch.int64)
    w = torch.full((n, n), -1, dtype=torch.int64)  # -1: never written
    for i, j in tk.wedge_tile_schedule(t).tolist():
        acc = torch.zeros((b, b), dtype=torch.int64)
        for k in range(t):
            if flags[k, i] and flags[k, j]:
                acc += (mt[i * b:(i + 1) * b, k * b:(k + 1) * b]
                        @ mt[j * b:(j + 1) * b, k * b:(k + 1) * b].T)
        w[i * b:(i + 1) * b, j * b:(j + 1) * b] = acc
        if i != j:
            w[j * b:(j + 1) * b, i * b:(i + 1) * b] = acc.T
    assert int(w.min()) >= 0
    return w.to(torch.float32)


@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("n", [128, 384])
def test_wedge_tiled_skip_and_mirror_equal_pallas(n, kind):
    m = _mask(n, kind)
    want = np.asarray(pk.wedge_count_matrix(jnp.asarray(m), interpret=True))
    assert np.array_equal(_wedge_tiled(m).numpy(), want)


def test_wedge_launches_stay_zero_on_cpu():
    before = tk.wedge_count_matrix.launches
    tk.wedge_count_matrix(torch.ones((128, 128), dtype=torch.bool))
    _, t = _tri_streams(capacity=128)
    assert dict(t_window_triangles(t, 400, method="mxu")) == GOLDEN
    assert tk.wedge_count_matrix.launches == before


# --------------------------------------------------------------------- #
# windows


def _out_of_order():
    rng = np.random.default_rng(21)
    e = 600
    src = rng.integers(0, 64, e).astype(np.int32)
    dst = rng.integers(0, 64, e).astype(np.int32)
    ts = np.sort(rng.integers(0, 1000, e)).astype(np.int64)
    swap = rng.choice(e, 60, replace=False)  # late stragglers
    ts[swap] = np.maximum(ts[swap] - rng.integers(100, 400, 60), 0)
    return src, dst, ts


def test_tumbling_window_events_match_on_out_of_order_stream():
    src, dst, ts = _out_of_order()
    j, t = _array_streams(src, dst, 64, 64, ts)
    jstats, tstats = {}, {}
    jev = list(jwindows.tumbling_window_events(iter(j), 100, jstats))
    tev = list(twindows.tumbling_window_events(iter(t), 100, tstats))
    assert [(k, w, nv) for k, w, _, nv in jev] == \
        [(k, w, nv) for k, w, _, nv in tev]
    assert jstats["late_edges"] == tstats["late_edges"] > 0
    for (_, _, jc, _), (_, _, tc, _) in zip(jev, tev):
        if jc is not None:
            assert tc.valid.dtype == torch.bool
            assert np.array_equal(np.asarray(jc.valid), tc.valid.numpy())


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("direction", ["out", "in", "all"])
def test_host_buffers_match(direction, sort):
    src, dst, ts = _out_of_order()
    j, t = _array_streams(src, dst, 64, 50, ts)
    jsnap = j.slice(100, direction, window_capacity=1024)
    tsnap = t.slice(100, direction, window_capacity=1024)
    jb = list(jsnap.host_buffers(sort=sort))
    tb = list(tsnap.host_buffers(sort=sort))
    assert [w for w, _ in jb] == [w for w, _ in tb] and len(jb) > 3
    for (_, ja), (_, ta) in zip(jb, tb):
        for x, y in zip(ja, ta):
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype
            assert np.array_equal(x, y)
    assert jsnap.stats == tsnap.stats


def test_window_buffer_overflow_error_is_the_same():
    src, dst = _zipf_columns(64, 500, 4)
    j, t = _array_streams(src, dst, 64, 100)
    msgs = []
    for s in (j, t):
        with pytest.raises(ValueError) as e:
            list(s.slice(1000, "all", window_capacity=300).host_buffers())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "window buffer overflow" in msgs[0]


def test_packed_out_windows_match():
    src, dst = _zipf_columns(256, 6000, 8)
    j, t = _array_streams(src, dst, 256, 700)
    jc = list(jtri._packed_out_windows(j, 2000, 4096, 256))
    tc = list(ttri._packed_out_windows(t, 2000, 4096, 256))
    assert len(jc) == len(tc) == 3
    for (jw, ja), (tw, ta) in zip(jc, tc):
        assert jw == tw and ja.dtype == ta.dtype == np.int32
        assert np.array_equal(ja, ta)


# --------------------------------------------------------------------- #
# the path


@pytest.mark.parametrize("chunk_size", [1, 3, 19])
def test_window_triangles_golden(chunk_size):
    j, t = _tri_streams(chunk_size)
    want = dict(jtri.window_triangles(j, 400))
    assert want == GOLDEN
    assert dict(t_window_triangles(t, 400)) == want


def test_window_triangles_duplicate_edges_counted_once():
    edges = [(1, 2, 1.0), (2, 3, 2.0), (1, 3, 3.0), (1, 2, 4.0), (2, 1, 5.0)]
    kw = dict(vertex_capacity=8, chunk_size=2,
              timestamps=np.array([0, 1, 2, 3, 4]))
    want = dict(jtri.window_triangles(
        j_edges(edges, time=JTime.EVENT, **kw), 1000))
    got = dict(t_window_triangles(
        t_edges(edges, time=TTime.EVENT, device="cpu", **kw), 1000))
    assert got == want == {0: 1}


@pytest.mark.parametrize("method", ["mxu", "mxu_interpret"])
def test_mxu_methods_equal_pallas_interpret(method):
    src, dst = _zipf_columns(128, 1500, 11)
    j, t = _array_streams(src, dst, 128, 256)
    want = dict(jtri.window_triangles(j, 500, method="mxu_interpret"))
    got = dict(t_window_triangles(t, 500, method=method))
    assert got == want and len(want) == 3 and sum(want.values()) > 0


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_batched_counts_equal_jax(batch):
    n, per_window = 256, 2000
    src, dst = _zipf_columns(n, 6 * per_window, 17)
    j, t = _array_streams(src, dst, n, 512)
    jw, jc = zip(*jtri.window_triangle_counts_batched(
        j, per_window, window_capacity=4096, batch=batch))
    tw, tc = zip(*ttri.window_triangle_counts_batched(
        t, per_window, window_capacity=4096, batch=batch))
    want = np.asarray(jnp.stack(jc))
    got = torch.stack(tc)
    assert jw == tw == tuple(range(6))
    assert want.dtype == np.int64 and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want) and want.sum() > 0


def test_pick_method_keys_on_the_device():
    pick = ttri._pick_method("auto", 256)
    assert pick(256, torch.device("cpu")) == "gather"
    assert pick(256, torch.device("cuda")) == "mxu"
    assert pick(255, torch.device("cuda")) == "gather"
    assert ttri._pick_method("auto", 200)(4096, "cuda") == "gather"
    assert ttri._pick_method("mxu", 256)(1, "cpu") == "mxu"


# --------------------------------------------------------------------- #
# not ported


@pytest.mark.parametrize("case", ["max_degree", "n2_over_2^31",
                                  "allowed_lateness", "bucketed"])
def test_unported_parts_raise(case, monkeypatch):
    # Each of these raised NotImplementedError until its slice was ported
    # (the lateness buffer with the windows slice, the rest with the
    # triangle library); each now gives gelly_tpu's result.
    j, t = _tri_streams()
    if case == "allowed_lateness":
        got = list(t.slice(400, allowed_lateness=50).host_buffers())
        want = list(j.slice(400, allowed_lateness=50).host_buffers())
        assert [w for w, _ in got] == [w for w, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert all(np.array_equal(x, np.asarray(y))
                       for x, y in zip(a, b))
        return
    if case == "max_degree":
        want = dict(jtri.window_triangles(j, 400, max_degree=8))
        got = dict(t_window_triangles(t, 400, max_degree=8))
    elif case == "n2_over_2^31":
        # The unpacked path, counted on the stream's 32 slots (a real
        # bool[2^16, 2^16] adjacency is 4 GiB).
        for mod in (jtri, ttri):
            real = mod._window_triangle_count
            monkeypatch.setattr(
                mod, "_window_triangle_count",
                lambda view, capacity, method="gather", real=real:
                real(view, 32, method))
        want = dict(jtri.window_triangles(j, 400, capacity=1 << 16))
        got = dict(t_window_triangles(t, 400, capacity=1 << 16))
    else:
        want = {w: int(c) for w, c in jtri.window_triangles_bucketed(j, 400)}
        got = {w: int(c) for w, c in ttri.window_triangles_bucketed(t, 400)}
    assert got == want == GOLDEN
    # The mesh count was the last part raising; on two CPU shards it
    # gives the same windows.
    from gelly_torch.parallel.mesh import make_mesh as t_make_mesh

    sharded = {w: int(c) for w, c in ttri.sharded_window_triangles(
        t, 400, mesh=t_make_mesh(2, devices=["cpu"] * 2))}
    assert sharded == GOLDEN


# --------------------------------------------------------------------- #
# prefetch_map (mirrors the gelly_tpu tests in tests/test_utils.py)


@pytest.mark.parametrize("depth,workers", [(2, 2), (1, 1), (4, 3), (0, 2)])
def test_prefetch_map_keeps_order(depth, workers):
    def fn(x):
        time.sleep(0.001 * (x % 3))  # finish out of order
        return x * x

    assert list(prefetch_map(fn, range(40), depth=depth,
                             workers=workers)) == [x * x for x in range(40)]


def test_prefetch_map_fn_error_raises_in_order():
    def fn(x):
        if x == 5:
            raise KeyError("bad item")
        return x

    got = []
    with pytest.raises(KeyError, match="bad item"):
        for x in prefetch_map(fn, range(10), depth=2, workers=2):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_prefetch_map_error_while_queue_full():
    def src():
        yield from range(4)
        raise RuntimeError("submitter failure")

    it = prefetch_map(lambda x: x * 2, src(), depth=1, workers=2)
    got = []
    time.sleep(0.3)
    with pytest.raises(RuntimeError, match="submitter failure"):
        for x in it:
            got.append(x)
            time.sleep(0.05)
    assert got == [0, 2, 4, 6]


def test_prefetch_map_cancel_while_queue_full():
    def submitters():
        return [th for th in threading.enumerate()
                if th.name.startswith("gelly-prefetch-submit")
                and th.is_alive()]

    before = set(submitters())
    ran = []

    def fn(x):
        ran.append(x)
        return x * 2

    it = prefetch_map(fn, iter(range(10_000)), depth=2, workers=2)
    assert next(it) == 0
    time.sleep(0.3)  # let the submitter fill the queue and park on put
    it.close()
    deadline = time.monotonic() + 5.0
    while (set(submitters()) - before) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not (set(submitters()) - before)
    n_after_close = len(ran)
    time.sleep(0.3)
    assert len(ran) == n_after_close


def test_prefetch_map_external_cancel_unblocks_parked_consumer():
    release = threading.Event()
    cancel = threading.Event()
    pulled = []

    def src():
        pulled.append(0)
        yield 0
        release.wait(10)  # a source stuck on I/O
        for i in range(1, 100):
            pulled.append(i)
            yield i

    it = prefetch_map(lambda x: x * 2, src(), depth=2, workers=1,
                      cancel=cancel)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(it), daemon=True)
    consumer.start()
    deadline = time.monotonic() + 5.0
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [0]
    cancel.set()
    consumer.join(2.0)
    assert not consumer.is_alive()
    assert got == [0]
    release.set()


@pytest.mark.parametrize("sparse", [False, True])
def test_fresh_counts_default_to_the_card(sparse):
    """The exact-count constructors put their state on ``DEFAULT_DEVICE``
    (the card) unless the caller asks for the CPU, as ``gelly_tpu``'s put
    theirs on its default device: on a machine without a card a call with
    no ``device`` raises the port's no-card error, and ``device="cpu"``
    equals ``gelly_tpu``'s zero state."""
    if sparse:
        def make(mod, **kw):
            return mod.fresh_sparse_triangle_counts(24, 8, **kw)
    else:
        def make(mod, **kw):
            return mod.fresh_triangle_counts(24, **kw)
    if torch.cuda.is_available():
        assert make(ttri).counts.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            make(ttri)
    got, want = make(ttri, device="cpu"), make(jtri)
    assert got._fields == want._fields
    for name, t, j in zip(got._fields, got, want):
        j = np.asarray(j)
        assert t.device.type == "cpu", name
        assert t.numpy().dtype == j.dtype, name
        assert t.numpy().tobytes() == j.tobytes(), name
