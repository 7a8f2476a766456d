"""gelly_torch's event-time windows (``window_ms``) and the
``allowed_lateness`` reorder buffer vs gelly_tpu's (CPU).

Mirrors ``tests/test_aggregation.py``'s window cases (event-time CC,
empty-window gaps, late edges, mid-window checkpoints, the reorder
buffer's results, its stats and bound, its checkpoint sidecar, a crash
between the paired writes, the refusals) on the port, and holds every
emission of the raw and codec CC plans and of a per-window Merger plan,
``stats``, the buffer's iterator events, and the checkpoint and sidecar
files (leaf for leaf, position-stamped names, meta keys) to
``gelly_tpu`` on the same seeded streams; files written by either package
resume in the other. ``gelly_tpu`` runs on a one-device mesh. Tolerance:
exact.
"""

import glob
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.core.chunk import make_chunk as t_make_chunk
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.io import TimeCharacteristic as TTime
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.core.windows import tumbling_window_events as t_events
from gelly_torch.engine import aggregation as tagg
from gelly_torch.engine.checkpoint import load_checkpoint
from gelly_torch.library import connected_components as tcc
from gelly_tpu.core.chunk import make_chunk as j_make_chunk
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.io import TimeCharacteristic as JTime
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.core.windows import tumbling_window_events as j_events
from gelly_tpu.engine import aggregation as jagg
from gelly_tpu.library.connected_components import (
    connected_components as j_cc,
)
from gelly_tpu.parallel.mesh import make_mesh


def _t(src, dst, ts, n_v, chunk):
    return t_stream(TSource(src, dst, timestamps=ts, chunk_size=chunk,
                            table=TIdentity(n_v), time=TTime.EVENT), n_v,
                    device="cpu")


def _j(src, dst, ts, n_v, chunk):
    return j_stream(JSource(src, dst, timestamps=ts, chunk_size=chunk,
                            table=JIdentity(n_v), time=JTime.EVENT), n_v)


def _shuffled(n, n_v, seed, block, t_hi):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n).astype(np.int64)
    dst = rng.integers(0, n_v, n).astype(np.int64)
    ts = np.sort(rng.integers(0, t_hi, n)).astype(np.int64)
    perm = np.arange(n)
    for lo in range(0, n, block):
        seg = perm[lo:lo + block]
        rng.shuffle(seg)
        perm[lo:lo + block] = seg
    return src, dst, ts, perm


def t_count():
    return tagg.SummaryAggregation(
        init=lambda device: torch.zeros((), dtype=torch.int64,
                                        device=device),
        fold=lambda s, c: s + c.valid.sum(dtype=torch.int64),
        combine=lambda a, b: a + b, name="count")


def j_count():
    return jagg.SummaryAggregation(
        init=lambda: jnp.zeros((), jnp.int64),
        fold=lambda s, c: s + jnp.sum(c.valid.astype(jnp.int64)),
        combine=lambda a, b: a + b, name="count")


def _emissions(st):
    return [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o)
            for o in st]


PLANS = {
    "raw": dict(ingest_combine=False),
    "dense": dict(codec="dense"),
    "sparse": dict(codec="sparse"),
    "compact": dict(codec="compact", compact_capacity=64),
}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("lateness", [0, 1000])
def test_window_ms_cc_emissions_equal_jax(plan, lateness):
    n_v = 64
    src, dst, ts, perm = _shuffled(300, n_v, 29, 30, 3000)
    order = perm if lateness else np.arange(300)
    tst = tagg.run_aggregation(
        tcc.connected_components(n_v, merge="gather", **PLANS[plan]),
        _t(src[order], dst[order], ts[order], n_v, 32), window_ms=1000,
        allowed_lateness=lateness)
    jst = jagg.run_aggregation(
        j_cc(n_v, merge="gather", **PLANS[plan]),
        _j(src[order], dst[order], ts[order], n_v, 32), window_ms=1000,
        allowed_lateness=lateness, mesh=make_mesh(1))
    got, want = _emissions(tst), _emissions(jst)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for key in ("late_edges", "windows_closed", "chunks"):
        assert tst.stats[key] == jst.stats[key]
    if lateness:
        assert tst.stats["buffered_edges"] == jst.stats["buffered_edges"] == 0


def test_sorted_and_shuffled_with_lateness_agree():
    n_v = 64
    src, dst, ts, perm = _shuffled(300, n_v, 29, 30, 3000)
    plan = lambda: tcc.connected_components(n_v, merge="gather",  # noqa
                                            ingest_combine=False)
    sorted_runs = _emissions(tagg.run_aggregation(
        plan(), _t(src, dst, ts, n_v, 32), window_ms=1000))
    shuffled = _emissions(tagg.run_aggregation(
        plan(), _t(src[perm], dst[perm], ts[perm], n_v, 32), window_ms=1000,
        allowed_lateness=1000))
    assert len(sorted_runs) == len(shuffled)
    for a, b in zip(sorted_runs, shuffled):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ts,window,want_late", [
    (np.array([0, 1000]), 1, 0),
    (np.array([10, 11, 0, 13]), 2, 1),
    (np.array([0, 1, 2, 3]), 2, 0),
])
def test_merger_count_gaps_and_late_edges_equal_jax(ts, window, want_late):
    src = np.arange(1, 2 * len(ts), 2, dtype=np.int64)
    dst = src + 1
    tst = tagg.run_aggregation(t_count(), _t(src, dst, ts, 16, 2),
                               window_ms=window)
    jst = jagg.run_aggregation(j_count(), _j(src, dst, ts, 16, 2),
                               window_ms=window, mesh=make_mesh(1))
    got = [int(x) for x in _emissions(tst)]
    assert got == [int(x) for x in _emissions(jst)]
    assert tst.stats["late_edges"] == jst.stats["late_edges"] == want_late


def test_events_and_buffer_stats_equal_jax():
    rng = np.random.default_rng(5)
    n = 256
    ts = np.sort(rng.integers(0, 4000, n)).astype(np.int64)
    ts[40:80] = ts[40:80][::-1].copy()  # out of order inside the bound
    ids = np.arange(32, dtype=np.int64)
    t_chunks = [t_make_chunk(ids, ids, ts=ts[lo:lo + 32], capacity=32,
                             device=None) for lo in range(0, n, 32)]
    j_chunks = [j_make_chunk(ids, ids, ts=ts[lo:lo + 32], capacity=32,
                             device=False) for lo in range(0, n, 32)]
    span = max(int(ts[lo:lo + 32].max() - ts[lo:lo + 32].min())
               for lo in range(0, n, 32))
    bound = -(-(500 + span) // 250) + 1
    ts_stats, js_stats = {}, {}
    tev = list(t_events(iter(t_chunks), 250, ts_stats, allowed_lateness=500))
    jit = j_events(iter(j_chunks), 250, js_stats, allowed_lateness=500)
    peak = 0
    for (k1, w1, c1, n1), (k2, w2, c2, n2) in zip(tev, jit):
        assert (k1, w1, n1) == (k2, w2, n2)
        if k1 == "edges":
            assert np.array_equal(c1.valid.numpy(), np.asarray(c2.valid))
    for _ in t_events(iter(t_chunks), 250, ts_stats,
                      allowed_lateness=500):
        peak = max(peak, ts_stats["buffered_edges"])
        assert ts_stats["open_windows"] <= bound
    assert peak > 0
    assert ts_stats["buffered_edges"] == ts_stats["open_windows"] == 0


def test_lateness_sorted_stream_unaffected():
    n, n_v = 256, 16
    rng = np.random.default_rng(31)
    src = rng.integers(0, n_v, n).astype(np.int64)
    dst = rng.integers(0, n_v, n).astype(np.int64)
    ts = np.arange(n, dtype=np.int64) * 16

    def collect(lateness):
        st = tagg.run_aggregation(t_count(), _t(src, dst, ts, n_v, 200),
                                  window_ms=100, allowed_lateness=lateness)
        return [int(x) for x in _emissions(st)], st.stats["late_edges"]

    want, late0 = collect(0)
    got, late = collect(50)
    assert late0 == late == 0 and got == want


def test_refusals_equal_jax():
    src = np.array([1, 2], np.int64)
    ts = np.array([0, 1], np.int64)
    msgs = []
    for run, stream, kw in (
            (tagg.run_aggregation, _t(src, src, ts, 8, 2), {}),
            (jagg.run_aggregation, _j(src, src, ts, 8, 2),
             dict(mesh=make_mesh(1)))):
        plan = t_count() if run is tagg.run_aggregation else j_count()
        for bad in (dict(allowed_lateness=5),
                    dict(merge_every=2, window_ms=5)):
            with pytest.raises(ValueError) as e:
                run(plan, stream, **bad, **kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    assert "allowed_lateness requires window_ms" in msgs[0]


# ---------------------------------------------------------------------- #
# checkpoints: mid-window, the lateness sidecar, across the packages

_TS = np.array([0, 5, 12, 3, 8, 17, 14, 9, 23, 21, 16, 27, 26, 31, 29, 35],
               np.int64)
_SRC = np.arange(16, dtype=np.int64) % 16
_DST = (np.arange(16, dtype=np.int64) + 1) % 16
_KW = dict(window_ms=10, allowed_lateness=10, checkpoint_every=1)


def _t_run(plan, **kw):
    return tagg.run_aggregation(plan, _t(_SRC, _DST, _TS, 16, 4), **kw)


def _j_run(plan, **kw):
    return jagg.run_aggregation(plan, _j(_SRC, _DST, _TS, 16, 4),
                                mesh=make_mesh(1), **kw)


def _cc_plans():
    return (tcc.connected_components(16, merge="gather",
                                     ingest_combine=False),
            j_cc(16, merge="gather", ingest_combine=False))


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("kind", ["count", "cc"])
def test_lateness_sidecar_resumes_across_packages(tmp_path, writer, kind):
    def plans():
        if kind == "count":
            return t_count(), j_count()
        return _cc_plans()

    want = _emissions(_t_run(plans()[0], **_KW))
    p = str(tmp_path / "lat.npz")
    first = _t_run if writer == "torch" else _j_run
    second = _j_run if writer == "torch" else _t_run
    pick = 0 if writer == "torch" else 1
    it = iter(first(plans()[pick], checkpoint_path=p, **_KW))
    next(it)
    next(it)
    del it
    sides = glob.glob(p + ".lateness.*")
    assert len(sides) == 1
    flat, pos, meta = load_checkpoint(sides[0])
    assert set(meta) == {"wins", "closed_upto", "max_ts"}
    assert sides[0] == f"{p}.lateness.{pos}"
    assert len(flat) % 8 == 0 and len(flat) // 8 == len(meta["wins"])
    got = _emissions(second(plans()[1 - pick], checkpoint_path=p, resume=True,
                            **_KW))
    assert np.array_equal(got[-1], want[-1])
    if kind == "count":
        assert int(got[-1]) == 16


def test_checkpoint_and_sidecar_files_equal_jax(tmp_path):
    files = {}
    for name, run, plan in (("t", _t_run, t_count()),
                            ("j", _j_run, j_count())):
        p = str(tmp_path / f"{name}.npz")
        it = iter(run(plan, checkpoint_path=p, **_KW))
        next(it)
        next(it)
        del it
        side, = glob.glob(p + ".lateness.*")
        files[name] = (load_checkpoint(p), load_checkpoint(side),
                       side.rsplit(".", 1)[1])
    (tm, ts_, tpos), (jm, js_, jpos) = files["t"], files["j"]
    assert tpos == jpos
    for a, b in ((tm, jm), (ts_, js_)):
        assert a[1] == b[1] and a[2] == b[2]
        assert len(a[0]) == len(b[0])
        for x, y in zip(a[0], b[0]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()




def test_checkpoint_midwindow_chunk_boundary_resume(tmp_path):
    p = str(tmp_path / "w.npz")
    src = np.array([1, 3, 5, 7], np.int64)
    ts = np.array([0, 1, 2, 3], np.int64)
    list(tagg.run_aggregation(t_count(), _t(src[:2], src[:2] + 1, ts[:2], 16,
                                            2),
                              window_ms=2, checkpoint_path=p))
    q = str(tmp_path / "copy.npz")
    shutil.copy(p, q)
    got = [int(x) for x in tagg.run_aggregation(
        t_count(), _t(src, src + 1, ts, 16, 2), window_ms=2,
        checkpoint_path=p, resume=True)]
    assert got[-1] == 4
    # gelly_tpu resumes the port's mid-window file too.
    jgot = [int(x) for x in jagg.run_aggregation(
        j_count(), _j(src, src + 1, ts, 16, 2), window_ms=2,
        checkpoint_path=q, resume=True, mesh=make_mesh(1))]
    assert jgot == got


def test_sidecar_crash_between_writes_recovers(tmp_path):
    want = _emissions(_t_run(t_count(), **_KW))
    p = str(tmp_path / "lat.npz")
    it = iter(_t_run(t_count(), checkpoint_path=p, **_KW))
    next(it)
    next(it)
    del it
    sides = glob.glob(p + ".lateness.*")
    pos = int(sides[0].rsplit(".", 1)[1])
    # A newer-position sidecar landed, the main file never advanced.
    shutil.copy(sides[0], f"{p}.lateness.{pos + 3}")
    got = _emissions(_t_run(t_count(), checkpoint_path=p, resume=True,
                            **_KW))
    assert int(got[-1]) == int(want[-1]) == 16
    assert len(glob.glob(p + ".lateness.*")) <= 1


def test_sidecar_position_mismatch_raises_jax_message(tmp_path):
    p = str(tmp_path / "lat.npz")
    it = iter(_t_run(t_count(), checkpoint_path=p, **_KW))
    next(it)
    next(it)
    del it
    side, = glob.glob(p + ".lateness.*")
    os.replace(side, p + ".lateness")  # the unstamped legacy name
    flat, pos, meta = load_checkpoint(p + ".lateness")
    from gelly_torch.engine.checkpoint import save_checkpoint

    save_checkpoint(p + ".lateness", flat, position=pos + 1, meta=meta)
    msgs = []
    for run, plan in ((_t_run, t_count()), (_j_run, j_count())):
        with pytest.raises(ValueError) as e:
            list(run(plan, checkpoint_path=p, resume=True, **_KW))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "lateness sidecar position" in msgs[0]
