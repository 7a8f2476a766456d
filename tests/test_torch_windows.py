"""gelly_torch's pane-ring sliding windows and TTL decay vs gelly_tpu's
(CPU).

Mirrors ``tests/test_windows.py`` on the port: the two-stack
``PaneRing`` (sums, amortised combines, order, export / reload), windowed
dense, sparse and compact CC (with TTL eviction and re-arrival) and
windowed degrees held emission by emission to ``gelly_tpu`` and to the
replay oracle, the compact plan's ``session.assigned`` trace, the
``snapshot()`` handle's one-pane staleness, every refusal with
``gelly_tpu``'s message, pane-ring checkpoints resumed across the two
packages both ways, a fold and combine that write in place, and a kill -9
child (this file run as a script) resumed bit for bit. ``gelly_tpu`` runs
on a one-device mesh. Tolerance: exact.

Child: ``python tests/test_torch_windows.py <ckpt> <out.npz> <sleep_s>``
with the repository root on ``PYTHONPATH``.
"""

import importlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.core.windows import PaneRing as TRing
from gelly_torch.engine import aggregation as tagg
from gelly_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from gelly_torch.library import connected_components as tcc
from gelly_torch.library import degrees as tdeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_V = 256
CH = 64


def _t(src, dst, n_v=N_V, chunk=CH):
    return t_stream(TSource(src, dst, chunk_size=chunk,
                            table=TIdentity(n_v)), n_v, device="cpu")


def _j(src, dst, n_v=N_V, chunk=CH):
    from gelly_tpu.core.io import EdgeChunkSource
    from gelly_tpu.core.stream import edge_stream_from_source
    from gelly_tpu.core.vertices import IdentityVertexTable

    return edge_stream_from_source(
        EdgeChunkSource(src, dst, chunk_size=chunk,
                        table=IdentityVertexTable(n_v)), n_v)


def _mesh():
    from gelly_tpu.parallel.mesh import make_mesh

    return make_mesh(1)


def _zipf_stream(n_chunks=20, seed=7):
    rng = np.random.default_rng(seed)
    n_e = CH * n_chunks
    src = (rng.zipf(1.4, n_e) % N_V).astype(np.int64)
    dst = (rng.zipf(1.4, n_e) % N_V).astype(np.int64)
    src[::37] = dst[::37]  # self-loops: touched, but no forest edge
    return src, dst


def _two_phase_stream():
    """Vertices 0..99 for 8 chunks, then only 100..119 for 16; vertex 5
    re-arrives at the very end."""
    rng = np.random.default_rng(3)
    a, b = 8 * CH, 16 * CH
    src = np.empty(a + b, np.int64)
    dst = np.empty(a + b, np.int64)
    src[:a] = rng.integers(0, 100, a)
    dst[:a] = rng.integers(0, 100, a)
    src[a:] = rng.integers(100, 120, b)
    dst[a:] = rng.integers(100, 120, b)
    src[-3:] = 5
    dst[-3:] = 110
    return src, dst


def _pane_edges(i, w, me, n_chunks):
    """Edge range of the window emitted at pane ``i``: the last ``w``
    panes of ``me`` chunks (the final pane may be short)."""
    return max(0, (i + 1 - w) * me) * CH, min((i + 1) * me, n_chunks) * CH


def _replay(src, dst, i, w, me, n_chunks=20):
    lo, hi = _pane_edges(i, w, me, n_chunks)
    return tcc.cc_labels_numpy(src[lo:hi], dst[lo:hi], None, N_V)


# ---------------------------------------------------------------------- #
# PaneRing


class TestPaneRing:
    def test_sliding_sum_and_combines_equal_jax(self):
        from gelly_tpu.core.windows import PaneRing as JRing

        rng = np.random.default_rng(11)
        for w in (1, 2, 3, 7, 16):
            tr, jr = TRing(w, lambda a, b: a + b), JRing(w, lambda a, b: a + b)
            vals = []
            for _ in range(5 * w + 3):
                v = int(rng.integers(0, 1000))
                vals.append(v)
                tr.push(v), jr.push(v)
                assert tr.live == jr.live == min(len(vals), w)
                assert tr.query() == jr.query() == sum(vals[-w:])
                assert tr.combines == jr.combines
            assert tr.export_panes() == jr.export_panes()

    def test_combines_amortized_constant(self):
        for w in (4, 16, 64):
            ring = TRing(w, lambda a, b: a + b)
            n = 8 * w
            for _ in range(n):
                ring.push(1)
                ring.query()
            assert ring.combines <= 4 * n, (w, ring.combines, n)

    def test_non_commutative_order(self):
        w = 5
        ring = TRing(w, lambda a, b: a + b)
        items = [[i] for i in range(23)]
        for i, it in enumerate(items):
            ring.push(it)
            lo = max(0, i + 1 - w)
            assert ring.query() == sum(items[lo:i + 1], [])
            assert ring.export_panes() == items[lo:i + 1]

    def test_export_reload_roundtrip(self):
        ring = TRing(4, lambda a, b: a + b)
        for i in range(11):
            ring.push(i)
        ring2 = TRing(4, lambda a, b: a + b)
        ring2.reload(ring.export_panes(), ring.panes_closed)
        assert ring2.query() == ring.query()
        assert ring2.panes_closed == ring.panes_closed
        ring.push(99), ring2.push(99)
        assert ring2.query() == ring.query()
        with pytest.raises(ValueError, match="exceed"):
            ring2.reload(list(range(5)), 5)
        with pytest.raises(ValueError, match=">= 1"):
            TRing(0, lambda a, b: a + b)


# ---------------------------------------------------------------------- #
# windowed plans vs gelly_tpu and the replay oracle


def _run_both(t_agg, j_agg, src, dst, trace=False, **kw):
    from gelly_tpu.engine.aggregation import run_aggregation

    tst = tagg.run_aggregation(t_agg, _t(src, dst), **kw)
    t_out, t_assigned = [], []
    for o in tst:
        t_out.append(o.numpy().copy())
        if trace:
            t_assigned.append(t_agg.session.assigned)
    jst = run_aggregation(j_agg, _j(src, dst), mesh=_mesh(), **kw)
    j_out, j_assigned = [], []
    for o in jst:
        j_out.append(np.asarray(o))
        if trace:
            j_assigned.append(j_agg.session.assigned)
    assert len(t_out) == len(j_out)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"pane {i}"
    assert t_assigned == j_assigned
    return t_out, tst, jst


_QUIET = dict(prefetch_depth=0, h2d_depth=0, ingest_workers=1)


@pytest.mark.parametrize("codec", ["dense", "sparse"])
@pytest.mark.parametrize("w,me,fold_batch", [(4, 2, 1), (3, 2, 2),
                                              (1, 1, 1)])
def test_dense_sparse_cc_windowed_equal_jax(codec, w, me, fold_batch):
    from gelly_tpu.library.connected_components import connected_components

    src, dst = _zipf_stream()
    outs, tst, jst = _run_both(
        tcc.connected_components(N_V, merge="gather", codec=codec,
                                 windowed=w),
        connected_components(N_V, merge="gather", codec=codec, windowed=w),
        src, dst, merge_every=me, fold_batch=fold_batch)
    for i, got in enumerate(outs):
        assert np.array_equal(got, _replay(src, dst, i, w, me)), f"pane {i}"
    assert tst.stats["windows.panes_closed"] == len(outs)
    assert tst.stats["windows_closed"] == jst.stats["windows_closed"]
    assert (tst.stats["windows.combine_dispatches"] > 0) == (w > 1)


def test_raw_cc_windowed_equal_jax():
    from gelly_tpu.library.connected_components import connected_components

    src, dst = _zipf_stream(seed=9)
    _run_both(tcc.connected_components(N_V, ingest_combine=False,
                                       windowed=3),
              connected_components(N_V, ingest_combine=False, windowed=3),
              src, dst, merge_every=2)


@pytest.mark.parametrize("wire", ["segments", "pairs"])
@pytest.mark.parametrize("w,ttl,me", [(4, 4, 2), (3, 5, 2), (2, None, 3)])
def test_compact_cc_windowed_ttl_equal_jax(wire, w, ttl, me):
    from gelly_tpu.library.connected_components import (
        connected_components_compact,
    )

    src, dst = _zipf_stream()
    t_agg = tcc.connected_components_compact(
        N_V, compact_capacity=N_V, wire=wire, windowed=w, ttl_panes=ttl)
    j_agg = connected_components_compact(
        N_V, compact_capacity=N_V, wire=wire, windowed=w, ttl_panes=ttl)
    outs, tst, _ = _run_both(t_agg, j_agg, src, dst, trace=True,
                             merge_every=me, **_QUIET)
    for i, got in enumerate(outs):
        assert np.array_equal(got, _replay(src, dst, i, w, me)), f"pane {i}"


def test_ttl_eviction_reclaims_capacity_and_rearrival():
    from gelly_tpu.library.connected_components import connected_components

    src, dst = _two_phase_stream()
    w, me, ttl = 3, 2, 4
    t_agg = tcc.connected_components(N_V, codec="compact",
                                     compact_capacity=N_V, windowed=w,
                                     ttl_panes=ttl)
    j_agg = connected_components(N_V, codec="compact", compact_capacity=N_V,
                                 windowed=w, ttl_panes=ttl)
    tst = tagg.run_aggregation(t_agg, _t(src, dst), merge_every=me,
                               **_QUIET)
    outs, assigned = [], []
    for out in tst:
        outs.append(out.numpy().copy())
        assigned.append(t_agg.session.assigned)
    assert max(assigned[:5]) > 100
    assert assigned[-2] < 40, assigned
    assert tst.stats["windows.evicted_slots"] >= 100
    for i, got in enumerate(outs):
        assert np.array_equal(got, _replay(src, dst, i, w, me, 24)), f"pane {i}"
    _run_both(tcc.connected_components(N_V, codec="compact",
                                       compact_capacity=N_V, windowed=w,
                                       ttl_panes=ttl),
              j_agg, src, dst, trace=True, merge_every=me, **_QUIET)


def test_pane_combine_flattens_where_the_reference_loses_links():
    """gelly_tpu merges a pane's unflattened compact forest and loses
    links (ROADMAP.md queue 3); the port flattens it first and equals the
    replay oracle at every pane. A drifting sparse stream found by a
    seeded search: JAX is wrong at its last window."""
    from gelly_tpu.library.connected_components import (
        connected_components_compact,
    )

    n, ch, block, drift, w = 8192, 256, 1024, 64, 8
    rng = np.random.default_rng(2)
    lo = (np.arange(2 * w) * drift) % n
    src = ((rng.integers(0, block, (2 * w, ch)) + lo[:, None]) % n).reshape(-1)
    dst = ((rng.integers(0, block, (2 * w, ch)) + lo[:, None]) % n).reshape(-1)
    kw = dict(compact_capacity=n, windowed=w)
    got = [o.numpy() for o in tagg.run_aggregation(
        tcc.connected_components_compact(n, **kw),
        _t(src, dst, n_v=n, chunk=ch), merge_every=2, **_QUIET)]
    want = [np.asarray(o) for o in __import__(
        "gelly_tpu.engine.aggregation", fromlist=["run_aggregation"]
    ).run_aggregation(connected_components_compact(n, **kw),
                      _j(src, dst, n_v=n, chunk=ch), merge_every=2,
                      mesh=_mesh(), **_QUIET)]
    for i, out in enumerate(got):
        lo_e, hi_e = max(0, (i + 1 - w) * 2) * ch, (i + 1) * 2 * ch
        assert np.array_equal(out, tcc.cc_labels_numpy(
            src[lo_e:hi_e], dst[lo_e:hi_e], None, n)), f"pane {i}"
    oracle = tcc.cc_labels_numpy(src, dst, None, n)
    assert not np.array_equal(want[-1], oracle)  # the reference's fault
    assert np.array_equal(got[-1], oracle)


@pytest.mark.parametrize("wire", ["segments", "pairs"])
def test_window_pane_convert_round_trip(wire):
    """A JAX pane of the windowed compact plan, folded over two units,
    continues in the port's pane fold, and the port's pane in JAX's:
    ``croot``, ``vertex_of``, ``touched`` and the labels stay JAX's."""
    import jax
    import jax.numpy as jnp

    from gelly_tpu.core.io import EdgeChunkSource
    from gelly_tpu.core.vertices import IdentityVertexTable
    from gelly_tpu.library.connected_components import (
        CCWindowPane,
        connected_components_compact,
    )

    src, dst = _zipf_stream(n_chunks=12, seed=13)
    kw = dict(compact_capacity=N_V, wire=wire, windowed=3)
    jplan = connected_components_compact(N_V, **kw)
    tplan = tcc.connected_components_compact(N_V, **kw)
    chunks = list(EdgeChunkSource(src, dst, chunk_size=CH,
                                  table=IdentityVertexTable(N_V)))
    jplan.on_run_start()
    units = [jplan.stack_payloads([jplan.host_compress(c)
                                   for c in chunks[lo:lo + 3]], 1, seq=seq)
             for seq, lo in enumerate(range(0, len(chunks), 3))]
    jfold = jax.jit(jplan.fold_compressed)
    jp = jplan.init()
    for payload in units[:2]:
        jp = jfold(jp, payload)
    tp = convert.cc_window_pane_from_numpy(
        *(np.asarray(x) for x in jp), device="cpu")
    for payload in units[2:]:
        jp = jfold(jp, payload)
        tp = tplan.fold_compressed(
            tp, {k: torch.from_numpy(np.array(v)) for k, v in payload.items()})
    for a, b in zip(convert.cc_window_pane_to_numpy(tp), jp):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(tplan.transform(tp).numpy(),
                          np.asarray(jplan.transform(jp)))
    # The other way: the port's pane is read by gelly_tpu's transform.
    back = CCWindowPane(*(jnp.asarray(x)
                          for x in convert.cc_window_pane_to_numpy(tp)))
    assert np.array_equal(np.asarray(jplan.transform(back)),
                          tplan.transform(tp).numpy())
    croot, vof, touched = convert.cc_window_pane_to_numpy(tp)
    with pytest.raises(TypeError, match="touched must be bool"):
        convert.cc_window_pane_from_numpy(croot, vof, vof, device="cpu")
    with pytest.raises(ValueError, match="one length"):
        convert.cc_window_pane_from_numpy(croot, vof[:-1], touched,
                                          device="cpu")


@pytest.mark.parametrize("codec", ["dense", "sparse", "raw"])
def test_degrees_windowed_equal_jax(codec):
    from gelly_tpu.library.degrees import degree_aggregate

    src, dst = _zipf_stream(seed=4)
    kw = dict(ingest_combine=False) if codec == "raw" else dict(codec=codec)
    outs, _, _ = _run_both(tdeg.degree_aggregate(N_V, windowed=3, **kw),
                           degree_aggregate(N_V, windowed=3, **kw),
                           src, dst, merge_every=2)
    for i, got in enumerate(outs):
        lo, hi = _pane_edges(i, 3, 2, 20)
        want = (np.bincount(src[lo:hi], minlength=N_V)
                + np.bincount(dst[lo:hi], minlength=N_V))
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_snapshot_one_pane_staleness():
    src, dst = _zipf_stream(seed=5)
    agg = tcc.connected_components(N_V, merge="gather", codec="dense",
                                   windowed=4)
    st = tagg.run_aggregation(agg, _t(src, dst), merge_every=2)
    assert isinstance(st, tagg.WindowedStream)
    assert st.snapshot() is None
    outs = []
    for out in st:
        outs.append(out.numpy().copy())
        snap = st.snapshot()
        assert snap["window"] == len(outs)
        assert np.array_equal(snap["labels"].numpy(), outs[-1])
    snap = st.snapshot()
    assert snap["window"] == len(outs) == st.stats["windows_closed"]
    assert st.stats["windows.snapshot_reads"] == len(outs) + 2


# ---------------------------------------------------------------------- #
# in-place folds and combines


def _inplace_plan(n, windowed):
    """A degree plan whose fold and combine write their first argument."""
    def fold(deg, c):
        deg.index_add_(0, torch.where(c.valid, c.src, 0).long(),
                       c.valid.to(torch.int64))
        return deg

    def combine(a, b):
        a.add_(b)
        return a

    agg = tagg.SummaryAggregation(
        init=lambda device: torch.zeros(n, dtype=torch.int64, device=device),
        fold=fold, combine=combine, fold_accumulates=True, name="inplace")
    agg.windowed_panes = windowed
    return agg


@pytest.mark.parametrize("w", [1, 3, 5])
def test_in_place_fold_and_combine_never_touch_ring_panes(w):
    src, dst = _zipf_stream(seed=8)
    st = tagg.run_aggregation(_inplace_plan(N_V, w), _t(src, dst),
                              merge_every=2)
    for i, got in enumerate(st):
        lo, hi = _pane_edges(i, w, 2, 20)
        assert np.array_equal(got.numpy(),
                              np.bincount(src[lo:hi], minlength=N_V)), i


# ---------------------------------------------------------------------- #
# refusals, with gelly_tpu's messages


def _msg(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _both_msgs(t_fn, j_fn):
    a, b = _msg(t_fn), _msg(j_fn)
    assert a == b
    return a


def test_refusals_equal_jax():
    from gelly_tpu.engine.aggregation import run_aggregation as jrun
    from gelly_tpu.library.connected_components import connected_components
    from gelly_tpu.library.degrees import degree_aggregate

    src, dst = _zipf_stream()
    assert "window_ms" in _both_msgs(
        lambda: tagg.run_aggregation(
            tcc.connected_components(N_V, codec="dense", windowed=4),
            _t(src, dst), window_ms=10),
        lambda: jrun(connected_components(N_V, codec="dense", windowed=4),
                     _j(src, dst), window_ms=10))
    assert "ttl" in _both_msgs(
        lambda: tcc.connected_components(N_V, codec="compact", ttl_panes=4),
        lambda: connected_components(N_V, codec="compact", ttl_panes=4))
    assert "ttl" in _both_msgs(
        lambda: tcc.connected_components(N_V, codec="compact",
                                         compact_capacity=N_V, windowed=4,
                                         ttl_panes=2),
        lambda: connected_components(N_V, codec="compact",
                                     compact_capacity=N_V, windowed=4,
                                     ttl_panes=2))
    assert "compact" in _both_msgs(
        lambda: tcc.connected_components(N_V, codec="dense", windowed=4,
                                         ttl_panes=4),
        lambda: connected_components(N_V, codec="dense", windowed=4,
                                     ttl_panes=4))
    assert "prefetch" in _both_msgs(
        lambda: tagg.run_aggregation(
            tcc.connected_components(N_V, codec="compact",
                                     compact_capacity=N_V, windowed=4,
                                     ttl_panes=4),
            _t(src, dst), merge_every=2, prefetch_depth=2, h2d_depth=2),
        lambda: jrun(connected_components(N_V, codec="compact",
                                          compact_capacity=N_V, windowed=4,
                                          ttl_panes=4),
                     _j(src, dst), merge_every=2, prefetch_depth=2,
                     h2d_depth=2))
    assert ">= 1 pane" in _both_msgs(
        lambda: tcc.connected_components(N_V, windowed=0),
        lambda: connected_components(N_V, windowed=0))
    assert ">= 1 pane" in _both_msgs(
        lambda: tdeg.degree_aggregate(N_V, windowed=0),
        lambda: degree_aggregate(N_V, windowed=0))
    assert "ttl_panes requires windowed" in _both_msgs(
        lambda: tagg.run_aggregation(
            tcc.connected_components(N_V, codec="dense"), _t(src, dst),
            ttl_panes=3),
        lambda: jrun(connected_components(N_V, codec="dense"), _j(src, dst),
                     ttl_panes=3))
    assert "TTL eviction hooks" in _both_msgs(
        lambda: tagg.run_aggregation(
            tcc.connected_components(N_V, codec="dense", windowed=2),
            _t(src, dst), ttl_panes=3, prefetch_depth=0, h2d_depth=0),
        lambda: jrun(connected_components(N_V, codec="dense", windowed=2),
                     _j(src, dst), ttl_panes=3, prefetch_depth=0,
                     h2d_depth=0))


def test_refuses_a_transient_plan_with_jax_message():
    from gelly_tpu.engine.aggregation import (
        SummaryAggregation as JAgg,
        run_aggregation as jrun,
    )

    src, dst = _zipf_stream()
    t_plan = tagg.SummaryAggregation(
        init=lambda d: torch.zeros(4), fold=lambda s, c: s,
        combine=lambda a, b: a, transient=True, name="t")
    j_plan = JAgg(init=lambda: None, fold=lambda s, c: s,
                  combine=lambda a, b: a, transient=True, name="t")
    assert "transient" in _both_msgs(
        lambda: tagg.run_aggregation(t_plan, _t(src, dst), windowed=2),
        lambda: jrun(j_plan, _j(src, dst), windowed=2))


# ---------------------------------------------------------------------- #
# pane-ring checkpoints across the packages


def _ckpt_plans(kind):
    from gelly_tpu.library.degrees import degree_aggregate

    jcc = importlib.import_module("gelly_tpu.library.connected_components")

    if kind == "compact":
        kw = dict(codec="compact", compact_capacity=N_V, windowed=3,
                  ttl_panes=4)
        return (lambda: tcc.connected_components(N_V, **kw),
                lambda: jcc.connected_components(N_V, **kw), _QUIET)
    if kind == "dense":
        kw = dict(merge="gather", codec="dense", windowed=3)
        return (lambda: tcc.connected_components(N_V, **kw),
                lambda: jcc.connected_components(N_V, **kw), {})
    return (lambda: tdeg.degree_aggregate(N_V, codec="sparse", windowed=3),
            lambda: degree_aggregate(N_V, codec="sparse", windowed=3), {})


@pytest.mark.parametrize("kind", ["compact", "dense", "degrees"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_ring_checkpoint_resumes_across_packages(tmp_path, kind, writer):
    from gelly_tpu.engine.aggregation import run_aggregation as jrun

    src, dst = _two_phase_stream()
    t_plan, j_plan, kw = _ckpt_plans(kind)
    me = 2
    full = [o.numpy().copy() for o in tagg.run_aggregation(
        t_plan(), _t(src, dst), merge_every=me, **kw)]
    ck = str(tmp_path / "win.npz")
    ck_kw = dict(merge_every=me, checkpoint_path=ck, checkpoint_every=1,
                 **kw)
    if writer == "torch":
        it = iter(tagg.run_aggregation(t_plan(), _t(src, dst), **ck_kw))
    else:
        it = iter(jrun(j_plan(), _j(src, dst), mesh=_mesh(), **ck_kw))
    for _ in range(5):
        next(it)
    it.close()
    if writer == "torch":
        rest = [np.asarray(o) for o in jrun(
            j_plan(), _j(src, dst), mesh=_mesh(), resume=True, **ck_kw)]
    else:
        rest = [o.numpy().copy() for o in tagg.run_aggregation(
            t_plan(), _t(src, dst), resume=True, **ck_kw)]
    assert 0 < len(rest) < len(full)
    for i, (got, want) in enumerate(zip(rest, full[-len(rest):])):
        assert np.array_equal(got, want), f"tail pane {i}"


def test_ring_checkpoint_leaves_equal_jax(tmp_path):
    from gelly_tpu.engine.aggregation import run_aggregation as jrun

    src, dst = _two_phase_stream()
    t_plan, j_plan, kw = _ckpt_plans("compact")
    files = []
    for name, run in (("t", lambda p: tagg.run_aggregation(
            t_plan(), _t(src, dst), merge_every=2, checkpoint_path=p, **kw)),
                      ("j", lambda p: jrun(
            j_plan(), _j(src, dst), merge_every=2, checkpoint_path=p,
            mesh=_mesh(), **kw))):
        p = str(tmp_path / f"{name}.npz")
        for _ in run(p):
            pass
        files.append(load_checkpoint(p))
    (tl, tpos, tmeta), (jl, jpos, jmeta) = files
    assert tpos == jpos and len(tl) == len(jl) == 5
    for name in ("windows", "ring_live", "windowed", "current_window"):
        assert tmeta[name] == jmeta[name]
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------- #
# kill -9 mid-stream (this file is the child)

KILL_EDGES = 48 * CH
KILL_WINDOW = 3


def _kill_source():
    rng = np.random.default_rng(21)
    src = (rng.zipf(1.4, KILL_EDGES) % N_V).astype(np.int64)
    dst = (rng.zipf(1.4, KILL_EDGES) % N_V).astype(np.int64)
    return src, dst


def child(ckpt: str, out: str, sleep_s: float) -> None:
    src, dst = _kill_source()
    agg = tcc.connected_components(N_V, codec="compact",
                                   compact_capacity=N_V,
                                   windowed=KILL_WINDOW, ttl_panes=4)
    if sleep_s:
        fold = agg.fold_compressed

        def slow(s, p):
            time.sleep(sleep_s)
            return fold(s, p)

        agg.fold_compressed = slow
    st = tagg.run_aggregation(agg, _t(src, dst), merge_every=2,
                              checkpoint_path=ckpt, checkpoint_every=1,
                              resume=os.path.exists(ckpt), **_QUIET)
    labels = None
    for labels in st:
        pass
    save_checkpoint(out, [labels, np.int64(st.stats["windows_closed"])],
                    position=0)


def _spawn(ckpt, out, sleep_s):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ckpt), str(out),
         str(sleep_s)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _wait(p, timeout=300):
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.faults
def test_windowed_kill9_resume_bit_identical(tmp_path):
    from gelly_torch.engine.checkpoint import read_checkpoint_header

    ckpt = tmp_path / "win-ck.npz"
    out_clean, out_resumed = tmp_path / "clean.npz", tmp_path / "res.npz"
    _wait(_spawn(tmp_path / "clean-ck.npz", out_clean, 0.0))
    p = _spawn(ckpt, out_resumed, 0.05)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if p.poll() is not None:
            pytest.fail(f"child exited early (rc={p.returncode})")
        try:
            if read_checkpoint_header(str(ckpt))["meta"]["windows"] >= 2:
                break
        except (FileNotFoundError, ValueError):
            pass
        time.sleep(0.01)
    else:
        pytest.fail("no checkpoint appeared before the deadline")
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=60) == -signal.SIGKILL
    p.stderr.close()
    assert not out_resumed.exists()
    header = read_checkpoint_header(str(ckpt))
    total = KILL_EDGES // CH
    assert 0 < header["position"] < total
    assert header["meta"]["windowed"] == KILL_WINDOW
    assert 0 < header["meta"]["ring_live"] <= KILL_WINDOW
    _wait(_spawn(ckpt, out_resumed, 0.0))
    resumed, _, _ = load_checkpoint(str(out_resumed))
    clean, _, _ = load_checkpoint(str(out_clean))
    assert len(resumed) == len(clean) == 2
    assert resumed[0].tobytes() == clean[0].tobytes()
    assert int(resumed[1]) == int(clean[1]) == total // 2


if __name__ == "__main__":
    child(sys.argv[1], sys.argv[2], float(sys.argv[3]))
