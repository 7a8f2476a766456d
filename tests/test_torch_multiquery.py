"""gelly_torch's fused multi-query engine vs gelly_tpu's (CPU).

Mirrors ``tests/test_multiquery.py`` at its sizes on the port (the library
quartet against standalone runs at every window, the per-query merge
window against the engine cadence, accumulating queries on S = 1, 2 and 4
shards, the ``fuse`` and ``run_aggregation`` refusals, the shared codec,
checkpoint resumes, live snapshots and the kill -9 child) and holds each
to ``gelly_tpu``: every emission at every window, every state leaf after
every chunk (``_step`` included), checkpoint files in both directions,
snapshots, the ``multiquery.*`` counters (on both packages' obs buses,
and the port's ``stream.stats`` view of them), the fold spans' per-query
attribution and the ``multiquery/<name>`` tracks, and every error text. Port-only: the spanner's in-place
combine never changes the state off a boundary or under merge-on-read, a
fused emission does not change when later folds run, the fused
``device_fields`` union, and fused states carried by ``convert``.

gelly_tpu runs on ``make_mesh(S)`` (the conftest's virtual CPU devices);
the port on ``device="cpu"``. Inputs are made from seeds with numpy.
Tolerance: none (dtype, shape and bytes of every leaf).

Child: ``python tests/test_torch_multiquery.py <ckpt> <out.npz>
[emit_sleep_s] [raw|codec]`` with the repository root on ``PYTHONPATH``.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_V = 96
CHUNK = 32
CHILD_EDGES = 1024


def _adversarial_edges():
    """Hot vertex + self-loops + an odd cycle + an even cycle + random
    pairs; slots >= 90 stay unseen (``tests/test_multiquery.py``'s)."""
    edges = [(1, 2), (2, 3), (3, 1)]
    edges += [(4, 5), (5, 6), (6, 7), (7, 4)]
    edges += [(0, 0), (9, 9)]
    edges += [(0, v) for v in range(20, 44)]
    rng = np.random.default_rng(41)
    edges += [(int(a), int(b)) for a, b in rng.integers(10, 90, (96, 2))]
    return edges


def _bipartite_adversarial_edges():
    edges = [(4, 5), (5, 6), (6, 7), (7, 4)]
    edges += [(0, v) for v in range(21, 44, 2)]
    rng = np.random.default_rng(43)
    a = rng.integers(5, 44, 64) * 2
    b = rng.integers(5, 44, 64) * 2 + 1
    edges += [(int(x), int(y)) for x, y in zip(a, b)]
    return edges


def _child_edges():
    rng = np.random.default_rng(29)
    return [(int(a), int(b)) for a, b in rng.integers(0, N_V, (CHILD_EDGES, 2))]


def _child_queries(compressed: bool):
    from gelly_torch.library import (
        bipartiteness_query,
        cc_query,
        degrees_query,
        spanner_query,
    )

    if compressed:
        return [cc_query(N_V, compressed=True, codec="sparse"),
                degrees_query(N_V, compressed=True, codec="sparse"),
                bipartiteness_query(N_V, compressed=True, codec="sparse")]
    return [cc_query(N_V), degrees_query(N_V),
            spanner_query(N_V, k=2, every=2)]


def child(ckpt: str, out: str, sleep_s: float, compressed: bool) -> None:
    """The kill -9 child: ``_multiquery_crash_child.py``'s run on the port
    (fold_batch=2, 2 codec workers, h2d_depth=2, a checkpoint a window)."""
    from gelly_torch import edge_stream_from_edges
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.engine.checkpoint import save_checkpoint, to_host, \
        tree_map

    res = run_aggregation(
        None, edge_stream_from_edges(_child_edges(), vertex_capacity=N_V,
                                     chunk_size=CHUNK, device="cpu"),
        queries=_child_queries(compressed), merge_every=2, fold_batch=2,
        checkpoint_path=ckpt, checkpoint_every=1,
        resume=os.path.exists(ckpt), codec_workers=2, h2d_depth=2)
    final = None
    for final in res:
        if sleep_s:
            time.sleep(sleep_s)  # the staging legs run ahead
    save_checkpoint(out, tree_map(to_host, final),
                    position=res.stats["chunks"])


if __name__ == "__main__":
    child(sys.argv[1], sys.argv[2],
          float(sys.argv[3]) if len(sys.argv) > 3 else 0.0,
          len(sys.argv) > 4 and sys.argv[4] == "codec")
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests (both packages)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gelly_torch import convert  # noqa: E402
from gelly_torch import edge_stream_from_edges as t_edges  # noqa: E402
from gelly_torch.engine import aggregation as tagg  # noqa: E402
from gelly_torch.engine import multiquery as tmq  # noqa: E402
from gelly_torch.engine.checkpoint import (  # noqa: E402
    load_checkpoint as t_load,
    read_checkpoint_header,
    tree_flatten,
)
from gelly_torch.library import (  # noqa: E402
    bipartiteness_query as t_bq,
    cc_query as t_cq,
    degrees_query as t_dq,
    spanner_query as t_sq,
)
from gelly_torch.library import connected_components as tcc  # noqa: E402
from gelly_torch import obs as t_obs  # noqa: E402
from gelly_torch.parallel import mesh as tmesh  # noqa: E402
from gelly_tpu import edge_stream_from_edges as j_edges  # noqa: E402
from gelly_tpu.engine import aggregation as jagg  # noqa: E402
from gelly_tpu.engine import multiquery as jmq  # noqa: E402
from gelly_tpu.engine.checkpoint import load_checkpoint as j_load  # noqa
from gelly_tpu.library.bipartiteness import \
    bipartiteness_query as j_bq  # noqa: E402
from gelly_tpu.library.connected_components import (  # noqa: E402
    cc_query as j_cq,
    connected_components as j_connected_components,
)
from gelly_tpu.library.degrees import degrees_query as j_dq  # noqa: E402
from gelly_tpu.library.spanner import spanner_query as j_sq  # noqa: E402
from gelly_tpu import obs as j_obs  # noqa: E402
from gelly_tpu.obs import bus as obs_bus  # noqa: E402
from gelly_tpu.parallel import mesh as jmesh  # noqa: E402

from _torch_native import load_jax_native  # noqa: E402

B = {"j": dict(cc=j_cq, degrees=j_dq, bipartiteness=j_bq, spanner=j_sq,
               run=jagg.run_aggregation, mq=jmq, Agg=jagg.SummaryAggregation),
     "t": dict(cc=t_cq, degrees=t_dq, bipartiteness=t_bq, spanner=t_sq,
               run=tagg.run_aggregation, mq=tmq, Agg=tagg.SummaryAggregation)}


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("chunk_combiner")


def _stream(pkg, edges=None, chunk=CHUNK):
    edges = edges if edges is not None else _adversarial_edges()
    if pkg == "j":
        return j_edges(edges, vertex_capacity=N_V, chunk_size=chunk)
    return t_edges(edges, vertex_capacity=N_V, chunk_size=chunk,
                   device="cpu")


def _kw(pkg, S=1, **over):
    kw = dict(ingest_workers=0, prefetch_depth=0, h2d_depth=0)
    if pkg == "j":
        kw["mesh"] = jmesh.make_mesh(S)
    elif S > 1:
        kw["mesh"] = tmesh.make_mesh(S, devices=["cpu"] * S)
    kw.update(over)
    return kw


def _quartet(pkg):
    b = B[pkg]
    return [b["cc"](N_V), b["degrees"](N_V), b["bipartiteness"](N_V),
            b["spanner"](N_V, k=2, every=2)]


def _codec_queries(pkg):
    b = B[pkg]
    return [b["cc"](N_V, compressed=True, codec="sparse"),
            b["degrees"](N_V, compressed=True, codec="sparse"),
            b["bipartiteness"](N_V, compressed=True, codec="sparse")]


def _run(pkg, queries=None, agg=None, edges=None, S=1, **kw):
    return B[pkg]["run"](agg, _stream(pkg, edges), queries=queries,
                         **_kw(pkg, S, **kw))


def _leaves(tree):
    """The host leaves of a tree of either package (``jax.tree`` order)."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_flatten(tree)[0]]


def _same(want, got, label):
    """Every leaf equal: dtype, shape and bytes (either package's tree)."""
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl), (label, len(wl), len(gl))
    for i, (w, g) in enumerate(zip(wl, gl)):
        assert w.dtype == g.dtype, (label, i, w.dtype, g.dtype)
        assert w.shape == g.shape, (label, i, w.shape, g.shape)
        assert w.tobytes() == g.tobytes(), f"{label}: leaf {i} diverged"


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return type(e), str(e)
    return None


def _same_error(make, match):
    """``make(pkg)`` raises the same error type and text in both
    packages, matching ``match``."""
    j, t = _error(lambda: make("j")), _error(lambda: make("t"))
    assert j is not None and t == j, (j, t)
    assert match in t[1], t


def _dummy(pkg, **over):
    if pkg == "j":
        kw = dict(init=lambda: jnp.zeros((4,), jnp.int32))
    else:
        kw = dict(init=lambda device="cpu": torch.zeros(4, dtype=torch.int32))
    kw.update(fold=lambda s, c: s, combine=lambda a, b: a + b, name="dummy")
    kw.update(over)
    return B[pkg]["Agg"](**kw)


# ---------------------------------------------------------------------- #
# the library quartet, window by window


def test_fused_quartet_equals_jax_and_standalone_at_every_window():
    jout = list(_run("j", _quartet("j"), merge_every=2))
    tout = list(_run("t", _quartet("t"), merge_every=2))
    assert len(tout) == len(jout) >= 2
    assert [sorted(x) for x in tout] == [
        ["bipartiteness", "cc", "degrees", "spanner"]] * len(tout)
    for i, (w, g) in enumerate(zip(jout, tout)):
        for name in w:
            _same(w[name], g[name], f"w{i}/{name}")
    for q in _quartet("t"):
        alone = list(_run("t", agg=q.agg, merge_every=2))
        assert len(alone) == len(tout)
        for i, (w, g) in enumerate(zip(alone, tout)):
            _same(w, g[q.name], f"alone w{i}/{q.name}")


def test_fused_state_equals_jax_after_every_chunk():
    # The fused fold driven chunk by chunk: every leaf of the state,
    # _step and the spanner's local/global included, and every emission.
    jplan, tplan = jmq.fuse(_quartet("j")), tmq.fuse(_quartet("t"))
    jfold, jtrans = jax.jit(jplan.fold), jax.jit(jplan.transform)
    js, ts = jplan.init(), tplan.init("cpu")
    _same(js, ts, "init")
    for i, (jc, tc) in enumerate(zip(_stream("j"), _stream("t"))):
        js, ts = jfold(js, jc), tplan.fold(ts, tc)
        _same(js, ts, f"state after chunk {i}")
        assert int(ts["_step"]) == i + 1
        _same(jtrans(js), tplan.transform(ts), f"emission after chunk {i}")


def test_fused_emission_matches_every_window_two_queries():
    names = ("cc", "degrees")
    out = {pkg: list(_run(pkg, [B[pkg][n](N_V) for n in names],
                          merge_every=2)) for pkg in "jt"}
    assert len(out["t"]) == len(out["j"])
    for n in names:
        alone = list(_run("t", agg=B["t"][n](N_V).agg, merge_every=2))
        for i, (a, f, w) in enumerate(zip(alone, out["t"], out["j"])):
            _same(a, f[n], f"{n}@{i}")
            _same(w[n], f[n], f"jax {n}@{i}")


@pytest.mark.parametrize("merge_every", [1, 3])
def test_per_query_merge_window_decouples_from_engine_cadence(merge_every):
    # The spanner's every=2 window fires at its own chunk cadence whatever
    # the engine's emission cadence.
    def fused(pkg):
        b = B[pkg]
        return _run(pkg, [b["cc"](N_V), b["spanner"](N_V, k=2, every=2)],
                    merge_every=merge_every).result()

    got = fused("t")
    want = _run("t", agg=t_sq(N_V, k=2, every=2).agg,
                merge_every=2).result()
    _same(want, got["spanner"], "spanner")
    _same(fused("j")["spanner"], got["spanner"], "jax spanner")


@pytest.mark.parametrize("S", [1, 2, 4])
def test_fused_accumulating_queries_on_shards(S):
    def fused(pkg):
        b = B[pkg]
        return list(_run(pkg, [b["cc"](N_V), b["degrees"](N_V),
                               b["bipartiteness"](N_V)],
                         S=S, merge_every=2))

    got, want = fused("t"), fused("j")
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        for n in w:
            _same(w[n], g[n], f"S={S} w{i}/{n}")
    one = list(_run("t", [t_cq(N_V), t_dq(N_V), t_bq(N_V)], merge_every=2))
    for i, (a, g) in enumerate(zip(one, got)):
        for n in ("cc", "degrees"):
            _same(a[n], g[n], f"S=1 vs S={S} w{i}/{n}")
        assert bool(a["bipartiteness"].ok) == bool(g["bipartiteness"].ok)
    for q in (t_cq(N_V), t_dq(N_V)):
        alone = _run("t", agg=q.agg, S=S, merge_every=2).result()
        _same(alone, got[-1][q.name], f"standalone S={S} {q.name}")


@pytest.mark.parametrize("S", [2, 4])
def test_fused_sharded_checkpoint_holds_jax_leaves(tmp_path, S):
    # The sharded fused global (every query's leaves and _step, the max
    # over the shards) in one file, equal to gelly_tpu's.
    files = {}
    for pkg in "jt":
        b = B[pkg]
        path = str(tmp_path / f"{pkg}.npz")
        _run(pkg, [b["cc"](N_V), b["degrees"](N_V)], S=S, merge_every=2,
             checkpoint_path=path).result()
        files[pkg] = path
    jl, jpos, _ = j_load(files["j"])
    tl, tpos, _ = t_load(files["t"])
    assert jpos == tpos
    _same(list(jl), list(tl), f"S={S} checkpoint")


# ---------------------------------------------------------------------- #
# refusals (type and text equal to gelly_tpu's)


def test_fuse_refuses_stateful_codec_plans():
    def compact(pkg):
        if pkg == "j":
            agg = j_connected_components(N_V, codec="compact",
                                         compact_capacity=N_V)
        else:
            agg = tcc.connected_components(N_V, codec="compact",
                                           compact_capacity=N_V)
        mq = B[pkg]["mq"]
        return mq.fuse([B[pkg]["cc"](N_V), mq.QuerySpec("compact", agg)])

    _same_error(compact, "GLOBAL STREAM order")
    _same_error(lambda p: B[p]["mq"].fuse([B[p]["mq"].QuerySpec(
        "ordered", _dummy(p, stack_ordered=True))]), "stack_ordered")
    _same_error(lambda p: B[p]["mq"].fuse([B[p]["mq"].QuerySpec(
        "codec", _dummy(p, requires_codec=True))]), "raw fold does not exist")
    _same_error(lambda p: B[p]["mq"].fuse([B[p]["mq"].QuerySpec(
        "codec", _dummy(p, requires_codec=True))], share_codec=False),
        "share_codec=False pins the raw path")


def test_fuse_refuses_transient_panes_and_host_transforms():
    def spec(p, **kw):
        return B[p]["mq"].QuerySpec("x", _dummy(p, **kw))

    _same_error(lambda p: B[p]["mq"].fuse([spec(p, transient=True)]),
                "transient")
    _same_error(lambda p: B[p]["mq"].fuse([spec(
        p, transform=lambda s: s, jit_transform=False)]), "host-side")

    def windowed(p):
        q = B[p]["degrees"](N_V)
        q.agg.windowed_panes = 2
        return B[p]["mq"].fuse([q])

    _same_error(windowed, "pane ring")


def test_fuse_refuses_mismatched_chunk_schemas():
    _same_error(lambda p: B[p]["mq"].fuse(
        [B[p]["cc"](64), B[p]["degrees"](128)]), "mismatched chunk schemas")


def test_fuse_refuses_bad_names_windows_and_nesting():
    def mq(p):
        return B[p]["mq"]

    _same_error(lambda p: mq(p).fuse([]), "at least one")
    _same_error(lambda p: mq(p).fuse([B[p]["cc"](N_V), B[p]["cc"](N_V)]),
                "duplicate")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec("_step", _dummy(p))]),
                "reserved")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec("", _dummy(p))]),
                "empty or reserved")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec("s", _dummy(p),
                                                      every=0)]), "every")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec(
        "acc", _dummy(p, fold_accumulates=True), every=2)]), "accumulates")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec(
        "outer", mq(p).fuse([B[p]["cc"](N_V)]))]), "nesting")
    _same_error(lambda p: mq(p).fuse([object()]), "cannot fuse object")
    _same_error(lambda p: mq(p).fuse([mq(p).QuerySpec("x", object())]),
                "agg must be a SummaryAggregation")
    _same_error(lambda p: mq(p).fuse([B[p]["cc"](N_V)], share_codec="yes"),
                "share_codec must be")
    _same_error(lambda p: mq(p).fuse([B[p]["cc"](N_V)], share_codec=1),
                "share_codec must be")
    # The accepted spellings name the plan as gelly_tpu does.
    for p in "jt":
        plan = mq(p).fuse([B[p]["cc"](N_V), ("deg", B[p]["degrees"](N_V).agg),
                           B[p]["bipartiteness"](N_V).agg])
        assert plan.query_names == ("cc", "deg", "bipartiteness-check")
        assert plan.name == "multiquery(cc+deg+bipartiteness-check)"
        assert mq(p).fuse([B[p]["cc"](N_V)], name="mine").name == "mine"


def test_run_aggregation_fused_arg_validation():
    def run(p, agg=None, queries=None, S=1, **kw):
        return _run(p, queries, agg=agg, S=S, **kw)

    _same_error(lambda p: run(p, _dummy(p), [B[p]["cc"](N_V)]), "not both")
    _same_error(lambda p: run(p), "required")
    _same_error(lambda p: run(p, queries=[B[p]["cc"](N_V)], window_ms=100),
                "merge_every-only")
    _same_error(lambda p: run(p, queries=[B[p]["cc"](N_V)],
                              host_precombine=lambda c: c),
                "host_precombine")
    _same_error(lambda p: run(p, queries=[B[p]["cc"](N_V),
                                          B[p]["spanner"](N_V, k=2)],
                              S=4, merge_every=2), "single-shard")
    _same_error(lambda p: run(p, queries=[B[p]["cc"](N_V)], windowed=2,
                              merge_every=2), "cannot carry a pane ring")


# ---------------------------------------------------------------------- #
# the shared codec


def test_fused_codec_one_payload_a_chunk_window_parity():
    # Every query's codec on: each chunk compressed once (counted), one
    # fold a chunk, every window equal to the raw fused run's and JAX's.
    edges = _bipartite_adversarial_edges()
    n_chunks = -(-len(edges) // CHUNK)
    raw = list(_run("t", [t_cq(N_V), t_dq(N_V), t_bq(N_V)], edges=edges,
                    merge_every=2))
    res = _run("t", _codec_queries("t"), edges=edges, merge_every=2)
    comp = list(res)
    with obs_bus.scope() as bus:
        jcomp = list(_run("j", _codec_queries("j"), edges=edges,
                          merge_every=2))
    assert len(raw) == len(comp) == len(jcomp) >= 2
    for i, (a, b, j) in enumerate(zip(raw, comp, jcomp)):
        for name in ("cc", "degrees", "bipartiteness"):
            _same(a[name], b[name], f"raw w{i}/{name}")
            _same(j[name], b[name], f"jax w{i}/{name}")
    jc = bus.snapshot()["counters"]["multiquery.compressed_chunks"]
    assert res.stats["multiquery.compressed_chunks"] == jc == n_chunks
    assert res.stats["units"] == n_chunks  # one fold a chunk


def test_fused_codec_compresses_once_a_chunk_on_the_bus():
    # The traced half of the codec-sharing test: one compress span and
    # one fold span a chunk (not a chunk times Q), and the bus's
    # multiquery.compressed_chunks counts the chunks, in both packages.
    edges = _bipartite_adversarial_edges()
    n_chunks = -(-len(edges) // CHUNK)
    got = {}
    for pkg, o in (("t", t_obs), ("j", j_obs)):
        tracer = o.SpanTracer()
        with o.scope() as bus, o.install(tracer):
            out = list(_run(pkg, _codec_queries(pkg), edges=edges,
                            merge_every=2))
        got[pkg] = (bus.snapshot()["counters"],
                    len(tracer.spans("compress")), len(tracer.spans("fold")),
                    len(out))
    counters, n_compress, n_fold, n_out = got["t"]
    assert counters["multiquery.compressed_chunks"] == n_chunks
    assert n_compress == n_fold == n_chunks
    assert got["t"][1:] == got["j"][1:]
    for key in ("multiquery.compressed_chunks", "engine.chunks_folded",
                "multiquery.emissions"):
        assert counters[key] == got["j"][0][key], key


@pytest.mark.parametrize("fold_batch", [1, 2])
def test_fused_codec_matches_standalone_codec_runs(fold_batch):
    kw = dict(merge_every=2, fold_batch=fold_batch)
    final = _run("t", _codec_queries("t"), **kw).result()
    jfinal = _run("j", _codec_queries("j"), **kw).result()
    for q in _codec_queries("t"):
        alone = _run("t", agg=q.agg, **kw).result()
        _same(alone, final[q.name], q.name)
        _same(jfinal[q.name], final[q.name], f"jax {q.name}")


@pytest.mark.parametrize("fold_batch", [1, 2])
def test_fused_codec_state_and_step_equal_jax(tmp_path, fold_batch):
    # The codec path's _step advances by each unit's widest batch.
    files = {}
    for pkg in "jt":
        path = str(tmp_path / f"{pkg}.npz")
        _run(pkg, _codec_queries(pkg), merge_every=2, fold_batch=fold_batch,
             checkpoint_path=path).result()
        files[pkg] = path
    jl, jpos, _ = j_load(files["j"])
    tl, tpos, _ = t_load(files["t"])
    assert jpos == tpos
    _same(list(jl), list(tl), "codec checkpoint")
    assert int(np.asarray(tl[0])) > 0  # "_step" sorts first


def test_fuse_share_codec_knob():
    for p in "jt":
        mq, b = B[p]["mq"], B[p]
        fused = mq.fuse(_codec_queries(p), share_codec=True)
        assert fused.host_compress is not None
        assert fused.fold_compressed is not None
        assert mq.fuse(_codec_queries(p), share_codec=False) \
            .host_compress is None
        mixed = mq.fuse([b["cc"](N_V, compressed=True, codec="sparse"),
                         b["degrees"](N_V)])
        assert mixed.host_compress is None
    _same_error(lambda p: B[p]["mq"].fuse(
        [B[p]["cc"](N_V, compressed=True, codec="sparse"),
         B[p]["spanner"](N_V, k=2, every=2)], share_codec=True),
        "share_codec=True")


def test_fused_payload_check_names_missing_queries():
    plans = {p: B[p]["mq"].fuse(_codec_queries(p)) for p in "jt"}
    chunk = next(iter(_stream("t")))
    payload = plans["t"].host_compress(chunk)
    assert sorted(payload) == ["bipartiteness", "cc", "degrees"]
    plans["t"].codec_payload_check(payload)
    _same_error(lambda p: plans[p].codec_payload_check({"cc": {}}),
                "missing per-query sub-payloads ['degrees', "
                "'bipartiteness']")
    bad = dict(payload, cc={"v": np.array([N_V], np.int32),
                            "r": np.array([0], np.int32)})
    _same_error(lambda p: plans[p].codec_payload_check(bad),
                "out of range for vertex_capacity")


# ---------------------------------------------------------------------- #
# checkpoints


@pytest.mark.parametrize("codec", [False, True], ids=["raw", "codec"])
def test_fused_checkpoint_resume_bit_identical(tmp_path, codec):
    # One position and every query's leaves (the step counter driving the
    # spanner's merge window included) in one file; a resumed run ends
    # bit-identical to the uninterrupted one, and to gelly_tpu's.
    def queries():
        return (_codec_queries("t") if codec
                else [t_cq(N_V), t_sq(N_V, k=2, every=2)])

    golden = _run("t", queries(), merge_every=2).result()
    ck = str(tmp_path / "mq.npz")
    it = iter(_run("t", queries(), merge_every=2, checkpoint_path=ck))
    next(it)
    next(it)  # the window-1 checkpoint lands when the generator resumes
    it.close()
    pos = read_checkpoint_header(ck)["position"]
    assert 0 < pos < len(list(_stream("t")))
    resumed = _run("t", queries(), merge_every=2, checkpoint_path=ck,
                   resume=True).result()
    jq = (_codec_queries("j") if codec
          else [j_cq(N_V), j_sq(N_V, k=2, every=2)])
    jgold = _run("j", jq, merge_every=2).result()
    for name in golden:
        _same(golden[name], resumed[name], name)
        _same(jgold[name], resumed[name], f"jax {name}")


@pytest.mark.parametrize("codec", [False, True], ids=["raw", "codec"])
@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")])
def test_fused_checkpoint_resumes_across_packages(tmp_path, writer, reader,
                                                  codec):
    # The quartet (or the codec trio) checkpointed at window 1 by one
    # package and resumed by the other: the file's leaves, and every
    # later emission, equal.
    def queries(pkg):
        return _codec_queries(pkg) if codec else _quartet(pkg)

    ck = str(tmp_path / "mq.npz")
    it = iter(_run(writer, queries(writer), merge_every=2,
                   checkpoint_path=ck))
    next(it)
    next(it)
    it.close()
    full = list(_run(writer, queries(writer), merge_every=2))
    resumed = list(_run(reader, queries(reader), merge_every=2,
                        checkpoint_path=ck, resume=True))
    assert len(resumed) == len(full) - 1
    for i, (w, g) in enumerate(zip(full[1:], resumed)):
        for name in w:
            _same(w[name], g[name], f"w{i + 1}/{name}")
    jl, _, _ = j_load(ck, like=jmq.fuse(queries("j")).init())
    tl, _, _ = t_load(ck, like=tmq.fuse(queries("t")).init("cpu"))
    _same(jl, tl, "loaded state")


def test_fused_state_carried_by_convert_both_ways():
    # gelly_tpu folds the first chunks, the port continues from the state
    # convert carries (the spanner's local/global and _step included), and
    # the port's state goes back to gelly_tpu.
    spec = {"cc": convert.cc_summary_from_numpy,
            "degrees": convert.degrees_from_numpy,
            "bipartiteness": convert.bipartite_summary_from_numpy,
            "spanner": convert.spanner_summary_from_numpy}
    jplan, tplan = jmq.fuse(_quartet("j")), tmq.fuse(_quartet("t"))
    jfold = jax.jit(jplan.fold)
    jchunks, tchunks = list(_stream("j")), list(_stream("t"))
    js = jplan.init()
    for c in jchunks[:3]:  # step 3: the spanner's window is open
        js = jfold(js, c)
    ts = convert.fused_state_from_numpy(
        spec, jax.tree.map(np.asarray, js), "cpu")
    _same(js, ts, "carried")
    for jc, tc in zip(jchunks[3:5], tchunks[3:5]):
        js, ts = jfold(js, jc), tplan.fold(ts, tc)
        _same(js, ts, "continued")
    host = convert.fused_state_to_numpy(ts)
    assert host["_step"].dtype == np.int64 and int(host["_step"]) == 5
    back = jax.tree.unflatten(jax.tree.structure(js), _leaves(ts))
    for jc, tc in zip(jchunks[5:], tchunks[5:]):
        back, ts = jfold(back, jc), tplan.fold(ts, tc)
    _same(back, ts, "back in gelly_tpu")
    with pytest.raises(ValueError, match="missing"):
        convert.fused_state_from_numpy(spec, {"_step": host["_step"]}, "cpu")
    with pytest.raises(TypeError, match="int64"):
        convert.fused_state_from_numpy(
            spec, dict(host, _step=np.int32(5)), "cpu")


# ---------------------------------------------------------------------- #
# port-only: the in-place combine, aliasing, device fields


@pytest.mark.parametrize("max_degree", [None, 8], ids=["dense", "sparse"])
def test_spanner_state_unchanged_off_boundary_and_by_transform(max_degree):
    # The port's spanner combines in place. Off a boundary the fused fold
    # must not touch `global` (local is the plain fold of the old local);
    # a transform (merge-on-read) must change no bit of the state.
    plan = tmq.fuse([t_cq(N_V), t_sq(N_V, k=2, every=3,
                                     max_degree=max_degree)])
    agg = plan.queries[1].agg
    chunks = list(_stream("t"))
    st = plan.init("cpu")
    for i, c in enumerate(chunks):
        before = tagg._clone_tree(st)
        want_local = agg.fold(tagg._clone_tree(st["spanner"]["local"]), c)
        st = plan.fold(st, c)
        if (i + 1) % 3:
            _same(before["spanner"]["global"], st["spanner"]["global"],
                  f"global off a boundary, chunk {i}")
            _same(want_local, st["spanner"]["local"], f"local, chunk {i}")
        else:
            _same(agg.init("cpu"), st["spanner"]["local"], "fresh local")
        held = tagg._clone_tree(st)
        plan.transform(st)
        _same(held, st, f"state after transform, chunk {i}")


def test_fused_emission_not_changed_by_later_folds():
    # The degree query has no transform: its emission is the running
    # vector, which later folds must not reach (transform_may_alias).
    res = iter(_run("t", [t_cq(N_V), t_dq(N_V), t_sq(N_V, k=2, every=2)],
                    merge_every=1))
    first = next(res)
    held = {n: tagg._clone_tree(first[n]) for n in first}
    rest = list(res)
    assert rest
    for n in first:
        _same(held[n], first[n], f"emission 0 / {n} after later folds")


def test_fused_device_fields_union():
    assert tmq.fuse([t_cq(N_V), t_bq(N_V)]).device_fields == (
        "src", "dst", "valid")
    assert tmq.fuse([t_cq(N_V), t_dq(N_V)]).device_fields == (
        "src", "dst", "event", "valid")
    assert tmq.fuse(_quartet("t")).device_fields == (
        "src", "dst", "event", "valid")
    assert tmq.fuse([t_cq(N_V), ("d", _dummy("t"))]).device_fields is None
    res = _run("t", [t_cq(N_V), t_dq(N_V)], merge_every=2)
    res.result()
    n_chunks = -(-len(_adversarial_edges()) // CHUNK)
    # i32 src/dst, i8 event, bool valid a lane.
    assert res.stats["h2d_bytes"] == n_chunks * CHUNK * 10


def test_builders_build_jax_specs():
    pairs = [(lambda b: b["cc"](N_V), None),
             (lambda b: b["cc"](N_V, name="c2", compressed=True,
                                codec="sparse"), None),
             (lambda b: b["degrees"](N_V, count_in=False), None),
             (lambda b: b["bipartiteness"](N_V, compressed=True), None),
             (lambda b: b["spanner"](N_V, 2, every=3, max_degree=8,
                                     gate_batch=16), None)]
    for make, _ in pairs:
        j, t = make(B["j"]), make(B["t"])
        assert (t.name, t.every, t.slot_capacity, t.accum) == (
            j.name, j.every, j.slot_capacity, j.accum)
        assert t.agg.name == j.agg.name
        assert (t.agg.host_compress is None) == (j.agg.host_compress is None)


# ---------------------------------------------------------------------- #
# live snapshots and the counters


def _drive_snapshots(res):
    """Each window: the snapshot handle, one query's snapshot and all of
    them; then an unknown query's error."""
    assert res.snapshot() is None and res.snapshot_window() == 0
    seen = []
    for i, out in enumerate(iter(res)):
        assert res.snapshot_window() == i + 1
        seen.append((out, res.snapshot("cc"), res.snapshot()))
    return seen, _error(lambda: res.snapshot("nope"))


def test_live_snapshots_one_window_staleness():
    with obs_bus.scope() as bus:
        jseen, jerr = _drive_snapshots(jmq.run_multiquery(
            [j_cq(N_V), j_dq(N_V)], _stream("j"), merge_every=2,
            **_kw("j")))
    res = tmq.run_multiquery([t_cq(N_V), t_dq(N_V)], _stream("t"),
                             merge_every=2, **_kw("t"))
    assert isinstance(res, tmq.MultiQueryStream)
    with t_obs.scope() as t_bus:
        seen, err = _drive_snapshots(res)
    assert err == jerr and "unknown query" in err[1]
    assert len(seen) == len(jseen) >= 2
    for i, ((out, cc, both), (_, jcc, jboth)) in enumerate(zip(seen, jseen)):
        assert isinstance(cc, np.ndarray)
        np.testing.assert_array_equal(cc, out["cc"].numpy())
        assert sorted(both) == ["cc", "degrees"]
        _same(jcc, cc, f"snapshot cc {i}")
        _same(jboth, both, f"snapshot {i}")
    counters = bus.snapshot()["counters"]
    st = res.stats
    t_counters = t_bus.snapshot()["counters"]
    for key in ("runs", "emissions", "snapshot_reads"):
        assert st[f"multiquery.{key}"] == counters[f"multiquery.{key}"] \
            == t_counters[f"multiquery.{key}"], key
    assert t_bus.gauges["multiquery.fused_queries"] == 2
    assert st["multiquery.runs"] == 1
    assert st["multiquery.emissions"] == 2 * len(seen)
    assert st["multiquery.fused_queries"] == \
        bus.gauges["multiquery.fused_queries"] == 2
    assert len(st["multiquery.emit_ms"]) == len(seen)
    # A second run of the stream counts on, as the bus does.
    res.result()
    assert st["multiquery.runs"] == 2


def test_fold_spans_carry_per_query_attribution(tmp_path):
    queries = [t_cq(N_V), t_dq(N_V)]
    tracer = t_obs.SpanTracer()
    with t_obs.scope() as bus, t_obs.install(tracer):
        windows = len(list(_run("t", queries, merge_every=2)))
    folds = tracer.spans("fold")
    assert folds and all(
        s["args"]["queries"] == "cc,degrees" for s in folds
    )
    # one per-query track span per window close
    per_query = {}
    for s in tracer.spans("multiquery"):
        assert s["track"] == f"multiquery/{s['args']['query']}"
        per_query.setdefault(s["args"]["query"], []).append(
            s["args"]["window"])
    assert sorted(per_query) == ["cc", "degrees"]
    assert all(v == list(range(1, windows + 1))
               for v in per_query.values())
    path = str(tmp_path / "trace.json")
    trace = t_obs.write_chrome_trace(path, tracer, bus=bus)
    t_obs.validate_chrome_trace(trace)
    # The same run in gelly_tpu: the same fold and query spans.
    j_tracer = j_obs.SpanTracer()
    with j_obs.scope(), j_obs.install(j_tracer):
        assert len(list(_run("j", [j_cq(N_V), j_dq(N_V)],
                             merge_every=2))) == windows

    def key(tr, stage):
        return sorted((s["track"], s["args"].get("unit"),
                       s["args"].get("queries"), s["args"].get("query"),
                       s["args"].get("window")) for s in tr.spans(stage))

    for stage in ("fold", "multiquery"):
        assert key(tracer, stage) == key(j_tracer, stage), stage


def test_stream_aggregate_with_queries():
    for p in "jt":
        out = _stream(p).aggregate(None, queries=[B[p]["cc"](N_V)],
                                   **_kw(p, merge_every=2))
        assert type(out).__name__ == "MultiQueryStream"
    got = _stream("t").aggregate(None, queries=[t_cq(N_V)],
                                 **_kw("t", merge_every=2)).result()
    want = _stream("j").aggregate(None, queries=[j_cq(N_V)],
                                  **_kw("j", merge_every=2)).result()
    _same(want["cc"], got["cc"], "cc")


# ---------------------------------------------------------------------- #
# kill -9


def _spawn(ckpt, out, sleep_s, mode):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ckpt), str(out),
         str(sleep_s), mode],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _wait(p, timeout=300):
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.slow
@pytest.mark.faults
@pytest.mark.parametrize("mode", ["raw", "codec"])
def test_fused_kill9_resume_bit_identical(tmp_path, mode):
    ckpt = tmp_path / "mq-ck.npz"
    out_clean = tmp_path / "clean.npz"
    out_resumed = tmp_path / "resumed.npz"
    _wait(_spawn(tmp_path / "clean-ck.npz", out_clean, 0.0, mode))
    p = _spawn(ckpt, out_resumed, 0.05, mode)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if p.poll() is not None:
            pytest.fail(f"child exited early (rc={p.returncode})")
        if ckpt.exists():
            break
        time.sleep(0.02)
    else:
        pytest.fail("no checkpoint appeared before the deadline")
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=60) == -signal.SIGKILL
    assert not out_resumed.exists()
    pos = read_checkpoint_header(str(ckpt))["position"]
    assert 0 < pos < -(-CHILD_EDGES // CHUNK)
    _wait(_spawn(ckpt, out_resumed, 0.0, mode))
    resumed, _, _ = t_load(str(out_resumed))
    clean, _, _ = t_load(str(out_clean))
    assert len(resumed) == len(clean)
    for r, c in zip(resumed, clean):
        assert r.dtype == c.dtype and r.tobytes() == c.tobytes()
