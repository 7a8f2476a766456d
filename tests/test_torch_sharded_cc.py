"""gelly_torch's CC on a mesh vs gelly_tpu's on ``make_mesh(S)`` (CPU).

Two halves, on the port's S CPU shards against gelly_tpu on the
conftest's 8 virtual devices:

- the engine's sharded plans: the raw, dense, sparse and compact CC plans
  under the replicated (butterfly), gather, tree and dirty-delta merges,
  every emission and ``stats["merge_modes"]``; a raw chunk whose shard
  slices reach ``RAW_DEDUP_MIN_CHUNK`` takes the dedup fold (its gather
  kernel's plain version here); checkpoints of a 4-shard run written by
  one package and resumed by the other, both ways; the engine's ``[S]``
  locals carried from gelly_tpu's fold and merged by the port;
- ``ShardedCC`` (mirrors ``tests/test_sharded_cc.py``): labels after every
  fold AND the striped parent forests, the sparse and dense emission
  pulls, the valid mask, refusals, and state carried across packages
  mid-stream with ``convert``.

Inputs are made from a seed with numpy. Tolerance: exact equality, dtype
included.
"""

import importlib

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import connected_components as tcc
from gelly_torch.parallel import collectives as tcol
from gelly_torch.parallel import mesh as tmesh
from gelly_torch.parallel.sharded_cc import ShardedCC as TShardedCC
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.engine.aggregation import _compiled_plan
from gelly_tpu.parallel import mesh as jmesh
from gelly_tpu.parallel.sharded_cc import ShardedCC as JShardedCC

jcc = importlib.import_module("gelly_tpu.library.connected_components")

N = 1 << 10
CHUNK = 256


def _tm(S):
    return tmesh.make_mesh(S, devices=["cpu"] * S)


def _zipf(seed=3, e=2000, n=N):
    rng = np.random.default_rng(seed)
    return ((rng.zipf(1.3, e) % n).astype(np.int32),
            (rng.zipf(1.3, e) % n).astype(np.int32))


def _streams(src, dst, n=N, chunk=CHUNK):
    return (j_stream(JSource(src, dst, chunk_size=chunk,
                             table=JIdentity(n)), n),
            t_stream(TSource(src, dst, chunk_size=chunk,
                             table=TIdentity(n)), n, device="cpu"))


def _both(S, build, run_kw, seed=3):
    src, dst = _zipf(seed)
    js_, ts_ = _streams(src, dst)
    jr = js_.aggregate(build(jcc), mesh=jmesh.make_mesh(S), **run_kw)
    want = [np.asarray(x) for x in jr]
    tr = ts_.aggregate(build(tcc), mesh=_tm(S), **run_kw)
    got = [x.numpy() for x in tr]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return jr, tr


PLANS = {
    "raw": (lambda m, mode: m.connected_components(
        N, ingest_combine=False, merge_mode=mode), dict(merge_every=2)),
    "raw-gather": (lambda m, mode: m.connected_components(
        N, merge="gather", ingest_combine=False, merge_mode=mode),
        dict(merge_every=2, fold_batch=2)),
    "dense": (lambda m, mode: m.connected_components(
        N, codec="dense", merge_mode=mode),
        dict(merge_every=4, fold_batch=2)),
    "sparse": (lambda m, mode: m.connected_components(
        N, codec="sparse", merge_mode=mode),
        dict(merge_every=4, fold_batch=4)),
    "compact": (lambda m, mode: m.connected_components(
        N, codec="compact", compact_capacity=N, merge_mode=mode),
        dict(merge_every=8, fold_batch=8)),
}


CASES = [(plan, 2, "replicated") for plan in sorted(PLANS)] + [
    (plan, 8, "delta") for plan in sorted(PLANS)] + [
    ("raw", 1, "replicated"), ("raw", 2, "delta"), ("raw", 4, "replicated"),
    ("raw", 4, "delta"), ("raw", 8, "replicated"), ("compact", 4, "delta")]


@pytest.mark.parametrize("plan,S,mode", CASES)
def test_cc_plans_on_mesh_equal_jax(S, plan, mode):
    build, run_kw = PLANS[plan]
    jr, tr = _both(S, lambda m: build(m, mode), run_kw)
    assert tr.stats["merge_modes"] == jr.stats["merge_modes"]
    if S > 1 and mode == "delta":
        assert tr.stats["merge_modes"]["delta"] > 0


@pytest.mark.parametrize("rows", [None, 1 << 12, 0])
def test_auto_merge_crossover_equal_jax(rows, S=8):
    # None: the n/4 = 256-row bound is below S * 256, so the delta merge
    # is never armed; 4096 rows: delta while S * bucket fits; 0: never.
    # merge_modes must count the same windows.
    jr, tr = _both(S, lambda m: m.connected_components(
        N, ingest_combine=False, merge_mode="auto", delta_auto_rows=rows),
        dict(merge_every=2))
    assert tr.stats["merge_modes"] == jr.stats["merge_modes"]


def test_raw_fold_takes_dedup_path_per_shard(monkeypatch):
    # 512-lane chunks on 2 shards: each shard folds 256 lanes, which is
    # the lowered threshold, so both packages take union_edges_dedup on
    # each shard (gelly_tpu reads the shard's capacity inside shard_map).
    calls = []
    from gelly_torch.ops import unionfind as tuf

    real = tuf.union_edges_dedup
    monkeypatch.setattr(jcc, "RAW_DEDUP_MIN_CHUNK", 256)
    monkeypatch.setattr(tcc, "RAW_DEDUP_MIN_CHUNK", 256)
    monkeypatch.setattr(tuf, "union_edges_dedup", lambda *a, **k: (
        calls.append(a[1].shape[0]), real(*a, **k))[1])
    src, dst = _zipf(5, 3000)
    for backend, jbackend in (("kernel", "pallas"), ("plain", "xla")):
        js_, ts_ = _streams(src, dst, chunk=512)
        want = [np.asarray(x) for x in js_.aggregate(
            jcc.connected_components(N, ingest_combine=False,
                                     fold_backend=jbackend),
            mesh=jmesh.make_mesh(2), merge_every=2)]
        got = [x.numpy() for x in ts_.aggregate(
            tcc.connected_components(N, ingest_combine=False,
                                     fold_backend=backend),
            mesh=_tm(2), merge_every=2)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert calls and set(calls) == {256}


@pytest.mark.parametrize("degree", [1, 2, 4])
def test_tree_merge_on_four_shards_equal_jax(degree):
    jr, tr = _both(4, lambda m: m.connected_components_tree(N, degree),
                   dict(merge_every=2))
    assert tr.stats["merge_modes"] == jr.stats["merge_modes"]


def test_event_time_codec_on_mesh_equal_jax():
    # window_ms with a codec: each masked chunk splits into S host slices
    # (split_chunk_host), one payload row a shard.
    rng = np.random.default_rng(8)
    src, dst = _zipf(8, 1200)
    ts = np.sort(rng.integers(0, 1200, src.shape[0])).astype(np.int64)
    from gelly_torch.core.io import TimeCharacteristic as TT
    from gelly_tpu.core.io import TimeCharacteristic as JT

    for codec in ("sparse", "compact"):
        js_ = j_stream(JSource(src, dst, timestamps=ts, time=JT.EVENT,
                               chunk_size=CHUNK, table=JIdentity(N)), N)
        ts_ = t_stream(TSource(src, dst, timestamps=ts, time=TT.EVENT,
                               chunk_size=CHUNK, table=TIdentity(N)), N,
                       device="cpu")
        kw = dict(compact_capacity=N) if codec == "compact" else {}
        want = [np.asarray(x) for x in js_.aggregate(
            jcc.connected_components(N, codec=codec, **kw),
            mesh=jmesh.make_mesh(4), window_ms=300)]
        got = [x.numpy() for x in ts_.aggregate(
            tcc.connected_components(N, codec=codec, **kw),
            mesh=_tm(4), window_ms=300)]
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_checkpoint_resumes_across_packages(tmp_path, writer):
    # A 4-shard run checkpoints every window (the global summary, after
    # the cadenced flatten); the consumer stops after emission 2, and the
    # other package resumes on its own 4-shard mesh.
    src, dst = _zipf(11, 3000)
    path = str(tmp_path / "cc.npz")
    js_, ts_ = _streams(src, dst)
    full = [np.asarray(x) for x in js_.aggregate(
        jcc.connected_components(N, codec="sparse", merge_mode="delta"),
        mesh=jmesh.make_mesh(4), merge_every=4, fold_batch=4)]
    kw = dict(merge_every=4, fold_batch=4, checkpoint_path=path)
    first = (js_.aggregate(jcc.connected_components(
        N, codec="sparse", merge_mode="delta"), mesh=jmesh.make_mesh(4),
        **kw) if writer == "jax" else ts_.aggregate(
        tcc.connected_components(N, codec="sparse", merge_mode="delta"),
        mesh=_tm(4), **kw))
    it = iter(first)
    for i in range(3):
        e = next(it)
        np.testing.assert_array_equal(np.asarray(e), full[i])
    it.close()
    if writer == "jax":
        rest = [x.numpy() for x in ts_.aggregate(
            tcc.connected_components(N, codec="sparse", merge_mode="delta"),
            mesh=_tm(4), resume=True, **kw)]
    else:
        rest = [np.asarray(x) for x in js_.aggregate(
            jcc.connected_components(N, codec="sparse", merge_mode="delta"),
            mesh=jmesh.make_mesh(4), resume=True, **kw)]
    assert len(rest) == len(full) - 2
    for a, b in zip(rest, full[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_jax_locals_merge_in_the_port(S):
    # gelly_tpu's [S]-sharded locals after one sharded fold, carried as
    # numpy [S, ...] to the port's per-shard summaries: the port's
    # butterfly and gather merges equal gelly_tpu's merge_locals.
    from gelly_tpu import make_chunk

    src, dst = _zipf(13, 512)
    for merge in ("tree", "gather"):
        jagg = jcc.connected_components(N, merge=merge, ingest_combine=False)
        m = jmesh.make_mesh(S)
        fold_step, merge_locals, _, locals0 = _compiled_plan(jagg, m)[:4]
        loc = fold_step(locals0(), make_chunk(src, dst))
        want = merge_locals(loc)
        stacked = [np.asarray(x) for x in loc]
        shards = convert.sharded_summaries_from_numpy(
            convert.cc_summary_from_numpy, _tm(S), *stacked)
        back = convert.sharded_summaries_to_numpy(
            convert.cc_summary_to_numpy, shards)
        for a, b in zip(back, stacked):
            np.testing.assert_array_equal(a, b)
        tagg = tcc.connected_components(N, merge=merge, ingest_combine=False)
        if merge == "gather":
            got = tcol.gather_merge(tagg.merge_stacked, shards, _tm(S),
                                    keep=(0,))[0]
        else:
            got = tcol.butterfly_merge(tagg.combine, shards, S, _tm(S),
                                       keep=(0,))[0]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------- #
# ShardedCC (mirrors tests/test_sharded_cc.py)

NV = 512


def _pairs(n_e, seed, n_v=NV):
    rng = np.random.default_rng(seed)
    return ((rng.zipf(1.4, n_e) % n_v).astype(np.int32),
            (rng.zipf(1.4, n_e) % n_v).astype(np.int32))


def _same_state(jc, tc):
    np.testing.assert_array_equal(
        convert.shards_to_numpy(tc.parent), np.asarray(jc.parent))
    np.testing.assert_array_equal(
        convert.shards_to_numpy(tc.seen), np.asarray(jc.seen))


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_cc_every_fold_equals_jax(S):
    jc = JShardedCC(NV, mesh=jmesh.make_mesh(S))
    tc = TShardedCC(NV, mesh=_tm(S))
    alla, allb = [], []
    for i, seed in enumerate([3, 4, 5]):
        a, b = _pairs(300, seed)
        alla.append(a)
        allb.append(b)
        jc.fold(a, b)
        tc.fold(a, b)
        _same_state(jc, tc)
        got = tc.labels()
        np.testing.assert_array_equal(got, jc.labels())
        np.testing.assert_array_equal(got, jcc.cc_labels_numpy(
            np.concatenate(alla), np.concatenate(allb), None, NV))
        np.testing.assert_array_equal(
            convert.shards_to_numpy(tc.dirty), np.asarray(jc.dirty))
    assert tc.stats["dropped"] == jc.stats["dropped"] == 0
    assert tc.stats["rounds"] > 0 and tc.stats["chase_levels"] > 0


@pytest.mark.parametrize("S", [4])
def test_sharded_cc_sparse_delta_pull_equals_jax(S):
    # At 2^14 slots with small folds every emission after the first takes
    # the compacted pull; a root-lowering hook at window 3.
    n = 1 << 14
    jc = JShardedCC(n, mesh=jmesh.make_mesh(S))
    tc = TShardedCC(n, mesh=_tm(S))
    rng = np.random.default_rng(77)
    for w in range(5):
        if w == 3:
            a, b = np.array([1], np.int64), np.array([n - 1], np.int64)
        elif w == 4:
            a = b = np.empty(0, np.int64)
        else:
            a, b = rng.integers(n // 2, n, (2, 200))
        if a.size:
            jc.fold(a, b)
            tc.fold(a, b)
        np.testing.assert_array_equal(tc.labels(), jc.labels())
        _same_state(jc, tc)
    assert tc.pull_buckets and tc.stats["emissions_sparse"] > 0


def test_sharded_cc_valid_mask_refusals_and_stripes():
    a = np.array([0, 9, 17, 33], np.int32)
    b = np.array([9, 17, 99, 207], np.int32)
    ok = np.array([True, True, False, True])
    jc = JShardedCC(NV, mesh=jmesh.make_mesh(8))
    tc = TShardedCC(NV, mesh=_tm(8))
    jc.fold(a, b, ok)  # 4 pairs pad unevenly across 8 shards
    tc.fold(a, b, ok)
    np.testing.assert_array_equal(tc.labels(), jc.labels())
    assert [p.shape for p in tc.parent] == [(NV // 8,)] * 8
    assert tc.per_device_state_bytes() == jc.per_device_state_bytes()
    for args in ((NV + 3,), ):
        errs = []
        for cls, m in ((JShardedCC, jmesh.make_mesh(8)),
                       (TShardedCC, _tm(8))):
            with pytest.raises(ValueError) as e:
                cls(*args, mesh=m)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    errs = []
    for cc in (jc, tc):
        with pytest.raises(ValueError) as e:
            cc.fold(np.array([0]), np.array([NV]))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_sharded_cc_state_carries_across_packages():
    # JAX folds two batches, the port continues from its state (and the
    # port's state goes back to JAX): every later emission equal.
    m8 = jmesh.make_mesh(8)
    jc = JShardedCC(NV, mesh=m8)
    for seed in (20, 21):
        jc.fold(*_pairs(200, seed))
    jc.labels()
    jc.fold(*_pairs(200, 22))  # dirty rows pending at the handover
    tc = TShardedCC(NV, mesh=_tm(8))
    convert.sharded_cc_from_numpy(tc, **convert.sharded_cc_to_numpy(jc))
    for seed in (23, 24):
        jc.fold(*_pairs(200, seed))
        tc.fold(*_pairs(200, seed))
        np.testing.assert_array_equal(tc.labels(), jc.labels())
        _same_state(jc, tc)
    # Back: the port's state into a fresh JAX instance.
    tc.fold(*_pairs(200, 25))
    state = convert.sharded_cc_to_numpy(tc)
    jc2 = JShardedCC(NV, mesh=m8)
    sh = NamedSharding(m8, P("shards"))
    jc2.parent, jc2.seen, jc2.dirty = (jax.device_put(state[k], sh)
                                       for k in ("parent", "seen", "dirty"))
    jc2._rootcache, jc2._seencache = state["rootcache"], state["seencache"]
    np.testing.assert_array_equal(jc2.labels(), tc.labels())
