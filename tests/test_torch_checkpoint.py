"""gelly_torch checkpoints and exactly-once resume vs gelly_tpu (CPU).

Mirrors ``tests/test_checkpoint.py`` case for case on the port, then holds
the port to ``gelly_tpu`` across the two packages: files written by either
load in the other, a run either package checkpointed at window k resumes
in the other, and the cadenced ``flatten`` leaves the same forests. The
same seeded Zipf stream goes into both packages; gelly_tpu runs on a
one-device mesh. Tolerance: exact equality, dtype included.
"""

import importlib
import json
import os
import zlib
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from gelly_torch import edge_stream_from_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.engine import checkpoint as tck
from gelly_torch.engine.checkpoint import (
    CHECKPOINT_VERSION,
    CheckpointCorruptError,
    load_checkpoint,
    read_checkpoint_header,
    save_checkpoint,
)
from gelly_torch.library import connected_components as tcc
from gelly_torch.library.connected_components import (
    CCSummary,
    connected_components,
    labels_to_components,
)
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.engine import checkpoint as jck
from gelly_tpu.parallel.mesh import make_mesh

jcc = importlib.import_module("gelly_tpu.library.connected_components")

CC_EDGES = [(1, 2), (1, 3), (2, 3), (1, 5), (6, 7), (8, 9)]
CC_EXPECTED = [[1, 2, 3, 5], [6, 7], [8, 9]]


def _edges_stream(edges, n=64, chunk=2, **kw):
    return edge_stream_from_edges(
        [(a, b, 1.0) for a, b in edges], vertex_capacity=n,
        chunk_size=chunk, device="cpu", **kw)


# ---------------------------------------------------------------------- #
# tests/test_checkpoint.py, case for case


def test_save_load_roundtrip(tmp_path):
    agg = connected_components(32)
    s = agg.init("cpu")
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, s, position=7, meta={"k": "v"})
    loaded, pos, meta = load_checkpoint(p, like=agg.init("cpu"))
    assert pos == 7 and meta == {"k": "v"}
    assert isinstance(loaded, CCSummary)
    assert isinstance(loaded.parent, torch.Tensor)
    assert loaded.parent.device.type == "cpu"
    assert torch.equal(loaded.parent, s.parent)
    assert torch.equal(loaded.seen, s.seen)


def test_resume_continues_cc(tmp_path):
    p = str(tmp_path / "cc.npz")
    s1 = _edges_stream(CC_EDGES)
    agg = connected_components(64)
    final = s1.aggregate(agg, merge_every=1, checkpoint_path=p).result()
    assert labels_to_components(final, s1.ctx) == CC_EXPECTED
    # Every chunk already consumed: the stored summary alone is the result.
    resumed = _edges_stream(CC_EDGES).aggregate(
        agg, merge_every=1, checkpoint_path=p, resume=True).result()
    assert resumed is None  # nothing left to fold; no emission
    _, pos, meta = load_checkpoint(p, like=agg.init("cpu"))
    assert pos == 3 and meta["windows"] == 3


def test_resume_midstream_matches_full_run(tmp_path):
    p = str(tmp_path / "cc_mid.npz")
    agg = connected_components(64)
    _edges_stream(CC_EDGES[:4]).aggregate(
        agg, merge_every=1, checkpoint_path=p).result()
    # Resume over the full stream: chunks 1-2 skipped, chunk 3 folded.
    s2 = _edges_stream(CC_EDGES)
    final = s2.aggregate(agg, merge_every=1, checkpoint_path=p,
                         resume=True).result()
    assert labels_to_components(final, s2.ctx) == CC_EXPECTED


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_checkpoint_is_chunk_consistent_at_every_prefix(tmp_path, cut):
    # Interrupt after every prefix of the stream: resume never loses or
    # repeats an edge. (gelly_tpu's case also runs event-time windows,
    # which the port has not ported yet.)
    edges = [(1, 2), (2, 3), (4, 5), (5, 6), (7, 8), (8, 9), (1, 9)]
    agg = connected_components(32)
    full = _edges_stream(edges, n=32)
    expected = labels_to_components(
        full.aggregate(agg, merge_every=1).result(), full.ctx)
    p = str(tmp_path / f"w{cut}.npz")
    for _ in _edges_stream(edges[:2 * cut], n=32).aggregate(
            agg, merge_every=1, checkpoint_path=p):
        pass
    s2 = _edges_stream(edges, n=32)
    resumed = s2.aggregate(agg, merge_every=1, checkpoint_path=p,
                           resume=True).result()
    assert labels_to_components(resumed, s2.ctx) == expected


def test_resume_midstream_codec_batched_plan(tmp_path):
    # The default CC plan at depth: the ingest codec with fold_batch > 1
    # and a multi-chunk cadence; the prefix run ends mid-window, so resume
    # re-enters mid-cadence.
    p = str(tmp_path / "cc_codec.npz")
    rng = np.random.default_rng(41)
    n_v, n_e = 256, 3000
    edges = [(int(a), int(b)) for a, b in rng.integers(0, n_v, (n_e, 2))]

    def stream(upto=None):
        return _edges_stream(edges[:upto], n=n_v, chunk=128)

    agg = connected_components(n_v)
    kw = dict(merge_every=4, fold_batch=4)
    want_stream = stream()
    want = labels_to_components(
        want_stream.aggregate(agg, **kw).result(), want_stream.ctx)
    stream(14 * 128).aggregate(agg, checkpoint_path=p, **kw).result()
    _, pos, _ = load_checkpoint(p, like=agg.init("cpu"))
    assert pos == 14
    s2 = stream()
    final = s2.aggregate(agg, checkpoint_path=p, resume=True, **kw).result()
    assert labels_to_components(final, s2.ctx) == want


def _rewrite_header(path, mutate):
    """Load a checkpoint npz, apply ``mutate(header_dict, arrays)``, rewrite."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__header__"}
    mutate(header, arrays)
    with open(path, "wb") as f:
        np.savez(f, __header__=np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8
        ), **arrays)


@pytest.mark.parametrize("like,match", [
    ({"a": np.zeros(16, np.int32)}, "shape"),
    ({"a": np.zeros(8, np.int64)}, "dtype"),
    ({"a": torch.zeros(16, dtype=torch.int32)}, "shape"),
    ({"a": torch.zeros(8, dtype=torch.int64)}, "dtype"),
])
def test_load_rejects_wrong_leaf(tmp_path, like, match):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": np.zeros(8, np.int32)}, position=1)
    with pytest.raises(CheckpointCorruptError, match=match):
        load_checkpoint(p, like=like)


def test_load_rejects_bad_position(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": np.zeros(4)}, position=3)
    for bad in (-5, 2 ** 60, "7", None):
        _rewrite_header(
            p, lambda h, a, b=bad: h.__setitem__("position", b)
        )
        with pytest.raises(CheckpointCorruptError, match="position"):
            load_checkpoint(p)
    with pytest.raises(ValueError, match="position"):
        save_checkpoint(p, {"a": np.zeros(4)}, position=-1)


def test_load_detects_bitrot_via_crc(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": torch.arange(32)}, position=2)

    def flip(h, arrays):
        arrays["leaf_0"] = arrays["leaf_0"].copy()
        arrays["leaf_0"][5] ^= 1  # single bit flip, shape/dtype intact
    _rewrite_header(p, flip)
    with pytest.raises(CheckpointCorruptError, match="CRC"):
        load_checkpoint(p)


def test_load_detects_torn_file(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": torch.arange(1024)}, position=2)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    for read in (load_checkpoint, read_checkpoint_header):
        with pytest.raises(CheckpointCorruptError, match="torn"):
            read(p)


def test_load_rejects_future_version(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": np.zeros(4)}, position=0)
    _rewrite_header(
        p, lambda h, a: h.__setitem__("version", CHECKPOINT_VERSION + 1)
    )
    with pytest.raises(CheckpointCorruptError, match="version"):
        load_checkpoint(p)


def test_v1_checkpoint_without_crc_still_loads(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": np.arange(4, dtype=np.int32)}, position=5)

    def strip_v2(h, a):
        del h["version"]
        del h["crc32"]
    _rewrite_header(p, strip_v2)
    loaded, pos, _ = load_checkpoint(
        p, like={"a": torch.zeros(4, dtype=torch.int32)}
    )
    assert pos == 5
    assert torch.equal(loaded["a"], torch.arange(4, dtype=torch.int32))


def test_crc_roundtrip_matches_manual(tmp_path):
    p = str(tmp_path / "c.npz")
    arr = np.arange(16, dtype=np.float32)
    header = save_checkpoint(p, [torch.from_numpy(arr)], position=0)
    with np.load(p) as z:
        on_disk = json.loads(bytes(z["__header__"]).decode())
    assert on_disk == header
    assert header["version"] == CHECKPOINT_VERSION
    assert header["crc32"] == [zlib.crc32(arr.tobytes())]


def test_snapshot_copies_cpu_state(tmp_path):
    # The host copy must not alias a CPU tensor a later fold writes.
    state = {"a": torch.zeros(4, dtype=torch.int32)}
    host = tck.tree_map(tck.to_host, state)
    state["a"].fill_(7)
    assert host["a"].tolist() == [0, 0, 0, 0]


# ---------------------------------------------------------------------- #
# the tree order and the file format against gelly_tpu


class _Pair(NamedTuple):
    x: object
    y: object


TREES = {
    "namedtuple": lambda: _Pair(np.arange(3, dtype=np.int32),
                                np.ones(2, bool)),
    "nested-dict": lambda: {"b": np.arange(2.0), "a": {
        "z": np.int64(5), "c": [np.zeros(1, np.int8), None,
                                (np.arange(4), np.float32(2.5))]}},
    "list": lambda: [np.arange(5, dtype=np.int64), np.zeros((2, 3))],
    "scalar": lambda: np.int64(9),
    "cc-summary": lambda: jcc.CCSummary(
        np.arange(8, dtype=np.int32), np.arange(8) % 2 == 0),
}


def _torchify(tree):
    return tck.tree_map(
        lambda x: torch.from_numpy(np.array(x)) if np.ndim(x) else x, tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_leaf_order_equals_jax_tree_flatten(name):
    tree = TREES[name]()
    got, spec = tck.tree_flatten(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    rebuilt = tck.tree_unflatten(spec, got)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_files_load_across_packages(tmp_path, name):
    tree = TREES[name]()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    hj = jck.save_checkpoint(pj, tree, position=11, meta={"w": 2})
    ht = save_checkpoint(pt, _torchify(tree), position=11, meta={"w": 2})
    assert hj["crc32"] == ht["crc32"] and hj["num_leaves"] == ht["num_leaves"]
    # gelly_tpu's file in the port, with a torch template: tensors back.
    like = _torchify(tree)
    got, pos, meta = load_checkpoint(pj, like=like)
    assert (pos, meta) == (11, {"w": 2})
    for g, t, w in zip(tck.tree_flatten(got)[0], tck.tree_flatten(like)[0],
                       jax.tree.leaves(tree)):
        assert type(g) is (torch.Tensor if isinstance(t, torch.Tensor)
                           else np.ndarray)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))
    # The port's file in gelly_tpu with like=.
    got, pos, meta = jck.load_checkpoint(pt, like=tree)
    assert (pos, meta) == (11, {"w": 2})
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------- #
# checkpointed runs: the port against gelly_tpu, window by window

N = 256
CHUNK = 32
N_EDGES = 11 * CHUNK - 20  # 11 chunks: windows of 4, 4 and 3 chunks
MERGE_EVERY = 4
FOLD_BATCH = 2

PLANS = {
    "compact-segments": lambda pkg: pkg.connected_components(
        N, merge="gather", codec="compact", compact_capacity=N),
    "compact-pairs": lambda pkg: pkg.connected_components_compact(
        N, compact_capacity=N, wire="pairs"),
    "sparse": lambda pkg: pkg.connected_components(N, codec="sparse"),
    "dense": lambda pkg: pkg.connected_components(N, codec="dense"),
    "raw": lambda pkg: pkg.connected_components(
        N, merge="gather", ingest_combine=False),
}


def _zipf(seed=5):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.3, N_EDGES) % N).astype(np.int32)
    dst = (rng.zipf(1.3, N_EDGES) % N).astype(np.int32)
    return src, dst


def _run_torch(plan, path=None, stop_after=None, **kw):
    src, dst = _zipf()
    stream = t_stream(TSource(src, dst, chunk_size=CHUNK,
                              table=TIdentity(N)), N, device="cpu")
    res = stream.aggregate(PLANS[plan](tcc), merge_every=MERGE_EVERY,
                           fold_batch=FOLD_BATCH, checkpoint_path=path, **kw)
    out = []
    for x in res:
        out.append(x.numpy())
        if len(out) == stop_after:
            break
    return out, res


def _run_jax(plan, path=None, stop_after=None, **kw):
    src, dst = _zipf()
    stream = j_stream(JSource(src, dst, chunk_size=CHUNK,
                              table=JIdentity(N)), N)
    it = iter(stream.aggregate(PLANS[plan](jcc), merge_every=MERGE_EVERY,
                               fold_batch=FOLD_BATCH, mesh=make_mesh(1),
                               checkpoint_path=path, **kw))
    out = []
    for x in it:
        out.append(np.asarray(x))
        if len(out) == stop_after:
            break
    it.close()
    return out


_JAX_FULL: dict = {}


def _jax_full(plan):
    if plan not in _JAX_FULL:
        _JAX_FULL[plan] = _run_jax(plan)
    return _JAX_FULL[plan]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("every", [1, 2])
def test_checkpoint_file_equals_gelly_tpu(tmp_path, plan, every):
    # Same stream, same cadence: the same positions and meta, and the
    # cadenced flatten leaves bit-identical forests in the files.
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    for stop in (3, None):
        got, res = _run_torch(plan, pt, stop_after=stop,
                              checkpoint_every=every)
        _run_jax(plan, pj, stop_after=stop, checkpoint_every=every)
        ht, hj = read_checkpoint_header(pt), read_checkpoint_header(pj)
        assert ht["position"] == hj["position"]
        assert ht["meta"] == hj["meta"]
        assert ht["crc32"] == hj["crc32"]
        lt, _, _ = load_checkpoint(pt)
        lj, _, _ = jck.load_checkpoint(pj)
        _same(lt, lj)
    _same(got, _jax_full(plan))
    assert res.stats["checkpoints"] == {1: 3, 2: 2}[every]
    assert res.stats["checkpoint_bytes"] > 0
    assert res.timer.busy()["checkpoint"] > 0


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("writer", ["gelly_tpu", "gelly_torch"])
def test_resume_across_packages_equals_uninterrupted(tmp_path, plan, writer):
    # Stop right after emission 2: checkpoint 1 (4 chunks) is on disk.
    p = str(tmp_path / "ck.npz")
    if writer == "gelly_tpu":
        _run_jax(plan, p, stop_after=2)
        got, res = _run_torch(plan, p, resume=True)
        assert res.stats["resumed_at"] == 4
        assert res.stats["chunks"] == 11 and res.stats["units"] == 4
    else:
        _run_torch(plan, p, stop_after=2)
        got = _run_jax(plan, p, resume=True)
    assert read_checkpoint_header(p)["meta"]["windows"] == 3
    full_t, _ = _run_torch(plan)
    _same(full_t, _jax_full(plan))
    _same(got, full_t[1:])


def test_resume_rebuilds_the_compact_session_after_its_reset(tmp_path):
    # A FRESH plan object: its id session knows nothing until on_resume
    # rebuilds it from the loaded vertex_of — after on_run_start's reset.
    p = str(tmp_path / "ck.npz")
    _run_torch("compact-segments", p, stop_after=2)
    agg = PLANS["compact-segments"](tcc)
    calls = []
    reset, rebuild = agg.on_run_start, agg.on_resume
    agg.on_run_start = lambda: (calls.append("reset"), reset())
    agg.on_resume = lambda s: (calls.append("resume"), rebuild(s))
    src, dst = _zipf()
    stream = t_stream(TSource(src, dst, chunk_size=CHUNK,
                              table=TIdentity(N)), N, device="cpu")
    res = stream.aggregate(agg, merge_every=MERGE_EVERY,
                           fold_batch=FOLD_BATCH, checkpoint_path=p,
                           resume=True)
    got = [x.numpy() for x in res]
    assert calls == ["reset", "resume"]
    _same(got, _jax_full("compact-segments")[1:])
    assert agg.session.assigned == int((got[-1] >= 0).sum())
    busy = res.timer.busy()
    for stage in ("resume_load", "on_resume", "resume_skip", "checkpoint"):
        assert stage in busy


def test_checkpoint_knob_validation(tmp_path):
    src, dst = _zipf()
    stream = t_stream(TSource(src, dst, chunk_size=CHUNK,
                              table=TIdentity(N)), N, device="cpu")
    agg = PLANS["sparse"](tcc)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        stream.aggregate(agg, resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        stream.aggregate(agg, checkpoint_path=str(tmp_path / "c.npz"),
                         checkpoint_every=0)
    with pytest.raises(FileNotFoundError):
        stream.aggregate(agg, checkpoint_path=str(tmp_path / "none.npz"),
                         resume=True).result()
    # The window knobs are ported: a pane ring checkpoints (the plan's
    # windowed builder variant: a plan with the dirty-delta merge refuses
    # a ring, as JAX's does); TTL without a ring and lateness without
    # window_ms refuse as JAX does.
    with pytest.raises(ValueError, match="dirty-delta"):
        stream.aggregate(agg, windowed=2, merge_every=MERGE_EVERY)
    windowed = stream.aggregate(
        tcc.connected_components(N, codec="sparse", windowed=2),
        checkpoint_path=str(tmp_path / "w.npz"), merge_every=MERGE_EVERY)
    windowed.result()
    assert windowed.stats["checkpoints"] > 0
    for knob, value, match in (("ttl_panes", 3, "requires windowed"),
                               ("allowed_lateness", 5, "window_ms")):
        with pytest.raises(ValueError, match=match):
            stream.aggregate(agg, checkpoint_path=str(tmp_path / "c.npz"),
                             **{knob: value})
