"""gelly_torch's sharded byte-range readers vs gelly_tpu's (CPU).

Mirrors ``tests/test_ingest_readers.py``: range alignment, the round-robin
schedule and its resume math, per-shard seekable resume, the engine's
``source_provider`` path (labels, no produce span, one compress track per
reader lane, checkpoint and resume, the refusals), the resilient runner
over a sharded source, the routing table and the coordinator's re-shard
hook, and ``EdgeChunkSource.iter_from``'s O(1) resume. Each test runs the
same seeded files through both packages: every chunk's fields, every
emission, every refusal text and every routing step must be equal
(tolerance: none), and a checkpoint either package writes through the
provider resumes in the other.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_wire import arr, buses, error_of, mesh1, pkg, same  # noqa: E402

pytestmark = pytest.mark.ingest
T, J = pkg("torch"), pkg("tpu")
NV = 128


def _edges(n=900, seed=11):
    rng = np.random.default_rng(seed)
    return rng.integers(0, NV, n), rng.integers(0, NV, n)


@pytest.fixture
def text_file(tmp_path):
    src, dst = _edges()
    p = tmp_path / "edges.txt"
    with open(p, "w") as f:
        f.write("% header comment\n")
        for i, (a, b) in enumerate(zip(src, dst)):
            f.write(f"{a} {b}\n")
            if i % 97 == 0:
                f.write("# interleaved comment\n")
            if i % 131 == 0:
                f.write("not-an-edge\n")
    return str(p), src, dst


@pytest.fixture
def bin_file(tmp_path):
    src, dst = _edges()
    p = tmp_path / "edges.bin"
    assert T.readers.write_binary_edges(str(p), src, dst) == len(src)
    q = tmp_path / "edges_tpu.bin"
    J.readers.write_binary_edges(str(q), src, dst)
    assert p.read_bytes() == q.read_bytes()
    return str(p), src, dst


def _pairs(chunks):
    out = []
    for c in chunks:
        m = arr(c.valid).astype(bool)
        out.extend(zip(arr(c.raw_src)[m].tolist(), arr(c.raw_dst)[m].tolist()))
    return out


def _fields(chunks):
    return [[arr(f) for f in c] for c in chunks]


def _source(P, path, **kw):
    return P.readers.ShardedEdgeSource(path, vertex_capacity=NV, **kw)


# ---------------------------------------------------------------------- #
# ranges + schedule math


def test_byte_ranges_cover_file_and_align_bin(bin_file):
    path, _, _ = bin_file
    size = os.path.getsize(path)
    for s in (1, 2, 3, 5):
        r = T.readers.byte_ranges(path, s)
        assert r == J.readers.byte_ranges(path, s)
        assert r[0][0] == 0 and r[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(lo % 16 == 0 and hi % 16 == 0 for lo, hi in r)


def test_byte_ranges_rejects_misaligned_bin(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"x" * 17)
    msg = error_of(lambda: T.readers.byte_ranges(str(p), 2))
    assert "multiple" in msg
    assert msg == error_of(lambda: J.readers.byte_ranges(str(p), 2))


def test_rr_order_and_consumed_after():
    counts = [3, 1, 2]
    order = list(T.readers.rr_order(counts))
    assert order == list(J.readers.rr_order(counts)) == [0, 1, 2, 0, 2, 0]
    for k in range(sum(counts) + 1):
        per = T.readers.consumed_after(counts, k)
        assert per == J.readers.consumed_after(counts, k)
        assert per == [order[:k].count(s) for s in range(3)]
    msg = error_of(lambda: T.readers.consumed_after(counts, 7))
    assert "exceeds" in msg
    assert msg == error_of(lambda: J.readers.consumed_after(counts, 7))


def test_unit_starts_alignment():
    counts = [5, 3]
    for start, want in ((4, ([1, 1], 2)), (7, ([2, 2], 4))):
        got = T.readers._unit_starts(counts, 2, start)
        assert got == want == J.readers._unit_starts(counts, 2, start)
    msg = error_of(lambda: T.readers._unit_starts(counts, 2, 3))
    assert "unit boundary" in msg
    assert msg == error_of(lambda: J.readers._unit_starts(counts, 2, 3))


# ---------------------------------------------------------------------- #
# reading + resume


@pytest.mark.parametrize("kind", ["text", "bin"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_read_is_exact_and_deterministic(kind, shards, text_file,
                                                 bin_file):
    path, src, dst = text_file if kind == "text" else bin_file
    chunks = list(_source(T, path, shards=shards, chunk_size=64))
    assert sorted(_pairs(chunks)) == sorted(zip(src.tolist(), dst.tolist()))
    again = list(_source(T, path, shards=shards, chunk_size=64))
    assert _pairs(chunks) == _pairs(again)
    # Every field of every chunk (slots, raw ids, record timestamps, the
    # valid mask and the padding) is gelly_tpu's, in its merge order.
    same(_fields(list(_source(J, path, shards=shards, chunk_size=64))),
         _fields(chunks))
    assert all(c.src.device.type == "cpu" for c in chunks)


@pytest.mark.parametrize("kind", ["text", "bin"])
def test_resume_continues_canonical_schedule(kind, text_file, bin_file):
    path, _, _ = text_file if kind == "text" else bin_file
    full = [_pairs([c]) for c in _source(T, path, shards=3, chunk_size=64)]
    n = len(full)
    for pos in (0, 1, 2, n // 2, n - 1, n):
        fresh = _source(T, path, shards=3, chunk_size=64)
        got = list(fresh.iter_from(pos))
        assert [_pairs([c]) for c in got] == full[pos:]
        same(_fields(list(_source(J, path, shards=3, chunk_size=64)
                          .iter_from(pos))), _fields(got))
        warm = _source(T, path, shards=3, chunk_size=64)
        list(warm)  # record offsets + counts
        assert [_pairs([c]) for c in warm.iter_from(pos)] == full[pos:]


def test_recorded_offsets_enable_direct_seek(text_file):
    path, _, _ = text_file
    rec = {}
    for P in (J, T):
        src = _source(P, path, shards=2, chunk_size=64)
        list(src)
        counts = src.shard_counts()
        rec[P.name] = (counts, [src.recorded_offsets(s) for s in range(2)])
        for s in range(2):
            offs = src.recorded_offsets(s)
            assert len(offs) == counts[s] and offs == sorted(offs)
            for idx in (0, counts[s] // 2):
                direct = next(iter(src._read_shard(s, idx)))
                fresh = _source(P, path, shards=2, chunk_size=64)
                scan = None
                for i, c in enumerate(fresh._read_shard(s, 0)):
                    if i == idx:
                        scan = c
                        break
                assert _pairs([direct]) == _pairs([scan])
    assert rec["torch"] == rec["tpu"]


def test_sharded_source_rejects_stateful_table(text_file):
    path, _, _ = text_file
    msgs = [error_of(lambda P=P: P.readers.ShardedEdgeSource(
        path, shards=2, table=P.vertices.VertexTable())) for P in (J, T)]
    assert "first-seen" in msgs[1] and msgs[0] == msgs[1]


def test_out_of_range_id_raises(tmp_path):
    p = tmp_path / "e.bin"
    T.readers.write_binary_edges(str(p), [1, 999], [2, 3])
    msgs = [error_of(lambda P=P: list(P.readers.ShardedEdgeSource(
        str(p), shards=1, chunk_size=4, vertex_capacity=8)))
        for P in (J, T)]
    assert "out of range" in msgs[1] and msgs[0] == msgs[1]


def test_ingest_fault_boundary_fires_in_reader(bin_file):
    path, _, _ = bin_file
    src = _source(T, path, shards=2, chunk_size=64)
    plan = T.faults.FaultPlan([T.faults.Fault(boundary="ingest", at=1)])
    with T.faults.install(plan):
        with pytest.raises(T.faults.FaultInjected):
            list(src)
    assert ("ingest", 1, "raise") in plan.fired


# ---------------------------------------------------------------------- #
# engine integration (source_provider)


def _cc_labels_reference(P, src, dst):
    stream = P.top.edge_stream_from_edges(
        list(zip(src.tolist(), dst.tolist())), vertex_capacity=NV,
        chunk_size=64, **P.kw)
    return arr(stream.aggregate(P.cc.connected_components(NV),
                                merge_every=4).result())


def _sharded(P, path, shards):
    return P.readers.edge_stream_from_sharded_file(path, NV, shards=shards,
                                                   chunk_size=64, **P.kw)


def test_source_provider_labels_match_and_lanes_are_independent(bin_file):
    path, src, dst = bin_file
    want = _cc_labels_reference(J, src, dst)
    rec = {}
    for P in (J, T):
        tracer = P.obs.SpanTracer(heartbeat_every_s=None)
        with P.obs.scope(), P.obs.install(tracer):
            res = _sharded(P, path, 3).aggregate(
                P.cc.connected_components(NV), merge_every=4,
                source_provider=True)
            windows = [arr(w) for w in res]
        np.testing.assert_array_equal(windows[-1], want)
        assert tracer.spans("produce") == []
        threads = {s["thread"] for s in tracer.spans("compress")}
        assert {"gelly-reader_0", "gelly-reader_1",
                "gelly-reader_2"} <= threads
        rec[P.name] = {"windows": windows,
                       "compress": len(tracer.spans("compress")),
                       "tracks": sorted(threads)}
    same(rec["tpu"], rec["torch"])


def test_source_provider_checkpoint_resume(bin_file, tmp_path):
    path, src, dst = bin_file
    want = _cc_labels_reference(J, src, dst)
    n_chunks = _source(T, path, shards=3, chunk_size=64).num_chunks
    for writer, reader in ((T, T), (J, T), (T, J)):
        ck = str(tmp_path / f"ck_{writer.name}_{reader.name}.npz")
        it = iter(_sharded(writer, path, 3).aggregate(
            writer.cc.connected_components(NV), merge_every=4,
            source_provider=True, checkpoint_path=ck, checkpoint_every=1))
        for _ in range(3):  # abandon mid-stream with a checkpoint on disk
            next(it)
        it.close()
        _, pos, _ = reader.checkpoint.load_checkpoint(ck)
        assert 0 < pos < n_chunks
        got = arr(_sharded(reader, path, 3).aggregate(
            reader.cc.connected_components(NV), merge_every=4,
            source_provider=True, checkpoint_path=ck, resume=True).result())
        np.testing.assert_array_equal(got, want)


def test_source_provider_mode_validation(bin_file):
    path, _, _ = bin_file
    rec = {}
    for P in (J, T):
        stream = _sharded(P, path, 2)
        plain = P.top.edge_stream_from_edges([(0, 1)], vertex_capacity=4,
                                             **P.kw)
        cc = P.cc.connected_components
        rec[P.name] = [
            error_of(lambda: stream.aggregate(
                cc(NV), window_ms=10, source_provider=True).result()),
            error_of(lambda: plain.aggregate(
                cc(4), source_provider=True).result()),
            error_of(lambda: plain.reverse().aggregate(
                cc(4), source_provider=True).result()),
            error_of(lambda: stream.aggregate(
                cc(NV), merge_every=4, source_provider=True,
                codec_workers=8).result()),
            error_of(lambda: stream.aggregate(
                cc(NV), merge_every=4, windowed=2,
                source_provider=True).result()),
        ]
    for msg, want in zip(rec["torch"], ("merge_every-only", "stage_units",
                                        "source_provider=True",
                                        "shard count IS the lane",
                                        "single-iterator only")):
        assert msg is not None and want in msg, (want, msg)
    assert rec["torch"] == rec["tpu"]


def test_source_provider_rejects_ordered_stacker(bin_file):
    path, _, _ = bin_file
    msgs = []
    for P in (J, T):
        agg = P.cc.connected_components_compact(NV)
        assert agg.stack_ordered
        msgs.append(error_of(lambda: _sharded(P, path, 2).aggregate(
            agg, merge_every=4, source_provider=True).result()))
    assert "ordered stacker" in msgs[1] and msgs[0] == msgs[1]


def test_resilient_runner_composes_with_sharded_source(bin_file, tmp_path):
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
    )

    path, src, dst = bin_file
    want = _cc_labels_reference(J, src, dst)
    agg = T.cc.connected_components(NV)

    def runner(source):
        return ResilientRunner(
            lambda s, c: (agg.fold(s, c), None), source,
            lambda: agg.init("cpu"),
            checkpoint_dir=str(tmp_path / "ckd"),
            config=ResilienceConfig(checkpoint_every_chunks=5,
                                    watchdog_timeout=None))

    source = _source(T, path, shards=4, chunk_size=64)
    r1 = runner(source)
    final = r1.run()
    np.testing.assert_array_equal(arr(agg.transform(final)), want)
    assert r1.position == source.num_chunks
    # A second runner over a FRESH source continues from the newest
    # checkpoint through iter_from (per-shard seeks), bit-identical.
    r2 = runner(_source(T, path, shards=4, chunk_size=64))
    resumed = r2.run()
    assert r2.stats["resumed_from"] is not None
    same(final, resumed)


# ---------------------------------------------------------------------- #
# routing table + coordination re-shard hook


def test_routing_table_reroute_matches_adoption_rule():
    rec = {}
    for P in (J, T):
        with buses(P.name) as b:
            rt = P.readers.ShardRoutingTable(num_shards=8, num_hosts=4)
            assert rt.shards_for(3) == [3, 7]
            moved = rt.reroute(4, 2)
            assert moved == {2: 0, 3: 1, 6: 0, 7: 1}
            rec[P.name] = {
                "moved": moved, "snapshot": rt.snapshot(),
                "hosts": [rt.shards_for(h) for h in range(2)],
                "reshards": b.counter("ingest.reshards"),
                "error": error_of(lambda: rt.reroute(2, 3)),
            }
    assert "new_count" in rec["torch"]["error"]
    assert rec["torch"] == rec["tpu"]


def test_coordinator_recover_drives_ingest_reshard(tmp_path):
    """The degraded re-join calls the re-shard hook with (old_count,
    new_count): the lost host's reader shards land on the survivor that
    adopted its state shards, in the port as in ``gelly_tpu``."""
    import threading

    rec = {}
    for P in (J, T):
        co_mod = __import__(P.root + ".engine.coordination",
                            fromlist=["Coordinator"])
        store = tmp_path / P.name

        def cfg():
            return co_mod.CoordinationConfig(
                lease_ttl=2.0, poll_s=0.005, barrier_timeout=10.0,
                lease_thread=False)

        errs = []

        def body(k):
            try:
                co = co_mod.Coordinator(str(store),
                                        co_mod.HostIdentity(k, 2), cfg())
                epoch, agreed = co.agree_position(8)
                co.publish(epoch,
                           {"x": np.arange(4, dtype=np.int64) * (k + 1)},
                           agreed)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        threads = [threading.Thread(target=body, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        rt = P.readers.ShardRoutingTable(num_shards=4, num_hosts=2)
        with P.bus.scope():
            co = co_mod.Coordinator(str(store), co_mod.HostIdentity(0, 1),
                                    cfg())
            state, pos, _meta = co.recover(
                like={"x": np.zeros(4, dtype=np.int64)},
                adopt=lambda a, b: {"x": a["x"] + b["x"]},
                reshard=rt.reroute)
        assert pos == 8 and rt.num_hosts == 1
        assert rt.shards_for(0) == [0, 1, 2, 3]
        rec[P.name] = {"pos": pos, "x": arr(state["x"]),
                       "routes": rt.snapshot()}
    same(rec["tpu"], rec["torch"])


# ---------------------------------------------------------------------- #
# EdgeChunkSource.iter_from O(1) resume


def test_edge_chunk_source_resume_skips_warm_prefix():
    rng = np.random.default_rng(5)
    src = rng.integers(10_000, 99_999, 640)
    dst = rng.integers(10_000, 99_999, 640)
    rec = {}
    for P in (J, T):
        io_mod = __import__(P.root + ".core.io", fromlist=["EdgeChunkSource"])

        class CountingTable(P.vertices.VertexTable):
            def __init__(self):
                super().__init__()
                self.encode_calls = 0

            def encode(self, raw_ids):
                self.encode_calls += 1
                return super().encode(raw_ids)

        table = CountingTable()
        source = io_mod.EdgeChunkSource(src, dst, chunk_size=64, table=table)
        full = [arr(c.src).tolist() for c in source]
        assert len(full) == 10
        table.encode_calls = 0
        assert [arr(c.src).tolist() for c in source.iter_from(7)] == full[7:]
        assert table.encode_calls == 2 * 3
        cold_table = CountingTable()
        cold = io_mod.EdgeChunkSource(src, dst, chunk_size=64,
                                      table=cold_table)
        assert [arr(c.src).tolist() for c in cold.iter_from(7)] == full[7:]
        assert cold_table.encode_calls == 2 * 10
        t2 = CountingTable()
        s2 = io_mod.EdgeChunkSource(src, dst, chunk_size=64, table=t2)
        it = iter(s2)
        for _ in range(4):
            next(it)
        it.close()
        t2.encode_calls = 0
        assert [arr(c.src).tolist() for c in s2.iter_from(7)] == full[7:]
        assert t2.encode_calls == 2 * 3 + 2 * 3
        rec[P.name] = full
    assert rec["torch"] == rec["tpu"]


def test_sharded_stream_defaults_to_the_card(bin_file):
    """``edge_stream_from_sharded_file`` runs on ``DEFAULT_DEVICE`` unless
    the caller asks for the CPU; its readers build host chunks either way."""
    import torch

    path, _, _ = bin_file
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            T.readers.edge_stream_from_sharded_file(path, NV, shards=2)
    stream = _sharded(T, path, 2)
    assert stream.ctx.device.type == "cpu"
    first = next(iter(stream.source))
    assert first.src.device.type == "cpu"
    assert mesh1(T).devices[0].type == "cpu"
