"""gelly_torch's end-to-end latency watermarks and STATS snapshot on
the CPU.

Mirrors the ``Watermarks`` min-queue tests of ``tests/test_telemetry.py``
(the O(1)-amortized backlog age against the ledger scan, rekey merges,
in-order traffic never rebuilding) and its STATS-shape test against the
port, then runs one seeded sequence of seed, stamp, retire, rekey and
drop operations through both packages' ``Watermarks`` on the same fake
clock and holds every snapshot, backlog age and retirement histogram
equal (exact). It also mirrors the tenant engine's submit-stamp
regression and the coordinated runner's watermark retirement, and the
tests that drive the ingest server: the STATS endpoint on a dedicated
connection and interleaved on the data connection, ``stats_fields`` and
its failure containment, the status CLI, the straggler-reply guard, the
sharded provider's watermark retirement, the router's engine telemetry
and its re-key of pre-attach stamps, and the SIGKILLed engine serve path
with STATS interleaved. Each server test runs with a port server and a
``gelly_tpu`` client too, and holds the STATS replies' deterministic
fields to ``gelly_tpu``'s.

Child: ``python tests/test_torch_telemetry.py <ckpt_path> <port_file>
<out.npz> [sleep_s]`` with the repository root on ``PYTHONPATH``
(``tests/_telemetry_crash_child.py``'s serve path on the port).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from gelly_torch import obs
from gelly_torch.obs.status import build_stats, fetch_stats

CHILD_NV = 128
CHILD_CHUNK = 16
CHILD_MERGE_EVERY = 2


def child(argv) -> None:
    """The kill -9 child on the port: an ``IngestServer(auto_ack=False)``
    feeding ``run_aggregation`` over a degree plan with recording on; a
    thread acks the engine checkpoint's position."""
    import itertools

    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.engine.checkpoint import (
        CheckpointCorruptError,
        read_checkpoint_header,
        save_checkpoint,
    )
    from gelly_torch.ingest import IngestServer
    from gelly_torch.library.degrees import degree_aggregate
    from gelly_torch.parallel.mesh import make_mesh

    ckpt_path, port_file, out_path = argv[0], argv[1], argv[2]
    sleep_s = float(argv[3]) if len(argv) > 3 else 0.0
    obs.set_recording(True)
    bus = obs.get_bus()
    resume = os.path.exists(ckpt_path)
    pos = int(read_checkpoint_header(ckpt_path)["position"]) if resume \
        else 0
    srv = IngestServer(auto_ack=False, resume_seq=pos, queue_depth=8,
                       stop_on_bye=True).start()
    tmp = port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, port_file)
    stop_acker = threading.Event()

    def acker():
        while not stop_acker.is_set():
            if os.path.exists(ckpt_path):
                try:
                    srv.ack(int(read_checkpoint_header(ckpt_path)[
                        "position"]))
                except (CheckpointCorruptError, OSError):
                    pass  # mid-replace; the next tick reads the new file
            time.sleep(0.02)

    t_ack = threading.Thread(target=acker, daemon=True)
    t_ack.start()
    # The wire resumed the sequence already (resume_seq): placeholders
    # stand for the folded prefix the engine's resume drops unread.
    stream = itertools.chain(iter([object()] * pos),
                             srv.chunks(CHILD_CHUNK,
                                        vertex_capacity=CHILD_NV))
    res = run_aggregation(
        degree_aggregate(CHILD_NV), stream, mesh=make_mesh(
            1, devices=["cpu"]), merge_every=CHILD_MERGE_EVERY,
        checkpoint_path=ckpt_path, checkpoint_every=1, resume=resume)
    ages: list = []
    oldest: list = []
    final = None
    try:
        for final in res:
            if sleep_s:
                time.sleep(sleep_s)
            ages.append(bus.watermarks.backlog_age("stream"))
            op = bus.watermarks.oldest_position("stream")
            oldest.append(-1 if op is None else op)
    finally:
        stop_acker.set()
        srv.stop()
    t_ack.join(timeout=5)
    hdr = read_checkpoint_header(ckpt_path)
    srv.ack(int(hdr["position"]))
    save_checkpoint(
        out_path,
        {"degrees": np.asarray(final, dtype=np.int64),
         "ages": np.asarray(ages, dtype=np.float64),
         "oldest": np.asarray(oldest, dtype=np.int64)},
        position=int(hdr["position"]),
        meta={"resume_pos": pos, "resumed": resume})


if __name__ == "__main__":
    child(sys.argv[1:])
    sys.exit(0)


# --------------------------------------------------------------------- #
# watermark min-deque: O(1)-amortized backlog_age vs the ledger scan


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scan_age(wm, stream, now):
    """The reference implementation the deque replaced: one O(pending)
    min-scan over the raw ledger."""
    st = wm._streams.get(stream)
    if st is None or not st.stamps:
        return 0.0
    return max(0.0, now - min(st.stamps.values()))


def test_watermark_minq_parity_hammer_vs_scan():
    from gelly_torch.obs.watermarks import Watermarks

    rng = np.random.default_rng(7)
    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    streams = ["a", "b"]
    base = {s: 0 for s in streams}
    nxt = {s: 0 for s in streams}
    reads = 0
    for _ in range(4000):
        ck.t += float(rng.random()) * 0.01
        s = streams[int(rng.integers(0, 2))]
        nxt[s] = max(nxt[s], base[s])
        op = float(rng.random())
        if op < 0.55:
            if rng.random() < 0.05 and nxt[s] > base[s]:
                p = int(rng.integers(base[s], nxt[s]))  # out-of-order
            else:
                p = nxt[s]
                nxt[s] += 1
            wm.stamp(s, p)
        elif op < 0.72:
            upto = int(rng.integers(base[s], nxt[s] + 2))
            wm.retire_durable(s, upto)
            base[s] = max(base[s], upto)
        elif op < 0.82:
            wm.retire_fold(s, int(rng.integers(base[s], nxt[s] + 2)))
        elif op < 0.90:
            pos = int(rng.integers(base[s], nxt[s] + 2))
            wm.seed(s, pos)
            base[s] = max(base[s], pos)
        else:
            reads += 1
            now = ck.t
            assert wm.backlog_age(s) == pytest.approx(
                _scan_age(wm, s, now), abs=1e-12)
            want = max((_scan_age(wm, x, now) for x in streams),
                       default=0.0)
            assert wm.max_backlog_age() == pytest.approx(want, abs=1e-12)
    assert reads > 200  # the hammer actually exercised the read path


def test_watermark_minq_rekey_and_snapshot_parity():
    from gelly_torch.obs.watermarks import Watermarks

    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    for p, t in [(0, 1.0), (1, 2.0), (2, 3.0)]:
        ck.t = t
        wm.stamp("pre", p)
    ck.t = 4.0
    wm.stamp("dst", 1)
    wm.rekey("pre", "dst")  # arbitrary-order merge -> lazy rebuild
    ck.t = 10.0
    assert wm.backlog_age("dst") == pytest.approx(9.0)
    assert wm.backlog_age("pre") == 0.0
    assert wm.snapshot()["dst"]["backlog_age_s"] == pytest.approx(9.0)
    wm.retire_durable("dst", 2)
    assert wm.backlog_age("dst") == pytest.approx(7.0)
    wm.retire_durable("dst", 100)
    assert wm.backlog_age("dst") == 0.0
    assert wm.max_backlog_age() == 0.0


def test_watermark_minq_in_order_reads_never_rebuild():
    from gelly_torch.obs.watermarks import Watermarks

    ck = _FakeClock()
    wm = Watermarks(clock=ck)
    for p in range(512):
        ck.t += 0.001
        wm.stamp("s", p)
        if p % 7 == 0:
            wm.backlog_age("s")
        if p % 64 == 63:
            wm.retire_durable("s", p - 32)
    st = wm._streams["s"]
    # The hot path stays incremental: in-position-order traffic never
    # flips the dirty bit (no O(n log n) rebuild), and the deque never
    # outgrows the ledger — each entry is pushed once and popped once.
    assert st.dirty is False
    assert len(st.minq) <= len(st.stamps)
    assert wm.backlog_age("s") == pytest.approx(
        _scan_age(wm, "s", ck.t), abs=1e-12)


# --------------------------------------------------------------------- #
# the STATS snapshot


def test_build_stats_shape_is_json_ready():
    with obs.scope() as bus, obs.record_metrics():
        bus.inc("ingest.frames_received")
        bus.observe("engine.fold_dispatch_ms", 1.5)
        bus.watermarks.stamp("stream", 0)
        st = json.loads(json.dumps(build_stats(bus)))
    assert st["counters"]["ingest.frames_received"] == 1
    assert st["histograms"]["engine.fold_dispatch_ms"]["count"] == 1
    assert st["watermarks"]["stream"]["pending"] == 1
    assert "process_index" in st["host"]


def test_fetch_stats_waits_for_the_ingest_port():
    """``fetch_stats`` speaks the STATS wire now: against a port nothing
    listens on it raises ``ConnectionError``, as ``gelly_tpu``'s does, and
    the CLI still validates its target before it tries."""
    import socket

    from gelly_torch.obs import status as status_mod
    from gelly_tpu.obs import status as jstatus

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens on it now
    errors = []
    for fetch in (fetch_stats, jstatus.fetch_stats):
        with pytest.raises(ConnectionError) as info:
            fetch("127.0.0.1", port, timeout=2.0)
        errors.append(type(info.value))
    assert errors[0] is errors[1]
    assert status_mod.main(["not-a-target"]) == 2
    assert status_mod.main([f"127.0.0.1:{port}"]) == 1


# --------------------------------------------------------------------- #
# across the packages: one seeded operation sequence, both ledgers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watermarks_sequence_equals_jax(seed):
    from gelly_torch.obs.bus import EventBus as TBus
    from gelly_torch.obs.watermarks import Watermarks as TWatermarks
    from gelly_tpu.obs.bus import EventBus as JBus
    from gelly_tpu.obs.watermarks import Watermarks as JWatermarks

    rng = np.random.default_rng(seed)
    ck = _FakeClock()
    t_wm, j_wm = TWatermarks(clock=ck), JWatermarks(clock=ck)
    t_bus, j_bus = TBus(), JBus()
    streams = ["stream", "t3", "wire:9"]
    nxt = {s: 0 for s in streams}
    for step in range(1500):
        ck.t += float(rng.random()) * 0.01
        s = streams[int(rng.integers(0, len(streams)))]
        op = float(rng.random())
        if op < 0.5:
            if rng.random() < 0.1 and nxt[s]:
                p = int(rng.integers(0, nxt[s]))  # out of order / stale
            else:
                p = nxt[s]
                nxt[s] += 1
            args = ("stamp", s, p)
        elif op < 0.65:
            args = ("retire_durable", s, int(rng.integers(0, nxt[s] + 2)))
        elif op < 0.8:
            args = ("retire_fold", s, int(rng.integers(0, nxt[s] + 2)))
        elif op < 0.88:
            pos = int(rng.integers(0, nxt[s] + 2))
            nxt[s] = max(nxt[s], pos)
            args = ("seed", s, pos)
        elif op < 0.95:
            dst = streams[int(rng.integers(0, len(streams)))]
            nxt[dst] = max(nxt[dst], nxt[s])
            args = ("rekey", s, dst)
        else:
            args = ("drop", s)
        for wm, bus in ((t_wm, t_bus), (j_wm, j_bus)):
            fn = getattr(wm, args[0])
            if args[0].startswith("retire"):
                fn(*args[1:], bus=bus, prefix="engine")
            else:
                fn(*args[1:])
        assert t_wm.snapshot() == j_wm.snapshot(), (step, args)
        assert t_wm.max_backlog_age() == j_wm.max_backlog_age()
        assert t_wm.oldest_position(s) == j_wm.oldest_position(s)
    t_h = t_bus.snapshot()["histograms"]
    j_h = j_bus.snapshot()["histograms"]
    assert t_h == j_h
    assert t_h["engine.e2e_ingress_to_fold_ms"]["count"] > 0
    assert t_h["engine.e2e_ingress_to_durable_ms"]["count"] > 0


# --------------------------------------------------------------------- #
# tenant engine: submit stamps keyed by a monotonic position


def test_tenant_submit_stamp_survives_mid_dispatch_submit():
    """Submit-side stamp positions come from the tenant's monotonic
    ``submitted`` counter, not ``consumed + len(queue)``, which
    under-counts by one between the scheduler's queue pop and its
    ``consumed`` bump: a submit landing there must stamp a new
    position, not re-stamp the previous chunk's."""
    from gelly_torch import edge_stream_from_edges
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.library.connected_components import cc_tenant_tier

    n_v = 128

    def chunks(seed, n=3):
        rng = np.random.default_rng(seed)
        stream = edge_stream_from_edges(
            [(int(a), int(b)) for a, b in rng.integers(0, n_v, (n * 8, 2))],
            vertex_capacity=n_v, chunk_size=8, device="cpu",
        )
        return list(stream)[:n]

    with obs.scope() as bus, obs.record_metrics():
        agg, cap = cc_tenant_tier(n_v, chunk_capacity=8)
        eng = MultiTenantEngine(merge_every=1, device="cpu")
        eng.add_tier("small", agg, cap)
        eng.admit(7, "small")
        c1, c2, c3 = chunks(31)
        eng.submit(7, c1)
        eng.submit(7, c2)
        # The dispatch window: the chunk is popped, ``consumed`` not yet
        # bumped.
        with eng._lock:
            eng._tenants[7].queue.popleft()
        eng.submit(7, c3)  # must stamp position 2, not re-stamp 1
        snap = bus.watermarks.snapshot()["7"]
        assert snap["pending"] == 3, snap
        assert snap["oldest_position"] == 0


# --------------------------------------------------------------------- #
# coordinated runner: every barrier commit is a durability point


def test_coordinated_runner_watermarks_fully_retire(tmp_path):
    """Every committed barrier epoch retires the e2e ledger, and the end
    of the stream drains it: with telemetry on, a healthy coordinated run
    ends with no pending stamp, a backlog age of 0 and one
    ingress-to-durable sample a chunk."""
    from gelly_torch.engine.coordination import (
        CoordinationConfig,
        Coordinator,
        HostIdentity,
    )
    from gelly_torch.engine.resilience import (
        ResilienceConfig,
        ResilientRunner,
    )

    co = Coordinator(
        str(tmp_path / "store"), HostIdentity(0, 1),
        CoordinationConfig(lease_ttl=2.0, poll_s=0.005,
                           barrier_timeout=10.0, lease_thread=False),
    )
    with obs.scope() as bus, obs.record_metrics():
        r = ResilientRunner(
            lambda s, c: (s + np.int64(c), None), list(range(10)),
            np.int64(0), coordinator=co,
            config=ResilienceConfig(checkpoint_every_chunks=4,
                                    watchdog_timeout=30.0),
        )
        assert int(r.run()) == sum(range(10))
        assert r.stats["checkpoints"] == 3  # 4, 8, final 10
        snap = bus.watermarks.snapshot()["stream"]
        assert snap["pending"] == 0, snap
        assert snap["base"] == 10
        assert bus.watermarks.backlog_age("stream") == 0.0
        h = bus.snapshot()["histograms"]
        assert h["resilience.e2e_ingress_to_durable_ms"]["count"] == 10
        assert bus.gauges["engine.backlog_age_s"] == 0.0


# --------------------------------------------------------------------- #
# the STATS endpoint over the wire (both packages' clients)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_wire import buses, engine, pkg, wait  # noqa: E402

N_V = 128
_CLIENTS = pytest.mark.parametrize("client", ["torch", "tpu"])


def _start_server(**kw):
    from gelly_torch.ingest import IngestServer

    return IngestServer(port=0, **kw).start()


@_CLIENTS
def test_stats_dedicated_connection_never_disturbs_data_stream(client):
    C = pkg(client)
    with buses("torch", client), obs.record_metrics():
        bus = obs.get_bus()
        srv = _start_server()
        try:
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            rng = np.random.default_rng(5)
            for _ in range(3):
                cli.send(C.edge_payload(rng.integers(0, N_V, 8),
                                        rng.integers(0, N_V, 8)))
            cli.flush(timeout=30)
            st = fetch_stats("127.0.0.1", srv.port)
            # gelly_tpu's fetch reads the port server's reply the same way.
            jst = C.status.fetch_stats("127.0.0.1", srv.port) \
                if client == "tpu" else st
            assert st["server"]["next_seq"] == jst["server"]["next_seq"] == 3
            assert st["counters"]["ingest.data_frames_raw"] == 3
            assert "stream" in st["watermarks"]
            h = st["histograms"]["ingest.receive_to_stage_ms"]
            assert h["count"] == 3
            for q in ("p50", "p90", "p99", "max"):
                assert h[q] >= 0
            for _ in range(2):
                cli.send(C.edge_payload(rng.integers(0, N_V, 8),
                                        rng.integers(0, N_V, 8)))
            assert cli.flush(timeout=30) == 5
            assert srv.next_seq == 5
            assert bus.snapshot()["counters"]["ingest.stats_requests"] == (
                2 if client == "tpu" else 1)
            cli.close(flush_timeout=None)
        finally:
            srv.stop()


@_CLIENTS
def test_client_stats_interleaves_on_the_data_connection(client):
    C = pkg(client)
    with buses("torch", client), obs.record_metrics():
        srv = _start_server()
        try:
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            rng = np.random.default_rng(6)
            cli.send(C.edge_payload(rng.integers(0, N_V, 8),
                                    rng.integers(0, N_V, 8)))
            st = cli.stats()
            assert st["server"]["next_seq"] == 1
            assert st["recording"] is True
            assert cli.send(C.edge_payload(rng.integers(0, N_V, 8),
                                           rng.integers(0, N_V, 8))) == 1
            assert cli.flush(timeout=30) == 2
            cli.close(flush_timeout=None)
        finally:
            srv.stop()


def test_stats_fields_extras_and_failure_containment():
    rec = {}
    for S in (pkg("tpu"), pkg("torch")):
        calls = {"n": 0}

        def fields():
            calls["n"] += 1
            if calls["n"] == 1:
                return {"custom": {"answer": 42}}
            raise RuntimeError("stats provider broke")

        with S.obs.scope():
            srv = S.IngestServer(port=0, stats_fields=fields).start()
            try:
                st = S.status.fetch_stats("127.0.0.1", srv.port)
                st2 = S.status.fetch_stats("127.0.0.1", srv.port)
            finally:
                srv.stop()
        rec[S.name] = (st["custom"], st2["stats_fields_error"])
    assert rec["torch"][0] == {"answer": 42}
    assert "stats provider broke" in rec["torch"][1]
    assert rec["torch"] == rec["tpu"]


def test_status_cli_prints_snapshot(capsys):
    from gelly_torch.obs import status as status_mod

    with obs.scope():
        srv = _start_server()
        try:
            assert status_mod.main([f"127.0.0.1:{srv.port}"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["server"]["port"] == srv.port
            assert "counters" in out and "watermarks" in out
            prom = status_mod.main(["--prometheus",
                                    f"127.0.0.1:{srv.port}"])
            assert prom == 0 and "ingest" in capsys.readouterr().out
            assert status_mod.main(["not-a-target"]) == 2
        finally:
            srv.stop()
    # gelly_tpu's server answers the port's CLI with the same shape.
    J = pkg("tpu")
    with J.obs.scope():
        jsrv = J.IngestServer(port=0).start()
        try:
            assert status_mod.main([f"127.0.0.1:{jsrv.port}"]) == 0
            jout = json.loads(capsys.readouterr().out)
        finally:
            jsrv.stop()
    assert sorted(jout) == sorted(out)
    assert sorted(jout["server"]) == sorted(out["server"])


def test_client_stats_rejects_straggler_reply():
    rec = {}
    for C in (pkg("tpu"), pkg("torch")):
        cli = C.IngestClient("127.0.0.1", 1)
        sent: list = []

        def fake_send(frame, cli=cli, C=C, sent=sent):
            _ftype, seq, _len, _crc = C.wire.unpack_header(frame)
            sent.append(seq)
            with cli._lock:
                cli._stats_payload = b'{"which": "stale"}'
                cli._stats_reply_token = seq - 1
            cli._stats_evt.set()

            def late():
                time.sleep(0.15)
                with cli._lock:
                    cli._stats_payload = b'{"which": "fresh"}'
                    cli._stats_reply_token = seq
                cli._stats_evt.set()

            threading.Thread(target=late, daemon=True).start()

        cli._raw_send = fake_send
        got = cli.stats(timeout=5.0)
        assert got == {"which": "fresh"} and len(sent) == 1

        def stale_only(frame, cli=cli, C=C):
            _ftype, seq, _len, _crc = C.wire.unpack_header(frame)
            with cli._lock:
                cli._stats_payload = b'{"which": "stale"}'
                cli._stats_reply_token = seq - 1
            cli._stats_evt.set()

        cli._raw_send = stale_only
        with pytest.raises(C.IngestError, match="no STATS reply") as info:
            cli.stats(timeout=0.3)
        rec[C.name] = (got, sent, str(info.value))
    assert rec["torch"] == rec["tpu"]


def test_sharded_provider_watermarks_fully_retire(tmp_path):
    """Provider-path stamps draw dense positions (``wm_alloc``): the
    ledger is empty once the stream completes, fresh and resumed, and the
    labels and histogram counts are ``gelly_tpu``'s."""
    rng = np.random.default_rng(23)
    src = rng.integers(0, N_V, 900)
    dst = rng.integers(0, N_V, 900)
    path = str(tmp_path / "edges.bin")
    pkg("torch").readers.write_binary_edges(path, src, dst)
    rec = {}
    for P in (pkg("tpu"), pkg("torch")):
        def agg_stream(ck, resume, P=P):
            stream = P.readers.edge_stream_from_sharded_file(
                path, N_V, shards=3, chunk_size=64, **P.kw)
            return stream.aggregate(
                P.cc.connected_components(N_V), merge_every=4, fold_batch=2,
                source_provider=True, checkpoint_path=ck,
                checkpoint_every=1, resume=resume)

        ck1 = str(tmp_path / f"ck_fresh_{P.name}.npz")
        with P.obs.scope() as bus, P.obs.record_metrics():
            labels = np.asarray(agg_stream(ck1, resume=False).result())
            snap = bus.watermarks.snapshot()["stream"]
            assert snap["pending"] == 0, snap
            assert bus.watermarks.backlog_age("stream") == 0.0
            h = bus.snapshot()["histograms"]
            count = h["engine.e2e_ingress_to_durable_ms"]["count"]
            assert count == snap["base"] > 0
        ck2 = str(tmp_path / f"ck_resume_{P.name}.npz")
        it = iter(agg_stream(ck2, resume=False))
        for _ in range(2):
            next(it)
        it.close()
        _, pos, _ = P.checkpoint.load_checkpoint(ck2)
        assert pos > 0
        with P.obs.scope() as bus, P.obs.record_metrics():
            labels2 = np.asarray(agg_stream(ck2, resume=True).result())
            snap2 = bus.watermarks.snapshot()["stream"]
            assert snap2["pending"] == 0, snap2
            assert bus.watermarks.backlog_age("stream") == 0.0
        np.testing.assert_array_equal(labels, labels2)
        rec[P.name] = (labels.tobytes(), count, snap["base"], pos,
                       snap2["base"])
    assert rec["torch"] == rec["tpu"]


# --------------------------------------------------------------------- #
# tenant engine telemetry through the router


def _routed_tenants(client, tenants, seed):
    C = pkg(client)
    rng = np.random.default_rng(seed)
    for t in tenants:
        for _ in range(2):
            p = C.edge_payload(rng.integers(0, N_V, 8),
                               rng.integers(0, N_V, 8))
            p["tenant"] = np.array([t], np.int64)
            yield p


@pytest.mark.tenants
@_CLIENTS
def test_tenant_router_wires_engine_telemetry_into_stats(client):
    from gelly_torch.ingest import TenantRouter
    from gelly_torch.library.connected_components import cc_tenant_tier

    C = pkg(client)
    with buses("torch", client), obs.record_metrics():
        bus = obs.get_bus()
        agg, cap = cc_tenant_tier(N_V, chunk_capacity=16)
        eng = engine(pkg("torch"), merge_every=1).start()
        router = TenantRouter(eng, "small", vertex_capacity=N_V)
        eng.add_tier("small", agg, cap)
        srv = _start_server()
        try:
            router.attach(srv)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            for p in _routed_tenants(client, (3, 4), 11):
                cli.send(p)
            cli.flush(timeout=30)

            def folded():
                try:
                    return eng.position(3) >= 2 and eng.position(4) >= 2
                except KeyError:
                    return False

            assert wait(folded, 30)
            st = fetch_stats("127.0.0.1", srv.port)
            assert set(st["tenants"]) >= {"3", "4"}
            for tid in ("3", "4"):
                row = st["tenants"][tid]
                assert row["position"] >= 2
                assert row["backlog_age_s"] >= 0.0
                assert row["tier"] == "small"
            snap = bus.snapshot()
            assert "tenants.round_ms" in snap["histograms"]
            assert "tenants.t3.e2e_ingress_to_fold_ms" in snap["histograms"]
            assert snap["gauges"]["tenants.backlog_age_max_s"] >= 0.0
            cli.close(flush_timeout=None)
        finally:
            srv.stop()
            router.stop()
            eng.stop()
    # The telemetry row's keys are gelly_tpu's engine's.
    J = pkg("tpu")
    jeng = engine(J, merge_every=1)
    jagg, jcap = J.cc.cc_tenant_tier(N_V, chunk_capacity=16)
    jeng.add_tier("small", jagg, jcap)
    jeng.admit(3, "small")
    assert sorted(jeng.telemetry()["3"]) == sorted(row)


@_CLIENTS
def test_router_attach_rekeys_preattach_wire_stamps(client):
    from gelly_torch.ingest import TenantRouter
    from gelly_torch.library.connected_components import cc_tenant_tier

    C = pkg(client)
    with buses("torch", client), obs.record_metrics():
        bus = obs.get_bus()
        agg, cap = cc_tenant_tier(N_V, chunk_capacity=16)
        eng = engine(pkg("torch"), merge_every=1).start()
        router = TenantRouter(eng, "small", vertex_capacity=N_V)
        eng.add_tier("small", agg, cap)
        srv = _start_server()
        try:
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            rng = np.random.default_rng(17)
            p = C.edge_payload(rng.integers(0, N_V, 8),
                               rng.integers(0, N_V, 8))
            p["tenant"] = np.array([5], np.int64)
            cli.send(p)
            cli.flush(timeout=30)
            assert bus.watermarks.snapshot()["stream"]["pending"] == 1
            router.attach(srv)
            assert "stream" not in bus.watermarks.snapshot()
            wire_key = srv.watermark_stream
            assert wait(lambda: bus.watermarks.snapshot().get(
                wire_key, {}).get("pending") == 0, 30, 0.02)
            assert bus.watermarks.max_backlog_age() == pytest.approx(
                0.0, abs=60.0)
            cli.close(flush_timeout=None)
        finally:
            srv.stop()
            router.stop()
            eng.stop()


# --------------------------------------------------------------------- #
# STATS interleaved with DATA, SIGKILL, exactly-once and watermarks


def _spawn_child(ckpt, port_file, out, sleep_s):
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(here) + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(ckpt),
         str(port_file), str(out), str(sleep_s)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _wait_port(port_file, proc, timeout=180):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"child exited rc={proc.returncode} before publishing its "
                "port")
        if os.path.exists(port_file):
            return int(open(port_file).read())
        time.sleep(0.02)
    raise AssertionError("child never published its port")


@pytest.mark.slow
@pytest.mark.faults
def test_stats_mid_stream_sigkill_exactly_once_and_watermarks(tmp_path):
    import signal

    from gelly_torch.engine.checkpoint import load_checkpoint
    from gelly_torch.ingest import IngestClient
    from gelly_torch.ingest.client import IngestError, edge_payload

    rng = np.random.default_rng(41)
    total = 32
    payloads = [edge_payload(rng.integers(0, CHILD_NV, CHILD_CHUNK),
                             rng.integers(0, CHILD_NV, CHILD_CHUNK))
                for _ in range(total)]
    golden = np.zeros(CHILD_NV, dtype=np.int64)
    for p in payloads:
        golden += np.bincount(p["src"], minlength=CHILD_NV)
        golden += np.bincount(p["dst"], minlength=CHILD_NV)
    ckpt = str(tmp_path / "ck.npz")
    port_file = str(tmp_path / "port")
    out = str(tmp_path / "final.npz")
    p1 = _spawn_child(ckpt, port_file, out, 0.05)
    try:
        port = _wait_port(port_file, p1)
        cli = IngestClient("127.0.0.1", port, send_pause_timeout=60)
        cli.connect()
        sent = 0

        def sender():
            nonlocal sent
            while sent < total:
                try:
                    cli.send(payloads[sent])
                    sent += 1
                except IngestError:
                    sent += 1  # buffered; reconnect() delivers it
                    return

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        st = None
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if cli.acked >= 4:
                st = fetch_stats("127.0.0.1", port, timeout=10)
                hists = st["histograms"]
                if ("engine.fold_dispatch_ms" in hists
                        and "engine.checkpoint_write_ms" in hists
                        and "ingest.receive_to_stage_ms" in hists):
                    break
            time.sleep(0.05)
        else:
            pytest.fail("histograms never appeared in mid-stream STATS")
        for name in ("engine.fold_dispatch_ms",
                     "engine.checkpoint_write_ms",
                     "ingest.receive_to_stage_ms"):
            h = st["histograms"][name]
            assert h["count"] >= 1
            assert h["p50"] >= 0.0 and h["p99"] >= h["p50"] >= 0.0
        assert st["watermarks"]["stream"]["backlog_age_s"] >= 0.0
        assert st["server"]["auto_ack"] is False
        acked_before_kill = cli.acked
        assert acked_before_kill < total
        os.kill(p1.pid, signal.SIGKILL)
        assert p1.wait(timeout=60) == -signal.SIGKILL
        assert not os.path.exists(out)
        t.join(timeout=60)
    finally:
        if p1.poll() is None:
            p1.kill()
    os.unlink(port_file)
    p2 = _spawn_child(ckpt, port_file, out, 0.0)
    try:
        cli.port = _wait_port(port_file, p2)
        deadline = time.monotonic() + 60
        while True:
            try:
                cli.reconnect()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        assert cli.acked >= acked_before_kill
        while sent < total:
            cli.send(payloads[sent])
            sent += 1
        cli.flush(timeout=180)
        cli.close()
        assert p2.wait(timeout=300) == 0
    finally:
        if p2.poll() is None:
            p2.kill()
    final, pos, meta = load_checkpoint(out)
    ages, degrees, oldest = final
    assert pos == total
    np.testing.assert_array_equal(np.asarray(degrees), golden)
    assert np.all(np.asarray(ages) >= 0.0)
    assert np.all(np.asarray(ages) < 600.0)
    assert meta["resumed"] is True
    resume_pos = int(meta["resume_pos"])
    assert resume_pos >= acked_before_kill
    sampled = np.asarray(oldest)
    sampled = sampled[sampled >= 0]
    if sampled.size:
        assert int(sampled.min()) >= resume_pos
