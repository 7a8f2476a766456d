"""gelly_torch's multi-tenant wire vs gelly_tpu's (CPU).

Mirrors ``tests/test_tenant_wire.py``: pre-shared-key HELLO auth,
per-tenant sequence spaces, WELCOME hold/release and the legacy pause bit,
the typed NACK shed, tenant-mode CRC resync, checkpoint-gated per-tenant
acks through a ``TenantRouter`` over the port's ``MultiTenantEngine``,
tenant-scoped STACKED frames, and the SIGKILLed tenant server. Every
loopback scenario runs with a port server (and router and engine) and a
port client, a ``gelly_tpu`` server and a port client, and a port server
and a ``gelly_tpu`` client, and its record (frames, acks, counters, error
texts, folded labels) must equal the run of ``gelly_tpu`` alone. The kill
-9 cases restart the server in the same or the other package on the
per-tenant checkpoint rotation. Inputs are seeded with numpy; tolerance:
none.

Child: ``python tests/test_torch_tenant_wire.py <ckpt_dir> <port_file>
<out.npz> <total> [plain|stacked]`` with the repository root on
``PYTHONPATH`` (``tests/_qos_crash_child.py``'s server on the port).
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHILD_TENANTS = 3
CHILD_NV = 96
CHILD_CHUNK = 16


def child(argv) -> None:
    """``tests/_qos_crash_child.py`` on the port: a degree tier with
    per-tenant checkpoints behind a ``TenantRouter(checkpoint_acks=True)``
    and an ``auto_ack=False`` ``tenant_streams`` server."""
    ckpt_dir, port_file, out_path = argv[0], argv[1], argv[2]
    total = int(argv[3])
    stacked = len(argv) > 4 and argv[4] == "stacked"

    from gelly_torch.engine.checkpoint import save_checkpoint
    from gelly_torch.engine.tenants import MultiTenantEngine
    from gelly_torch.ingest import IngestServer, TenantRouter
    from gelly_torch.library.degrees import degree_aggregate
    from gelly_torch.obs import bus as obs_bus

    eng = MultiTenantEngine(merge_every=2, checkpoint_dir=ckpt_dir,
                            checkpoint_every=1, resume=True, device="cpu")
    eng.add_tier("deg", degree_aggregate(CHILD_NV, ingest_combine=False),
                 CHILD_CHUNK)
    for tid in range(CHILD_TENANTS):
        eng.admit(tid, "deg")
    srv = IngestServer(auto_ack=False, tenant_streams=True,
                       queue_depth=16).start()
    router = TenantRouter(eng, "deg", vertex_capacity=CHILD_NV,
                          checkpoint_acks=True)
    eng.start()
    router.attach(srv)
    tmp = port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, port_file)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if all(eng.position(t) >= total for t in range(CHILD_TENANTS)):
                break
            time.sleep(0.02)
        for tid in range(CHILD_TENANTS):
            eng.finish(tid)
        while time.time() < deadline:
            tel = eng.telemetry()
            if all(tel[str(t)]["done"] for t in range(CHILD_TENANTS)):
                break
            time.sleep(0.02)
        time.sleep(0.5)  # an idle round flushes the last partial windows
        rows = [np.asarray(eng.degree(t)) for t in range(CHILD_TENANTS)]
        positions = [eng.position(t) for t in range(CHILD_TENANTS)]
        if stacked:
            assert obs_bus.get_bus().counters.get(
                "ingest.frames_stacked", 0) > 0, "no STACKED frame staged"
    finally:
        srv.stop()
        router.stop()
        eng.stop()
    save_checkpoint(out_path, rows, position=sum(positions))


if __name__ == "__main__":
    child(sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

import pytest  # noqa: E402

sys.path.insert(0, HERE)

from _torch_wire import (  # noqa: E402
    PAIR_IDS,
    PAIRS,
    arr,
    buses,
    check_pair,
    drain_frames,
    engine,
    error_of,
    payload_record,
    pkg,
    wait,
)

pytestmark = pytest.mark.ingest
T, J = pkg("torch"), pkg("tpu")
N_V = 128
pair = pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)


def _tenant_of(p) -> int:
    return int(np.asarray(p["tenant"]).reshape(-1)[0])


# ---------------------------------------------------------------------- #
# pre-shared-key HELLO auth


def _auth_ok(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(auth_token="sesame") as srv:
            out: list = []
            drain_frames(srv, out)
            with C.IngestClient("127.0.0.1", srv.port,
                                auth_token="sesame") as cli:
                for i in range(3):
                    cli.send(C.edge_payload([i, i + 1], [i + 2, i + 3]))
                cli.flush(timeout=10)
            assert wait(lambda: len(out) == 3)
        counters = b.counters()
        return {"frames": [(s_, payload_record(p)) for s_, p, _ in out],
                "challenges": counters.get("ingest.auth_challenges"),
                "failures": counters.get("ingest.auth_failures", 0)}


@pair
def test_auth_handshake_accepts_matching_token(server, client):
    check_pair(_auth_ok, server, client)


def _auth_missing(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(auth_token="sesame") as srv:
            cli = C.IngestClient("127.0.0.1", srv.port,
                                 connect_timeout=5.0)
            return error_of(cli.connect)


@pair
def test_auth_missing_token_raises_before_streaming(server, client):
    check_pair(_auth_missing, server, client)
    assert "pre-shared auth token" in _auth_missing(server, client)


def _auth_wrong(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(auth_token="sesame") as srv:
            cli = C.IngestClient("127.0.0.1", srv.port, auth_token="wrong",
                                 connect_timeout=5.0)
            msg = error_of(cli.connect)
        counters = b.counters()
        return {"error": msg,
                "failures": counters.get("ingest.auth_failures"),
                "challenges": counters.get("ingest.auth_challenges")}


@pair
def test_auth_wrong_token_gets_typed_auth_fail(server, client):
    check_pair(_auth_wrong, server, client)
    assert "authentication failed" in _auth_wrong(server, client)["error"]


def _read_frame(P, sock):
    return P.wire.read_frame(sock.recv)


def test_auth_refuses_data_before_handshake():
    rec = {}
    for S in (J, T):
        with buses(S.name) as b:
            with S.IngestServer(auth_token="sesame") as srv:
                raw = socket.create_connection(("127.0.0.1", srv.port),
                                               timeout=5)
                raw.settimeout(5)
                try:
                    raw.sendall(S.wire.pack_frame(
                        S.wire.DATA, 0,
                        S.wire.pack_payload(S.edge_payload([1], [2]))))
                    first = _read_frame(S, raw)[0]
                    second = _read_frame(S, raw)[0]
                finally:
                    raw.close()
            rec[S.name] = (first, second,
                           b.counter("ingest.auth_failures"))
    assert rec["torch"] == (T.wire.AUTH_FAIL, T.wire.BYE, 1)
    assert rec["torch"] == rec["tpu"]


# ---------------------------------------------------------------------- #
# per-tenant sequence spaces


def _distinct_spaces(s, c, stack):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(tenant_streams=True) as srv:
            out: list = []
            drain_frames(srv, out)
            cli = C.IngestClient("127.0.0.1", srv.port, tenant_streams=True,
                                 stack=stack).connect()
            try:
                for i in range(4):
                    cli.send(C.edge_payload([i], [i + 1]), tenant=7)
                    if i < 2:
                        cli.send(C.edge_payload([i], [i + 2]), tenant=9)
                cli.flush(timeout=10)
                acks = (cli.acked_for(7), cli.acked_for(9))
                assert wait(lambda: len(out) == 6)
            finally:
                cli.close(flush_timeout=None)
        counters = b.counters()
        return {"acks": acks,
                "seqs": sorted((_tenant_of(p), s_) for s_, p, _ in out),
                "stacked": counters.get("ingest.frames_stacked", 0),
                "unroutable": counters.get("ingest.chunks_unroutable", 0)}


@pair
def test_tenant_streams_have_distinct_seq_spaces(server, client):
    check_pair(_distinct_spaces, server, client, 1)
    rec = _distinct_spaces(server, client, 1)
    assert rec["acks"] == (4, 2)
    assert rec["seqs"] == [(7, 0), (7, 1), (7, 2), (7, 3), (9, 0), (9, 1)]


# ---------------------------------------------------------------------- #
# WELCOME carries park/pause/shed state


def _welcome_hold(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(tenant_streams=True) as srv:
            srv.pause_tenant(3)  # no connection yet: state only
            cli = C.IngestClient("127.0.0.1", srv.port, tenant_streams=True,
                                 send_pause_timeout=10).connect()
            try:
                held = (cli.tenant_paused(3), cli.tenant_paused(4))
                cli.send(C.edge_payload([1], [2]), tenant=4)
                cli.flush(timeout=10)
                done = threading.Event()

                def held_send():
                    cli.send(C.edge_payload([5], [6]), tenant=3)
                    done.set()

                t = threading.Thread(target=held_send, daemon=True)
                t.start()
                time.sleep(0.2)
                blocked = not done.is_set()
                srv.resume_tenant(3)
                released = done.wait(5)
                cli.flush(timeout=10)
                srv.pause_tenant(3)
                assert wait(lambda: cli.tenant_paused(3))
                cli.close(flush_timeout=None)
                srv.resume_tenant(3)  # lands in no socket: state only
                cli.connect()
                after = cli.tenant_paused(3)
                cli.send(C.edge_payload([7], [8]), tenant=3)
                cli.flush(timeout=10)
                acks = (cli.acked_for(3), cli.acked_for(4))
            finally:
                cli.close(flush_timeout=None)
        return {"held": held, "blocked": blocked, "released": released,
                "after": after, "acks": acks}


@pair
def test_welcome_carries_tenant_hold_and_release(server, client):
    check_pair(_welcome_hold, server, client)
    rec = _welcome_hold(server, client)
    assert rec["held"] == (True, False) and rec["blocked"]
    assert rec["released"] and rec["after"] is False


def _welcome_legacy(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer() as srv:
            srv.pause_tenant(0)
            cli = C.IngestClient("127.0.0.1", srv.port,
                                 connect_timeout=5.0).connect()
            try:
                paused = cli.paused
                srv.resume_tenant(0)
                assert wait(lambda: not cli.paused)
                cli.send(C.edge_payload([1], [2]))
                flushed = cli.flush(timeout=10)
            finally:
                cli.close(flush_timeout=None)
        return {"paused": paused, "flushed": flushed}


@pair
def test_welcome_carries_legacy_pause_bit(server, client):
    check_pair(_welcome_legacy, server, client)
    assert _welcome_legacy(server, client)["paused"] is True


# ---------------------------------------------------------------------- #
# typed NACK shed


def _shed(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(tenant_streams=True) as srv:
            out: list = []
            drain_frames(srv, out)
            cli = C.IngestClient("127.0.0.1", srv.port,
                                 tenant_streams=True).connect()
            cli.send(C.edge_payload([1], [2]), tenant=5)
            cli.send(C.edge_payload([1], [2]), tenant=6)
            cli.flush(timeout=10)
            srv.shed_tenant(5, reason="overload")
            assert wait(lambda: 5 in cli.shed_tenants)
            reason = cli.shed_tenants[5]
            send_error = error_of(
                lambda: cli.send(C.edge_payload([3], [4]), tenant=5))
            cli.send(C.edge_payload([3], [4]), tenant=6)
            cli.flush(timeout=10)
            ack6 = cli.acked_for(6)
            cli.close(flush_timeout=None)
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            raw.settimeout(5)
            try:
                raw.sendall(C.wire.pack_frame(C.wire.HELLO, 0))
                ftype, _seq, wbody = _read_frame(C, raw)
                info = C.wire.unpack_json(wbody)
                p = C.edge_payload([9], [10])
                p["tenant"] = np.asarray([5], dtype=np.int64)
                raw.sendall(C.wire.pack_frame(C.wire.DATA, 1,
                                              C.wire.pack_payload(p)))
                nack = _read_frame(C, raw)
                env = C.wire.unpack_json(nack[2])
            finally:
                raw.close()
        counters = b.counters()
        assert counters.get("ingest.nacks_sent", 0) >= 2
        return {"reason": reason, "send_error": send_error, "ack6": ack6,
                "welcome": (ftype, info["shed_tenants"]),
                "nack": (nack[0], nack[1], env),
                "nacks_received": counters.get("ingest.nacks_received"),
                "shed": counters.get("ingest.frames_shed")}


@pair
def test_shed_tenant_nacks_and_closes_stream(server, client):
    check_pair(_shed, server, client)
    rec = _shed(server, client)
    assert rec["reason"] == "overload" and "shed" in rec["send_error"]
    assert rec["nack"] == (T.wire.NACK, 0,
                           {"reason": "overload", "tenant": 5})


# ---------------------------------------------------------------------- #
# tenant-mode CRC resync, checkpoint-gated acks, stacks through a router


def _oracle_labels(P, agg, edges):
    st = P.top.edge_stream_from_edges(
        [(int(a), int(b)) for a, b in edges], vertex_capacity=N_V,
        chunk_size=16, table=P.vertices.IdentityVertexTable(N_V), **P.kw)
    return arr(st.aggregate(agg, merge_every=1).result())


def _routed(s, c, edges, tenant, stack, corrupt):
    S, C = pkg(s), pkg(c)
    agg, cap = S.cc.cc_tenant_tier(N_V, chunk_capacity=16)
    with buses(s, c) as b:
        eng = engine(S, merge_every=1).start()
        router = S.TenantRouter(eng, "small", vertex_capacity=N_V)
        eng.add_tier("small", agg, cap)
        srv = S.IngestServer(tenant_streams=True).start()
        router.attach(srv)
        cli = C.IngestClient("127.0.0.1", srv.port, tenant_streams=True,
                             stack=stack).connect()
        left = [1 if corrupt else 0]
        try:
            orig = cli._raw_send

            def corrupting(frame):
                if left[0] and len(frame) > 200:  # only DATA is this big
                    left[0] -= 1
                    frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
                orig(frame)

            cli._raw_send = corrupting
            for i in range(0, len(edges), 16):
                cli.send(C.edge_payload(edges[i:i + 16, 0],
                                        edges[i:i + 16, 1]), tenant=tenant)
            cli.flush(timeout=30)
            assert left[0] == 0

            def folded():
                # position() counts a chunk when its fold is dispatched;
                # its window's snapshot is published after the fold, so
                # the labels are read only once the snapshot covers the
                # last window (merge_every=1: one window a chunk).
                try:
                    return (eng.position(tenant) >= len(edges) // 16
                            and eng.queue_depth() == 0
                            and eng.snapshot_window(tenant)
                            >= len(edges) // 16)
                except KeyError:
                    return False  # auto-admission not seen yet

            assert wait(folded, timeout=30)
            eng.finish(tenant)
            assert wait(lambda: eng.snapshot_window(tenant) > 0, timeout=10)
            got = arr(eng.labels(tenant))
        finally:
            cli.close(flush_timeout=None)
            eng.stop()
            srv.stop()
            router.stop()
        counters = b.counters()
    assert got.tobytes() == _oracle_labels(S, agg, edges).tobytes()
    rec = {"labels": got, "stacked": counters.get("ingest.frames_stacked", 0),
           "enqueued": counters.get("ingest.chunks_enqueued")}
    if corrupt:
        assert counters.get("ingest.frames_rejected", 0) >= 1
        assert counters.get("ingest.frames_resent", 0) >= 1
    else:
        rec["rejected"] = counters.get("ingest.frames_rejected", 0)
    return rec


@pair
def test_tenant_mode_crc_corruption_resyncs_and_completes(server, client):
    edges = np.random.default_rng(41).integers(0, N_V, (64, 2))
    check_pair(_routed, server, client, edges, 3, 1, True)


@pair
def test_checkpoint_gated_acks_flow_through_router(server, client,
                                                   tmp_path):
    S, C = pkg(server), pkg(client)
    edges = {t: np.random.default_rng(50 + t).integers(0, N_V, (64, 2))
             for t in (1, 2)}
    agg, cap = S.cc.cc_tenant_tier(N_V, chunk_capacity=16)
    with buses(server, client):
        eng = engine(S, merge_every=1, checkpoint_dir=str(tmp_path),
                     checkpoint_every=1).start()
        router = S.TenantRouter(eng, "small", vertex_capacity=N_V,
                                checkpoint_acks=True)
        eng.add_tier("small", agg, cap)
        srv = S.IngestServer(tenant_streams=True, auto_ack=False).start()
        router.attach(srv)
        cli = C.IngestClient("127.0.0.1", srv.port,
                             tenant_streams=True).connect()
        try:
            for t in (1, 2):
                for i in range(0, 64, 16):
                    cli.send(C.edge_payload(edges[t][i:i + 16, 0],
                                            edges[t][i:i + 16, 1]),
                             tenant=t)
            cli.flush(timeout=60)  # only checkpoint-gated acks complete it
            for t in (1, 2):
                assert cli.acked_for(t) == 4
                assert eng.position(t) == 4
                assert list(tmp_path.glob(f"t{t}-*.npz"))
            assert cli.unacked_count == 0
        finally:
            cli.close(flush_timeout=None)
            eng.stop()
            srv.stop()
            router.stop()
    # The per-tenant rotation the port wrote resumes in gelly_tpu's
    # engine at the acked position, and vice versa.
    other = J if S is T else T
    eng2 = engine(other, merge_every=1, checkpoint_dir=str(tmp_path),
                  checkpoint_every=1, resume=True)
    agg2, cap2 = other.cc.cc_tenant_tier(N_V, chunk_capacity=16)
    eng2.add_tier("small", agg2, cap2)
    for t in (1, 2):
        eng2.admit(t, "small")
        assert eng2.position(t) == 4


@pair
def test_stacks_are_tenant_scoped_on_the_wire(server, client):
    check_pair(_distinct_spaces, server, client, 3)
    rec = _distinct_spaces(server, client, 3)
    assert rec["seqs"] == [(7, 0), (7, 1), (7, 2), (7, 3), (9, 0), (9, 1)]
    assert rec["stacked"] == 2 and rec["unroutable"] == 0


def _mixed_stack(s, c):
    S, C = pkg(s), pkg(c)

    def tp(t, v):
        p = C.edge_payload([v], [v + 1])
        if t is not None:
            p["tenant"] = np.asarray([t], dtype=np.int64)
        return p

    def stack(*payloads):
        return C.wire.pack_stacked(
            [(C.wire.pack_payload(p), False) for p in payloads])

    with buses(s, c) as b:
        with S.IngestServer(tenant_streams=True) as srv:
            out: list = []
            drain_frames(srv, out)
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            raw.settimeout(5)
            try:
                raw.sendall(C.wire.pack_frame(C.wire.HELLO, 0))
                welcome = _read_frame(C, raw)[0]
                raw.sendall(C.wire.pack_frame(
                    C.wire.STACKED, 0, stack(tp(3, 1), tp(4, 2))))
                raw.sendall(C.wire.pack_frame(
                    C.wire.STACKED, 0, stack(tp(None, 3), tp(None, 4))))
                raw.sendall(C.wire.pack_frame(
                    C.wire.STACKED, 0, stack(tp(3, 5), tp(3, 6))))
                ftype, seq, body = _read_frame(C, raw)
                ack = (ftype, seq, C.wire.unpack_json(body))
            finally:
                raw.close()
            assert wait(lambda: len(out) == 2)
        counters = b.counters()
        return {"welcome": welcome, "ack": ack,
                "frames": [(s_, payload_record(p)) for s_, p, _ in out],
                "unroutable": counters.get("ingest.chunks_unroutable"),
                "stacked": counters.get("ingest.frames_stacked")}


@pair
def test_mixed_tenant_stack_refused_whole(server, client):
    check_pair(_mixed_stack, server, client)
    rec = _mixed_stack(server, client)
    assert rec["ack"] == (T.wire.ACK, 2, {"tenant": 3})
    assert (rec["unroutable"], rec["stacked"]) == (2, 1)


@pair
def test_stacked_tenant_stream_folds_bit_identical_through_router(server,
                                                                  client):
    edges = np.random.default_rng(77).integers(0, N_V, (96, 2))
    check_pair(_routed, server, client, edges, 5, 3, False)
    rec = _routed(server, client, edges, 5, 3, False)
    assert (rec["stacked"], rec["enqueued"], rec["rejected"]) == (2, 6, 0)


# ---------------------------------------------------------------------- #
# SIGKILL: the multi-tenant exactly-once wire


def _spawn(ckpt, port_file, out, total, framing, who):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    script = (os.path.abspath(__file__) if who == "torch"
              else os.path.join(HERE, "_qos_crash_child.py"))
    return subprocess.Popen(
        [sys.executable, script, str(ckpt), str(port_file), str(out),
         str(total), framing],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _wait_port(port_file, proc, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"server child exited rc={proc.returncode} before "
                "publishing its port")
        if os.path.exists(port_file):
            return int(open(port_file).read())
        time.sleep(0.02)
    raise AssertionError("server child never published its port")


def _sigkill_tenants(tmp_path, stack, first, second, client):
    C = pkg(client)
    TIDS = tuple(range(CHILD_TENANTS))
    total = 10
    edges = {t: np.random.default_rng(300 + t).integers(
        0, CHILD_NV, (total * CHILD_CHUNK, 2)) for t in TIDS}

    def mk(t, i):
        lo, hi = i * CHILD_CHUNK, (i + 1) * CHILD_CHUNK
        return C.edge_payload(edges[t][lo:hi, 0], edges[t][lo:hi, 1])

    # Golden: every tenant's degrees (additive, so cadence is immaterial;
    # a double or dropped fold changes the counts).
    golden = {}
    for t in TIDS:
        e = edges[t]
        golden[t] = (np.bincount(e[:, 0], minlength=CHILD_NV)
                     + np.bincount(e[:, 1], minlength=CHILD_NV))
    framing = "stacked" if stack > 1 else "plain"
    ckpt = tmp_path / "ckpt"
    port_file = str(tmp_path / "port")
    out = str(tmp_path / "final.npz")
    p1 = _spawn(ckpt, port_file, out, total, framing, first)
    try:
        port = _wait_port(port_file, p1)
        cli = C.IngestClient("127.0.0.1", port, tenant_streams=True,
                             send_pause_timeout=60, stack=stack)
        cli.connect()

        def sender():
            try:
                for i in range(total):
                    for t in TIDS:
                        cli.send(mk(t, i), tenant=t)
                    time.sleep(0.03)
            except C.IngestError:
                return  # server died mid-send; the suffix resends below

        st = threading.Thread(target=sender, daemon=True)
        st.start()
        assert wait(lambda: all(list(ckpt.glob(f"t{t}-*.npz")) for t in TIDS)
                    and all(cli.acked_for(t) >= 2 for t in TIDS), 180,
                    0.02), "no per-tenant checkpoints/acks"
        acked_before = {t: cli.acked_for(t) for t in TIDS}
        os.kill(p1.pid, signal.SIGKILL)
        assert p1.wait(timeout=60) == -signal.SIGKILL
        assert not os.path.exists(out)
        st.join(timeout=60)
    finally:
        if p1.poll() is None:
            p1.kill()
    with cli._lock:
        buffered = {t: cli._next.get(t, 0) for t in TIDS}
    os.unlink(port_file)
    p2 = _spawn(ckpt, port_file, out, total, framing, second)
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
        for t in TIDS:  # acked work never rewinds
            assert cli.acked_for(t) >= acked_before[t]
        for t in TIDS:
            for i in range(buffered[t], total):
                cli.send(mk(t, i), tenant=t)
        cli.flush(timeout=180)
        cli.close()
        assert p2.wait(timeout=300) == 0
    finally:
        if p2.poll() is None:
            p2.kill()
    final, pos, _ = pkg(second).checkpoint.load_checkpoint(out)
    assert pos == total * len(TIDS)
    for t in TIDS:
        got = arr(final[t])
        np.testing.assert_array_equal(got.astype(np.int64), golden[t])


@pytest.mark.faults
@pytest.mark.tenants
def test_sigkilled_multitenant_server_resumes_exactly_once(tmp_path):
    """Three tenants on one ``tenant_streams`` port server with
    checkpoint-gated acks and a ``stack=3`` client, SIGKILLed mid-stream
    and restarted on its per-tenant checkpoints: the degree vectors
    (non-idempotent counts) equal ``np.bincount``'s."""
    _sigkill_tenants(tmp_path, 3, "torch", "torch", "torch")


@pytest.mark.slow
@pytest.mark.faults
@pytest.mark.tenants
@pytest.mark.parametrize("stack,first,second,client", [
    (1, "torch", "torch", "torch"),
    (3, "torch", "tpu", "tpu"),
    (1, "tpu", "torch", "torch"),
])
def test_sigkilled_multitenant_server_resumes_exactly_once_matrix(
        tmp_path, stack, first, second, client):
    _sigkill_tenants(tmp_path, stack, first, second, client)
