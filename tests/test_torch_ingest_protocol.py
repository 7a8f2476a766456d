"""gelly_torch's wire protocol vs gelly_tpu's (CPU).

Mirrors ``tests/test_ingest_protocol.py``: framing and the payload codec,
CRC reject and retransmit, torn frames, duplicates and re-acks, reconnects
at the acked seq, gauge-driven PAUSE/RESUME, batched acks, the ``"ingest"``
fault boundary, DATA_COMPRESSED frames, STACKED frames (the age deadline,
the byte ceiling, mid-frame resume, the covering-frame rewind), the
precompressed fold and its refusals, and the SIGKILLed server. Every
loopback scenario runs with a port server and a port client, a
``gelly_tpu`` server and a port client, and a port server and a
``gelly_tpu`` client, and its record (seqs, payloads, deterministic
counters, emissions) must equal the run of ``gelly_tpu`` alone; framing
tests hold the bytes equal and unpack each package's frames in the other.
The kill -9 cases kill a server of one package and restart a server of the
same or the other package on its checkpoints (``CheckpointManager``
rotations read across the packages), with the client resending from the
WELCOME position. Inputs are seeded with numpy; tolerance: none.

Child: ``python tests/test_torch_ingest_protocol.py <ckpt_dir> <port_file>
<out.npz> <total> <sleep_s> <raw|compressed> <plain|stacked>`` with the
repository root on ``PYTHONPATH`` (``tests/_ingest_crash_child.py``'s
server on the port).
"""

import io
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N_V_CHILD = 256
CKPT_EVERY = 4


def _child_init() -> dict:
    return {
        "parent": np.arange(N_V_CHILD, dtype=np.int32),
        "chunks": np.zeros((), dtype=np.int64),
        "edges": np.zeros((), dtype=np.int64),
    }


def _find(parent: np.ndarray, v: int) -> int:
    while parent[v] != v:
        parent[v] = parent[parent[v]]
        v = parent[v]
    return int(v)


def _child_fold(state: dict, payload: dict) -> dict:
    """``tests/_ingest_crash_child.py``'s fold: a numpy union-find with
    chunk and edge counters (union is idempotent, the counters are not)."""
    parent = state["parent"].copy()
    src = np.asarray(payload["src"] if "src" in payload else payload["v"])
    dst = np.asarray(payload["dst"] if "dst" in payload else payload["r"])
    for a, b in zip(src.tolist(), dst.tolist()):
        ra, rb = _find(parent, a), _find(parent, b)
        if ra != rb:
            lo, hi = (ra, rb) if ra < rb else (rb, ra)
            parent[hi] = lo
    return {"parent": parent, "chunks": state["chunks"] + 1,
            "edges": state["edges"] + np.int64(src.shape[0])}


def _child_labels(state: dict) -> np.ndarray:
    parent = state["parent"].copy()
    return np.asarray([_find(parent, v) for v in range(N_V_CHILD)],
                      dtype=np.int32)


def child(argv) -> None:
    """The kill -9 child on the port: an ``IngestServer(auto_ack=False)``
    feeding the checkpointed fold; a frame is acked only after a
    checkpoint covering it is written."""
    ckpt_dir, port_file, out_path = argv[0], argv[1], argv[2]
    total = int(argv[3])
    sleep_s = float(argv[4])
    compressed = argv[5] == "compressed"
    stacked = argv[6] == "stacked"

    from gelly_torch.engine.checkpoint import save_checkpoint
    from gelly_torch.engine.resilience import CheckpointManager
    from gelly_torch.ingest import IngestServer
    from gelly_torch.obs import bus as obs_bus

    mgr = CheckpointManager(ckpt_dir, keep=3, async_write=False)
    state = _child_init()
    pos = 0
    found = mgr.load_latest(like=state)
    if found is not None:
        state, pos, _meta, _path = found
        state = {k: np.asarray(v) for k, v in state.items()}
    srv = IngestServer(auto_ack=False, resume_seq=pos, queue_depth=8).start()
    tmp = port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, port_file)
    try:
        for seq, payload, is_comp in srv.frames():
            if sleep_s:
                time.sleep(sleep_s)
            assert seq == pos, f"sequence skew: frame {seq} at {pos}"
            assert is_comp == compressed, (seq, is_comp)
            state = _child_fold(state, payload)
            pos = seq + 1
            if pos % CKPT_EVERY == 0:
                mgr.save(state, pos)
                srv.ack(pos)  # durability first, ack second
            if pos == total:
                break
        mgr.save(state, pos)
        srv.ack(pos)
        if stacked:
            assert obs_bus.get_bus().counters.get(
                "ingest.frames_stacked", 0) > 0, "no STACKED frame staged"
    finally:
        srv.stop()
    save_checkpoint(out_path, state, position=pos)


if __name__ == "__main__":
    child(sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------- #
# the tests

sys.path.insert(0, HERE)

from _torch_wire import (  # noqa: E402
    PAIR_IDS,
    PAIRS,
    buses,
    check_pair,
    drain,
    drain_frames,
    error_of,
    host_chunk,
    mesh1,
    payload_record,
    pkg,
    same,
    wait,
)

pytestmark = pytest.mark.ingest
T, J = pkg("torch"), pkg("tpu")
pair = pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)


# ---------------------------------------------------------------------- #
# framing + payload codec


def _payload_sample():
    rng = np.random.default_rng(3)
    return {
        "v": rng.integers(0, 1 << 20, 9).astype(np.int32),
        "r": rng.integers(-5, 5, (2, 3)).astype("<i8"),
        "w": rng.random(4).astype("<f4"),
        "b": np.asarray([True, False]),
    }


def test_frame_roundtrip():
    body = T.wire.pack_payload({"v": np.arange(9, dtype=np.int32)})
    assert body == J.wire.pack_payload({"v": np.arange(9, dtype=np.int32)})
    frame = T.wire.pack_frame(T.wire.DATA, 41, body)
    assert frame == J.wire.pack_frame(J.wire.DATA, 41, body)
    for P, Q in ((T, J), (J, T)):
        ftype, seq, payload = Q.wire.read_frame(
            io.BytesIO(P.wire.pack_frame(P.wire.DATA, 41, body)).read)
        assert (ftype, seq) == (T.wire.DATA, 41)
        np.testing.assert_array_equal(
            Q.wire.unpack_payload(payload)["v"], np.arange(9))


def test_payload_codec_roundtrip_and_determinism():
    p = _payload_sample()
    b1 = T.wire.pack_payload(p)
    b2 = T.wire.pack_payload(dict(reversed(p.items())))
    assert b1 == b2 == J.wire.pack_payload(p)  # sorted keys, same bytes
    for Q in (T, J):
        out = Q.wire.unpack_payload(b1)
        assert set(out) == set(p)
        same(p, out)
    # A port payload of tensors packs to the same bytes as its arrays.
    import torch

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert T.wire.pack_payload(tp) == b1


def test_payload_codec_rejects_malformed():
    good = T.wire.pack_payload({"v": np.arange(4, dtype=np.int32)})
    for bad in (good[:-3], good + b"xx"):
        errs = [error_of(lambda Q=Q: Q.wire.unpack_payload(bad))
                for Q in (J, T)]
        assert errs[0] is not None and errs[0].startswith("FrameError")
        assert errs[0] == errs[1]


def test_header_validation():
    cases = [
        b"XX" + b"\0" * (T.wire.HEADER_BYTES - 2),
        struct.pack(">HBBQII", T.wire.MAGIC, T.wire.DATA, 0, 0,
                    T.wire.MAX_PAYLOAD + 1, 0),
        struct.pack(">HBBQII", T.wire.MAGIC, 99, 0, 0, 0, 0),
    ]
    assert (T.wire.MAGIC, T.wire.HEADER_BYTES, T.wire.MAX_PAYLOAD) == (
        J.wire.MAGIC, J.wire.HEADER_BYTES, J.wire.MAX_PAYLOAD)
    assert T.wire.FRAME_TYPES == J.wire.FRAME_TYPES
    for hdr, match in zip(cases, ("magic", "MAX_PAYLOAD", "frame type")):
        with pytest.raises(T.wire.FrameError, match=match):
            T.wire.unpack_header(hdr)
        assert error_of(lambda: T.wire.unpack_header(hdr)) == error_of(
            lambda: J.wire.unpack_header(hdr))


def test_crc_mismatch_detected():
    body = T.wire.pack_payload({"v": np.arange(4, dtype=np.int32)})
    frame = bytearray(T.wire.pack_frame(T.wire.DATA, 3, body))
    frame[-1] ^= 0xFF  # flip one payload byte
    for Q in (T, J):
        with pytest.raises(Q.wire.CrcMismatch):
            Q.wire.read_frame(io.BytesIO(bytes(frame)).read)
        ftype, seq, _payload, ok = Q.wire.read_frame_checked(
            io.BytesIO(bytes(frame)).read)
        assert (ftype, seq, ok) == (T.wire.DATA, 3, False)


def test_truncated_frame_detected():
    body = T.wire.pack_payload({"v": np.arange(4, dtype=np.int32)})
    frame = T.wire.pack_frame(T.wire.DATA, 3, body)
    for Q in (T, J):
        with pytest.raises(Q.wire.TruncatedFrame):
            Q.wire.read_frame(io.BytesIO(frame[: len(frame) // 2]).read)
        assert Q.wire.read_frame(io.BytesIO(b"").read)[0] == Q.wire.BYE


def test_json_trace_and_stacked_frames_cross_packages():
    """Every frame family packs to the same bytes in both packages and
    unpacks in the other: JSON bodies, trace stamps, stacked bodies."""
    doc = {"tenant": 3, "reason": "overload", "nested": {"a": [1, 2]}}
    assert T.wire.pack_json(doc) == J.wire.pack_json(doc)
    assert J.wire.unpack_json(T.wire.pack_json(doc)) == doc
    p = _payload_sample()
    for P, Q in ((T, J), (J, T)):
        stamped = P.wire.stamp_trace(dict(p), "00000000deadbeef", 77)
        blob = P.wire.pack_payload(stamped)
        back = Q.wire.unpack_payload(blob)
        assert Q.wire.pop_trace(back) == P.wire.pop_trace(dict(stamped))
        same(p, back)
    parts = [(T.wire.pack_payload(T.edge_payload([i], [i + 1])), i % 2 == 0)
             for i in range(5)]
    body = T.wire.pack_stacked(parts)
    assert body == J.wire.pack_stacked(parts)
    assert J.wire.unpack_stacked(body) == T.wire.unpack_stacked(body) \
        == parts
    frame = T.wire.pack_frame(T.wire.STACKED, 12, body)
    assert frame == J.wire.pack_frame(J.wire.STACKED, 12, body)
    assert J.wire.read_frame(io.BytesIO(frame).read) == (
        J.wire.STACKED, 12, body)


# ---------------------------------------------------------------------- #
# loopback server/client


def _in_order_with_acks(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                for i in range(25):
                    cli.send(C.edge_payload([i], [i + 1]))
                cli.flush(timeout=10)
                assert cli.acked == 25
                assert cli.unacked_count == 0
        t.join(timeout=5)
        snap = b.counters()
        assert snap["ingest.acks_sent"] >= 1
        return {"seqs": [s_ for s_, _ in got],
                "payloads": [payload_record(p) for _, p in got],
                "enqueued": snap["ingest.chunks_enqueued"]}


@pair
def test_loopback_stream_in_order_with_acks(server, client):
    check_pair(_in_order_with_acks, server, client)


def _reconnect(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            for i in range(10):
                cli.send(C.edge_payload([i], [i]))
            cli.flush(timeout=10)
            cli._teardown_socket()
            cli.reconnect()
            for i in range(10, 15):
                cli.send(C.edge_payload([i], [i]))
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "enqueued": b.counter("ingest.chunks_enqueued")}


@pair
def test_reconnect_resumes_at_acked_seq(server, client):
    check_pair(_reconnect, server, client)


def _inject(cli, frame: bytes) -> None:
    with cli._send_lock:
        cli._sock.sendall(frame)


def _corrupt_retransmit(s, c, compressed):
    S, C = pkg(s), pkg(c)
    if compressed:
        def mk(i):
            return {"v": np.asarray([i * 7], np.int32),
                    "r": np.asarray([0], np.int32)}

        def send(cli, i):
            cli.send_compressed(mk(i))
        kind = C.wire.DATA_COMPRESSED
    else:
        def mk(i):
            return C.edge_payload([i], [i])

        def send(cli, i):
            cli.send(mk(i))
        kind = C.wire.DATA
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            send(cli, 0)
            cli.flush(timeout=10)
            frame = bytearray(C.wire.pack_frame(
                kind, 1, C.wire.pack_payload(mk(1))))
            frame[-1] ^= 0xFF
            _inject(cli, bytes(frame))
            assert wait(lambda: b.counter("ingest.frames_rejected") >= 1, 5)
            assert srv.next_seq == 1  # never advanced past bad bytes
            send(cli, 1)
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "payloads": [payload_record(p) for _, p in got]}


@pair
def test_corrupt_frame_rejected_and_retransmitted(server, client):
    check_pair(_corrupt_retransmit, server, client, False)


def _torn(s, c, compressed):
    S, C = pkg(s), pkg(c)
    if compressed:
        body = C.wire.pack_payload({"v": np.arange(8, dtype=np.int32),
                                    "r": np.zeros(8, np.int32)})
        frame = C.wire.pack_frame(C.wire.DATA_COMPRESSED, 0, body)
        cut = 9
    else:
        body = C.wire.pack_payload(C.edge_payload([5], [6]))
        frame = C.wire.pack_frame(C.wire.DATA, 0, body)
        cut = 7
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            raw.sendall(frame[: len(frame) - cut])  # torn mid-payload
            raw.close()
            assert wait(lambda: b.counter("ingest.frames_truncated") >= 1,
                        5)
            truncated = b.counter("ingest.frames_truncated")
            assert srv.next_seq == 0
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                if compressed:
                    cli.send_compressed(C.wire.unpack_payload(body))
                else:
                    cli.send(C.edge_payload([5], [6]))
                cli.flush(timeout=10)
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got], "truncated": truncated,
                "payloads": [payload_record(p) for _, p in got]}


@pair
def test_torn_frame_mid_write_enqueues_nothing(server, client):
    check_pair(_torn, server, client, False)


def _duplicate(s, c, compressed):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            if compressed:
                p0 = {"v": np.asarray([1], np.int32),
                      "r": np.asarray([0], np.int32)}
                cli.send_compressed(p0)
                kind = C.wire.DATA_COMPRESSED
            else:
                p0 = C.edge_payload([0], [0])
                cli.send(p0)
                kind = C.wire.DATA
            cli.flush(timeout=10)
            _inject(cli, C.wire.pack_frame(kind, 0, C.wire.pack_payload(p0)))
            if compressed:
                cli.send_compressed({"v": np.asarray([2], np.int32),
                                     "r": np.asarray([0], np.int32)})
            else:
                cli.send(C.edge_payload([1], [1]))
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "duplicate": b.counter("ingest.frames_duplicate")}


@pair
def test_duplicate_frames_dropped_and_reacked(server, client):
    check_pair(_duplicate, server, client, False)


def _backpressure_high_water(s, c):
    H = 3
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        depths: list = []
        sbus = S.bus.get_bus()
        with S.IngestServer(queue_depth=32, high_water=H, low_water=1,
                            pause_poll_s=0.002) as srv:
            orig_gauge = sbus.gauge

            def spy_gauge(name, value):
                if name == "ingest.staged_depth":
                    depths.append(value)
                orig_gauge(name, value)

            sbus.gauge = spy_gauge
            got: list = []
            t = drain(srv, got, delay=0.01)
            with C.IngestClient("127.0.0.1", srv.port,
                                send_pause_timeout=30) as cli:
                for i in range(40):
                    cli.send(C.edge_payload([i], [i]))
                cli.flush(timeout=30)
        t.join(timeout=10)
        snap = b.counters()
        assert snap["ingest.backpressure_engaged"] >= 1
        assert snap["ingest.pauses_received"] >= 1
        assert depths and max(depths) <= H
        assert sbus.snapshot()["gauges"]["ingest.paused"] == 0  # released
        return {"seqs": [s_ for s_, _ in got]}


@pair
def test_backpressure_bounds_staged_depth_at_high_water(server, client):
    check_pair(_backpressure_high_water, server, client)


def _backpressure_gauge(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        sbus = S.bus.get_bus()
        with S.IngestServer(queue_depth=32, high_water=4, low_water=1,
                            pause_poll_s=0.002) as srv:
            got: list = []
            t = drain(srv, got)
            sbus.gauge("pipeline.staged_depth", 10)  # engine side is deep
            with C.IngestClient("127.0.0.1", srv.port,
                                send_pause_timeout=30) as cli:
                cli.send(C.edge_payload([0], [0]))
                assert wait(lambda: cli.paused, 5)
                assert sbus.snapshot()["gauges"]["ingest.paused"] == 1
                sbus.gauge("pipeline.staged_depth", 0)  # engine drained
                cli.send(C.edge_payload([1], [1]))
                cli.flush(timeout=10)
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got]}


@pair
def test_backpressure_is_gauge_driven(server, client):
    check_pair(_backpressure_gauge, server, client)


def _batched_acks(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(queue_depth=16, ack_every=3) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                for i in range(4):
                    cli.send(C.edge_payload([i], [i]))
                flushed = cli.flush(timeout=5)
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got], "flushed": flushed}


@pair
def test_batched_acks_flush_on_idle_and_bye(server, client):
    check_pair(_batched_acks, server, client)


def test_payload_to_chunk_validates_vertex_capacity():
    rec = {}
    for Q in (J, T):
        ok = Q.server.payload_to_chunk(Q.edge_payload([1, 2], [3, 4]), 8,
                                       vertex_capacity=8)
        rec[Q.name] = {
            "chunk": [np.asarray(f) for f in ok],
            "errors": [
                error_of(lambda: Q.server.payload_to_chunk(
                    Q.edge_payload([1, 70000], [2, 3]), 8,
                    vertex_capacity=1 << 16)),
                error_of(lambda: Q.server.payload_to_chunk(
                    Q.edge_payload([-1], [2]), 8, vertex_capacity=8)),
                error_of(lambda: Q.server.payload_to_chunk(
                    Q.edge_payload([0, 1, 2], [0, 1, 2]), 2)),
            ]}
    same(rec["tpu"], rec["torch"])
    assert int(np.asarray(rec["torch"]["chunk"][4]).sum()) == 2  # valid
    assert "out of range" in rec["torch"]["errors"][0]
    assert "chunk capacity" in rec["torch"]["errors"][2]
    # The port's host chunk holds CPU tensors, and a read-only wire view
    # is copied, never aliased writable.
    view = T.wire.unpack_payload(T.wire.pack_payload(
        T.edge_payload([1, 2], [3, 4])))
    assert not view["src"].flags.writeable
    c = T.server.payload_to_chunk(view, 2, vertex_capacity=8)
    assert c.raw_src.device.type == "cpu"
    c.raw_src.add_(1)
    assert view["src"].tolist() == [1, 2]


def test_ingest_fault_boundary_fires_on_send():
    for C in (T, J):
        with buses("torch", "tpu"):
            with T.IngestServer(queue_depth=4) as srv:
                with C.IngestClient("127.0.0.1", srv.port) as cli:
                    plan = C.faults.FaultPlan(
                        [C.faults.Fault(boundary="ingest", at=0)])
                    with C.faults.install(plan):
                        with pytest.raises(C.faults.FaultInjected):
                            cli.send(C.edge_payload([0], [0]))
                    assert ("ingest", 0, "raise") in plan.fired


# ---------------------------------------------------------------------- #
# pre-compressed DATA frames


def _cc_chunks(P, n_v=1 << 10, chunk=256, chunks=6, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(chunks):
        s = rng.integers(0, n_v, chunk).astype(np.int64)
        d = rng.integers(0, n_v, chunk).astype(np.int64)
        out.append(host_chunk(P, s, d, chunk))
    return out


def _compressed_contract(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain_frames(srv, got)
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                cli.send(C.edge_payload([0], [1]))
                cli.send_compressed({"v": np.arange(3, dtype=np.int32),
                                     "r": np.zeros(3, np.int32)})
                cli.send(C.edge_payload([2], [3]))
                cli.flush(timeout=10)
        t.join(timeout=5)
        snap = b.counters()
        return {"frames": [(s_, payload_record(p), bool(k))
                           for s_, p, k in got],
                "raw": snap["ingest.data_frames_raw"],
                "compressed": snap["ingest.data_frames_compressed"]}


@pair
def test_compressed_frames_ride_the_same_contract(server, client):
    check_pair(_compressed_contract, server, client)


@pair
def test_corrupt_compressed_frame_rejected_and_retransmitted(server,
                                                             client):
    check_pair(_corrupt_retransmit, server, client, True)


@pair
def test_torn_compressed_frame_enqueues_nothing(server, client):
    check_pair(_torn, server, client, True)


@pair
def test_duplicate_compressed_replay_dropped_and_reacked(server, client):
    check_pair(_duplicate, server, client, True)


def test_mixed_stream_consumers_fail_loudly():
    rec = {}
    for S in (J, T):
        errs = []
        with buses(S.name):
            with S.IngestServer(queue_depth=4) as srv:
                with S.IngestClient("127.0.0.1", srv.port) as cli:
                    cli.send_compressed({"v": np.asarray([1], np.int32),
                                         "r": np.asarray([0], np.int32)})
                    cli.flush(timeout=10)
                errs.append(error_of(lambda: next(srv.chunks(capacity=8))))
            with S.IngestServer(queue_depth=4) as srv:
                with S.IngestClient("127.0.0.1", srv.port) as cli:
                    cli.send(S.edge_payload([0], [1]))
                    cli.flush(timeout=10)
                errs.append(error_of(
                    lambda: next(srv.compressed_payloads())))
        rec[S.name] = errs
    assert "compressed DATA frame" in rec["torch"][0]
    assert "raw DATA frame" in rec["torch"][1]
    assert rec["torch"] == rec["tpu"]


def _precompressed_fold(s, c, stack):
    """The wire-vs-file twin: client-compressed payloads folded with
    ``precompressed=True`` (STACKED frames of ``stack`` when > 1) emit
    what the codec path emits over the same chunks; zero compress spans."""
    S, C = pkg(s), pkg(c)
    n_v = 1 << 10
    m1 = mesh1(S)
    merge_every = 2 if stack == 1 else 6
    chunks = _cc_chunks(S, n_v=n_v)
    golden = [np.asarray(w) for w in S.run_aggregation(
        S.cc.connected_components(n_v, codec="sparse"), chunks,
        merge_every=merge_every, mesh=m1, ingest_workers=0,
        prefetch_depth=0, h2d_depth=0)]
    payloads = [C.cc.connected_components(n_v, codec="sparse")
                .host_compress(ch) for ch in _cc_chunks(C, n_v=n_v)]
    payloads = [{k: np.asarray(v) for k, v in p.items()} for p in payloads]
    agg_wire = S.cc.connected_components(n_v, codec="sparse")
    tracer = S.obs.SpanTracer()
    with buses(s, c) as b, S.obs.install(tracer):
        with S.IngestServer(queue_depth=16, stop_on_bye=True) as srv:
            def feed():
                with C.IngestClient("127.0.0.1", srv.port,
                                    stack=stack) as cli:
                    for p in payloads:
                        cli.send_compressed(p)
                    cli.flush(timeout=30)

            t = threading.Thread(target=feed, daemon=True)
            t.start()
            if stack == 1:
                windows = S.run_aggregation(
                    agg_wire, srv.compressed_payloads(), merge_every=2,
                    mesh=m1, precompressed=True, ingest_workers=0,
                    prefetch_depth=0, h2d_depth=0)
            else:
                windows = S.run_aggregation(
                    agg_wire, srv.compressed_payload_units(),
                    merge_every=6, fold_batch=stack, mesh=m1,
                    precompressed=True, ingest_workers=0,
                    prefetch_depth=0, h2d_depth=0)
            wire_windows = [np.asarray(w) for w in windows]
            t.join(timeout=30)
        snap = b.counters()
    assert len(wire_windows) == len(golden) >= 1
    for i, (w, g) in enumerate(zip(wire_windows, golden)):
        assert w.tobytes() == g.tobytes(), f"window {i} diverged"
    assert tracer.spans("compress") == []
    rec = {"windows": wire_windows, "stack_spans": len(tracer.spans("stack")),
           "fold_spans": len(tracer.spans("fold"))}
    if stack > 1:
        rec.update(stacked=snap["ingest.frames_stacked"],
                   units=snap["engine.units_folded"],
                   chunks=snap["engine.chunks_folded"])
    return rec


@pair
def test_precompressed_wire_fold_matches_file_ingest(server, client):
    check_pair(_precompressed_fold, server, client, 1)


def test_precompressed_validation():
    class _Provider:  # quacks like a ShardedEdgeSource
        def stage_units(self, *a, **k):
            return iter(())

    rec = {}
    for P in (J, T):
        n_v = 1 << 10
        m = mesh1(P)
        ra = P.run_aggregation
        codec = P.cc.connected_components(n_v, codec="sparse")
        bad = {"v": np.asarray([n_v + 5], np.int32),
               "r": np.asarray([0], np.int32)}
        rec[P.name] = [
            error_of(lambda: ra(P.cc.connected_components(
                n_v, ingest_combine=False), [], precompressed=True,
                mesh=m).result()),
            error_of(lambda: ra(P.cc.connected_components(
                n_v, codec="compact", compact_capacity=n_v), [],
                precompressed=True, mesh=m).result()),
            error_of(lambda: ra(codec, [], precompressed=True, mesh=m,
                                window_ms=10).result()),
            error_of(lambda: ra(codec, [], precompressed=True, mesh=m,
                                host_precombine=lambda c: c).result()),
            error_of(lambda: ra(codec, [], precompressed=True, mesh=m,
                                source_provider=_Provider()).result()),
            error_of(lambda: ra(codec, [bad], precompressed=True, mesh=m,
                                ingest_workers=0, prefetch_depth=0,
                                h2d_depth=0).result()),
            error_of(lambda: ra(codec, [], precompressed=True, mesh=m,
                                windowed=2, merge_every=2).result()),
        ]
    for msg, want in zip(rec["torch"], ("codec-capable", "ordered stacker",
                                        "merge_every-only",
                                        "host_precombine",
                                        "source_provider parses",
                                        "out of range", "windowed panes")):
        assert msg is not None and want in msg, (want, msg)
    assert rec["torch"] == rec["tpu"]


def test_bare_iterator_without_mesh_runs_on_the_card():
    """The port's rule for a stream with no ``ctx`` (a server's payload or
    chunk iterator, a list) and no mesh: ``DEFAULT_DEVICE``, the card. On a
    machine without one it raises the port's no-card error; with a CPU
    mesh it runs."""
    import torch

    from gelly_torch.core.device import DEFAULT_DEVICE

    assert DEFAULT_DEVICE == "cuda"
    n_v = 64
    agg = T.cc.connected_components(n_v, ingest_combine=False)
    chunks = _cc_chunks(T, n_v=n_v, chunk=16, chunks=2)
    if torch.cuda.is_available():
        out = T.run_aggregation(agg, chunks).result()
        assert out.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            T.run_aggregation(agg, chunks).result()
    out = T.run_aggregation(agg, chunks, mesh=mesh1(T)).result()
    assert out.device.type == "cpu"


# ---------------------------------------------------------------------- #
# STACKED frames


def test_stacked_body_codec_roundtrip_and_bounds():
    blobs = [T.wire.pack_payload(T.edge_payload([i], [i + 1]))
             for i in range(5)]
    parts = [(b, i % 2 == 0) for i, b in enumerate(blobs)]
    body = T.wire.pack_stacked(parts)
    assert T.wire.unpack_stacked(body) == parts
    bad_kind = bytearray(body)
    bad_kind[2] = 7  # first table entry's kind byte
    for fn, match in ((lambda Q: Q.wire.pack_stacked([]), "must be 1"),
                      (lambda Q: Q.wire.unpack_stacked(body[:-3]), None),
                      (lambda Q: Q.wire.unpack_stacked(body + b"x"), None),
                      (lambda Q: Q.wire.unpack_stacked(bytes(bad_kind)),
                       "kind")):
        with pytest.raises(T.wire.FrameError, match=match):
            fn(T)
        assert error_of(lambda: fn(T)) == error_of(lambda: fn(J))


def _stacked_loopback(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            units: list = []

            def run():
                for item in srv.stacks():
                    units.append(item)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            with C.IngestClient("127.0.0.1", srv.port, stack=4) as cli:
                for i in range(10):
                    cli.send(C.edge_payload([i], [i + 1]))
                cli.flush(timeout=10)
                assert cli.acked == 10 and cli.unacked_count == 0
        t.join(timeout=5)
        snap = b.counters()
        assert snap["ingest.frames_received"] <= 5
        return {"units": [(s_, [payload_record(p) for p in ps])
                          for s_, ps, _ in units],
                "stacked": snap["ingest.frames_stacked"],
                "enqueued": snap["ingest.chunks_enqueued"],
                "flush_size": snap["ingest.stack_flush_size"]}


@pair
def test_stacked_loopback_in_order_and_tail_drain(server, client):
    check_pair(_stacked_loopback, server, client)
    rec = _stacked_loopback(server, client)
    assert [(s_, len(p)) for s_, p in rec["units"]] == [(0, 4), (4, 4),
                                                        (8, 2)]


def _stacked_age(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port, stack=64,
                                stack_ms=30) as cli:
                cli.send(C.edge_payload([0], [1]))
                cli.send(C.edge_payload([1], [2]))
                assert wait(lambda: len(got) >= 2, 5)
        t.join(timeout=5)
        assert b.counter("ingest.stack_flush_age") >= 1
        return {"seqs": [s_ for s_, _ in got]}


@pair
def test_stacked_age_deadline_flushes_partial_stack(server, client):
    check_pair(_stacked_age, server, client)


def _stacked_bytes(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port, stack=1000,
                                stack_bytes=1) as cli:
                cli.send(C.edge_payload([0], [1]))
                cli.send(C.edge_payload([1], [2]))
                cli.flush(timeout=10)
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "flush_bytes": b.counter("ingest.stack_flush_bytes")}


@pair
def test_stacked_byte_ceiling_flushes_before_k(server, client):
    check_pair(_stacked_bytes, server, client)


def _stacked_frame(P, base, payloads, compressed=False):
    parts = [(P.wire.pack_payload(p), compressed) for p in payloads]
    return P.wire.pack_frame(P.wire.STACKED, base, P.wire.pack_stacked(parts))


def _stacked_corrupt(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            frame = _stacked_frame(C, 0, [C.edge_payload([i], [i])
                                          for i in range(3)])
            bad = bytearray(frame)
            bad[-1] ^= 0xFF
            _inject(cli, bytes(bad))
            assert wait(lambda: b.counter("ingest.frames_rejected") >= 1, 5)
            assert srv.next_seq == 0
            _inject(cli, frame)
            assert wait(lambda: len(got) >= 3, 5)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "stacked": b.counter("ingest.frames_stacked")}


@pair
def test_corrupt_stacked_frame_rejected_then_whole_frame_lands(server,
                                                               client):
    check_pair(_stacked_corrupt, server, client)


def _stacked_torn(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            frame = _stacked_frame(C, 0, [C.edge_payload([i], [i])
                                          for i in range(4)])
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            raw.sendall(frame[: len(frame) - 11])  # torn mid-stack
            raw.close()
            assert wait(lambda: b.counter("ingest.frames_truncated") >= 1,
                        5)
            assert srv.next_seq == 0
            with C.IngestClient("127.0.0.1", srv.port, stack=4) as cli:
                for i in range(4):
                    cli.send(C.edge_payload([i], [i]))
                cli.flush(timeout=10)
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "stacked": b.counter("ingest.frames_stacked")}


@pair
def test_torn_stacked_frame_stages_nothing(server, client):
    check_pair(_stacked_torn, server, client)


def _stacked_duplicate(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port, stack=3).connect()
            payloads = [C.edge_payload([i], [i]) for i in range(3)]
            for p in payloads:
                cli.send(p)
            cli.flush(timeout=10)
            _inject(cli, _stacked_frame(C, 0, payloads))
            cli.send(C.edge_payload([9], [9]))
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "duplicate": b.counter("ingest.frames_duplicate"),
                "stacked": b.counter("ingest.frames_stacked")}


@pair
def test_duplicate_stacked_replay_dropped_and_reacked(server, client):
    check_pair(_stacked_duplicate, server, client)


def _stacked_mixed(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            cli.send(C.edge_payload([0], [0]))
            _inject(cli, _stacked_frame(
                C, 1, [C.edge_payload([i], [i]) for i in range(1, 4)]))
            assert wait(lambda: len(got) >= 4, 5)
            cli._next[None] = 4  # the raw injection advanced the space
            cli.send(C.edge_payload([4], [4]))
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got],
                "payloads": [payload_record(p) for _, p in got]}


@pair
def test_mixed_stacked_and_unstacked_frames_share_seq_space(server, client):
    check_pair(_stacked_mixed, server, client)


def _stacked_mid_frame_resume(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(queue_depth=16, resume_seq=2) as srv:
            units: list = []

            def run():
                for item in srv.stacks():
                    units.append(item)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            raw.settimeout(5.0)
            raw.sendall(C.wire.pack_frame(C.wire.HELLO, 0))
            welcome = C.wire.read_frame_checked(raw.recv)[:2]
            raw.sendall(_stacked_frame(
                C, 0, [C.edge_payload([i], [i]) for i in range(4)]))
            ack = C.wire.read_frame_checked(raw.recv)[:2]
            assert wait(lambda: bool(units), 5)
            raw.close()
        t.join(timeout=5)
        return {"welcome": welcome, "ack": ack,
                "units": [(s_, [payload_record(p) for p in ps])
                          for s_, ps, _ in units]}


@pair
def test_stacked_mid_frame_resume_drops_durable_prefix(server, client):
    check_pair(_stacked_mid_frame_resume, server, client)
    rec = _stacked_mid_frame_resume(server, client)
    assert rec["welcome"] == (T.wire.WELCOME, 2)
    assert rec["ack"] == (T.wire.ACK, 4)
    assert [(s_, len(p)) for s_, p in rec["units"]] == [(2, 2)]


def _stacked_rewind(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port, stack=4).connect()
            for i in range(4):
                cli.send(C.edge_payload([i], [i]))
            cli.flush(timeout=10)
            cli._teardown_socket()
            cli.reconnect()
            for i in range(4, 8):
                cli.send(C.edge_payload([i], [i]))
            cli.flush(timeout=10)
            cli.close()
        t.join(timeout=5)
        return {"seqs": [s_ for s_, _ in got]}


@pair
def test_stacked_client_rewinds_covering_frame_on_reconnect(server, client):
    check_pair(_stacked_rewind, server, client)


@pair
def test_stacked_fold_bit_identical_and_one_dispatch_per_frame(server,
                                                               client):
    check_pair(_precompressed_fold, server, client, 3)
    rec = _precompressed_fold(server, client, 3)
    assert (rec["stacked"], rec["units"], rec["chunks"]) == (2, 2, 6)
    assert rec["fold_spans"] == 2


def test_raw_chunk_units_fold_bit_identical_through_the_engine():
    """Raw STACKED frames through ``chunk_units`` fold as one unit each
    (``fold_batch`` >= K), and the engine resumes a checkpoint whose
    position lies inside a frame by folding only the frame's suffix."""
    rec = {}
    for P in (J, T):
        n_v = 256
        rng = np.random.default_rng(9)
        edges = rng.integers(0, n_v, (8 * 32, 2))
        chunks = [host_chunk(P, edges[i:i + 32, 0], edges[i:i + 32, 1], 32)
                  for i in range(0, len(edges), 32)]
        agg = P.cc.connected_components(n_v, ingest_combine=False)
        golden = [np.asarray(w) for w in P.run_aggregation(
            agg, chunks, merge_every=4, mesh=mesh1(P), ingest_workers=0,
            prefetch_depth=0, h2d_depth=0)]
        units = [chunks[0:3], chunks[3:6], chunks[6:8]]
        with buses(P.name) as b:
            got = [np.asarray(w) for w in P.run_aggregation(
                agg, units, merge_every=4, fold_batch=4, mesh=mesh1(P),
                ingest_workers=0, prefetch_depth=0, h2d_depth=0)]
            folded = b.counter("engine.units_folded")
        rec[P.name] = {"golden": golden, "stacked": got, "units": folded}
    same(rec["tpu"], rec["torch"])
    assert rec["torch"]["units"] == 3


# ---------------------------------------------------------------------- #
# SIGKILL'd server: no double fold of acked chunks, across the packages


def _spawn(ckpt, port_file, out, total, sleep_s, mode, framing, who):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    script = (os.path.abspath(__file__) if who == "torch"
              else os.path.join(HERE, "_ingest_crash_child.py"))
    return subprocess.Popen(
        [sys.executable, script, str(ckpt), str(port_file), str(out),
         str(total), str(sleep_s), mode, framing],
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


def _sigkill_case(tmp_path, mode, stack, first, second, client):
    compressed = mode == "compressed"
    framing = "stacked" if stack > 1 else "plain"
    C = pkg(client)
    rng = np.random.default_rng(23)
    total = 64

    def mk_payload():
        src = rng.integers(0, N_V_CHILD, 32)
        dst = rng.integers(0, N_V_CHILD, 32)
        if compressed:
            v, r = T.cc.cc_pairs_numpy(src, dst, None, N_V_CHILD)
            return {"v": v, "r": r}
        return C.edge_payload(src, dst)

    payloads = [mk_payload() for _ in range(total)]
    golden = _child_init()
    for p in payloads:
        golden = _child_fold(golden, p)
    ckpt = tmp_path / "ckpt"
    port_file = str(tmp_path / "port")
    out = str(tmp_path / "final.npz")
    p1 = _spawn(ckpt, port_file, out, total, 0.03, mode, framing, first)
    try:
        port = _wait_port(port_file, p1)
        cli = C.IngestClient("127.0.0.1", port, send_pause_timeout=60,
                             stack=stack)
        cli.connect()
        sent = 0

        def sender():
            nonlocal sent
            while sent < total:
                try:
                    cli.send(payloads[sent], compressed=compressed)
                    sent += 1
                except C.IngestError:
                    sent += 1  # buffered: reconnect() delivers it
                    return

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        assert wait(lambda: len(list(ckpt.glob("ckpt-*.npz"))) >= 2
                    and cli.acked >= 8, 180, 0.02), "no checkpoints/acks"
        acked_before_kill = cli.acked
        os.kill(p1.pid, signal.SIGKILL)
        assert p1.wait(timeout=60) == -signal.SIGKILL
        assert not os.path.exists(out)  # died mid-stream
        t.join(timeout=60)
    finally:
        if p1.poll() is None:
            p1.kill()
    os.unlink(port_file)
    p2 = _spawn(ckpt, port_file, out, total, 0.0, mode, framing, second)
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
        assert cli.acked >= acked_before_kill  # acked work never rewinds
        while sent < total:
            cli.send(payloads[sent], compressed=compressed)
            sent += 1
        cli.flush(timeout=120)
        cli.close()
        assert p2.wait(timeout=180) == 0
    finally:
        if p2.poll() is None:
            p2.kill()
    final, pos, _ = pkg(second).checkpoint.load_checkpoint(
        out, like=_child_init())
    final = {k: np.asarray(v) for k, v in final.items()}
    assert pos == total
    key = "v" if compressed else "src"
    assert int(final["chunks"]) == total
    assert int(final["edges"]) == sum(int(p[key].shape[0]) for p in payloads)
    np.testing.assert_array_equal(_child_labels(final),
                                  _child_labels(golden))
    assert final["parent"].tobytes() == golden["parent"].tobytes()


@pytest.mark.faults
@pytest.mark.parametrize("mode,stack,first,second,client", [
    ("raw", 3, "torch", "torch", "torch"),
    ("compressed", 3, "torch", "tpu", "tpu"),
])
def test_sigkilled_server_never_double_folds_acked_chunks(
        tmp_path, mode, stack, first, second, client):
    """A port server killed mid-stream resumes (in the port, or in
    ``gelly_tpu`` from the port's checkpoint rotation) with no acked chunk
    folded twice; ``stack=3`` against ``CKPT_EVERY=4`` puts durable
    positions inside frames."""
    _sigkill_case(tmp_path, mode, stack, first, second, client)


@pytest.mark.slow
@pytest.mark.faults
@pytest.mark.parametrize("mode,stack,first,second,client", [
    ("raw", 1, "torch", "torch", "torch"),
    ("compressed", 1, "torch", "torch", "torch"),
    ("compressed", 3, "torch", "torch", "torch"),
    ("raw", 3, "tpu", "torch", "torch"),
    ("raw", 1, "torch", "torch", "tpu"),
])
def test_sigkilled_server_never_double_folds_acked_chunks_matrix(
        tmp_path, mode, stack, first, second, client):
    _sigkill_case(tmp_path, mode, stack, first, second, client)


@pytest.mark.parametrize("stack", [1, 2])
def test_large_frame_waits_for_a_slow_reader(stack):
    """A frame the server reads later than the client's socket poll (0.2
    s) is sent whole by the port's client, which waits up to
    ``send_pause_timeout`` for the server to drain it; ``gelly_tpu``'s
    ``sendall`` gives up after one poll ("send failed (timed out)"). The
    server here answers the handshake, sleeps 0.8 s, then reads the
    16 MiB frame (a DATA frame, or a STACKED frame of two 8 MiB payloads)
    and acks it."""
    import socket as socket_mod

    n = (1 << 20) // stack
    payloads = [T.edge_payload(np.arange(n) + i, np.arange(n))
                for i in range(stack)]
    blobs = [T.wire.pack_payload(p) for p in payloads]
    want = (T.wire.DATA, blobs[0]) if stack == 1 else (
        T.wire.STACKED, T.wire.pack_stacked([(b, False) for b in blobs]))

    def run(C):
        lst = socket_mod.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        got = {}

        def server():
            conn, _ = lst.accept()
            conn.settimeout(30)
            try:
                ftype, _seq, _p = T.wire.read_frame(conn.recv)
                assert ftype == T.wire.HELLO
                conn.sendall(T.wire.pack_frame(T.wire.WELCOME, 0))
                time.sleep(0.8)  # the frame waits in the socket buffers
                ftype, seq, body = T.wire.read_frame(conn.recv)
                got["frame"] = (ftype, seq, (ftype, body) == want)
                conn.sendall(T.wire.pack_frame(T.wire.ACK, seq + stack))
                T.wire.read_frame(conn.recv)  # BYE
            except Exception as e:  # noqa: BLE001 - the record says so
                got["server_error"] = repr(e)
            finally:
                conn.close()
                lst.close()

        th = threading.Thread(target=server, daemon=True)
        th.start()
        cli = C.IngestClient("127.0.0.1", lst.getsockname()[1],
                             send_pause_timeout=20, stack=stack).connect()

        def send():
            for p in payloads:
                cli.send(p)
            cli.flush(timeout=20)

        err = error_of(send)
        cli.close(flush_timeout=None)
        th.join(30)
        return err, got

    err, got = run(T)
    assert err is None and got["frame"] == (want[0], 0, True)
    jerr, _ = run(J)
    assert jerr is not None and "timed out" in jerr
