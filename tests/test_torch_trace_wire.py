"""gelly_torch's wire trace propagation and push alerts vs gelly_tpu's (CPU).

Mirrors ``tests/test_trace_wire.py``: DATA and STACKED frames carry the
client's (trace id, span id) stamp; the server's ``wire_recv`` and
``staging`` spans link to it and bind each staged position for the
engine's ``fold`` and ``checkpoint`` spans; retransmits resend the
original stamped bytes; malformed stamps degrade silently; SUBSCRIBE /
ALERT frames push matching bus events outside the data seq space; a
router-attached tenant scheduler beats with its tenant fields. Loopback
scenarios run with a port server and a port client, a ``gelly_tpu``
server and a port client, and a port server and a ``gelly_tpu`` client
(each side traced by its own package's tracer: a stamp packed by one
package links the other's spans); the record (span counts, the link
structure, alert payloads, counters) must equal the run of ``gelly_tpu``
alone. Tolerance: none.
"""

import contextlib
import os
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_wire import (  # noqa: E402
    PAIR_IDS,
    PAIRS,
    buses,
    check_pair,
    drain,
    engine,
    error_of,
    mesh1,
    payload_record,
    pkg,
    wait,
)

pytestmark = pytest.mark.ingest
T, J = pkg("torch"), pkg("tpu")
pair = pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)


def _one(spans, **match):
    hits = [s for s in spans
            if all(s["args"].get(k) == v for k, v in match.items())]
    assert len(hits) == 1, (match, [s["args"] for s in spans])
    return hits[0]


@contextlib.contextmanager
def _traced(s, c, capacity=4096):
    """One tracer a package (one, when both sides are the same package),
    installed around the scenario; yields (server tracer, client tracer)."""
    S, C = pkg(s), pkg(c)
    st = S.obs.SpanTracer(capacity=capacity, heartbeat_every_s=None)
    ct = st if s == c else C.obs.SpanTracer(capacity=capacity,
                                            heartbeat_every_s=None)
    with contextlib.ExitStack() as stack:
        stack.enter_context(S.obs.install(st))
        if ct is not st:
            stack.enter_context(C.obs.install(ct))
        yield st, ct


def _data_frame_trace(s, c, k):
    S, C = pkg(s), pkg(c)
    with buses(s, c), _traced(s, c) as (st, ct):
        with S.IngestServer(queue_depth=16) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port, stack=k) as cli:
                for i in range(k):
                    cli.send(C.edge_payload([i], [i + 1]))
                cli.flush(timeout=10)
        t.join(timeout=5)
    sends, recvs = ct.spans("client_send"), st.spans("wire_recv")
    stages = st.spans("staging")
    send = _one(sends, stack=k) if k > 1 else sends[0]
    recv = _one(recvs, stack=k) if k > 1 else recvs[0]
    stage = _one(stages, stack=k) if k > 1 else stages[0]
    return {
        "seqs": [s_ for s_, _ in got],
        "stamp_stripped": all(S.wire.TRACE_KEY not in p for _, p in got),
        "spans": (len(sends), len(recvs), len(stages)),
        "one_trace": (send["args"]["trace"] == ct.trace_id
                      == recv["args"]["trace"] == stage["args"]["trace"]),
        "chained": (recv["args"]["parent"] == send["args"]["span"]
                    and stage["args"]["parent"] == recv["args"]["span"]),
        "bound": all(st.ctx(pos) == (ct.trace_id, stage["args"]["span"])
                     for pos in range(k)),
    }


@pair
def test_data_frame_carries_trace_context(server, client):
    check_pair(_data_frame_trace, server, client, 1)
    rec = _data_frame_trace(server, client, 1)
    assert rec["spans"] == (1, 1, 1)
    assert rec["one_trace"] and rec["chained"] and rec["bound"]


@pair
def test_stacked_frame_links_all_payloads_to_one_frame_span(server, client):
    check_pair(_data_frame_trace, server, client, 4)
    rec = _data_frame_trace(server, client, 4)
    assert rec["one_trace"] and rec["chained"] and rec["bound"]


def _retransmit(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b, _traced(s, c) as (st, ct):
        with S.IngestServer(queue_depth=8) as srv:
            got: list = []
            t = drain(srv, got)
            cli = C.IngestClient("127.0.0.1", srv.port).connect()
            orig = cli._raw_send
            left = [1]

            def corrupting(frame):
                if left[0] and len(frame) > 100:  # only DATA is this big
                    left[0] -= 1
                    frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
                orig(frame)

            cli._raw_send = corrupting
            cli.send(C.edge_payload([1], [2]))
            cli.flush(timeout=10)
            cli.close()
            assert left[0] == 0
        t.join(timeout=5)
        assert b.counter("ingest.frames_resent") >= 1
    sends = ct.spans("client_send")
    recvs = st.spans("wire_recv")
    assert recvs
    return {"got": [s_ for s_, _ in got], "sends": len(sends),
            "linked": all(r["args"]["trace"] == ct.trace_id
                          and r["args"]["parent"] == sends[0]["args"]["span"]
                          for r in recvs)}


@pair
def test_retransmit_reuses_original_trace_context(server, client):
    check_pair(_retransmit, server, client)
    rec = _retransmit(server, client)
    assert rec["sends"] == 1 and rec["linked"]


def test_unstamped_and_malformed_stamps_degrade_silently():
    for Q in (T, J):
        assert Q.wire.pop_trace({"x": np.arange(2)}) is None
        bad = {Q.wire.TRACE_KEY: np.arange(3, dtype=np.uint64)}
        assert Q.wire.pop_trace(bad) is None
        assert Q.wire.TRACE_KEY not in bad
    assert T.wire.TRACE_KEY == J.wire.TRACE_KEY
    for s, c in [("tpu", "tpu")] + PAIRS:
        S, C = pkg(s), pkg(c)
        with buses(s, c) as b:
            with S.IngestServer(queue_depth=8) as srv:
                got: list = []
                t = drain(srv, got)
                with C.IngestClient("127.0.0.1", srv.port) as cli:
                    p = C.edge_payload([1], [2])
                    p[C.wire.TRACE_KEY] = np.arange(5, dtype=np.uint64)
                    cli.send(p)
                    cli.flush(timeout=10)
            t.join(timeout=5)
            assert b.counter("ingest.frames_rejected") == 0
        assert len(got) == 1 and S.wire.TRACE_KEY not in got[0][1]
        assert payload_record(got[0][1])["src"].tolist() == [1]


def _e2e(s, c, tmp_path):
    S, C = pkg(s), pkg(c)
    n_v = 64
    agg = S.cc.connected_components(n_v)
    edges = np.random.default_rng(7).integers(0, n_v, (48, 2))
    with buses(s, c) as b, _traced(s, c, 1 << 14) as (st, ct):
        with S.IngestServer(queue_depth=16, stop_on_bye=True) as srv:
            def feed():
                with C.IngestClient("127.0.0.1", srv.port) as cli:
                    for i in range(0, 48, 16):
                        cli.send(C.edge_payload(edges[i:i + 16, 0],
                                                edges[i:i + 16, 1]))
                    cli.flush(timeout=30)

            ft = threading.Thread(target=feed, daemon=True)
            ft.start()
            out = np.asarray(S.run_aggregation(
                agg, srv.chunks(16, n_v), merge_every=1, mesh=mesh1(S),
                checkpoint_path=str(tmp_path / f"ck_{s}_{c}.npz"),
                checkpoint_every=1, ingest_workers=0, prefetch_depth=0,
                h2d_depth=0).result())
            ft.join(timeout=30)
        trace = S.obs.write_chrome_trace(
            str(tmp_path / f"trace_{s}_{c}.json"), st, bus=b.buses[0])
    send = _one(ct.spans("client_send"), seq=0)
    recv = _one(st.spans("wire_recv"), seq=0)
    stage = _one(st.spans("staging"), seq=0)
    folds = [x for x in st.spans("fold")
             if x["args"].get("parent") == stage["args"]["span"]]
    fold_ids = {x["args"]["span"] for x in st.spans("fold")}
    ckpts = st.spans("checkpoint")
    linked = [x for x in ckpts if x["args"].get("parent") in fold_ids]
    return {
        "labels": out,
        "trace_id": trace["otherData"]["trace_id"] == st.trace_id,
        "chained": (recv["args"]["parent"] == send["args"]["span"]
                    and stage["args"]["parent"] == recv["args"]["span"]),
        "fold_linked": len(folds),
        "fold_trace": folds[0]["args"]["trace"] == ct.trace_id,
        # The checkpoint closes the chain the client's stamp opened.
        "ckpt_linked": bool(linked) and all(
            x["args"]["trace"] == ct.trace_id for x in linked),
    }


@pair
def test_e2e_wire_to_checkpoint_shares_one_trace(server, client, tmp_path):
    check_pair(_e2e, server, client, tmp_path)
    rec = _e2e(server, client, tmp_path)
    assert rec["trace_id"] and rec["chained"] and rec["fold_trace"]
    assert rec["fold_linked"] == 1 and rec["ckpt_linked"]


# ---------------------------------------------------------------------- #
# push alert subscriptions


def _subscribe(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        sbus = S.bus.get_bus()
        with S.IngestServer(queue_depth=8) as srv:
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                seen: list = []
                sub_id = cli.subscribe(events=("slo.",),
                                       on_alert=seen.append)
                subscribers = sbus.gauges.get("alerts.subscribers")
                sbus.emit("slo.breach", slo="fold_p99_ms", tenant=None,
                          value=50.0, threshold=10.0, burn_rate=1.0)
                sbus.emit("alerts.degree_spike", degree=99.0)  # filtered
                assert wait(lambda: bool(seen), 5)
                last = cli.alerts[-1]
        counters = b.counters()
        return {"sub_id": sub_id, "subscribers": subscribers,
                "seen": seen, "last_is_seen": last == seen[0],
                "subscriptions": counters["alerts.subscriptions"],
                "pushed": counters["alerts.pushed"],
                "received": counters["ingest.alerts_received"],
                "after": sbus.gauges.get("alerts.subscribers")}


@pair
def test_subscribe_pushes_matching_alerts_only(server, client):
    check_pair(_subscribe, server, client)
    rec = _subscribe(server, client)
    assert len(rec["seen"]) == 1 and rec["seen"][0]["event"] == "slo.breach"
    assert rec["seen"][0]["fields"]["value"] == 50.0
    assert (rec["subscribers"], rec["after"]) == (1, 0)


def _subscribe_filters(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        sbus = S.bus.get_bus()
        with S.IngestServer(queue_depth=8) as srv:
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                seen: list = []
                cli.subscribe(events=("slo.",), tenant=3,
                              slo="backlog_age_s", on_alert=seen.append)
                sbus.emit("slo.breach", slo="backlog_age_s", tenant=7,
                          value=9.0)
                sbus.emit("slo.breach", slo="fold_p99_ms", tenant=3,
                          value=9.0)
                sbus.emit("slo.breach", slo="backlog_age_s", tenant=3,
                          value=9.0)
                assert wait(lambda: bool(seen), 5)
                time.sleep(0.1)  # would-be stragglers

                def malformed():
                    cli._sub_evt.clear()
                    cli._sock.sendall(C.wire.pack_frame(
                        C.wire.SUBSCRIBE, 99, b"\xff\xfe"))
                    if not cli._sub_evt.wait(5):
                        raise AssertionError("no SUBSCRIBE reply")
                    payload = C.wire.unpack_json(cli._sub_payload)
                    if not payload.get("ok"):
                        raise C.IngestError(payload.get("error", "?"))

                err = error_of(malformed)
        return {"tenants": [a["fields"]["tenant"] for a in seen],
                "error": err}


@pair
def test_subscribe_tenant_and_slo_filters(server, client):
    check_pair(_subscribe_filters, server, client)
    rec = _subscribe_filters(server, client)
    assert rec["tenants"] == [3] and "malformed" in rec["error"]


def _degree_spike(s, c):
    S, C = pkg(s), pkg(c)
    rng = np.random.default_rng(11)
    n_v = 256
    with buses(s, c) as b:
        watch = S.slo.SummaryDeltaWatch(bus=S.bus.get_bus(),
                                        spike_factor=4.0, min_degree=8)
        with S.IngestServer(queue_depth=32) as srv:
            def consume():
                for _seq, payload in srv.payloads():
                    deg = np.bincount(payload["dst"], minlength=n_v)
                    watch.observe(max_degree=int(deg.max()))

            threading.Thread(target=consume, daemon=True).start()
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                spikes: list = []
                cli.subscribe(events=("alerts.degree_spike",),
                              on_alert=spikes.append)
                for _ in range(6):
                    e = rng.integers(0, n_v, (64, 2))
                    cli.send(C.edge_payload(e[:, 0], e[:, 1]))
                cli.flush(timeout=10)
                src = rng.integers(0, n_v, 64)
                cli.send(C.edge_payload(src, np.zeros(64, dtype=np.int64)))
                cli.flush(timeout=10)
                assert wait(lambda: bool(spikes), 5), "no degree-spike ALERT"
        assert b.counter("alerts.pushed") >= 1
        return {"event": spikes[0]["event"],
                "degree": spikes[0]["fields"]["degree"]}


@pair
def test_degree_spike_stream_delivers_push_alert(server, client):
    check_pair(_degree_spike, server, client)
    assert _degree_spike(server, client)["degree"] >= 32.0


def _backlog_breach(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c):
        sbus = S.bus.get_bus()
        plane = S.slo.SloPlane([S.slo.backlog_age_max_s(0.005)], bus=sbus)
        with S.IngestServer(queue_depth=8) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                breaches: list = []
                cli.subscribe(events=("slo.breach",),
                              on_alert=breaches.append)
                cli.send(C.edge_payload([1], [2]))
                cli.flush(timeout=10)
                sbus.watermarks.stamp("stream", 0)
                time.sleep(0.02)  # age past the 5 ms budget
                ticked = plane.tick()
                burn = sbus.gauges["slo.backlog_age_max_s.burn_rate"]
                assert wait(lambda: bool(breaches), 5), "no breach ALERT"
                fields = breaches[0]["fields"]
                assert fields["value"] >= 0.005
        t.join(timeout=5)
        return {"ticked": ticked, "burn": burn, "slo": fields["slo"]}


@pair
def test_blown_backlog_slo_pushes_breach_alert_end_to_end(server, client):
    check_pair(_backlog_breach, server, client)
    assert _backlog_breach(server, client) == {
        "ticked": 1, "burn": 1.0, "slo": "backlog_age_max_s"}


def _alerts_outside_seq_space(s, c):
    S, C = pkg(s), pkg(c)
    with buses(s, c) as b:
        sbus = S.bus.get_bus()
        with S.IngestServer(queue_depth=32) as srv:
            got: list = []
            t = drain(srv, got)
            with C.IngestClient("127.0.0.1", srv.port) as cli:
                seen: list = []
                cli.subscribe(events=("alerts.",), on_alert=seen.append)
                for i in range(20):
                    cli.send(C.edge_payload([i], [i + 1]))
                    if i % 5 == 0:
                        sbus.emit("alerts.degree_spike", degree=float(i))
                cli.flush(timeout=10)
                assert wait(lambda: len(seen) >= 4, 5)
                acked, unacked = cli.acked, cli.unacked_count
        t.join(timeout=5)
        counters = b.counters()
        return {"seqs": [s_ for s_, _ in got], "acked": acked,
                "unacked": unacked, "alerts": len(seen),
                "enqueued": counters["ingest.chunks_enqueued"],
                "pushed": counters["alerts.pushed"],
                "dropped": counters.get("alerts.dropped", 0)}


@pair
def test_alert_plane_stays_outside_data_seq_space(server, client):
    check_pair(_alerts_outside_seq_space, server, client)
    rec = _alerts_outside_seq_space(server, client)
    assert rec["seqs"] == list(range(20)) and rec["pushed"] == 4


def _router_heartbeat(s, c):
    S, C = pkg(s), pkg(c)
    n_v = 64
    tracer = S.obs.SpanTracer(capacity=4096, heartbeat_every_s=0.0)
    with buses(s, c), S.obs.install(tracer):
        agg, cap = S.cc.cc_tenant_tier(n_v, chunk_capacity=16)
        eng = engine(S, merge_every=1).start()
        router = S.TenantRouter(eng, "small", vertex_capacity=n_v)
        eng.add_tier("small", agg, cap)
        try:
            with S.IngestServer(queue_depth=16) as srv:
                router.attach(srv)
                with C.IngestClient("127.0.0.1", srv.port) as cli:
                    rng = np.random.default_rng(7)
                    for tid in (3, 4):
                        for _ in range(2):
                            p = C.edge_payload(rng.integers(0, n_v, 8),
                                               rng.integers(0, n_v, 8))
                            p["tenant"] = np.array([tid], np.int64)
                            cli.send(p)
                    cli.flush(timeout=30)

                    def folded():
                        try:
                            return (eng.position(3) >= 2
                                    and eng.position(4) >= 2)
                        except KeyError:
                            return False

                    assert wait(folded, 30)
        finally:
            eng.stop()
            router.stop()
    beats = tracer.instants("heartbeat")
    assert beats, "router-attached scheduler never beat"
    line = beats[-1]["args"]
    return {f: f in line for f in ("tenants_active", "tenants_queue_depth",
                                   "backlog_age_max_s", "slo_breaching")} | {
        "slo_breaching_value": line.get("slo_breaching")}


@pair
def test_router_attached_heartbeat_carries_tenant_fields(server, client):
    check_pair(_router_heartbeat, server, client)
    rec = _router_heartbeat(server, client)
    assert all(v for k, v in rec.items() if k != "slo_breaching_value")
    assert rec["slo_breaching_value"] == 0
