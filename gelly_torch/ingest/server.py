"""The network edge-ingestion front end: a socket server for the wire.

The reference gets live sources for free from Flink
(``env.socketTextStream`` → ``SimpleEdgeStream``); this server is the
port's equivalent L0: clients stream compressed chunk payloads
(``ingest/wire.py`` frames), the server validates CRC + sequence and
hands them to whatever consumes :meth:`IngestServer.payloads` — the
engine, a resilient fold loop, a bench harness.

Delivery contract:

- **Per-stream sequence numbers.** One logical stream per server; the
  expected next sequence survives reconnects (a new connection's
  WELCOME carries it, and the client rewinds its resend buffer to it).
  Duplicates (seq below expected, a reconnect replay) are dropped and
  re-acked; gaps are REJECTed with the expected seq.
- **CRC per frame** (the checkpoint-layer discipline on the wire): a
  corrupt payload is REJECTed — ``ingest.frames_rejected`` counts it —
  and the expected seq does NOT advance; the client retransmits. A
  torn frame (connection died mid-frame) ends the connection without
  enqueueing anything.
- **Pre-compressed DATA frames.** A ``DATA_COMPRESSED`` frame carries
  a payload the CLIENT already ran through the plan's ingest codec
  (``host_compress``): it rides the same seq/CRC/duplicate/resume/ack
  machinery as DATA, but is admitted straight into staging — the
  consumer folds it directly (``run_aggregation(precompressed=True)``
  or a compressed tenant tier) and the server performs ZERO compress
  work. ``ingest.data_frames_raw`` / ``ingest.data_frames_compressed``
  count the two kinds.
- **Stacked frames.** A ``STACKED`` frame carries K payloads (raw or
  compressed per entry) behind ONE header/CRC/recv/staging admission,
  covering sequence positions ``[seq, seq + K)``; it stages as ONE
  queue unit so the whole stack rides the engine's existing
  ``fold_many``/``fold_codec`` stacked dispatch — one fold dispatch
  per frame, not per chunk. Duplicate/gap handling is whole-frame; a
  frame whose prefix is already staged (the mid-frame checkpoint
  resume) admits only the unseen suffix, keeping exactly-once at
  chunk granularity. ``ingest.frames_stacked`` counts them and
  ``ingest.chunks_per_stacked_frame`` records K. In
  ``tenant_streams`` mode a stack must be single-tenant-scoped.
  :meth:`IngestServer.frames` unstacks transparently;
  :meth:`IngestServer.stacks` yields whole units for
  frame-granularity consumers.
- **Acks follow durability, not receipt.** With ``auto_ack=True``
  (lossy-tolerant pipelines) a frame is acked once enqueued. With
  ``auto_ack=False`` the CONSUMER calls :meth:`ack` after its own
  durability point (e.g. after a checkpoint covering the position), so
  an acked chunk is never re-sent AND never re-folded: a server
  SIGKILLed after folding-but-before-checkpointing simply never acked
  those frames, and the restarted incarnation's WELCOME asks the
  client to resend exactly from the checkpoint position.
- **Gauge-driven backpressure.** Before each frame read the server
  checks the staging depth — ``max`` of its own queue and the engine's
  ``pipeline.staged_depth`` gauge — against ``high_water``; at/above
  it, a PAUSE frame goes out and the server stops reading the socket
  (TCP flow control backs the contract even against a client that
  ignores PAUSE) until the depth drains to ``low_water``, then RESUME.
  Engagements are published as ``ingest.backpressure_engaged`` events
  and the ``ingest.paused`` gauge.
- **Per-tenant sequence spaces** (``tenant_streams=True``). One
  connection multiplexes N tenants: each DATA frame's ``"tenant"``
  payload entry selects a per-tenant sequence space
  (``[next_expected, acked, durable]``), WELCOME carries the whole
  per-tenant expected-seq map (plus park/pause/shed state, so a
  reconnecting client holds a parked tenant's stream IMMEDIATELY, not
  at the next backpressure poll), and ACK/REJECT/PAUSE/RESUME/NACK
  frames carry a ``{"tenant": ...}`` JSON envelope scoping them to one
  stream. ``ack(pos, tenant=tid)`` is the checkpoint-gated per-tenant
  ack the :class:`TenantRouter` fires from the engine's ``on_durable``
  rotation; a QoS-shed tenant's frames are refused with a typed NACK
  carrying its durable position.
- **Pre-shared-key auth** (``auth_token=``). The server answers the
  first bare HELLO with an AUTH_CHALLENGE nonce; the client re-HELLOs
  with ``{"auth": hex(HMAC-SHA256(token, nonce))}``; anything else —
  or any non-handshake frame before authentication — gets a typed
  AUTH_FAIL and the connection closes (``ingest.auth_failures``).
- **Live introspection (STATS).** A ``STATS`` frame — on a dedicated
  connection (``obs.status.fetch_stats`` / ``python -m
  gelly_torch.obs.status HOST:PORT``) or interleaved on the data
  connection — is answered mid-stream with a JSON snapshot (counters,
  gauges, histogram quantiles, per-tenant backlog-age watermarks, host
  identity; ``stats_fields`` merges server-specific extras). STATS is
  read-only: it never advances the expected sequence, never acks, and
  a stats-only connection is never adopted as the data connection —
  the DATA stream's exactly-once state is untouched. With telemetry
  recording on (``obs.bus.recording()`` or an installed tracer) the
  server additionally records the ``ingest.receive_to_stage_ms``
  histogram and stamps each staged frame's ingress time into
  ``bus.watermarks`` (stream key ``"stream"``), the source of the
  end-to-end latency watermarks downstream consumers retire. A STATS
  request whose payload is ``{"format": "prometheus"}`` is answered
  with the Prometheus text-format exposition of every bus
  counter/gauge/histogram instead of JSON (``obs/slo.py``'s
  ``prometheus_text``).
- **Wire trace propagation.** With a span tracer installed, each
  admitted frame's payload may carry a compact trace context
  (``wire.TRACE_KEY`` — the client's trace_id + client-send span id;
  stamped by ``IngestClient``, absent on legacy senders). The server
  POPS it before the payload reaches any chunk builder or codec, and
  records a ``wire_recv`` span (frame fully received → payload
  decoded, parented on the client-send span) plus a ``staging`` span
  (admission wait → enqueued, parented on wire_recv) per admitted
  unit; the staged positions are bound to the staging span's context
  in the tracer's position registry, so the engine's fold/checkpoint
  spans downstream link to the same trace — one causal chain
  client-send → wire → staging → fold → durable checkpoint.
- **Push alert subscriptions (SUBSCRIBE/ALERT).** A SUBSCRIBE frame
  registers an EventBus subscription scoped to this connection: every
  bus event matching the JSON filter (event-name prefixes, tenant,
  SLO name) is pushed as an ALERT frame. Delivery is BEST-EFFORT and
  explicitly OUTSIDE the exactly-once data plane: ALERT seqs are a
  per-connection counter (never stream positions), alerts are never
  buffered for retransmission and never acked; a failed send bumps
  ``alerts.dropped`` and moves on. The subscription dies with the
  connection. ``analysis/contracts.py`` rule AL001 enforces the
  separation: an ALERT-sending scope must not touch seq/ack state or
  the resend buffer.
"""

from __future__ import annotations

import hmac
import logging
import secrets
import socket
import threading
import time
from typing import Iterator

import numpy as np

from ..engine import faults as faults_mod
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing
from . import wire

logger = logging.getLogger("gelly_torch.ingest")

_DONE = object()


def _trace_recv(tracer, t_rx: float, tctx, seq: int, nbytes: int,
                **extra) -> int:
    """Record one admitted frame's ``wire_recv`` span (frame fully
    received → payload decoded), parented on the client-send span when
    the frame carried a trace context; returns the span id the
    ``staging`` span parents on."""
    sid = tracer.next_span_id()
    args = {"seq": seq, "bytes": nbytes, "span": sid}
    if tctx is not None:
        args["trace"], args["parent"] = tctx
    args.update(extra)
    tracer.span("wire_recv", "ingest", t_rx - tracer.t0, **args)
    return sid


def _trace_staged(tracer, t0: float, rx_sid: int, tctx, keys, seq: int,
                  depth: int, **extra) -> None:
    """Record one staged unit's ``staging`` span (admission wait →
    enqueued) and bind every covered position to its context, so the
    engine's fold/checkpoint spans can link to the same trace by
    position. A context-less (legacy) frame still gets a span and a
    binding under the server tracer's own trace id — the server-side
    chain stays linked even when the client stamps nothing."""
    sid = tracer.next_span_id()
    trace = tctx[0] if tctx is not None else tracer.trace_id
    tracer.span("staging", "ingest", t0, seq=seq, span=sid,
                parent=rx_sid, trace=trace, depth=depth, **extra)
    for k in keys:
        tracer.bind_ctx(k, trace, sid)


def _json_safe(fields: dict) -> dict:
    """Alert fields as plain JSON types: an EventBus event may carry
    arrays/objects, and a malformed alert payload must never break the
    wire framing (``pack_json`` has no fallback encoder)."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = repr(v)[:200]
    return out


def _alert_match(events, tenant, slo, name: str, fields: dict) -> bool:
    """One subscription filter against one bus event. ``events`` are
    exact names or dotted prefixes (``"alerts."``); a tenant filter
    passes events that carry NO tenant field (a global breach concerns
    every subscriber) and blocks other tenants' events; an SLO filter
    matches the event's ``slo`` field."""
    if events and not any(
        name == e or (e.endswith(".") and name.startswith(e))
        for e in events
    ):
        return False
    if tenant is not None:
        ev_tenant = fields.get("tenant")
        if ev_tenant is not None:
            try:
                if int(ev_tenant) != int(tenant):
                    return False
            except (TypeError, ValueError):
                return False
    if slo is not None and fields.get("slo") != slo:
        return False
    return True


def payload_to_chunk(payload: dict, capacity: int,
                     vertex_capacity: int | None = None):
    """Convert a raw-edge payload (``{"src": i64[n], "dst": i64[n]}``,
    the :func:`~gelly_torch.ingest.client.edge_payload` format) into a
    padded host EdgeChunk of fixed ``capacity`` (static shapes keep the
    downstream fold on one compiled program).

    ``vertex_capacity`` bounds the identity id space, matching every
    file-based ingest path: an out-of-range id raises here instead of
    silently truncating to int32 and corrupting (or being masked out
    of) the downstream fold — wire clients are exactly the peers most
    likely to send ids the summary was not sized for."""
    from ..core.chunk import make_chunk

    src = np.asarray(payload["src"], dtype=np.int64)
    dst = np.asarray(payload["dst"], dtype=np.int64)
    if src.shape[0] > capacity:
        raise ValueError(
            f"payload carries {src.shape[0]} edges > chunk capacity "
            f"{capacity}"
        )
    if vertex_capacity is not None and src.shape[0]:
        hi = int(max(src.max(), dst.max()))
        lo = int(min(src.min(), dst.min()))
        if hi >= vertex_capacity or lo < 0:
            raise ValueError(
                f"payload vertex id {hi if hi >= vertex_capacity else lo} "
                f"out of range for vertex_capacity {vertex_capacity} "
                "(wire ingest uses identity ids; re-encode at the client "
                "or raise vertex_capacity)"
            )
    return make_chunk(
        src.astype(np.int32), dst.astype(np.int32),
        raw_src=src, raw_dst=dst, capacity=capacity, device=None,
    )


class IngestServer:
    """Accepts one resumable ingest stream on a TCP port.

    ``start()`` binds and returns (the accept loop runs on a daemon
    thread); iterate :meth:`payloads` (or :meth:`chunks`) to consume.
    ``queue_depth`` bounds staged frames (absolute backstop);
    ``high_water`` / ``low_water`` drive the PAUSE/RESUME protocol.
    ``resume_seq`` seeds the expected sequence — a restarted server
    passes its checkpoint position so acked chunks are never re-folded.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 queue_depth: int = 64, high_water: int | None = None,
                 low_water: int | None = None, ack_every: int = 1,
                 auto_ack: bool = True, resume_seq: int = 0,
                 pause_poll_s: float = 0.005, stop_on_bye: bool = False,
                 stats_fields=None, auth_token: str | None = None,
                 tenant_streams: bool = False,
                 resume_seqs: dict | None = None):
        self.host = host
        # Pre-shared-key HELLO auth (None = open, loopback default).
        self.auth_token = auth_token
        # Per-tenant sequence spaces: DATA frames carry a "tenant"
        # payload entry and seq numbers are scoped per tenant.
        self.tenant_streams = bool(tenant_streams)
        # {tenant_id: [next_expected, acked, durable]} — list cells so
        # the conn loop's updates are plain subscript stores under
        # _state_lock. resume_seqs seeds each tenant's position (the
        # per-tenant resume_seq: a restarted server passes checkpoint
        # positions so acked chunks are never re-folded).
        self._tseq: dict[int, list] = {
            int(tid): [int(p), int(p), int(p)]
            for tid, p in (resume_seqs or {}).items()
        }
        # Tenants held by policy (QoS park → wire PAUSE) and tenants
        # shed (stream closed; frames answered with a typed NACK).
        self._tenant_held: set[int] = set()
        self._tenant_shed: dict[int, str] = {}
        # Whether gauge-driven backpressure currently holds the wire —
        # WELCOME carries it so a reconnecting client holds at once.
        self._bp_paused = False
        # Optional zero-arg callable whose dict merges into every STATS
        # reply (e.g. the tenant engine's per-tenant telemetry via
        # TenantRouter). Failures are contained and reported in-band.
        self.stats_fields = stats_fields
        # Watermark ledger key staged frames are ingress-stamped under
        # (telemetry-gated). "stream" matches the single-stream
        # consumer's retire key; the TenantRouter re-keys attached
        # servers (per-tenant ledgers own the watermark there).
        self.watermark_stream = "stream"
        # One-shot servers (the example's --serve mode): a client BYE
        # ends the whole stream, so the consumer's iterator terminates.
        self.stop_on_bye = stop_on_bye
        self._requested_port = port
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = queue_depth
        self.high_water = (queue_depth if high_water is None
                           else int(high_water))
        if self.high_water < 1:
            raise ValueError(f"high_water must be >= 1, got {high_water}")
        self.low_water = (max(0, self.high_water // 2) if low_water is None
                          else int(low_water))
        if self.low_water >= self.high_water:
            raise ValueError(
                f"low_water {self.low_water} must sit below high_water "
                f"{self.high_water}"
            )
        self.ack_every = max(1, int(ack_every))
        self.auto_ack = auto_ack
        self.pause_poll_s = pause_poll_s
        import queue as queue_mod

        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        # _state_lock guards the protocol counters; _send_lock guards
        # socket writes (acks go out from BOTH the connection thread
        # and the consumer's ack() call). Never nested.
        self._state_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._next_seq = int(resume_seq)
        self._acked = int(resume_seq)
        self._durable = int(resume_seq)
        # Push-alert subscriptions: ids are server-unique; the live
        # count feeds the ``alerts.subscribers`` gauge. Both under
        # _state_lock (subscribe/teardown are control-plane rare).
        self._next_sub_id = 0
        self._alert_subscribers = 0
        self._conn_sock: socket.socket | None = None
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self.port: int | None = None

    # ------------------------------------------------------------ control

    def start(self) -> "IngestServer":
        if self._listener is not None:
            raise RuntimeError("server already started")
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self._requested_port))
        ls.listen(4)
        ls.settimeout(0.1)
        with self._state_lock:  # the accept loop reads _listener
            self._listener = ls
            self.port = ls.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="gelly-ingest-accept",
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        """End the stream: the consumer's :meth:`payloads` iterator
        terminates after draining what is already queued."""
        self._stop.set()
        with self._state_lock:
            sock, self._conn_sock = self._conn_sock, None
        if sock is not None:
            _close_quietly(sock)
        if self._listener is not None:
            _close_quietly(self._listener)
        # Unblock a parked consumer.
        try:
            self._q.put_nowait(_DONE)
        except Exception:  # queue full: consumer will still see _stop
            pass
        # Retire the ingress ledger: frames stamped at receive but
        # never consumed (staged at teardown, or a router-less run
        # with no durable retirement) must not read as ever-growing
        # backlog in max_backlog_age() after the stream is gone. Key
        # read under the state lock — TenantRouter.attach rekeys the
        # ledger under the same lock; drop() is a no-op when telemetry
        # never stamped.
        with self._state_lock:
            wmk = obs_bus.get_bus().watermarks
            wmk.drop(self.watermark_stream)
            for tid in self._tseq:
                wmk.drop(f"{self.watermark_stream}:t{tid}")

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- consumer

    def _staged_units(self) -> Iterator[tuple]:
        """Drain the staging queue: one item per STAGED UNIT — a plain
        frame's ``(seq, payload_dict, compressed_bool)`` or a stacked
        frame's ``(first_seq, [payload, ...], [compressed, ...])`` (the
        list-typed third element is the discriminator). The bounded
        queue is the backpressure boundary either way; a stacked frame
        occupies ONE slot."""
        import queue as queue_mod

        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is _DONE:
                return
            yield item

    def frames(self) -> Iterator[tuple[int, dict, bool]]:
        """Yield ``(seq, payload_dict, compressed)`` in sequence order
        until :meth:`stop` — ``compressed`` is True for
        ``DATA_COMPRESSED`` frames (client-side-compressed codec
        payloads the consumer folds directly, no server compress). The
        bounded staging queue is the backpressure boundary: not
        consuming stalls the wire, never memory. STACKED frames are
        unstacked transparently here — one yield per carried payload,
        positions tiling ``[first_seq, first_seq + K)`` — so per-chunk
        consumers never see frame boundaries; consumers that want the
        frame-granularity unit (one fold dispatch per frame) iterate
        :meth:`stacks` instead."""
        for item in self._staged_units():
            seq, payload, compressed = item
            if isinstance(compressed, list):
                for i, (p, c) in enumerate(zip(payload, compressed)):
                    yield seq + i, p, c
            else:
                yield item

    def stacks(self) -> Iterator[tuple[int, list, list]]:
        """Yield ``(first_seq, [payload, ...], [compressed, ...])`` —
        one item per staged unit, in sequence order. A plain DATA /
        DATA_COMPRESSED frame yields a 1-payload unit; a STACKED frame
        yields its whole (possibly prefix-dropped) stack. This is the
        frame-granularity consumer: each unit is exactly one staging
        admission, and feeding units whole to the engine keeps ONE
        fold dispatch per frame."""
        for item in self._staged_units():
            seq, payload, compressed = item
            if isinstance(compressed, list):
                yield seq, payload, compressed
            else:
                yield seq, [payload], [compressed]

    def compressed_payload_units(self) -> Iterator[list]:
        """Yield each staged unit as a LIST of pre-compressed codec
        payloads — the stream shape ``run_aggregation(...,
        precompressed=True)`` folds with one dispatch per unit (a
        list item is a pre-grouped fold batch there). A raw DATA
        payload anywhere in the stream is a protocol error, same
        contract as :meth:`compressed_payloads`."""
        for seq, payloads, flags in self.stacks():
            for i, c in enumerate(flags):
                if not c:
                    raise ValueError(
                        f"raw DATA payload at seq {seq + i} on a "
                        "compressed-payload consumer — the client must "
                        "compress before send (send_compressed); mixing "
                        "raw and compressed chunks in one stream has no "
                        "single fold to land in"
                    )
            yield payloads

    def chunk_units(self, capacity: int,
                    vertex_capacity: int | None = None) -> Iterator[list]:
        """Yield each staged unit as a LIST of padded EdgeChunks (see
        :func:`payload_to_chunk`) — the raw-edge twin of
        :meth:`compressed_payload_units`: one list per frame keeps one
        ``fold_many`` dispatch per frame downstream. A compressed
        payload anywhere in the stream raises, same contract as
        :meth:`chunks`."""
        for seq, payloads, flags in self.stacks():
            for i, c in enumerate(flags):
                if c:
                    raise ValueError(
                        f"compressed DATA payload at seq {seq + i} on a "
                        "raw-chunk consumer — consume "
                        "compressed_payload_units() with a codec plan "
                        "instead"
                    )
            yield [payload_to_chunk(p, capacity, vertex_capacity)
                   for p in payloads]

    def payloads(self) -> Iterator[tuple[int, dict]]:
        """Yield ``(seq, payload_dict)`` in sequence order until
        :meth:`stop` (see :meth:`frames` for the variant that also
        reports the compressed flag)."""
        for seq, payload, _compressed in self.frames():
            yield seq, payload

    def compressed_payloads(self) -> Iterator[dict]:
        """Yield pre-compressed codec payloads in sequence order — the
        stream ``run_aggregation(..., precompressed=True)`` folds with
        zero server-side compress spans. A raw DATA frame on the
        stream is a protocol error here (the consumer's fold has no
        raw-chunk path wired): raised loudly, never silently folded."""
        for seq, payload, compressed in self.frames():
            if not compressed:
                raise ValueError(
                    f"raw DATA frame at seq {seq} on a compressed-"
                    "payload consumer — the client must compress before "
                    "send (send_compressed / DATA_COMPRESSED); mixing "
                    "raw and compressed chunks in one stream has no "
                    "single fold to land in"
                )
            yield payload

    def chunks(self, capacity: int,
               vertex_capacity: int | None = None) -> Iterator:
        """Raw-edge payload stream as padded EdgeChunks (see
        :func:`payload_to_chunk`; pass the stream's ``vertex_capacity``
        so out-of-range wire ids fail loudly, file-ingest parity)."""
        for seq, payload, compressed in self.frames():
            if compressed:
                raise ValueError(
                    f"compressed DATA frame at seq {seq} on a raw-chunk "
                    "consumer — this stream folds raw edges "
                    "(payload_to_chunk); consume compressed_payloads() "
                    "with a codec plan instead"
                )
            yield payload_to_chunk(payload, capacity, vertex_capacity)

    def ack(self, upto: int, tenant=None) -> None:
        """Mark every seq < ``upto`` durable (consumer checkpoint
        covering those chunks committed) and push an ACK to the client.
        The ``auto_ack=False`` half of the exactly-once contract. In
        ``tenant_streams`` mode pass ``tenant=`` — the ACK is scoped to
        that tenant's sequence space (a ``{"tenant": ...}`` envelope
        rides the frame)."""
        if tenant is not None or self.tenant_streams:
            if tenant is None:
                raise ValueError(
                    "tenant_streams server: ack(upto, tenant=tid)"
                )
            tid = int(tenant)
            with self._state_lock:
                st = self._tseq.setdefault(tid, [0, 0, 0])
                if upto <= st[2]:
                    return
                st[2] = upto
                st[1] = max(st[1], upto)
                sock = self._conn_sock
            if sock is not None:
                self._send(sock, wire.pack_frame(
                    wire.ACK, upto, wire.pack_json({"tenant": tid})))
                obs_bus.get_bus().inc("ingest.acks_sent")
            return
        with self._state_lock:
            if upto <= self._durable:
                return
            self._durable = upto
            self._acked = max(self._acked, upto)
            sock = self._conn_sock
        if sock is not None:
            self._send(sock, wire.pack_frame(wire.ACK, upto))
            obs_bus.get_bus().inc("ingest.acks_sent")

    def seed_tenant_seq(self, tenant, pos: int) -> None:
        """Seed one tenant's expected/acked/durable wire position (the
        per-tenant ``resume_seq``: the router passes each tenant's
        engine position at attach so acked chunks are never re-folded).
        Max-merges — never rewinds state a live connection advanced."""
        tid = int(tenant)
        pos = int(pos)
        with self._state_lock:
            st = self._tseq.setdefault(tid, [0, 0, 0])
            st[0] = max(st[0], pos)
            st[1] = max(st[1], pos)
            st[2] = max(st[2], pos)

    def wire_ledger(self, tenant=None) -> str:
        """Watermark ledger key ingress stamps land under: the base
        stream key, or the per-tenant sub-key in tenant_streams mode
        (distinct per-tenant seq spaces must not collide on one
        ledger)."""
        if tenant is None or not self.tenant_streams:
            return self.watermark_stream
        return f"{self.watermark_stream}:t{int(tenant)}"

    def pause_tenant(self, tenant) -> None:
        """Policy hold (QoS park): PAUSE the tenant's stream. Scoped
        with a ``{"tenant": ...}`` envelope in tenant_streams mode; a
        legacy single-stream server pauses the whole wire (one tenant
        per server there). The hold survives reconnects — WELCOME
        carries it — and is lifted only by :meth:`resume_tenant`, never
        by the backpressure loop's RESUME."""
        tid = int(tenant)
        with self._state_lock:
            self._tenant_held.add(tid)
            sock = self._conn_sock
        if sock is not None:
            if self.tenant_streams:
                self._send(sock, wire.pack_frame(
                    wire.PAUSE, 0, wire.pack_json({"tenant": tid})))
            else:
                self._send(sock, wire.pack_frame(wire.PAUSE, 0))

    def resume_tenant(self, tenant) -> None:
        """Lift a :meth:`pause_tenant` hold (QoS un-park) and RESUME
        the stream (legacy mode: only once no other hold or
        backpressure pause remains)."""
        tid = int(tenant)
        with self._state_lock:
            self._tenant_held.discard(tid)
            clear = not self._tenant_held and not self._bp_paused
            sock = self._conn_sock
        if sock is not None:
            if self.tenant_streams:
                self._send(sock, wire.pack_frame(
                    wire.RESUME, 0, wire.pack_json({"tenant": tid})))
            elif clear:
                self._send(sock, wire.pack_frame(wire.RESUME, 0))

    def shed_tenant(self, tenant, reason: str = "qos") -> None:
        """Close a tenant's stream by policy: every subsequent frame
        for it is refused with a typed NACK carrying the tenant's
        durable position (everything below it is folded and safe;
        nothing at/above it will ever be acked)."""
        tid = int(tenant)
        with self._state_lock:
            self._tenant_held.discard(tid)
            self._tenant_shed[tid] = str(reason)
            st = self._tseq.setdefault(tid, [0, 0, 0])
            durable = st[2]
            sock = self._conn_sock
        obs_bus.get_bus().inc("ingest.nacks_sent")
        if sock is not None:
            env = {"reason": str(reason)}
            if self.tenant_streams:
                env["tenant"] = tid
            self._send(sock, wire.pack_frame(
                wire.NACK, durable, wire.pack_json(env)))

    @property
    def next_seq(self) -> int:
        with self._state_lock:
            return self._next_seq

    @property
    def durable_seq(self) -> int:
        with self._state_lock:
            return self._durable

    # ------------------------------------------------------------ wire IO

    def _send(self, sock, frame: bytes) -> bool:
        try:
            with self._send_lock:
                sock.sendall(frame)
            return True
        except OSError:
            return False

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            # Adoption as THE data connection is deferred to the first
            # HELLO/DATA frame (_adopt): a read-only STATS connection
            # must be answerable mid-stream without closing the live
            # data socket out from under the streaming client.
            t = threading.Thread(
                target=self._conn_loop, args=(sock, addr), daemon=True,
                name="gelly-ingest-conn",
            )
            t.start()

    def _adopt(self, sock: socket.socket) -> None:
        """Make ``sock`` the (single) data connection — latest wins: a
        reconnecting client's old socket may still look open
        server-side. Called on the first stream frame, never for
        STATS-only connections."""
        with self._state_lock:
            if self._conn_sock is sock:
                return
            old, self._conn_sock = self._conn_sock, sock
        if old is not None:
            _close_quietly(old)

    def _conn_loop(self, sock: socket.socket, addr) -> None:
        bus = obs_bus.get_bus()
        tracer = obs_tracing.active_tracer()
        sock.settimeout(0.2)
        logger.info("ingest connection from %s", addr)
        # Batched-ack remainder (ack_every > 1): flushed on BYE and on
        # every idle recv tick, so a client's flush() never waits past
        # one socket-timeout quantum for the tail acknowledgement.
        pending_acks = [0]

        def flush_tail():
            if self.auto_ack and pending_acks[0]:
                pending_acks[0] = 0
                with self._state_lock:
                    acked = self._acked
                self._send(sock, wire.pack_frame(wire.ACK, acked))
                bus.inc("ingest.acks_sent")

        recv = _timeout_recv(sock, self._stop, idle=flush_tail)
        # Pre-shared-key handshake state (per connection): unauthed
        # connections may only HELLO (challenge/proof) or BYE.
        authed = self.auth_token is None
        nonce: bytes | None = None
        # Push-alert state (per connection): bus unsubscribe callables
        # (fired at teardown — a dead connection must not keep a
        # subscriber pushing into a closed socket forever) and the
        # alert seq counter — its OWN space, never stream state.
        # itertools.count: next() is GIL-atomic, so concurrent bus
        # emitters allocate alert seqs without a lock.
        import itertools

        alert_subs: list = []
        alert_seq = itertools.count(1)
        try:
            while not self._stop.is_set():
                try:
                    ftype, seq, payload, crc_ok = wire.read_frame_checked(
                        recv
                    )
                except wire.TruncatedFrame:
                    # Torn frame: nothing of it is trusted or enqueued;
                    # the acked-seq resume makes the tear harmless.
                    bus.inc("ingest.frames_truncated")
                    return
                except wire.FrameError as e:
                    bus.inc("ingest.frames_rejected")
                    logger.warning("undecodable frame from %s: %s", addr, e)
                    return  # no trustworthy frame boundary left
                except _ConnClosed:
                    return
                faults_mod.inject("ingest")
                # Frame-receive instant for the receive→stage latency
                # histogram (telemetry-gated; cadence is per frame =
                # per chunk, never per edge).
                telemetry = obs_bus.telemetry_on()
                t_rx = time.perf_counter() if telemetry else 0.0
                bus.inc("ingest.frames_received")
                bus.inc("ingest.bytes_received",
                        wire.HEADER_BYTES + len(payload))
                if not crc_ok:
                    # The checkpoint CRC discipline on the wire: reject,
                    # never advance past unverifiable bytes.
                    bus.inc("ingest.frames_rejected")
                    if tracer is not None:
                        tracer.instant("ingest.frame_rejected", seq=seq)
                    if self.tenant_streams:
                        # The tenant id lives in the (unverifiable)
                        # payload, so no single stream's expect can be
                        # named: ask the client to retransmit every
                        # un-acked frame (duplicates drop + re-ack).
                        self._send(sock, wire.pack_frame(
                            wire.REJECT, 0,
                            wire.pack_json({"resync": True})))
                        continue
                    with self._state_lock:
                        expect = self._next_seq
                    self._send(sock, wire.pack_frame(wire.REJECT, expect))
                    continue
                if not authed and ftype not in (wire.HELLO, wire.BYE):
                    # Nothing but the handshake crosses an unauthed
                    # connection — STATS introspection included.
                    bus.inc("ingest.auth_failures")
                    self._send(sock, wire.pack_frame(wire.AUTH_FAIL, 0))
                    return
                if ftype == wire.STATS:
                    # Read-only introspection, answerable mid-stream:
                    # touches neither the expected seq nor the ack
                    # state, and never adopts this connection. The
                    # request payload selects the exposition format
                    # (JSON default; {"format": "prometheus"} for the
                    # text exposition).
                    self._answer_stats(sock, bus, seq, payload)
                    continue
                if ftype == wire.SUBSCRIBE:
                    # Push-alert registration: like STATS, read-only
                    # control — never adopts the connection, never
                    # touches seq/ack state (AL001).
                    self._answer_subscribe(sock, bus, seq, payload,
                                           alert_subs, alert_seq)
                    continue
                if ftype == wire.HELLO:
                    if not authed:
                        proof = None
                        if payload:
                            try:
                                proof = wire.unpack_json(payload).get(
                                    "auth")
                            except wire.FrameError:
                                proof = None
                        if proof is None:
                            # First (bare) HELLO: challenge with a
                            # fresh nonce; the client re-HELLOs with
                            # the HMAC proof.
                            nonce = secrets.token_bytes(16)
                            bus.inc("ingest.auth_challenges")
                            self._send(sock, wire.pack_frame(
                                wire.AUTH_CHALLENGE, 0, nonce))
                            continue
                        want = hmac.new(
                            self.auth_token.encode(), nonce or b"",
                            "sha256",
                        ).hexdigest()
                        if not (isinstance(proof, str)
                                and hmac.compare_digest(proof, want)):
                            bus.inc("ingest.auth_failures")
                            logger.warning(
                                "auth failure from %s", addr)
                            self._send(sock, wire.pack_frame(
                                wire.AUTH_FAIL, 0))
                            return
                        authed = True
                    self._adopt(sock)
                    expect, wpayload = self._welcome_args()
                    self._send(sock, wire.pack_frame(
                        wire.WELCOME, expect, wpayload))
                    continue
                if ftype == wire.BYE:
                    with self._state_lock:
                        is_data = self._conn_sock is sock
                    if not is_data:
                        # A stats-only (or never-handshaken) connection
                        # closing is not the STREAM's goodbye.
                        return
                    flush_tail()
                    if self.stop_on_bye:
                        self.stop()
                    return
                if ftype == wire.STACKED:
                    # K chunks behind ONE header/CRC/admission: the
                    # frame covers positions [seq, seq + K) and stages
                    # as one unit (one fold dispatch downstream).
                    self._adopt(sock)
                    if not self._stacked_data(sock, bus, tracer, seq,
                                              payload, telemetry, t_rx):
                        return  # stopped while staging
                    continue
                if ftype not in (wire.DATA, wire.DATA_COMPRESSED):
                    continue  # unexpected control frame: ignore
                self._adopt(sock)
                compressed = ftype == wire.DATA_COMPRESSED
                if self.tenant_streams:
                    if not self._tenant_data(sock, bus, tracer, seq,
                                             payload, compressed,
                                             telemetry, t_rx):
                        return  # stopped while staging
                    continue
                with self._state_lock:
                    expect = self._next_seq
                if seq < expect:
                    # Reconnect replay of an already-staged chunk.
                    bus.inc("ingest.frames_duplicate")
                    with self._state_lock:
                        acked = self._acked
                    self._send(sock, wire.pack_frame(wire.ACK, acked))
                    continue
                if seq > expect:
                    bus.inc("ingest.frames_rejected")
                    self._send(sock, wire.pack_frame(wire.REJECT, expect))
                    continue
                try:
                    data = wire.unpack_payload(payload)
                except wire.FrameError as e:
                    bus.inc("ingest.frames_rejected")
                    logger.warning("malformed payload seq=%d: %s", seq, e)
                    self._send(sock, wire.pack_frame(wire.REJECT, expect))
                    continue
                # Pop the wire trace context BEFORE the payload reaches
                # any consumer (it is transport metadata, not stream
                # data — chunk builders and codecs must never see it).
                tctx = wire.pop_trace(data)
                rx_sid = 0
                t_stage = 0.0
                if tracer is not None:
                    rx_sid = _trace_recv(tracer, t_rx, tctx, seq,
                                         len(payload))
                    t_stage = tracer.now()
                # Admission control sits HERE — at the staging boundary,
                # after control frames (so a handshake always completes
                # even under full backpressure) and before the enqueue
                # (so the staged depth never exceeds the high-water
                # mark). Frames the client already pushed into kernel
                # buffers wait there under TCP flow control.
                if telemetry:
                    # Ingress stamp BEFORE the admission wait: the e2e
                    # watermark must count backpressure time — that is
                    # the backlog the QoS round gates on. First-stamp-
                    # wins keys this to the consumer's chunk positions
                    # (seq == the engine's 0-based chunk index). Key
                    # read + stamp under the state lock: a concurrent
                    # TenantRouter.attach swaps the key and rekeys the
                    # ledger under the same lock, so no stamp can land
                    # under the old key after its ledger moved.
                    with self._state_lock:
                        bus.watermarks.stamp(self.watermark_stream,
                                             seq)
                self._apply_backpressure(sock, bus)
                if not self._enqueue((seq, data, compressed)):
                    return  # stopped while staging
                with self._state_lock:
                    self._next_seq = seq + 1
                    if self.auto_ack:
                        self._acked = seq + 1
                    acked = self._acked
                bus.inc("ingest.chunks_enqueued")
                if telemetry:
                    bus.observe("ingest.receive_to_stage_ms",
                                (time.perf_counter() - t_rx) * 1e3)
                if compressed:
                    bus.inc("ingest.data_frames_compressed")
                else:
                    bus.inc("ingest.data_frames_raw")
                bus.gauge("ingest.staged_depth", self._q.qsize())
                if tracer is not None:
                    _trace_staged(tracer, t_stage, rx_sid, tctx, (seq,),
                                  seq, self._q.qsize())
                    tracer.instant("ingest.chunk_staged", track="ingest",
                                   seq=seq, bytes=len(payload))
                pending_acks[0] += 1
                if self.auto_ack and pending_acks[0] >= self.ack_every:
                    pending_acks[0] = 0
                    self._send(sock, wire.pack_frame(wire.ACK, acked))
                    bus.inc("ingest.acks_sent")
        finally:
            # Tear down this connection's alert subscriptions BEFORE
            # closing the socket state: a subscriber firing after this
            # point would only count alerts.dropped against a socket
            # that can never deliver again.
            if alert_subs:
                for unsub in alert_subs:
                    unsub()
                with self._state_lock:
                    self._alert_subscribers -= len(alert_subs)
                    n_subs = self._alert_subscribers
                bus.gauge("alerts.subscribers", n_subs)
            _close_quietly(sock)
            with self._state_lock:
                if self._conn_sock is sock:
                    self._conn_sock = None

    def _welcome_args(self) -> tuple[int, bytes]:
        """WELCOME's (seq, payload): the legacy expected seq plus a
        JSON body carrying pause/park/shed state — a reconnecting
        client must hold a held stream IMMEDIATELY, not at the next
        backpressure poll — and (tenant_streams) the whole per-tenant
        expected-seq map."""
        with self._state_lock:
            if self.tenant_streams:
                body = {
                    "paused": self._bp_paused,
                    "paused_tenants": sorted(self._tenant_held),
                    "shed_tenants": sorted(self._tenant_shed),
                    "streams": {str(tid): st[0]
                                for tid, st in self._tseq.items()},
                }
            else:
                # Legacy single-stream: a policy hold (one tenant per
                # server) or an in-force backpressure pause holds the
                # whole wire from the first frame after reconnect.
                body = {
                    "paused": self._bp_paused or bool(self._tenant_held),
                }
            return self._next_seq, wire.pack_json(body)

    def _tenant_data(self, sock, bus, tracer, seq: int, payload: bytes,
                     compressed: bool, telemetry: bool,
                     t_rx: float) -> bool:
        """One DATA frame in tenant_streams mode: the payload's
        ``"tenant"`` entry selects the sequence space; duplicate/gap/
        shed handling and acks are all scoped to it. Returns False only
        when staging stopped (the conn loop exits). Reached only after
        the conn loop's CRC guard — the payload bytes are verified."""
        try:
            data = wire.unpack_payload(payload)
        except wire.FrameError as e:
            bus.inc("ingest.frames_rejected")
            logger.warning("malformed payload seq=%d: %s", seq, e)
            self._send(sock, wire.pack_frame(
                wire.REJECT, 0, wire.pack_json({"resync": True})))
            return True
        tctx = wire.pop_trace(data)
        wt = data.get("tenant")
        if wt is None:
            bus.inc("ingest.chunks_unroutable")
            logger.warning(
                "tenant-streams frame seq=%d without a tenant id "
                "dropped", seq,
            )
            return True
        tid = int(np.asarray(wt).reshape(-1)[0])
        with self._state_lock:
            st = self._tseq.setdefault(tid, [0, 0, 0])
            expect = st[0]
            acked = st[1]
            durable = st[2]
            shed = self._tenant_shed.get(tid)
        env = wire.pack_json({"tenant": tid})
        if shed is not None:
            # Terminal: the stream was closed by policy. The NACK's
            # seq is the durable position — everything below it is
            # folded and safe, nothing at/above it will ever be acked.
            bus.inc("ingest.frames_shed")
            bus.inc("ingest.nacks_sent")
            self._send(sock, wire.pack_frame(
                wire.NACK, durable,
                wire.pack_json({"tenant": tid, "reason": shed})))
            return True
        if seq < expect:
            # Reconnect replay of an already-staged chunk.
            bus.inc("ingest.frames_duplicate")
            self._send(sock, wire.pack_frame(wire.ACK, acked, env))
            return True
        if seq > expect:
            bus.inc("ingest.frames_rejected")
            self._send(sock, wire.pack_frame(wire.REJECT, expect, env))
            return True
        if telemetry:
            # Ingress stamp BEFORE the admission wait (the e2e
            # watermark counts backpressure time), under the state
            # lock against a concurrent attach rekey — same contract
            # as the legacy path's stamp site.
            with self._state_lock:
                bus.watermarks.stamp(self.wire_ledger(tid), seq)
        rx_sid = 0
        t_stage = 0.0
        if tracer is not None:
            rx_sid = _trace_recv(tracer, t_rx, tctx, seq, len(payload),
                                 tenant=tid)
            t_stage = tracer.now()
        self._apply_backpressure(sock, bus)
        if not self._enqueue((seq, data, compressed)):
            return False
        with self._state_lock:
            st = self._tseq[tid]
            st[0] = seq + 1
            if self.auto_ack:
                st[1] = seq + 1
            acked = st[1]
        bus.inc("ingest.chunks_enqueued")
        if telemetry:
            bus.observe("ingest.receive_to_stage_ms",
                        (time.perf_counter() - t_rx) * 1e3)
        if compressed:
            bus.inc("ingest.data_frames_compressed")
        else:
            bus.inc("ingest.data_frames_raw")
        bus.gauge("ingest.staged_depth", self._q.qsize())
        if tracer is not None:
            _trace_staged(tracer, t_stage, rx_sid, tctx,
                          (("t", tid, seq),), seq, self._q.qsize(),
                          tenant=tid)
            tracer.instant("ingest.chunk_staged", track="ingest",
                           seq=seq, tenant=tid, bytes=len(payload))
        if self.auto_ack:
            # Per-tenant acks are unbatched (ack_every applies to the
            # legacy single-stream path): each tenant's flush() waits
            # on its OWN space, so a remainder could strand it.
            self._send(sock, wire.pack_frame(wire.ACK, acked, env))
            bus.inc("ingest.acks_sent")
        return True

    def _stacked_data(self, sock, bus, tracer, seq: int, payload: bytes,
                      telemetry: bool, t_rx: float) -> bool:
        """One STACKED frame (legacy or tenant mode): K payloads behind
        one header/CRC, covering sequence positions ``[seq, seq + K)``.
        Admission is whole-frame against the stream's expected
        position ``e``:

        - ``seq + K <= e`` — whole-frame reconnect replay: drop,
          re-ack (``ingest.frames_duplicate``).
        - ``seq > e`` — gap: REJECT with the expected seq; the client
          rewinds its frame-granularity resend buffer to the COVERING
          frame (its base may be below ``e`` — the overlap case below
          absorbs that).
        - ``seq <= e < seq + K`` — admit: the prefix ``[seq, e)`` is
          already staged (possibly durable — the mid-frame checkpoint
          resume case), so those payloads are DROPPED here and only
          ``[e, seq + K)`` stages, as ONE queue unit. Exactly-once
          holds at chunk granularity even though retransmission is
          frame-granular.

        Tenant mode adds: the stack must be single-tenant-scoped
        (every payload names the same tenant) — per-tenant seq spaces,
        checkpoint-gated acks, and shed NACKs are untouched because a
        frame never straddles sequence spaces. Returns False only when
        staging stopped. Reached only after the conn loop's CRC guard."""
        if self.tenant_streams:
            reject = wire.pack_frame(
                wire.REJECT, 0, wire.pack_json({"resync": True}))
        else:
            with self._state_lock:
                expect0 = self._next_seq
            reject = wire.pack_frame(wire.REJECT, expect0)
        try:
            parts = wire.unpack_stacked(payload)
            datas = [wire.unpack_payload(b) for b, _c in parts]
        except wire.FrameError as e:
            bus.inc("ingest.frames_rejected")
            logger.warning("malformed stacked frame seq=%d: %s", seq, e)
            self._send(sock, reject)
            return True
        flags = [c for _b, c in parts]
        # Pop every payload's wire trace context before any of them
        # reach a consumer. All K payloads of one stacked frame carry
        # the SAME frame-level client-send context (the client stamps
        # the stack's one span id), so the first surviving context
        # after the prefix drop is THE frame's context.
        tctxs = [wire.pop_trace(d) for d in datas]
        k = len(datas)
        env = b""
        tid = None
        if self.tenant_streams:
            tids = set()
            for d in datas:
                wt = d.get("tenant")
                tids.add(None if wt is None
                         else int(np.asarray(wt).reshape(-1)[0]))
            if len(tids) != 1 or None in tids:
                # A stack that straddles (or omits) tenant ids has no
                # single sequence space to land in — refuse it whole;
                # partial admission would tear per-tenant exactly-once.
                bus.inc("ingest.chunks_unroutable")
                logger.warning(
                    "stacked frame seq=%d is not single-tenant-scoped "
                    "(tenants=%s); dropped", seq,
                    sorted(str(t) for t in tids),
                )
                return True
            tid = tids.pop()
            env = wire.pack_json({"tenant": tid})
            with self._state_lock:
                st = self._tseq.setdefault(tid, [0, 0, 0])
                expect, acked, durable = st
                shed = self._tenant_shed.get(tid)
            if shed is not None:
                bus.inc("ingest.frames_shed")
                bus.inc("ingest.nacks_sent")
                self._send(sock, wire.pack_frame(
                    wire.NACK, durable,
                    wire.pack_json({"tenant": tid, "reason": shed})))
                return True
        else:
            with self._state_lock:
                expect = self._next_seq
                acked = self._acked
        if seq + k <= expect:
            # Whole-frame reconnect replay: every position is already
            # staged. Drop and re-ack, same as a duplicate DATA frame.
            bus.inc("ingest.frames_duplicate")
            self._send(sock, wire.pack_frame(wire.ACK, acked, env))
            return True
        if seq > expect:
            bus.inc("ingest.frames_rejected")
            self._send(sock, wire.pack_frame(wire.REJECT, expect, env))
            return True
        # seq <= expect < seq + k: admit. Drop the already-staged
        # prefix [seq, expect) — the mid-frame resume case: the
        # consumer's checkpoint (and ack) landed inside the frame, the
        # client retransmitted the COVERING frame, and re-staging the
        # durable prefix would double-fold it.
        drop = expect - seq
        if drop:
            logger.debug(
                "stacked frame seq=%d: dropping %d already-staged "
                "prefix payload(s), staging [%d, %d)", seq, drop,
                expect, seq + k,
            )
        datas = datas[drop:]
        flags = flags[drop:]
        tctx = next((c for c in tctxs[drop:] if c is not None), None)
        stage_seq = expect
        if telemetry:
            # Ingress stamp BEFORE the admission wait, under the state
            # lock against a concurrent attach rekey — one stamp per
            # CHUNK position (the watermark ledger retires chunkwise),
            # same contract as the per-frame paths.
            with self._state_lock:
                led = (self.wire_ledger(tid) if tid is not None
                       else self.watermark_stream)
                for j in range(len(datas)):
                    bus.watermarks.stamp(led, stage_seq + j)
        rx_sid = 0
        t_stage = 0.0
        if tracer is not None:
            rx_sid = _trace_recv(tracer, t_rx, tctx, seq, len(payload),
                                 stack=k)
            t_stage = tracer.now()
        self._apply_backpressure(sock, bus)
        if not self._enqueue((stage_seq, datas, flags)):
            return False
        with self._state_lock:
            if tid is not None:
                st = self._tseq[tid]
                st[0] = seq + k
                if self.auto_ack:
                    st[1] = seq + k
                acked = st[1]
            else:
                self._next_seq = seq + k
                if self.auto_ack:
                    self._acked = seq + k
                acked = self._acked
        bus.inc("ingest.frames_stacked")
        bus.inc("ingest.chunks_enqueued", len(datas))
        bus.observe("ingest.chunks_per_stacked_frame", k)
        if telemetry:
            bus.observe("ingest.receive_to_stage_ms",
                        (time.perf_counter() - t_rx) * 1e3)
        bus.gauge("ingest.staged_depth", self._q.qsize())
        if tracer is not None:
            # ONE staging span covers the whole admitted stack; every
            # covered position binds to it (all K payloads link to the
            # one frame-level chain).
            if tid is not None:
                keys = [("t", tid, stage_seq + j)
                        for j in range(len(datas))]
            else:
                keys = list(range(stage_seq, stage_seq + len(datas)))
            _trace_staged(tracer, t_stage, rx_sid, tctx, keys,
                          stage_seq, self._q.qsize(), stack=k)
            tracer.instant("ingest.chunk_staged", track="ingest",
                           seq=stage_seq, stack=k, bytes=len(payload))
        if self.auto_ack:
            # Acks are frame-granular on the stacked path: the frame
            # IS the batch, so ack_every batching on top of it would
            # only strand the client's flush() behind a remainder.
            self._send(sock, wire.pack_frame(wire.ACK, acked, env))
            bus.inc("ingest.acks_sent")
        return True

    def _answer_stats(self, sock, bus, seq: int = 0,
                      req: bytes = b"") -> None:
        """Reply to one STATS frame: a JSON snapshot of the current bus
        (counters/gauges/histogram quantiles/watermarks/host identity)
        plus the server's own sequencing view and any ``stats_fields``
        extras — or, when the request payload is ``{"format":
        "prometheus"}``, the Prometheus text-format exposition of every
        bus counter/gauge/histogram (``obs/slo.prometheus_text``). The
        request's ``seq`` is echoed on the reply — it is a client-side
        correlation token (never stream state), letting
        ``IngestClient.stats()`` reject a straggler reply to an earlier
        timed-out request. Failures are contained — introspection must
        never take the stream down."""
        import json

        from ..obs.status import build_stats

        bus.inc("ingest.stats_requests")
        fmt = "json"
        if req:
            try:
                fmt = str(wire.unpack_json(req).get("format", "json"))
            except wire.FrameError:
                fmt = "json"  # legacy/garbled request: JSON reply
        if fmt == "prometheus":
            from ..obs.slo import prometheus_text

            try:
                body = prometheus_text(bus).encode("utf-8")
            except Exception as e:  # noqa: BLE001
                body = (f"# exposition error: {type(e).__name__}: "
                        f"{e}"[:200] + "\n").encode("utf-8")
            self._send(sock, wire.pack_frame(wire.STATS, seq, body))
            return
        extra: dict = {}
        if self.stats_fields is not None:
            try:
                extra = dict(self.stats_fields())
            except Exception as e:  # noqa: BLE001
                extra = {"stats_fields_error":
                         f"{type(e).__name__}: {e}"[:200]}
        with self._state_lock:
            extra["server"] = {
                "port": self.port,
                "next_seq": self._next_seq,
                "acked": self._acked,
                "durable": self._durable,
                "staged_depth": self._q.qsize(),
                "auto_ack": self.auto_ack,
                "tenant_streams": self.tenant_streams,
            }
            if self.tenant_streams:
                extra["server"]["tenants"] = {
                    str(tid): {"next_seq": st[0], "acked": st[1],
                               "durable": st[2]}
                    for tid, st in self._tseq.items()
                }
                extra["server"]["held_tenants"] = sorted(
                    self._tenant_held)
                extra["server"]["shed_tenants"] = sorted(
                    self._tenant_shed)
        try:
            body = json.dumps(build_stats(bus, extra=extra),
                              default=str).encode("utf-8")
        except Exception as e:  # noqa: BLE001
            body = json.dumps(
                {"error": f"{type(e).__name__}: {e}"[:200]}
            ).encode("utf-8")
        self._send(sock, wire.pack_frame(wire.STATS, seq, body))

    def _answer_subscribe(self, sock, bus, seq: int, payload: bytes,
                          subs: list, alert_seq) -> None:
        """Register one push-alert subscription for this connection
        and confirm it (SUBSCRIBE echo carrying the correlation token
        and the subscription id). The registered bus subscriber pushes
        every matching event as an ALERT frame — BEST-EFFORT by
        contract: the alert seq is ``next(alert_seq)`` (a
        per-connection counter, its own space), nothing is buffered
        for retransmission, nothing is acked, and a send failure only
        counts ``alerts.dropped``. The data plane's exactly-once state
        is untouched (AL001)."""
        flt: dict | None = {}
        if payload:
            try:
                flt = wire.unpack_json(payload)
            except wire.FrameError:
                flt = None
        if flt is None or not isinstance(flt.get("events", []), list):
            self._send(sock, wire.pack_frame(
                wire.SUBSCRIBE, seq,
                wire.pack_json({"ok": False,
                                "error": "malformed filter"})))
            return
        events = [str(e) for e in flt.get("events", [])]
        tenant = flt.get("tenant")
        slo = flt.get("slo")
        with self._state_lock:
            self._next_sub_id += 1
            sub_id = self._next_sub_id
            self._alert_subscribers += 1
            n_subs = self._alert_subscribers
        bus.inc("alerts.subscriptions")
        bus.gauge("alerts.subscribers", n_subs)

        def push_alert(name: str, fields: dict) -> None:
            if not _alert_match(events, tenant, slo, name, fields):
                return
            body = wire.pack_json({
                "event": name, "sub_id": sub_id,
                "fields": _json_safe(fields),
            })
            frame = wire.pack_frame(wire.ALERT, next(alert_seq), body)
            if self._send(sock, frame):
                bus.inc("alerts.pushed")
            else:
                # Best-effort: a closed/blocked socket drops the alert
                # — the conn loop's teardown unsubscribes shortly.
                bus.inc("alerts.dropped")

        subs.append(bus.subscribe(push_alert))
        logger.info(
            "alert subscription %d registered (events=%s tenant=%s "
            "slo=%s)", sub_id, events or "all", tenant, slo,
        )
        self._send(sock, wire.pack_frame(
            wire.SUBSCRIBE, seq,
            wire.pack_json({"ok": True, "sub_id": sub_id})))

    def _enqueue(self, item) -> bool:
        import queue as queue_mod

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _apply_backpressure(self, sock, bus) -> None:
        """PAUSE the client while the staging depth sits at/above the
        high-water mark; RESUME once drained to low_water. Depth is the
        max of this server's own queue and the engine's
        ``pipeline.staged_depth`` gauge, so wire admission tracks the
        whole pipeline, not just the socket-side buffer."""
        depth = max(self._q.qsize(),
                    bus.gauges.get("pipeline.staged_depth", 0))
        if depth < self.high_water:
            return
        bus.emit("ingest.backpressure_engaged", depth=depth,
                 high_water=self.high_water)
        bus.gauge("ingest.paused", 1)
        with self._state_lock:
            self._bp_paused = True
        self._send(sock, wire.pack_frame(wire.PAUSE, 0))
        try:
            while not self._stop.is_set():
                depth = max(self._q.qsize(),
                            bus.gauges.get("pipeline.staged_depth", 0))
                if depth <= self.low_water:
                    break
                time.sleep(self.pause_poll_s)
        finally:
            bus.gauge("ingest.paused", 0)
            with self._state_lock:
                self._bp_paused = False
                # A legacy-mode POLICY hold (pause_tenant on a single-
                # stream server) must survive a backpressure release:
                # the bare RESUME below would lift it. Tenant-scoped
                # holds ride their own envelopes, so tenant_streams
                # always RESUMEs the wire-level pause.
                resume = self.tenant_streams or not self._tenant_held
            if resume:
                self._send(sock, wire.pack_frame(wire.RESUME, 0))


class TenantRouter:
    """Route N client ingest streams into a multi-tenant engine's
    per-tenant queues — under the ONE ``pipeline.staged_depth`` gauge.

    Each attached :class:`IngestServer` (one port = one client stream)
    gets a drain thread converting its payloads to chunks and
    submitting them to the :class:`~gelly_torch.engine.tenants.
    MultiTenantEngine`; a payload's ``"tenant"`` entry (any 1-element
    integer array the client adds next to ``src``/``dst``) selects the
    tenant, falling back to the server's ``default_tenant``. Unknown
    tenants are auto-admitted into ``tier`` (set ``auto_admit=False``
    to reject them instead — counted as ``ingest.chunks_unroutable``).

    Backpressure composes unchanged: after every submit the router
    publishes the engine's TOTAL queued depth as the
    ``pipeline.staged_depth`` gauge — the same gauge the single-stream
    engine exposes — so every attached server's PAUSE/RESUME admission
    check (``max`` of its own queue and the gauge) tracks the whole
    engine backlog, not just its own socket buffer.

    Delivery semantics are the attached servers' ``auto_ack`` contract
    by default. With ``checkpoint_acks=True`` (servers constructed
    with ``auto_ack=False``), the router registers on the engine's
    ``on_durable`` hooks and fires ``server.ack(pos, tenant=tid)``
    after each tenant's CheckpointManager rotation — checkpoint-gated
    per-tenant acks, the multi-tenant exactly-once wire. Attaching a
    ``tenant_streams=True`` server also seeds each admitted tenant's
    wire position from ``MultiTenantEngine.position`` (the per-tenant
    replay point), and the engine's ``on_qos`` transitions are mapped
    onto wire control (park → PAUSE, un-park → RESUME, shed → NACK).
    """

    def __init__(self, engine, tier: str, *,
                 vertex_capacity: int | None = None,
                 tenant_of=None, auto_admit: bool = True,
                 checkpoint_acks: bool = False):
        self.engine = engine
        self.tier = tier
        self.vertex_capacity = vertex_capacity
        self._tenant_of = tenant_of or (
            lambda t: int(np.asarray(t).reshape(-1)[0])
        )
        self.auto_admit = auto_admit
        # The engine re-publishes the shared gauge as its queues drain:
        # the router alone publishes only on submit, which starves the
        # servers' RESUME poll once a PAUSEd client stops sending.
        engine.publish_staged_gauge = True
        self._stop = threading.Event()
        self._admit_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        # tenant id -> the server its stream rides (checkpoint-gated
        # acks and QoS wire actions are addressed through it).
        self._tenant_server: dict = {}
        self.checkpoint_acks = bool(checkpoint_acks)
        if checkpoint_acks:
            hooks = getattr(engine, "on_durable", None)
            if hooks is None:
                raise ValueError(
                    "checkpoint_acks=True needs an engine exposing "
                    "on_durable hooks (MultiTenantEngine); attach the "
                    "servers with auto_ack=False so acks are gated on "
                    "the per-tenant checkpoint rotation"
                )
            hooks.append(self._on_durable)
        qos_hooks = getattr(engine, "on_qos", None)
        if qos_hooks is not None:
            # QoS ladder transitions map onto wire control: park →
            # PAUSE, un-park → RESUME, shed → typed NACK.
            qos_hooks.append(self._on_qos)

    def attach(self, server: IngestServer,
               default_tenant=None) -> threading.Thread:
        """Start draining ``server`` (already started) into the engine.
        The server's STATS endpoint is wired to the engine's per-tenant
        telemetry (positions, queue depths, backlog ages) unless the
        caller installed its own ``stats_fields``."""
        if server.stats_fields is None and hasattr(self.engine,
                                                   "telemetry"):
            server.stats_fields = (
                lambda: {"tenants": self.engine.telemetry()}
            )
        # One wire ledger per attached server (distinct seq spaces must
        # not collide on one key); drained as frames route (below).
        # Frames staged between server.start() and this attach were
        # ingress-stamped under the DEFAULT key — rekey carries those
        # stamps along so the drain loop's retirement reaches them
        # (left behind, they would read as permanently growing backlog
        # nobody retires). Swap + rekey under the server's state lock,
        # which the conn loop's stamp site also holds: a frame racing
        # this attach either stamps the old key BEFORE the rekey (and
        # moves with it) or sees the new key — never a stranded stamp.
        # Attach before clients start streaming when multiple servers
        # share one bus: the default key cannot tell two unattached
        # servers' seq spaces apart.
        with server._state_lock:
            old_key = server.watermark_stream
            server.watermark_stream = f"wire:{server.port}"
            wmk = obs_bus.get_bus().watermarks
            wmk.rekey(old_key, server.watermark_stream)
            for tid in server._tseq:
                # Per-tenant sub-ledgers move with the base key.
                wmk.rekey(f"{old_key}:t{tid}",
                          f"{server.watermark_stream}:t{tid}")
        if default_tenant is not None:
            with self._admit_lock:
                self._tenant_server[default_tenant] = server
        if getattr(server, "tenant_streams", False):
            # Seed each admitted tenant's wire position from the
            # engine's resume point, so a restarted server re-welcomes
            # every tenant at its durable position (nothing acked is
            # ever re-folded, nothing unacked is skipped).
            tenant_ids = getattr(self.engine, "tenant_ids", None)
            if tenant_ids is not None:
                for tid in tenant_ids():
                    try:
                        server.seed_tenant_seq(
                            tid, self.engine.position(tid))
                    except KeyError:
                        continue
                    with self._admit_lock:
                        self._tenant_server[tid] = server
        t = threading.Thread(
            target=self._drain_loop, args=(server, default_tenant),
            daemon=True, name="gelly-tenant-router",
        )
        self._threads.append(t)
        t.start()
        return t

    def stop(self, timeout: float = 5.0) -> None:
        """Stop routing (does NOT stop the attached servers — stopping
        a server ends its drain thread via the payloads iterator)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def _on_durable(self, tid, position) -> None:
        """Checkpoint-gated wire ack: the engine fires this AFTER the
        tenant's CheckpointManager rotation made ``position`` durable
        (the ``manager.save`` in ``_checkpoint_tier`` /
        ``_execute_parks`` dominates every call), so the ack below can
        never precede its durability point — the multi-tenant half of
        the auto_ack=False exactly-once contract."""
        srv = self._tenant_server.get(tid)
        if srv is None:
            return
        try:
            if srv.tenant_streams:
                srv.ack(position, tenant=tid)  # graphlint: disable=EO001 -- durability dominates across the hook boundary: the engine fires on_durable only after manager.save committed this position
            else:
                srv.ack(position)  # graphlint: disable=EO001 -- durability dominates across the hook boundary: the engine fires on_durable only after manager.save committed this position
        except Exception:  # noqa: BLE001 — acks must never kill the engine
            logger.exception(
                "checkpoint-gated ack failed for tenant %r", tid)

    def _on_qos(self, tid, action: str, info: dict) -> None:
        """Map QoS ladder transitions onto wire control frames."""
        srv = self._tenant_server.get(tid)
        if srv is None:
            return
        try:
            if action == "park":
                srv.pause_tenant(tid)
            elif action == "unpark":
                srv.resume_tenant(tid)
            elif action == "shed":
                srv.shed_tenant(tid,
                                reason=str(info.get("reason", "qos")))
        except Exception:  # noqa: BLE001 — wire control must never kill the engine
            logger.exception(
                "qos wire action %r failed for tenant %r", action, tid)

    def _ensure_admitted(self, tid) -> bool:
        with self._admit_lock:
            try:
                self.engine.position(tid)
                return True  # already admitted
            except KeyError:
                pass
            if not self.auto_admit:
                return False
            try:
                lane = self.engine.admit(tid, self.tier)
            except Exception as e:  # noqa: BLE001
                # AdmissionRefused (QoS ceiling) or an already-queued
                # duplicate: drop the chunk observably, keep draining.
                logger.warning("tenant %r not admitted: %s", tid, e)
                return False
            # lane == -1: queued admission (QoS admission="queue") —
            # the engine admits it once pressure drains; until then
            # its chunks are unroutable.
            return lane >= 0

    def _drain_loop(self, server: IngestServer, default_tenant) -> None:
        bus = obs_bus.get_bus()
        chunk_capacity = self.engine.chunk_capacity(self.tier)
        # Drain at STAGED-UNIT granularity (server.stacks()): a STACKED
        # frame's whole K-chunk payload is submitted in one round, so
        # the engine's chunk-granular queues — and therefore DRR credit
        # accounting — see K chunks, not one frame, while the gauge and
        # ledger retire move once per frame.
        for base_seq, payloads, flags in server.stacks():
            if self._stop.is_set():
                break
            routed_tid = None
            for i, payload in enumerate(payloads):
                seq = base_seq + i
                # Per-payload containment: a malformed payload
                # (out-of-range ids, wrong shapes, a finished tenant)
                # must drop THAT chunk — observably — not kill the
                # drain thread (or the rest of its stack) while the
                # server keeps staging and (auto_ack) ACK-ing frames
                # nobody folds.
                try:
                    wire_tenant = payload.pop("tenant", None)
                    tid = (
                        default_tenant if wire_tenant is None
                        else self._tenant_of(wire_tenant)
                    )
                    if tid is None or not self._ensure_admitted(tid):
                        bus.inc("ingest.chunks_unroutable")
                        logger.warning(
                            "unroutable ingest payload (tenant=%r, no "
                            "default); dropped", wire_tenant,
                        )
                        continue
                    with self._admit_lock:
                        self._tenant_server[tid] = server
                    if flags[i]:
                        # Client-side-compressed payload straight into
                        # the compressed tier's queue: no
                        # payload_to_chunk, no server-side compress —
                        # the engine folds exactly the bytes the
                        # producer shipped (a raw tier refuses it
                        # below, counted invalid).
                        self.engine.submit_payload(tid, payload)
                    else:
                        chunk = payload_to_chunk(
                            payload, chunk_capacity, self.vertex_capacity
                        )
                        self.engine.submit(tid, chunk)
                    routed_tid = tid
                except Exception as e:  # noqa: BLE001
                    bus.inc("ingest.chunks_invalid")
                    logger.warning(
                        "invalid ingest payload seq=%d dropped (%s: %s)",
                        seq, type(e).__name__, e,
                    )
                    continue
            if routed_tid is None:
                continue
            # The one shared gauge: every attached server's admission
            # check reads it, so wire backpressure tracks the WHOLE
            # engine backlog across all N client streams. (The engine's
            # scheduler loop re-publishes it as queues DRAIN —
            # publish_staged_gauge below — so a paused client can't
            # strand the gauge above low_water.) Once per staged unit,
            # not per chunk — the frame is the admission quantum.
            bus.gauge("pipeline.staged_depth", self.engine.queue_depth())
            if obs_bus.telemetry_on():
                # Routed into per-tenant queues: the per-tenant ledger
                # (stamped by engine.submit*) owns the e2e watermark
                # from here; drain this server's wire ledger so it
                # never reads as backlog nobody will retire. Tenant-
                # streams servers stamp under per-tenant sub-keys (the
                # seq is scoped to the tenant) AND enforce single-
                # tenant stacks, so retiring the whole frame range
                # under the last routed tenant's ledger matches every
                # stamp the staging path made for it.
                bus.watermarks.retire_durable(
                    server.wire_ledger(routed_tid),
                    base_seq + len(payloads))


class _ConnClosed(Exception):
    """Internal: the socket closed / the server is stopping."""


def _timeout_recv(sock, stop: threading.Event, idle=None):
    """A ``recv(n)`` that polls the stop event through socket timeouts
    (the accept/conn threads must die with the server, not block in a
    bare recv forever). ``idle`` (optional zero-arg callable) runs on
    each timeout tick — the conn loop uses it to flush batched acks
    while the wire is quiet."""

    def recv(n: int) -> bytes:
        while True:
            if stop.is_set():
                raise _ConnClosed()
            try:
                return sock.recv(n)
            except socket.timeout:
                if idle is not None:
                    idle()
                continue
            except OSError:
                raise _ConnClosed()

    return recv


def _close_quietly(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass
