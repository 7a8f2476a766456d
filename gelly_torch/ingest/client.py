"""Ingest client: resumable compressed-chunk streaming over the wire.

The sending half of ``ingest/server.py``'s delivery contract:

- every DATA frame carries the next sequence number and stays in the
  **resend buffer** until the server acks past it (acks follow the
  server's durability point, so the buffer is exactly the chunks a
  server crash could lose);
- a **reconnect** re-handshakes (HELLO → WELCOME) and rewinds to the
  server's expected seq, retransmitting the buffered suffix — the
  client-side half of "a SIGKILLed server restarts without
  double-folding acked chunks";
- **PAUSE/RESUME** frames gate :meth:`send` (gauge-driven
  backpressure); REJECT frames rewind and retransmit in place.
- **Per-tenant sequence spaces** (``tenant_streams=True``): one
  connection multiplexes N tenants, each with its own seq space,
  resend buffer partition, acks, policy holds (a tenant-scoped PAUSE
  from a QoS park blocks only that tenant's sends) and shed state (a
  typed NACK is terminal: further sends for that tenant raise).
  WELCOME carries the per-tenant expected-seq map plus park/pause
  state, so a reconnecting client holds a held stream BEFORE its first
  frame, not at the next backpressure poll.
- **Pre-shared-key auth** (``auth_token=``): the handshake answers the
  server's AUTH_CHALLENGE nonce with an HMAC-SHA256 proof.
- **Adaptive coalescing** (``stack=K`` / ``stack_bytes=`` /
  ``stack_ms=``): payloads buffer client-side and ship as ONE
  ``STACKED`` frame — one header, one CRC, one send syscall, one
  server staging admission per K chunks — flushed when K payloads
  accumulate, the byte ceiling is reached, or the oldest buffered
  payload ages past the deadline (a background
  ``gelly-ingest-client-stack`` thread owns the age flush).
  :meth:`flush` drains the partial tail unconditionally before
  waiting on acks (the batched-ack-tail lesson), and the resend
  buffer holds whole framed stacks: an ack releases a stack only once
  it covers the frame's LAST position, and a reconnect retransmits
  the covering frame whole when the server's expected seq lands
  mid-frame (the server drops the already-durable prefix payloads).
  Stacks never mix tenants — each stream key buffers separately.

- **Wire trace propagation** (tracer-gated, zero-cost when no tracer
  is installed): every DATA/STACKED frame is stamped with a compact
  trace context (``wire.stamp_trace`` — the tracer's trace_id plus the
  client-send span id) riding the payload dict, and a ``client_send``
  span is recorded per frame. The server's recv/staging spans link to
  it, so one exported trace shows client-send → wire → staging → fold
  → checkpoint as one causal chain. Because the stamped frame BYTES
  live in the resend buffer, a retransmitted frame reuses its original
  trace context by construction — a retry is the same causal event,
  never a new trace. All K payloads of a STACKED frame stamp the ONE
  frame-level span allocated when the stack buffer opens.
- **Push alert subscriptions** (:meth:`subscribe`): register a filter
  (event-name prefixes, tenant, SLO name) and the server pushes
  matching EventBus events as ALERT frames — delivered to the
  ``on_alert`` callback and the bounded :attr:`alerts` deque. Delivery
  is BEST-EFFORT and outside the exactly-once data seq space: alert
  seqs are a per-connection counter, never acked, never retransmitted.

A background reader thread (``gelly-ingest-client-rx``) owns every
incoming frame; protocol state is lock-guarded and ack progress is
signalled through a condition variable (:meth:`flush` waits on it).
"""

from __future__ import annotations

import hmac
import logging
import socket
import threading
import time
from typing import Iterable

import numpy as np

from ..engine import faults as faults_mod
from ..obs import bus as obs_bus
from ..obs import tracing as obs_tracing
from . import wire

logger = logging.getLogger("gelly_torch.ingest")


def edge_payload(src, dst) -> dict:
    """The raw-edge DATA payload (``ingest/server.payload_to_chunk``'s
    inverse): one frame per chunk of (src, dst) pairs."""
    return {
        "src": np.asarray(src, dtype=np.int64),
        "dst": np.asarray(dst, dtype=np.int64),
    }


def _send_all(sock, data: bytes, timeout: float) -> None:
    """``sock.sendall`` that waits up to ``timeout`` seconds for the
    server to drain the frame. The socket's own timeout is the reader
    thread's short poll, and ``sendall`` applies it to the whole call, so
    a frame the server takes longer than one poll to read (a frame of
    tens of MiB, a server whose staging queue is full) would fail;
    ``gelly_tpu``'s client fails there."""
    view = memoryview(data)
    deadline = time.monotonic() + timeout
    while view:
        try:
            sent = sock.send(view)
        except socket.timeout:
            if time.monotonic() > deadline:
                raise
            continue
        view = view[sent:]


class IngestError(RuntimeError):
    """Client-side protocol failure (timeout, unresumable state)."""


class IngestClient:
    """One resumable ingest stream to an :class:`IngestServer`.

    ``connect()`` handshakes and starts the reader thread; ``send()``
    frames one payload dict; ``flush()`` blocks until the server has
    acked everything sent; ``reconnect()`` re-handshakes after a server
    restart and retransmits the unacked suffix. Single-sender
    discipline: ``send``/``flush``/``close`` belong to one caller
    thread (the reader thread only ever retransmits under the send
    lock).
    """

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 5.0,
                 send_pause_timeout: float = 30.0,
                 auth_token: str | None = None,
                 tenant_streams: bool = False,
                 stack: int = 1, stack_bytes: int | None = None,
                 stack_ms: float | None = None):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self.send_pause_timeout = send_pause_timeout
        # Pre-shared key for the server's AUTH_CHALLENGE (None = open).
        self.auth_token = auth_token
        # Per-tenant sequence spaces (must match the server's mode).
        self.tenant_streams = bool(tenant_streams)
        # Adaptive coalescing: buffer up to ``stack`` payloads (and at
        # most ``stack_bytes`` of packed payload) per stream key and
        # ship them as ONE STACKED frame; ``stack_ms`` bounds how long
        # the oldest buffered payload may wait before the age thread
        # flushes the partial stack. stack=1 with no deadline disables
        # coalescing entirely (every payload ships as a legacy frame).
        self.stack = int(stack)
        if self.stack < 1 or self.stack > wire.MAX_STACK:
            raise ValueError(
                f"stack must be in 1..{wire.MAX_STACK}, got {stack}"
            )
        self.stack_bytes = None if stack_bytes is None else int(stack_bytes)
        if self.stack_bytes is not None and self.stack_bytes < 1:
            raise ValueError(
                f"stack_bytes must be >= 1, got {stack_bytes}"
            )
        self.stack_ms = None if stack_ms is None else float(stack_ms)
        if self.stack_ms is not None and self.stack_ms <= 0:
            raise ValueError(f"stack_ms must be > 0, got {stack_ms}")
        # stream_key -> [base_seq, [(payload_bytes, compressed), ...],
        # packed_bytes_total, oldest_monotonic] — payloads buffered but
        # not yet framed/sent. Guarded by _lock; drained by the K/byte
        # triggers in send(), the age thread, and flush()'s
        # unconditional tail drain.
        self._stack_buf: dict = {}
        self._stack_evt = threading.Event()  # stops the age thread
        self._stack_thread: threading.Thread | None = None
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        # (stream_key, base_seq) -> (framed bytes, chunk count): the
        # resend buffer at FRAME granularity — a frame covers positions
        # [base_seq, base_seq + count) and is pruned only once an ack
        # covers its LAST position. stream_key None = the legacy single
        # stream; an int = one tenant's seq space (tenant_streams).
        self._unacked: dict = {}
        # Per-stream next seq / acked position, same keying.
        self._next: dict = {None: 0}
        self._ackd: dict = {None: 0}
        # Tenants held by a tenant-scoped PAUSE (QoS park) and streams
        # shed by a typed NACK (key None = the whole legacy stream).
        self._paused_tenants: set = set()
        self._shed: dict = {}
        self._closed = False
        self._rx_error: BaseException | None = None
        # Set = clear to send; PAUSE clears it, RESUME sets it.
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        self._rx_thread: threading.Thread | None = None
        # In-flight STATS request slot: the reader thread parks the
        # reply payload (and its echoed request token) here and sets
        # the event (one request at a time — the single-sender
        # discipline covers stats() too). The token lets stats()
        # reject a straggler reply to an earlier timed-out request.
        self._stats_evt = threading.Event()
        self._stats_payload: bytes | None = None
        self._stats_reply_token = 0
        self._stats_token = 0
        # Push-alert state: SUBSCRIBE confirmations ride the same
        # correlation-token discipline as STATS; received ALERT frames
        # land in the bounded ``alerts`` deque and fan out to the
        # registered handlers (contained — a raising handler must
        # never kill the reader thread).
        from collections import deque

        self._sub_evt = threading.Event()
        self._sub_payload: bytes | None = None
        self._sub_reply_token = 0
        self._sub_token = 0
        self._alert_handlers: list = []
        self.alerts: "deque[dict]" = deque(maxlen=256)

    # ---------------------------------------------------------- lifecycle

    def connect(self) -> "IngestClient":
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        sock.settimeout(0.2)
        with self._lock:
            self._sock = sock
            self._closed = False
            self._rx_error = None
        # Synchronous handshake BEFORE the reader thread exists: the
        # WELCOME tells us where the server wants the stream to resume.
        # Control frames can legitimately interleave (a server already
        # under backpressure PAUSEs before it reads the HELLO) — absorb
        # them here the same way the reader loop would.
        self._raw_send(wire.pack_frame(wire.HELLO, 0))
        recv = _blocking_recv(sock, self.connect_timeout)
        while True:
            ftype, seq, _payload = wire.read_frame(recv)
            if ftype == wire.WELCOME:
                break
            if ftype == wire.AUTH_CHALLENGE:
                if self.auth_token is None:
                    raise IngestError(
                        "server requires a pre-shared auth token — "
                        "construct IngestClient(auth_token=...) with "
                        "the server's key"
                    )
                proof = hmac.new(
                    self.auth_token.encode(), bytes(_payload), "sha256",
                ).hexdigest()
                self._raw_send(wire.pack_frame(
                    wire.HELLO, 0, wire.pack_json({"auth": proof})))
                continue
            if ftype == wire.AUTH_FAIL:
                raise IngestError(
                    "authentication failed (AUTH_FAIL) — wrong or "
                    "missing auth token"
                )
            if ftype == wire.PAUSE:
                self._resume_evt.clear()
            elif ftype == wire.RESUME:
                self._resume_evt.set()
            elif ftype in (wire.ACK, wire.REJECT):
                continue  # stale from a previous connection epoch
            else:
                raise IngestError(
                    f"expected WELCOME during handshake, got frame "
                    f"type {ftype}"
                )
        # The handshake left _resume_evt reflecting THIS connection's
        # backpressure state (a dead connection's teardown always sets
        # it, so no stale PAUSE can leak in from before). WELCOME's
        # control body is authoritative on top of that — apply the
        # pause/park/shed state BEFORE any rewind/replay, so a client
        # reconnecting into a held stream holds IMMEDIATELY instead of
        # blasting frames until the next backpressure poll.
        info = _ctl(_payload)
        if "paused" in info:
            if info["paused"]:
                self._resume_evt.clear()
            else:
                self._resume_evt.set()
        with self._lock:
            self._paused_tenants = {
                int(x) for x in info.get("paused_tenants", ())
            }
            for x in info.get("shed_tenants", ()):
                self._shed.setdefault(int(x), "shed")
        if self.tenant_streams:
            self._rewind_streams({
                int(k): int(v)
                for k, v in info.get("streams", {}).items()
            })
        else:
            self._rewind_to(seq)
        self._rx_thread = threading.Thread(
            target=self._reader_loop, args=(sock,), daemon=True,
            name="gelly-ingest-client-rx",
        )
        self._rx_thread.start()
        if self.stack_ms is not None:
            t = self._stack_thread
            if t is None or not t.is_alive():
                self._stack_evt.clear()
                self._stack_thread = threading.Thread(
                    target=self._stack_age_loop, daemon=True,
                    name="gelly-ingest-client-stack",
                )
                self._stack_thread.start()
        return self

    def reconnect(self) -> "IngestClient":
        """Re-handshake after a dropped connection / server restart and
        retransmit the unacked suffix from the server's expected seq."""
        self._teardown_socket()
        return self.connect()

    def close(self, flush_timeout: float | None = 10.0) -> None:
        """Flush (when a timeout is given), send BYE, stop the reader.
        A flush failure still tears the connection down — the unacked
        frames stay buffered for a later ``reconnect()``."""
        if flush_timeout is not None:
            try:
                self.flush(timeout=flush_timeout)
            except IngestError as e:
                logger.warning("close(): flush incomplete (%s)", e)
        with self._lock:
            sock = self._sock
        if sock is not None:
            try:
                self._raw_send(wire.pack_frame(wire.BYE, 0))
            except IngestError:
                pass
        self._teardown_socket()
        # Stop the age-deadline flusher (restarted by a later
        # connect()): LV401 — the stop event plus a bounded join.
        self._stack_evt.set()
        t = self._stack_thread
        if t is not None:
            t.join(timeout=1.0)

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close(flush_timeout=None)

    # ------------------------------------------------------------ sending

    def send(self, payload: dict, *, compressed: bool = False,
             tenant=None) -> int:
        """Frame + transmit one payload dict; returns its seq. Blocks
        while the server holds the stream PAUSEd (backpressure).
        ``compressed=True`` marks the payload as PRE-COMPRESSED (a
        codec ``host_compress`` output) — it rides the same seq space
        and resend buffer, framed ``DATA_COMPRESSED`` so the server
        admits it with zero server-side compress work.

        In ``tenant_streams`` mode the frame rides the TENANT's seq
        space: pass ``tenant=`` or include a ``"tenant"`` entry in the
        payload. A tenant-scoped PAUSE (QoS park) blocks only that
        tenant's sends; a shed tenant's sends raise."""
        faults_mod.inject("ingest")
        key = None
        if self.tenant_streams:
            wt = payload.get("tenant") if tenant is None else tenant
            if wt is None:
                raise IngestError(
                    "tenant_streams client: pass tenant= or include a "
                    "'tenant' entry in the payload"
                )
            key = int(np.asarray(wt).reshape(-1)[0])
            if "tenant" not in payload:
                payload = dict(payload)
                payload["tenant"] = np.asarray([key], dtype=np.int64)
        if not self._resume_evt.wait(self.send_pause_timeout):
            raise IngestError(
                f"stream PAUSEd longer than {self.send_pause_timeout}s — "
                "is the consumer stalled past the backpressure window?"
            )
        if key is not None:
            self._wait_tenant_flow(key)
        if self._stacking:
            return self._send_stacked(key, payload, compressed)
        ftype = wire.DATA_COMPRESSED if compressed else wire.DATA
        # Wire trace context (tracer-gated; no tracer ⇒ the payload and
        # frame bytes are exactly what they were before this feature).
        # Stamping happens at PACK time, so the stamped bytes live in
        # the resend buffer and a retransmit reuses the original
        # context by construction — a retry is the same causal event.
        tracer = obs_tracing.active_tracer()
        sid = 0
        t_span = 0.0
        with self._lock:
            self._raise_rx_error_locked()
            self._raise_shed_locked(key)
            seq = self._next.setdefault(key, 0)
            if tracer is not None:
                sid = tracer.next_span_id()
                t_span = tracer.now()
                payload = wire.stamp_trace(
                    payload, tracer.trace_id, sid)
            frame = wire.pack_frame(
                ftype, seq, wire.pack_payload(payload)
            )
            self._unacked[(key, seq)] = (frame, 1)
            self._next[key] = seq + 1
        self._raw_send(frame)
        if tracer is not None:
            tracer.span("client_send", "client", t_span, seq=seq,
                        span=sid, trace=tracer.trace_id,
                        bytes=len(frame))
        obs_bus.get_bus().inc("ingest.frames_sent")
        return seq

    @property
    def _stacking(self) -> bool:
        return (self.stack > 1 or self.stack_bytes is not None
                or self.stack_ms is not None)

    def _raise_shed_locked(self, key) -> None:
        if key in self._shed:
            raise IngestError(
                f"stream {'(default)' if key is None else key} was "
                f"shed by the server ({self._shed[key]}); the "
                "folded prefix below the NACK's durable position "
                "is safe — nothing further will be accepted"
            )

    def _send_stacked(self, key, payload: dict,
                      compressed: bool) -> int:
        """Coalescing :meth:`send`: buffer the packed payload under its
        stream key and flush when K payloads accumulate or the byte
        ceiling is hit (the age deadline is the background thread's
        trigger; :meth:`flush` drains any partial tail). Positions are
        assigned AT BUFFER TIME, so the flushed frame's base seq plus
        its payload count exactly tiles the stream's seq space."""
        # Tracer installed ⇒ packing moves INSIDE the lock: the trace
        # context every payload stamps is the FRAME-level client-send
        # span, allocated when its stack buffer opens — and which
        # buffer a payload joins is only decided under the lock. (No
        # tracer ⇒ the pack stays outside the lock, unchanged hot
        # path.)
        tracer = obs_tracing.active_tracer()
        blob = wire.pack_payload(payload) if tracer is None else b""
        flush_reason = None
        while True:
            flush_first = False
            ctx = None
            with self._lock:
                self._raise_rx_error_locked()
                self._raise_shed_locked(key)
                buf = self._stack_buf.get(key)
                if tracer is not None:
                    # All K payloads of one STACKED frame link to the
                    # ONE frame-level span: reuse the open buffer's
                    # context, or allocate afresh for the stack this
                    # payload will open. The flush_first loop re-enters
                    # here, so a payload bumped into a NEW stack by the
                    # byte ceiling is re-stamped with that stack's own
                    # context.
                    if buf is not None and buf[1]:
                        ctx = buf[4]
                    else:
                        ctx = (tracer.next_span_id(), tracer.now())
                    blob = wire.pack_payload(wire.stamp_trace(
                        payload, tracer.trace_id, ctx[0]))
                if buf is not None and buf[1]:
                    # Exact stacked-body bound: count field + one table
                    # entry per payload + the blobs. Appending past
                    # MAX_PAYLOAD would make the eventual pack_stacked
                    # raise with the payloads already popped — ship the
                    # buffered stack FIRST, then buffer this payload.
                    n = len(buf[1]) + 1
                    body = 2 + 5 * n + buf[2] + len(blob)
                    if body > wire.MAX_PAYLOAD:
                        flush_first = True
                if not flush_first:
                    seq = self._next.setdefault(key, 0)
                    self._next[key] = seq + 1
                    if buf is None or not buf[1]:
                        buf = self._stack_buf[key] = [
                            seq, [], 0, time.monotonic(), ctx
                        ]
                    buf[1].append((blob, compressed))
                    buf[2] += len(blob)
                    if len(buf[1]) >= self.stack:
                        flush_reason = "size"
                    elif (self.stack_bytes is not None
                          and buf[2] >= self.stack_bytes):
                        flush_reason = "bytes"
            if not flush_first:
                break
            self._flush_stack(key, reason="bytes")
        if flush_reason is not None:
            self._flush_stack(key, reason=flush_reason)
        return seq

    def _flush_stack(self, key, reason: str | None = None) -> None:
        """Frame + transmit one stream key's buffered stack. A single
        buffered payload ships as a legacy DATA/DATA_COMPRESSED frame
        (K=1 needs no stack table); more ship as ONE STACKED frame
        covering [base, base + K). The send lock is held across
        register-and-send so a racing size-trigger flush and age-
        thread flush cannot invert frame order on the wire."""
        bus = obs_bus.get_bus()
        with self._send_lock:
            with self._lock:
                buf = self._stack_buf.pop(key, None)
                if buf is None or not buf[1] or key in self._shed:
                    return
                base, parts, nbytes, t0, ctx = buf
                if len(parts) == 1:
                    blob, comp = parts[0]
                    ftype = (wire.DATA_COMPRESSED if comp
                             else wire.DATA)
                    frame = wire.pack_frame(ftype, base, blob)
                else:
                    frame = wire.pack_frame(
                        wire.STACKED, base, wire.pack_stacked(parts)
                    )
                self._unacked[(key, base)] = (frame, len(parts))
                sock = self._sock
            if reason == "size":
                bus.inc("ingest.stack_flush_size")
            elif reason == "bytes":
                bus.inc("ingest.stack_flush_bytes")
            elif reason == "age":
                bus.inc("ingest.stack_flush_age")
            if sock is None:
                raise IngestError(
                    "not connected (the stacked frame stays buffered "
                    "for reconnect())"
                )
            try:
                _send_all(sock, frame, self.send_pause_timeout)
            except OSError as e:
                raise IngestError(
                    f"send failed ({e}); reconnect() to resume at the "
                    "acked sequence"
                ) from e
        if ctx is not None:
            tracer = obs_tracing.active_tracer()
            if tracer is not None:
                # ONE frame-level client-send span for the whole stack
                # — every stamped payload named this span id as its
                # parent, so all K link to it in the exported trace.
                tracer.span("client_send", "client", ctx[1], seq=base,
                            stack=len(parts), span=ctx[0],
                            trace=tracer.trace_id, bytes=len(frame))
        bus.inc("ingest.frames_sent")

    def _drain_stack_tails(self) -> None:
        """Unconditionally flush every stream key's partial stack (the
        LV203 contract: the size/byte/age triggers are all threshold-
        guarded, so :meth:`flush`/:meth:`close` must drain the tail
        without one). Shed keys are skipped — the server would only
        NACK the frames."""
        with self._lock:
            due = [k for k, buf in self._stack_buf.items()
                   if buf[1] and k not in self._shed]
        for key in due:
            self._flush_stack(key)

    def _stack_age_loop(self) -> None:
        """Age-deadline flusher (``gelly-ingest-client-stack``): wakes
        a few times per deadline and ships any stack whose OLDEST
        payload has waited past ``stack_ms``. Paused/held/shed streams
        are skipped — their stacks simply age until flow resumes (or
        :meth:`flush` drains them). Send failures are swallowed: the
        frame is already registered unacked, so reconnect replays
        it."""
        deadline = self.stack_ms / 1000.0
        tick = max(0.001, deadline / 4)
        while not self._stack_evt.wait(tick):
            now = time.monotonic()
            with self._lock:
                due = [k for k, buf in self._stack_buf.items()
                       if buf[1] and now - buf[3] >= deadline
                       and k not in self._shed
                       and k not in self._paused_tenants]
            if not due or not self._resume_evt.is_set():
                continue
            for key in due:
                try:
                    self._flush_stack(key, reason="age")
                except IngestError:
                    pass  # disconnected: the frame rides the resend buffer

    def _wait_tenant_flow(self, key: int) -> None:
        """Block while ``key``'s stream is held by a tenant-scoped
        PAUSE (QoS park). A shed notice or reader death unblocks (the
        locked checks in :meth:`send` raise the right error)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: (key not in self._paused_tenants
                         or key in self._shed
                         or self._rx_error is not None),
                timeout=self.send_pause_timeout,
            )
            if not ok:
                raise IngestError(
                    f"tenant {key} held (PAUSEd) longer than "
                    f"{self.send_pause_timeout}s — parked by QoS while "
                    "its backlog drains?"
                )

    def send_compressed(self, payload: dict) -> int:
        """:meth:`send` with ``compressed=True`` — the client-side leg
        of the shared compression plane: compress once here (the
        plan's ``host_compress``), and the server/engine fold the
        payload directly."""
        return self.send(payload, compressed=True)

    def send_edges(self, src, dst, chunk_size: int = 4096) -> int:
        """Chunk raw (src, dst) arrays into DATA frames; returns the
        number of frames sent."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        n = 0
        for lo in range(0, src.shape[0], chunk_size):
            self.send(edge_payload(src[lo:lo + chunk_size],
                                   dst[lo:lo + chunk_size]))
            n += 1
        return n

    def send_payloads(self, payloads: Iterable[dict]) -> int:
        n = 0
        for p in payloads:
            self.send(p)
            n += 1
        return n

    def stats(self, timeout: float = 5.0) -> dict:
        """Ask the server for its live STATS snapshot ON THE DATA
        CONNECTION — interleaves with DATA frames without touching the
        stream's seq/ack state (the server answers mid-stream). Returns
        the decoded JSON dict; for a stats read that must not share the
        data socket, use :func:`gelly_torch.obs.status.fetch_stats`.

        The request carries a correlation token in the frame's seq
        field (STATS seqs are never stream state; the server echoes
        them back), so a straggler reply to an EARLIER timed-out
        request can never satisfy this one with a stale snapshot."""
        import json

        with self._lock:
            self._stats_token += 1
            token = self._stats_token
        self._stats_evt.clear()
        self._raw_send(wire.pack_frame(wire.STATS, token))
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._stats_evt.wait(remaining):
                with self._lock:
                    self._raise_rx_error_locked()
                raise IngestError(f"no STATS reply within {timeout}s")
            with self._lock:
                if self._stats_reply_token == token:
                    payload = self._stats_payload
                    break
                # A stale straggler (or a legacy seq-0 reply) — keep
                # waiting for OUR token until the deadline.
                self._stats_evt.clear()
        return json.loads(payload.decode("utf-8"))

    def subscribe(self, *, events=("alerts.", "slo."), tenant=None,
                  slo: str | None = None, on_alert=None,
                  timeout: float = 5.0) -> int:
        """Register a push-alert subscription on the data connection:
        the server pushes every EventBus event matching the filter as
        an ALERT frame (decoded dicts land in :attr:`alerts` and fan
        out to ``on_alert(alert)`` when given). Filter semantics:
        ``events`` — exact names or dotted prefixes (``"alerts."``
        matches the whole family); ``tenant`` — only events whose
        fields name that tenant (events carrying NO tenant field still
        match — a global breach concerns every subscriber); ``slo`` —
        only SLO events for that spec name. Returns the server's
        subscription id.

        Delivery is BEST-EFFORT, explicitly outside the exactly-once
        data plane: alert seqs are a per-connection counter, never
        acked, never retransmitted — a dropped alert bumps the
        server's ``alerts.dropped`` and is gone. Poll :meth:`stats`
        for the lossless view. The request rides a correlation token
        in the seq field (echoed on the confirmation), same straggler
        discipline as :meth:`stats`."""
        import json

        flt: dict = {"events": [str(e) for e in events]}
        if tenant is not None:
            flt["tenant"] = int(tenant)
        if slo is not None:
            flt["slo"] = str(slo)
        with self._lock:
            if on_alert is not None:
                self._alert_handlers.append(on_alert)
            self._sub_token += 1
            token = self._sub_token
        self._sub_evt.clear()
        self._raw_send(wire.pack_frame(
            wire.SUBSCRIBE, token, wire.pack_json(flt)))
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._sub_evt.wait(remaining):
                with self._lock:
                    self._raise_rx_error_locked()
                raise IngestError(
                    f"no SUBSCRIBE confirmation within {timeout}s")
            with self._lock:
                if self._sub_reply_token == token:
                    payload = self._sub_payload
                    break
                # A stale straggler — keep waiting for OUR token.
                self._sub_evt.clear()
        info = json.loads(payload.decode("utf-8"))
        if not info.get("ok"):
            raise IngestError(f"server refused subscription: {info}")
        return int(info.get("sub_id", 0))

    def flush(self, timeout: float = 30.0) -> int:
        """Wait until the server has acked every sent frame (every
        NON-SHED stream in tenant mode: a shed tenant's tail will
        never be acked and must not hang the flush); returns the acked
        seq (summed across tenants in tenant mode).
        :class:`IngestError` on timeout.

        With coalescing on, any PARTIAL stacks drain first —
        unconditionally, no size/byte/age threshold — so a flush can
        never hang waiting on acks for payloads still sitting in the
        client's own buffer."""
        if self._stacking:
            self._drain_stack_tails()
        with self._cv:
            ok = self._cv.wait_for(self._flush_done_locked,
                                   timeout=timeout)
            self._raise_rx_error_locked()
            if not ok:
                raise IngestError(
                    f"flush timed out with {len(self._unacked)} frame(s) "
                    "unacked"
                )
            return self._acked_locked()

    def _flush_done_locked(self) -> bool:
        if self._rx_error is not None:
            return True
        for key, n in list(self._next.items()):
            if key in self._shed:
                continue
            if self._ackd.get(key, 0) < n:
                return False
        return True

    def _acked_locked(self) -> int:
        if self.tenant_streams:
            return sum(v for k, v in list(self._ackd.items())
                       if k is not None)
        return self._ackd.get(None, 0)

    @property
    def acked(self) -> int:
        with self._lock:
            return self._acked_locked()

    def acked_for(self, tenant) -> int:
        """One tenant's acked wire position (tenant_streams mode)."""
        with self._lock:
            return self._ackd.get(int(tenant), 0)

    def tenant_paused(self, tenant) -> bool:
        """True while the tenant's stream is held by a tenant-scoped
        PAUSE (QoS park)."""
        with self._lock:
            return int(tenant) in self._paused_tenants

    @property
    def shed_tenants(self) -> dict:
        """``{stream_key: reason}`` for streams the server shed (key
        None = the legacy single stream)."""
        with self._lock:
            return dict(self._shed)

    @property
    def unacked_count(self) -> int:
        with self._lock:
            return len(self._unacked)

    @property
    def paused(self) -> bool:
        return not self._resume_evt.is_set()

    # ------------------------------------------------------------ plumbing

    def _raw_send(self, frame: bytes) -> None:
        with self._lock:
            sock = self._sock
        if sock is None:
            raise IngestError("not connected")
        try:
            with self._send_lock:
                _send_all(sock, frame, self.send_pause_timeout)
        except OSError as e:
            raise IngestError(
                f"send failed ({e}); reconnect() to resume at the acked "
                "sequence"
            ) from e

    def _rewind_to(self, server_next: int) -> None:
        """Align the legacy single stream with the server's expected
        seq after a (re)connect: prune frames the server already
        staged, retransmit the rest. Pruning is FRAME-granular: a
        stacked frame is released only when ``server_next`` covers its
        LAST position — an expected seq landing MID-frame (the
        checkpoint position fell inside a stack) keeps the covering
        frame, which is retransmitted whole and whose already-durable
        prefix payloads the server drops on admission."""
        with self._lock:
            if server_next > self._next.get(None, 0):
                raise IngestError(
                    f"server expects seq {server_next} but only "
                    f"{self._next.get(None, 0)} frames were ever sent — "
                    "wrong server / stream?"
                )
            if server_next < self._ackd.get(None, 0):
                raise IngestError(
                    f"server rewound below the acked position "
                    f"({server_next} < {self._ackd.get(None, 0)}) — "
                    "acked state was lost; refusing to guess at "
                    "consistency"
                )
            self._ackd[None] = server_next
            for k in [k for k, v in self._unacked.items()
                      if k[0] is None and k[1] + v[1] <= server_next]:
                del self._unacked[k]
            replay = [self._unacked[k][0] for k in sorted(
                (k for k in self._unacked if k[0] is None),
                key=lambda k: k[1])]
            self._cv.notify_all()
        for frame in replay:
            self._raw_send(frame)
        if replay:
            obs_bus.get_bus().inc("ingest.frames_resent", len(replay))

    def _rewind_tenant(self, tid: int, server_next: int) -> None:
        """Per-tenant :meth:`_rewind_to` (tenant_streams mode): align
        one tenant's seq space with the server's expected position and
        retransmit its buffered suffix (never for a shed stream — the
        server would only NACK the replay)."""
        with self._lock:
            if server_next > self._next.get(tid, 0):
                raise IngestError(
                    f"server expects seq {server_next} for tenant {tid} "
                    f"but only {self._next.get(tid, 0)} frames were "
                    "ever sent — wrong server / stream?"
                )
            if server_next < self._ackd.get(tid, 0):
                raise IngestError(
                    f"server rewound tenant {tid} below the acked "
                    f"position ({server_next} < {self._ackd.get(tid, 0)})"
                    " — acked state was lost; refusing to guess at "
                    "consistency"
                )
            self._ackd[tid] = server_next
            # Frame-granular pruning, same mid-frame rule as the
            # legacy rewind: a stack is released only once covered to
            # its LAST position; a straddled stack replays whole.
            for k in [k for k, v in self._unacked.items()
                      if k[0] == tid and k[1] + v[1] <= server_next]:
                del self._unacked[k]
            replay = [] if tid in self._shed else [
                self._unacked[k][0] for k in sorted(
                    (k for k in self._unacked if k[0] == tid),
                    key=lambda k: k[1])
            ]
            self._cv.notify_all()
        for frame in replay:
            self._raw_send(frame)
        if replay:
            obs_bus.get_bus().inc("ingest.frames_resent", len(replay))

    def _rewind_streams(self, server_streams: dict) -> None:
        """Tenant-mode (re)connect alignment: rewind every tenant seen
        locally OR named in WELCOME's per-tenant expected-seq map. A
        tenant the server has no record of rewinds to 0 (full replay);
        a server position below our acked state raises — same
        consistency refusal as the single-stream path."""
        with self._lock:
            tids = {k[0] for k in self._unacked if k[0] is not None}
            tids.update(k for k in self._next if k is not None)
            tids.update(server_streams)
        for tid in sorted(tids):
            self._rewind_tenant(tid, server_streams.get(tid, 0))

    def _retransmit_all(self) -> None:
        """Server-requested resync (a CRC-failed frame in tenant mode
        has no attributable stream, so no single expect can be named):
        retransmit EVERY buffered frame of every non-shed stream.
        Duplicates are dropped + re-acked server-side, so over-sending
        is always safe; deleting here never is."""
        with self._lock:
            replay = [self._unacked[k][0] for k in sorted(
                (k for k in self._unacked if k[0] not in self._shed),
                key=lambda k: (str(k[0]), k[1]))
            ]
        for frame in replay:
            self._raw_send(frame)
        if replay:
            obs_bus.get_bus().inc("ingest.frames_resent", len(replay))

    def _reader_loop(self, sock) -> None:
        bus = obs_bus.get_bus()
        recv = _poll_recv(sock, lambda: self._closed)
        try:
            while True:
                try:
                    ftype, seq, _payload = wire.read_frame(recv)
                except (wire.FrameError, _SocketGone):
                    return
                if ftype == wire.ACK:
                    ctl = _ctl(_payload)
                    scope = ctl.get("tenant")
                    key = None if scope is None else int(scope)
                    with self._lock:
                        if seq > self._ackd.get(key, 0):
                            self._ackd[key] = seq
                        # Frame-granular release: a stacked frame
                        # leaves the resend buffer only once the ack
                        # covers its LAST position [base + count).
                        for k in [k for k, v in self._unacked.items()
                                  if k[0] == key and k[1] + v[1] <= seq]:
                            del self._unacked[k]
                        self._cv.notify_all()
                elif ftype == wire.PAUSE:
                    bus.inc("ingest.pauses_received")
                    ctl = _ctl(_payload)
                    scope = ctl.get("tenant")
                    if scope is not None:
                        # Tenant-scoped flow stop (QoS park): only that
                        # stream's senders hold; others keep flowing.
                        with self._lock:
                            self._paused_tenants.add(int(scope))
                            self._cv.notify_all()
                    else:
                        self._resume_evt.clear()
                elif ftype == wire.RESUME:
                    ctl = _ctl(_payload)
                    scope = ctl.get("tenant")
                    if scope is not None:
                        with self._lock:
                            self._paused_tenants.discard(int(scope))
                            self._cv.notify_all()
                    else:
                        self._resume_evt.set()
                elif ftype == wire.REJECT:
                    # Server refused a frame (CRC / gap): rewind to its
                    # expected seq and retransmit in place. A tenant-mode
                    # CRC failure has no attributable stream, so the
                    # server asks for a full resync instead of naming an
                    # expected seq.
                    bus.inc("ingest.rejects_received")
                    ctl = _ctl(_payload)
                    try:
                        if ctl.get("resync"):
                            self._retransmit_all()
                        elif ctl.get("tenant") is not None:
                            self._rewind_tenant(int(ctl["tenant"]), seq)
                        else:
                            self._rewind_to(seq)
                    except IngestError as e:
                        with self._lock:
                            self._rx_error = e
                            self._cv.notify_all()
                        return
                elif ftype == wire.NACK:
                    # Terminal stream refusal (QoS shed): seq is the
                    # tenant's durable position — below it is folded,
                    # at/above it is dropped and will never be acked.
                    bus.inc("ingest.nacks_received")
                    ctl = _ctl(_payload)
                    scope = ctl.get("tenant")
                    key = None if scope is None else int(scope)
                    reason = str(ctl.get("reason", "shed"))
                    with self._lock:
                        self._shed[key] = reason
                        if key is not None:
                            self._paused_tenants.discard(key)
                        self._cv.notify_all()
                    logger.warning(
                        "ingest stream shed by server (tenant=%s, "
                        "reason=%s, durable=%d)", scope, reason, seq,
                    )
                elif ftype == wire.AUTH_FAIL:
                    with self._lock:
                        self._rx_error = IngestError(
                            "server refused authentication (AUTH_FAIL)"
                        )
                        self._cv.notify_all()
                    return
                elif ftype == wire.STATS:
                    with self._lock:
                        self._stats_payload = _payload
                        self._stats_reply_token = seq
                    self._stats_evt.set()
                elif ftype == wire.SUBSCRIBE:
                    # Server confirmation of a subscribe() request —
                    # seq echoes our correlation token.
                    with self._lock:
                        self._sub_payload = _payload
                        self._sub_reply_token = seq
                    self._sub_evt.set()
                elif ftype == wire.ALERT:
                    # Best-effort push: record + fan out, contained —
                    # a raising handler must never kill the reader
                    # (the ACK/flow-control branches below depend on
                    # this thread staying alive).
                    bus.inc("ingest.alerts_received")
                    alert = _ctl(_payload)
                    self.alerts.append(alert)
                    with self._lock:
                        handlers = list(self._alert_handlers)
                    for fn in handlers:
                        try:
                            fn(alert)
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "alert handler failed on %r",
                                alert.get("event"))
                elif ftype == wire.BYE:
                    return
        finally:
            # Never leave the sender parked on a PAUSE that can no
            # longer be lifted by this (dead) connection.
            self._resume_evt.set()
            with self._lock:
                self._paused_tenants.clear()
                self._cv.notify_all()

    def _raise_rx_error_locked(self) -> None:
        if self._rx_error is not None:
            raise IngestError(
                f"reader thread failed: {self._rx_error}"
            ) from self._rx_error

    def _teardown_socket(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            self._closed = True
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        t = self._rx_thread
        if t is not None:
            t.join(timeout=1.0)
        with self._lock:
            self._closed = False


class _SocketGone(Exception):
    pass


def _ctl(payload: bytes) -> dict:
    """Decode an optional control-JSON envelope on a server frame.
    Legacy servers send empty payloads on ACK/PAUSE/RESUME/REJECT;
    malformed JSON degrades to the unscoped (legacy) interpretation
    rather than killing the reader."""
    if not payload:
        return {}
    try:
        return wire.unpack_json(payload)
    except wire.FrameError:
        return {}


def _blocking_recv(sock, timeout: float):
    """recv(n) with an overall deadline — handshake use."""
    import time

    deadline = time.monotonic() + timeout

    def recv(n: int) -> bytes:
        while True:
            if time.monotonic() > deadline:
                raise IngestError("handshake timed out")
            try:
                return sock.recv(n)
            except socket.timeout:
                continue
            except OSError:
                raise _SocketGone()

    return recv


def _poll_recv(sock, closed) -> "callable":
    def recv(n: int) -> bytes:
        while True:
            if closed():
                raise _SocketGone()
            try:
                return sock.recv(n)
            except socket.timeout:
                continue
            except OSError:
                raise _SocketGone()

    return recv
