"""The ingest wire format: length-prefixed, CRC-checked frames.

One frame carries one compressed chunk payload (or a control message).
The payload body is a self-describing dict-of-ndarrays codec — exactly
the pytrees the ingest codecs already produce (e.g. the sparse CC
codec's counted ``{"v": i32[k], "r": i32[k]}`` pairs at ~0.25
bytes/edge after chunk combining), so the wire carries the SAME bytes
the H2D leg would, and the server can hand frames straight to the fold
without re-compressing.

Frame layout (network byte order)::

    magic  u16   0x4749 ("GI")
    type   u8    HELLO/WELCOME/DATA/ACK/REJECT/PAUSE/RESUME/BYE/
                 DATA_COMPRESSED/STATS/NACK/AUTH_CHALLENGE/AUTH_FAIL/
                 STACKED/SUBSCRIBE/ALERT
    flags  u8    reserved (0)
    seq    u64   per-stream sequence number (DATA/DATA_COMPRESSED: the
                 chunk position; STACKED: the FIRST stacked payload's
                 chunk position — the frame covers [seq, seq + K);
                 ACK/REJECT/WELCOME: the position being acknowledged /
                 expected)
    len    u32   payload byte length
    crc    u32   zlib.crc32 of the payload bytes

The CRC discipline is the checkpoint layer's (``engine/checkpoint.py``
v2: validate-before-use, loud rejection): a receiver computes the CRC
over the received payload and REJECTS the frame on mismatch — it never
advances its expected sequence number past bytes it could not verify.
A torn frame (socket closed mid-frame) surfaces as
:class:`TruncatedFrame` and ends the connection; the acked-sequence
resume makes the tear harmless.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

MAGIC = 0x4749  # "GI"
_HEADER = struct.Struct(">HBBQII")
HEADER_BYTES = _HEADER.size

# Frame types.
HELLO = 1    # client -> server: open/resume a stream
WELCOME = 2  # server -> client: carries the server's next expected seq
DATA = 3     # client -> server: one raw-edge chunk payload
ACK = 4      # server -> client: every seq < value is durably folded
REJECT = 5   # server -> client: frame refused; value = expected seq
PAUSE = 6    # server -> client: backpressure — stop sending
RESUME = 7   # server -> client: backpressure released
BYE = 8      # either side: orderly close
# One CLIENT-SIDE-COMPRESSED chunk payload (a codec host_compress
# output — e.g. the sparse CC pairs at ~0.25 B/edge): rides the same
# per-stream seq space, CRC discipline, duplicate/gap handling, resume
# and ack semantics as DATA, but the server admits it straight into
# staging — zero server-side compress work for bytes the producer
# already reduced (the shared compression plane's wire leg).
DATA_COMPRESSED = 9
# Read-only live introspection (the serving-plane telemetry endpoint):
# a client sends STATS with an empty payload, the server replies with a
# STATS frame whose payload is UTF-8 JSON (obs/status.build_stats —
# counters, gauges, histogram quantiles, per-tenant backlog watermarks,
# host identity). STATS never carries stream data: it is answerable
# MID-STREAM, rides the same CRC discipline, and touches neither the
# expected sequence nor the ack state — on a dedicated connection the
# server does not even adopt it as the data connection.
STATS = 10
# Typed stream refusal (server -> client): the tenant's stream was
# CLOSED by policy (QoS shed). seq carries the tenant's durable
# position — everything below it is folded and safe; everything at or
# above it was dropped and will NOT be acked. Payload is control JSON
# ``{"tenant": ..., "reason": ...}``. Unlike REJECT (a per-frame
# refusal that invites a rewind-and-resend), NACK is terminal for the
# stream: the client must stop sending for that tenant and surface the
# refusal to its producer.
NACK = 11
# Pre-shared-key handshake (server -> client): the server demands an
# HMAC proof before adopting the connection. Payload = an opaque nonce;
# the client re-HELLOs with ``{"auth": hex(HMAC-SHA256(token, nonce))}``
# in its payload. Sent only by servers constructed with auth_token=.
AUTH_CHALLENGE = 12
# Authentication failed (server -> client): missing/bad proof, or a
# non-handshake frame before authentication. Terminal — the server
# closes the connection after sending it.
AUTH_FAIL = 13
# One frame carrying K chunk payloads (client -> server): the stack
# body is a count, a per-payload (kind, length) table, and the K
# concatenated ``pack_payload`` blobs — so ONE 20-byte header, ONE
# CRC32 (the frame header's, over the whole packed stack), ONE
# send/recv pair and ONE staging admission cover K chunks. The frame's
# seq is the FIRST payload's stream position; the frame covers
# positions ``[seq, seq + K)`` on the ordinary seq-space discipline:
# a torn stack stages nothing (TruncatedFrame ends the connection), a
# CRC-corrupt stack is REJECTed whole and retransmitted whole, a
# duplicate stack (seq + K <= expected) is dropped and re-acked, and a
# stack STRADDLING the expected position (seq <= expected < seq + K —
# the mid-frame checkpoint-resume case) is admitted with its already-
# durable prefix payloads dropped. Each payload's kind byte marks it
# raw (DATA semantics) or pre-compressed (DATA_COMPRESSED semantics).
STACKED = 14
# Push-alert registration (client -> server): the payload is a JSON
# filter — ``{"events": [name-or-prefix, ...], "tenant": int|null,
# "slo": str|null}`` — selecting which EventBus events this connection
# wants pushed as ALERT frames (component merges, degree spikes, SLO
# breaches). The request's seq is a client-side correlation token
# (never stream state) echoed on the server's SUBSCRIBE confirmation
# reply (``{"ok": true, "sub_id": n}``), same discipline as STATS.
SUBSCRIBE = 15
# Push alert (server -> client): one matched EventBus event, payload
# ``{"event": name, "fields": {...}}``. Delivery is BEST-EFFORT and
# explicitly OUTSIDE the exactly-once data plane: the frame's seq is a
# per-connection alert counter (never a stream position), alerts are
# never buffered for retransmission, never acked, and a send failure
# only bumps ``alerts.dropped`` — a client that needs a lossless view
# polls STATS; alerts are the low-latency nudge, not the ledger.
ALERT = 16

FRAME_TYPES = (HELLO, WELCOME, DATA, ACK, REJECT, PAUSE, RESUME, BYE,
               DATA_COMPRESSED, STATS, NACK, AUTH_CHALLENGE, AUTH_FAIL,
               STACKED, SUBSCRIBE, ALERT)

# Bound on a single payload (64 MiB): a length prefix beyond it is
# treated as a corrupt header, not an allocation request.
MAX_PAYLOAD = 64 << 20


class FrameError(ValueError):
    """The frame failed validation (bad magic/type/length/CRC)."""


class CrcMismatch(FrameError):
    """Payload bytes do not match the header CRC — corrupt in flight."""


class TruncatedFrame(FrameError):
    """The stream ended mid-frame (torn write / dropped connection)."""


def pack_frame(ftype: int, seq: int, payload: bytes = b"") -> bytes:
    """Serialize one frame; CRC computed over the payload bytes."""
    if ftype not in FRAME_TYPES:
        raise FrameError(f"unknown frame type {ftype}")
    if len(payload) > MAX_PAYLOAD:
        raise FrameError(
            f"payload of {len(payload)} bytes exceeds MAX_PAYLOAD "
            f"({MAX_PAYLOAD})"
        )
    return _HEADER.pack(
        MAGIC, ftype, 0, seq, len(payload), zlib.crc32(payload)
    ) + payload


def unpack_header(buf: bytes) -> tuple[int, int, int, int]:
    """Parse a header; returns (type, seq, length, crc)."""
    if len(buf) < HEADER_BYTES:
        raise TruncatedFrame(
            f"{len(buf)} header bytes of {HEADER_BYTES}"
        )
    magic, ftype, _flags, seq, length, crc = _HEADER.unpack(
        buf[:HEADER_BYTES]
    )
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#06x}")
    if ftype not in FRAME_TYPES:
        raise FrameError(f"unknown frame type {ftype}")
    if length > MAX_PAYLOAD:
        raise FrameError(
            f"declared payload length {length} exceeds MAX_PAYLOAD"
        )
    return ftype, seq, length, crc


def read_frame(recv) -> tuple[int, int, bytes]:
    """Read one frame off ``recv(n) -> bytes`` (a socket-recv-like
    callable). Returns ``(type, seq, payload)``; the payload CRC is
    verified here — :class:`CrcMismatch` on corruption,
    :class:`TruncatedFrame` on a stream that ends mid-frame, and a
    clean EOF (zero bytes at a frame boundary) returns ``(BYE, 0,
    b"")``.
    """
    ftype, seq, payload, ok = read_frame_checked(recv)
    if not ok:
        raise CrcMismatch(
            f"frame seq={seq}: payload CRC mismatch — corrupt in flight"
        )
    return ftype, seq, payload


def read_frame_checked(recv) -> tuple[int, int, bytes, bool]:
    """Like :func:`read_frame` but reports a CRC mismatch as ``ok =
    False`` instead of raising — the receiver then still KNOWS the
    frame's claimed seq (the bytes were consumed off the stream either
    way) and can send a targeted REJECT so the sender retransmits.
    Truncation and malformed headers still raise: past those the
    stream has no trustworthy frame boundary left."""
    head = _read_exact(recv, HEADER_BYTES, allow_eof=True)
    if head is None:
        return BYE, 0, b"", True
    ftype, seq, length, crc = unpack_header(head)
    payload = b""
    if length:
        payload = _read_exact(recv, length, allow_eof=False)
    return ftype, seq, payload, zlib.crc32(payload) == crc


def _read_exact(recv, n: int, allow_eof: bool):
    parts = []
    got = 0
    while got < n:
        b = recv(n - got)
        if not b:
            if allow_eof and got == 0:
                return None
            raise TruncatedFrame(f"stream ended after {got} of {n} bytes")
        parts.append(b)
        got += len(b)
    return b"".join(parts)


# --------------------------------------------------------------------- #
# payload codec: dict[str, np.ndarray] <-> bytes

_PAYLOAD_HEAD = struct.Struct(">H")
_ARR_HEAD = struct.Struct(">B")


def pack_payload(payload: dict) -> bytes:
    """Serialize a dict of numpy arrays (sorted key order, so equal
    dicts produce identical bytes and hence identical CRCs)."""
    out = [_PAYLOAD_HEAD.pack(len(payload))]
    for key in sorted(payload):
        arr = np.ascontiguousarray(payload[key])
        kb = key.encode()
        dt = arr.dtype.str.encode()  # e.g. b"<i4" — endianness explicit
        out.append(_ARR_HEAD.pack(len(kb)))
        out.append(kb)
        out.append(_ARR_HEAD.pack(len(dt)))
        out.append(dt)
        out.append(_ARR_HEAD.pack(arr.ndim))
        out.append(struct.pack(f">{arr.ndim}Q", *arr.shape))
        out.append(struct.pack(">Q", arr.nbytes))
        out.append(arr.tobytes())
    return b"".join(out)


def unpack_payload(buf: bytes) -> dict:
    """Inverse of :func:`pack_payload`; :class:`FrameError` on any
    structural inconsistency (the CRC already vouched for the bytes —
    this guards against a malformed SENDER, not corruption)."""
    view = memoryview(buf)
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(view):
            raise FrameError("payload body shorter than its structure")
        out = view[pos:pos + n]
        pos += n
        return out

    (count,) = _PAYLOAD_HEAD.unpack(take(_PAYLOAD_HEAD.size))
    out: dict = {}
    for _ in range(count):
        (klen,) = _ARR_HEAD.unpack(take(1))
        key = bytes(take(klen)).decode()
        (dlen,) = _ARR_HEAD.unpack(take(1))
        dtype = np.dtype(bytes(take(dlen)).decode())
        (ndim,) = _ARR_HEAD.unpack(take(1))
        shape = struct.unpack(f">{ndim}Q", take(8 * ndim))
        (nbytes,) = struct.unpack(">Q", take(8))
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes != want:
            raise FrameError(
                f"array {key!r}: {nbytes} bytes declared but shape "
                f"{shape} x {dtype} needs {want}"
            )
        out[key] = np.frombuffer(take(nbytes), dtype=dtype).reshape(shape)
    if pos != len(view):
        raise FrameError(
            f"{len(view) - pos} trailing bytes after the last array"
        )
    return out


# --------------------------------------------------------------------- #
# wire trace context: a compact (trace_id, parent span id) pair riding
# the self-describing payload dict

# The reserved payload key the context rides under. It is an ordinary
# payload array (u64[2] = [trace_id, span_id]), so the frame format is
# UNCHANGED — legacy receivers that never pop it would just see one
# extra array, and legacy senders' frames (no such key) remain valid.
# Receivers must pop_trace() BEFORE handing the payload to a chunk
# builder or codec (the key is transport metadata, not stream data).
TRACE_KEY = "_trace"


def stamp_trace(payload: dict, trace_id_hex: str, span_id: int) -> dict:
    """Return a COPY of ``payload`` carrying the wire trace context
    (the caller's dict is never mutated — it may be a caller-owned
    template). ``trace_id_hex`` is the tracer's 16-hex-char id;
    ``span_id`` is the sending span the receiver's spans parent on."""
    out = dict(payload)
    out[TRACE_KEY] = np.array(
        [int(trace_id_hex, 16), int(span_id)], dtype=np.uint64
    )
    return out


def pop_trace(data: dict) -> tuple[str, int] | None:
    """Remove and decode the wire trace context from an unpacked
    payload dict (in place). Returns ``(trace_id_hex, parent_span_id)``
    or None when the sender stamped nothing (legacy frames) or the
    entry is malformed — a bad stamp must never reject a CRC-valid
    data frame, so malformed decodes degrade to unlinked, silently."""
    arr = data.pop(TRACE_KEY, None)
    if arr is None:
        return None
    try:
        flat = np.asarray(arr, dtype=np.uint64).reshape(-1)
        if flat.shape[0] != 2:
            return None
        return format(int(flat[0]), "016x"), int(flat[1])
    except (TypeError, ValueError, OverflowError):
        return None


# --------------------------------------------------------------------- #
# stacked-frame body codec: K (kind, payload-bytes) entries <-> bytes

_STACK_HEAD = struct.Struct(">H")
_STACK_ENTRY = struct.Struct(">BI")

# Payload kind bytes in the stack's per-payload table.
STACK_RAW = 0         # DATA semantics (raw-edge payload)
STACK_COMPRESSED = 1  # DATA_COMPRESSED semantics (codec payload)

# Bound on payloads per stack: a u16 count field, and a frame is
# bounded by MAX_PAYLOAD anyway — a count beyond this is a malformed
# sender, not an allocation request.
MAX_STACK = (1 << 16) - 1


def pack_stacked(parts) -> bytes:
    """Serialize a STACKED frame body from ``[(payload_bytes,
    compressed), ...]`` — each element an already-``pack_payload``-ed
    blob plus its kind flag. The caller wraps the result in
    ``pack_frame(STACKED, base_seq, body)``: the frame-level CRC is the
    ONLY integrity check for the whole stack (no per-payload CRCs —
    that is the point)."""
    n = len(parts)
    if not 1 <= n <= MAX_STACK:
        raise FrameError(f"stack of {n} payloads (must be 1..{MAX_STACK})")
    out = [_STACK_HEAD.pack(n)]
    blobs = []
    for blob, compressed in parts:
        out.append(_STACK_ENTRY.pack(
            STACK_COMPRESSED if compressed else STACK_RAW, len(blob)
        ))
        blobs.append(blob)
    out.extend(blobs)
    body = b"".join(out)
    if len(body) > MAX_PAYLOAD:
        raise FrameError(
            f"stacked body of {len(body)} bytes exceeds MAX_PAYLOAD "
            f"({MAX_PAYLOAD}) — lower stack= / stack_bytes="
        )
    return body


def unpack_stacked(buf) -> list:
    """Inverse of :func:`pack_stacked`: returns ``[(payload_bytes,
    compressed), ...]``. :class:`FrameError` on any structural
    inconsistency (the frame CRC already vouched for the bytes — this
    guards against a malformed sender). The per-payload blobs still
    need :func:`unpack_payload`."""
    view = memoryview(buf)
    if len(view) < _STACK_HEAD.size:
        raise FrameError("stacked body shorter than its count field")
    (n,) = _STACK_HEAD.unpack(view[:_STACK_HEAD.size])
    if n < 1:
        raise FrameError("stacked frame with zero payloads")
    pos = _STACK_HEAD.size
    table = []
    for _ in range(n):
        if pos + _STACK_ENTRY.size > len(view):
            raise FrameError("stacked table shorter than its count")
        kind, length = _STACK_ENTRY.unpack(view[pos:pos + _STACK_ENTRY.size])
        if kind not in (STACK_RAW, STACK_COMPRESSED):
            raise FrameError(f"unknown stack payload kind {kind}")
        table.append((kind, length))
        pos += _STACK_ENTRY.size
    out = []
    for kind, length in table:
        if pos + length > len(view):
            raise FrameError(
                "stacked payload table overruns the frame body"
            )
        out.append((bytes(view[pos:pos + length]),
                    kind == STACK_COMPRESSED))
        pos += length
    if pos != len(view):
        raise FrameError(
            f"{len(view) - pos} trailing bytes after the last stacked "
            "payload"
        )
    return out


def pack_json(obj: dict) -> bytes:
    """Serialize a control-frame JSON payload (WELCOME's per-tenant
    state, tenant-scoped ACK/PAUSE/RESUME/NACK envelopes, HELLO auth
    proofs). Sorted keys + compact separators: equal dicts produce
    identical bytes, hence identical CRCs — the same determinism
    discipline as :func:`pack_payload`."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def unpack_json(buf: bytes) -> dict:
    """Inverse of :func:`pack_json`; :class:`FrameError` on malformed
    or non-object JSON (the CRC already vouched for the bytes — this
    guards against a malformed sender)."""
    try:
        obj = json.loads(bytes(buf).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise FrameError(f"bad control JSON payload: {e}") from e
    if not isinstance(obj, dict):
        raise FrameError(
            f"control JSON payload must be an object, got "
            f"{type(obj).__name__}"
        )
    return obj
