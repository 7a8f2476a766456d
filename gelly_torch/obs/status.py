"""Live introspection: the STATS snapshot builder + fetch CLI.

A running ingest server answers read-only ``STATS`` wire frames
(``ingest/wire.py`` type 10) mid-stream: the reply payload is the JSON
rendered by :func:`build_stats` — counters, gauges, histogram quantile
snapshots (p50/p90/p99/max per recorded latency distribution),
per-stream/per-tenant backlog-age watermarks, and host identity — so an
operator can ask a live chip "how far behind is tenant 7, and what is
p99 fold dispatch right now?" without attaching a debugger or
perturbing the DATA stream (STATS rides its own connection, or
interleaves on the data connection without touching seq/ack state).

Fetch side::

    python -m gelly_torch.obs.status HOST:PORT

prints the JSON snapshot (``fetch_stats`` is the library form). The
serve side answers automatically; enable histogram/watermark recording
(``--stats`` on the example, or ``obs.bus.set_recording(True)``) so the
distributions actually populate.
"""

from __future__ import annotations

import json
import socket
import sys
import time

from . import bus as obs_bus


def build_stats(bus=None, extra: dict | None = None) -> dict:
    """The STATS reply body: a JSON-ready snapshot of the given (or
    current) bus — counters, gauges, histogram quantiles, watermark
    ledgers — plus host identity and a wall-clock stamp. ``extra``
    merges in server-specific fields (e.g. the tenant engine's
    per-tenant view)."""
    from .heartbeat import host_fields

    bus = bus if bus is not None else obs_bus.get_bus()
    out = bus.snapshot()
    out["host"] = host_fields()
    out["recording"] = obs_bus.recording()
    out["wall_time"] = time.time()
    if extra:
        out.update(extra)
    return out


def fetch_stats(host: str, port: int, timeout: float = 5.0,
                fmt: str = "json"):
    """Ask a live ingest server for its STATS snapshot over a DEDICATED
    connection (the server never adopts a stats-only connection as the
    data stream, so an in-flight DATA stream is untouched). Returns the
    decoded JSON dict, or — with ``fmt="prometheus"`` — the raw
    Prometheus text exposition rendered by
    :func:`gelly_torch.obs.slo.prometheus_text` (a scrape bridge pipes
    this straight into a textfile collector). The wire it speaks comes
    with ROADMAP.md queue 1 item 12b (ingest); until then this raises."""
    try:
        from ..ingest import wire
    except ImportError as e:
        raise NotImplementedError(
            "fetch_stats needs gelly_torch.ingest, which is not ported yet: "
            "ROADMAP.md queue 1 item 12b"
        ) from e

    if fmt not in ("json", "prometheus"):
        raise ValueError(f"fmt must be 'json' or 'prometheus', got {fmt!r}")
    req = b"" if fmt == "json" else wire.pack_json({"format": fmt})
    deadline = time.monotonic() + timeout
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.settimeout(0.2)
        sock.sendall(wire.pack_frame(wire.STATS, 0, req))

        def recv(n: int) -> bytes:
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no STATS reply from {host}:{port} within "
                        f"{timeout}s"
                    )
                try:
                    return sock.recv(n)
                except socket.timeout:
                    continue

        while True:
            ftype, _seq, payload = wire.read_frame(recv)
            if ftype == wire.STATS:
                text = payload.decode("utf-8")
                return text if fmt == "prometheus" else json.loads(text)
            if ftype == wire.BYE:
                raise ConnectionError(
                    f"{host}:{port} closed before answering STATS"
                )
            # Any other control frame on this connection is unexpected
            # but harmless — keep waiting for the reply.


def main(argv) -> int:
    args = list(argv)
    fmt = "json"
    if "--prometheus" in args:
        args.remove("--prometheus")
        fmt = "prometheus"
    if len(args) != 1 or ":" not in args[0]:
        print("usage: python -m gelly_torch.obs.status [--prometheus] "
              "HOST:PORT", file=sys.stderr)
        return 2
    host, port = args[0].rsplit(":", 1)
    try:
        stats = fetch_stats(host, int(port), fmt=fmt)
    except (OSError, TimeoutError, ValueError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if fmt == "prometheus":
        sys.stdout.write(stats)
    else:
        json.dump(stats, sys.stdout, indent=2, sort_keys=True, default=str)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
