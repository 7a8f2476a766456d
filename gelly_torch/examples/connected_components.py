"""Streaming Connected Components (ConnectedComponentsExample.java:49-169).

Usage: python -m gelly_torch.examples.connected_components [--device=DEV]
           [--checkpoint-dir=DIR]
           [--codec-workers=K] [--h2d-depth=D] [--merge-mode=MODE]
           [--trace-out=PATH] [--shards=S]
           [--queries=cc,degrees,bipartiteness]
           [--serve=PORT | --connect=HOST:PORT] [--compressed] [--stats]
           [--auth-token=TOKEN] [--stack=K] [--stack-ms=MS]
           [<edges path> <merge every chunks>]
Prints (vertex, component) pairs after each merge window.

``--stack=K`` (with ``--connect``) coalesces K chunk payloads into one
STACKED wire frame — one header/CRC/recv/fold-dispatch per K chunks
instead of per chunk (README "Ingestion", stacked frames).
``--stack-ms=MS`` bounds how long a partial stack may wait before it
flushes anyway (latency floor for trickling streams); the final
partial tail always drains on flush. Composable with ``--compressed``
(stacks carry either payload kind).

``--auth-token=TOKEN`` (with ``--serve``/``--connect``) arms the wire's
pre-shared-key handshake: the server answers a bare HELLO with an
HMAC-SHA256 challenge and nothing but the handshake crosses an
unauthenticated connection; the client proves the token inside its
re-HELLO. Both sides must pass the same token (README "Multi-tenant
serving", exactly-once multi-tenant wire).

``--stats`` (with ``--serve``) turns on serving-plane telemetry
recording (``gelly_torch.obs``): fold-dispatch / checkpoint-write /
receive→stage latency histograms and the end-to-end backlog-age
watermark populate, and a live ``python -m gelly_torch.obs.status
HOST:PORT`` (or any STATS wire frame) answers mid-stream with the JSON
snapshot — without perturbing the DATA stream (README
"Observability").

``--compressed`` (with ``--serve``/``--connect``) switches the wire to
client-side-compressed DATA_COMPRESSED frames: the connect peer runs
each chunk through the CC sparse codec before send (~0.25 B/edge at
scale instead of 16 B/edge raw pairs) and the serve peer folds the
payloads directly — zero server-side compress spans (README
"Ingestion", shared compression plane). Both sides must pass it.

``--queries=cc,degrees,bipartiteness`` fuses several questions over the
ONE stream (README "Fused multi-query"): each chunk is staged and
transferred once and every named query's fold runs in the same
fused fold — the per-query answers print at end of stream.
Composable with ``--shards`` and ``--trace-out`` (the trace shows one
compress/H2D/fold pipeline feeding one ``multiquery/<name>`` track per
query); the resilient ``--checkpoint-dir`` driver and ``--serve`` are
single-query paths.

``--shards=S`` reads the edge file through S sharded byte-range reader
lanes (``gelly_torch.ingest``): each lane parses AND compresses its own
range on its own thread — no global produce loop (README "Ingestion").
Requires an edge file with identity ids; with ``--trace-out`` the
capture shows one ``compress/gelly-reader_<s>`` track per lane.

``--serve=PORT`` turns this process into the ingestion server: edges
arrive over the wire protocol (length-prefixed CRC-checked frames) from
a ``--connect`` peer, are folded as they stream in, and components
print when the client closes the stream. ``--connect=HOST:PORT``
instead STREAMS the edge file (or the default data) to such a server
and prints the acked frame count. Backpressure (PAUSE/RESUME at the
staged-depth high-water mark) and reconnect-at-acked-seq resume are
exercised for free — see README "Ingestion" for the contract.

``--trace-out=PATH`` installs a span tracer (``gelly_torch.obs``) around
the run and writes a Chrome-trace JSON to PATH afterwards — open it in
Perfetto (ui.perfetto.dev) to see per-unit produce/compress/H2D/fold
spans, window closes, and checkpoints on one timeline (README
"Observability"). Works with both the pipelined-executor path and the
resilient ``--checkpoint-dir`` driver.

``--checkpoint-dir=DIR`` opts into the resilient driver
(``gelly_torch.engine.resilience``): the fold checkpoints into DIR every
merge window, and re-running the same command after a crash resumes from
the newest valid checkpoint instead of refolding from chunk zero.

``--device=DEV`` (default ``cuda``) places the stream, its summaries and
the fold; a CUDA request on a machine without a card raises, never falls
back to the CPU. ``--connect`` is a host-only client: it resolves no
device and creates no CUDA context.

Pipelined-executor knobs (see the README "Pipelined executor" section):
``--codec-workers=K`` sizes the host compress pool, ``--h2d-depth=D``
bounds the in-flight device double buffers (0 = transfer inline), and
``--merge-mode=delta|replicated|auto`` picks the cross-shard window
merge (dirty-delta rows vs full summaries). They configure the
aggregate path only — combining them with ``--checkpoint-dir`` (the
resilient raw-fold driver, which has no codec/H2D pipeline or merge
windows) is an error, not a silent no-op.
"""
import sys

from gelly_torch.core.device import resolve_device
from gelly_torch.examples._util import (
    arg,
    sequence_default_edges,
    split_device,
    stream_from_args,
)
from gelly_torch.library.connected_components import (
    connected_components,
    labels_to_components,
)


def _serve_stream(port, device, vertex_capacity=1 << 16,
                  chunk_capacity=4096, auth_token=None):
    """An EdgeStream fed by the wire: raw-edge payloads from a
    ``--connect`` peer become padded identity chunks."""
    from gelly_torch import EdgeStream, IdentityVertexTable, StreamContext
    from gelly_torch.ingest import IngestServer

    server = IngestServer(port=port, stop_on_bye=True,
                          auth_token=auth_token).start()
    print(f"# ingest server on port {server.port}; waiting for a "
          "--connect peer (stream ends at the client's BYE)")
    ctx = StreamContext(table=IdentityVertexTable(vertex_capacity),
                        vertex_capacity=vertex_capacity, device=device)
    chunks = lambda: server.chunks(chunk_capacity,  # noqa: E731
                                   vertex_capacity=vertex_capacity)
    return EdgeStream(chunks, ctx), server


_WIRE_CAPACITY = 1 << 16
_WIRE_CHUNK = 4096


def _wire_codec_plan():
    # The shared client/server codec of the --compressed wire: both
    # sides must agree on the payload format (sparse (v, root) pairs)
    # for the server to fold the client's bytes directly.
    return connected_components(_WIRE_CAPACITY, codec="sparse")


def _connect_main(target, rest, compressed=False, auth_token=None,
                  stack=None, stack_ms=None):
    """Stream the edge file (or the default data) to a --serve peer.
    With ``--compressed``, each chunk is reduced CLIENT-SIDE to its
    sparse spanning-forest pairs (the plan's ingest codec) and shipped
    as a DATA_COMPRESSED frame — the server folds the payload directly,
    paying zero compress time (README "Ingestion"). With ``--stack=K``
    the client coalesces K payloads per STACKED frame (one
    header/CRC/recv/fold-dispatch each); ``--stack-ms`` caps a partial
    stack's wait. Host only: no device is resolved."""
    import numpy as np

    from gelly_torch.ingest import IngestClient

    host, port = target.rsplit(":", 1)
    if rest:
        from gelly_torch.core.io import read_edge_list

        src, dst, _ = read_edge_list(rest[0])
    else:
        edges = sequence_default_edges()
        src = np.asarray([e[0] for e in edges], dtype=np.int64)
        dst = np.asarray([e[1] for e in edges], dtype=np.int64)
    kw = {}
    if stack is not None:
        kw["stack"] = stack
    if stack_ms is not None:
        kw["stack_ms"] = stack_ms
    cli = IngestClient(host, int(port), auth_token=auth_token,
                       **kw).connect()
    if compressed:
        from gelly_torch.core.chunk import make_chunk

        agg = _wire_codec_plan()
        frames = 0
        for lo in range(0, src.shape[0], _WIRE_CHUNK):
            s, d = src[lo:lo + _WIRE_CHUNK], dst[lo:lo + _WIRE_CHUNK]
            c = make_chunk(
                s.astype(np.int32), d.astype(np.int32),
                raw_src=s, raw_dst=d, capacity=_WIRE_CHUNK,
                device=None,
            )
            cli.send_compressed(agg.host_compress(c))
            frames += 1
        kind = "client-compressed"
    else:
        frames = cli.send_edges(src, dst, chunk_size=_WIRE_CHUNK)
        kind = "raw-edge"
    cli.flush(timeout=60)
    cli.close()  # BYE ends the server's stream
    if stack:
        print(f"# streamed {src.shape[0]} edges: {frames} {kind} "
              f"chunks coalesced into STACKED frames (stack={stack}); "
              f"server acked {cli.acked}")
    else:
        print(f"# streamed {src.shape[0]} edges in {frames} CRC-checked "
              f"{kind} frames; server acked {cli.acked}")


def _serve_compressed_main(port, device, merge_every, trace_out,
                           codec_workers=None, h2d_depth=None,
                           merge_mode="auto", auth_token=None):
    """--serve --compressed: fold CLIENT-compressed payloads straight
    off the wire (``run_aggregation(precompressed=True)``) — a traced
    run shows zero ``compress`` spans on this side. The executor knobs
    (--codec-workers/--h2d-depth/--merge-mode) configure this
    aggregate path exactly like the file-ingest run's."""
    from gelly_torch import IdentityVertexTable, StreamContext
    from gelly_torch.engine.aggregation import run_aggregation
    from gelly_torch.ingest import IngestServer
    from gelly_torch.parallel.mesh import make_mesh

    server = IngestServer(port=port, stop_on_bye=True,
                          auth_token=auth_token).start()
    print(f"# compressed ingest server on port {server.port}; waiting "
          "for a --connect ... --compressed peer (the client compresses; "
          "this side folds the payloads directly)")
    ctx = StreamContext(table=IdentityVertexTable(_WIRE_CAPACITY),
                        vertex_capacity=_WIRE_CAPACITY, device=device)
    agg = connected_components(_WIRE_CAPACITY, codec="sparse",
                               merge_mode=merge_mode)

    def run():
        labels = None
        # The payload iterator carries no device: a one-shard mesh on
        # --device places the fold.
        res = run_aggregation(
            agg, server.compressed_payloads(),
            mesh=make_mesh(1, devices=[device]),
            merge_every=merge_every, precompressed=True,
            codec_workers=codec_workers, h2d_depth=h2d_depth,
        )
        try:
            for labels in res:
                pass  # continuously-improving; print the final
        finally:
            server.stop()
        return labels

    if trace_out is None:
        labels = run()
    else:
        from gelly_torch import obs

        tracer = obs.SpanTracer()
        with obs.scope() as bus, obs.install(tracer):
            labels = run()
        trace = obs.write_chrome_trace(trace_out, tracer, bus=bus)
        n_compress = len(tracer.spans("compress"))
        print(f"# trace: {len(trace['traceEvents'])} events -> "
              f"{trace_out} (server-side compress spans: {n_compress}; "
              f"trace_id={tracer.trace_id})")
    if labels is None:
        print("# stream ended before any payload arrived; nothing to "
              "fold")
        return
    for comp in labels_to_components(labels, ctx):
        print(f"{comp[0]}: {comp}")


def _multiquery_main(stream, names, merge_every, shards, trace_out):
    """Fused multi-query run: every named question answered from ONE
    shared ingest pipeline (one staging pass + one fold dispatch per
    chunk; README "Fused multi-query")."""
    import numpy as np

    from gelly_torch.core.device import to_numpy
    from gelly_torch.library.bipartiteness import bipartiteness_query
    from gelly_torch.library.connected_components import cc_query
    from gelly_torch.library.degrees import degrees_query

    cap = stream.ctx.vertex_capacity
    builders = {
        "cc": lambda: cc_query(cap),
        "degrees": lambda: degrees_query(cap),
        "bipartiteness": lambda: bipartiteness_query(cap),
    }
    unknown = [n for n in names if n not in builders]
    if unknown:
        raise SystemExit(
            f"unknown --queries names {unknown}; supported: "
            f"{sorted(builders)} (the spanner's per-edge gate is a "
            "dedicated example, spanner_example.py)"
        )
    specs = [builders[n]() for n in names]

    def run():
        return stream.aggregate(
            None, queries=specs, merge_every=merge_every,
            source_provider=True if shards is not None else None,
        ).result()

    if trace_out is None:
        final = run()
    else:
        from gelly_torch import obs

        tracer = obs.SpanTracer()
        with obs.scope() as bus, obs.install(tracer):
            final = run()
        trace = obs.write_chrome_trace(trace_out, tracer, bus=bus)
        print(f"# trace: {len(trace['traceEvents'])} events -> "
              f"{trace_out} (one multiquery/<name> track per query; "
              f"trace_id={tracer.trace_id})")
    for n in names:
        if n == "cc":
            for comp in labels_to_components(final["cc"], stream.ctx):
                print(f"cc {comp[0]}: {comp}")
        elif n == "degrees":
            deg = to_numpy(final["degrees"])
            top = np.argsort(deg)[::-1][:5]
            top = top[deg[top] > 0]
            raw = stream.ctx.decode(top)  # slots -> raw vertex ids
            pairs = [(int(r), int(deg[v]))
                     for v, r in zip(top.tolist(), raw.tolist())]
            print(f"degrees top: {pairs}")
        elif n == "bipartiteness":
            ok = bool(to_numpy(final["bipartiteness"].ok))
            print(f"bipartiteness: {'ok' if ok else 'odd cycle found'}")


def main(args):
    # Resolved only after the --connect branch: the client needs no device.
    device, args = split_device(args, resolve=False)
    ckpt_dir = None
    codec_workers = None
    h2d_depth = None
    merge_mode = "auto"
    trace_out = None
    shards = None
    serve = None
    connect = None
    queries = None
    compressed = False
    stats = False
    auth_token = None
    stack = None
    stack_ms = None
    rest = []
    for a in args:
        if a.startswith("--checkpoint-dir="):
            ckpt_dir = a.split("=", 1)[1]
        elif a.startswith("--codec-workers="):
            codec_workers = int(a.split("=", 1)[1])
        elif a.startswith("--h2d-depth="):
            h2d_depth = int(a.split("=", 1)[1])
        elif a.startswith("--merge-mode="):
            merge_mode = a.split("=", 1)[1]
        elif a.startswith("--trace-out="):
            trace_out = a.split("=", 1)[1]
        elif a.startswith("--shards="):
            shards = int(a.split("=", 1)[1])
        elif a.startswith("--queries="):
            queries = [q for q in a.split("=", 1)[1].split(",") if q]
        elif a.startswith("--serve="):
            serve = int(a.split("=", 1)[1])
        elif a.startswith("--connect="):
            connect = a.split("=", 1)[1]
        elif a == "--compressed":
            compressed = True
        elif a == "--stats":
            stats = True
        elif a.startswith("--auth-token="):
            auth_token = a.split("=", 1)[1]
        elif a.startswith("--stack="):
            stack = int(a.split("=", 1)[1])
        elif a.startswith("--stack-ms="):
            stack_ms = float(a.split("=", 1)[1])
        else:
            rest.append(a)
    if ckpt_dir is not None and (
        codec_workers is not None or h2d_depth is not None
        or merge_mode != "auto"
    ):
        raise SystemExit(
            "--codec-workers/--h2d-depth/--merge-mode configure the "
            "pipelined executor (stream.aggregate); --checkpoint-dir runs "
            "the resilient raw-fold driver, which has no codec/H2D "
            "pipeline or merge windows — drop the executor knobs or the "
            "checkpoint dir"
        )
    if sum(x is not None for x in (serve, connect)) > 1:
        raise SystemExit("--serve and --connect are mutually exclusive")
    if compressed and serve is None and connect is None:
        raise SystemExit(
            "--compressed shapes the WIRE (client-side codec payloads "
            "in DATA_COMPRESSED frames); pair it with --serve or "
            "--connect"
        )
    if stats and serve is None:
        raise SystemExit(
            "--stats enables serving-plane telemetry on the ingest "
            "SERVER (histograms + watermarks behind the STATS frame); "
            "pair it with --serve"
        )
    if stats:
        # Recording stays on for the process lifetime: every STATS
        # request (python -m gelly_torch.obs.status HOST:PORT) reads the
        # live histograms/watermarks mid-stream.
        from gelly_torch import obs

        obs.set_recording(True)
        print("# serving-plane telemetry recording ON — query live "
              "stats with: python -m gelly_torch.obs.status "
              f"127.0.0.1:{serve}")
    if auth_token is not None and serve is None and connect is None:
        raise SystemExit(
            "--auth-token arms the wire's pre-shared-key handshake; "
            "pair it with --serve or --connect (both sides must pass "
            "the same token)"
        )
    if (stack is not None or stack_ms is not None) and connect is None:
        raise SystemExit(
            "--stack/--stack-ms configure the CLIENT's frame "
            "coalescing (K payloads per STACKED wire frame); pair "
            "them with --connect"
        )
    if connect is not None:
        return _connect_main(connect, rest, compressed=compressed,
                             auth_token=auth_token, stack=stack,
                             stack_ms=stack_ms)
    device = resolve_device(device)
    if serve is not None and (ckpt_dir is not None or shards is not None):
        raise SystemExit(
            "--serve ingests from the wire — it cannot also read a "
            "sharded file (--shards) or run the checkpoint driver"
        )
    if shards is not None and ckpt_dir is not None:
        raise SystemExit(
            "--shards uses the pipelined executor's sharded source "
            "provider; drop --checkpoint-dir (use aggregate-path "
            "checkpoint_path resume instead)"
        )
    if serve is not None and compressed:
        if queries is not None:
            raise SystemExit(
                "--serve --compressed folds the wire codec's single CC "
                "plan; --queries is the fused raw-chunk path — drop one"
            )
        return _serve_compressed_main(
            serve, device, arg(rest, 1, 4), trace_out,
            codec_workers=codec_workers, h2d_depth=h2d_depth,
            merge_mode=merge_mode, auth_token=auth_token,
        )
    if serve is not None:
        stream, server = _serve_stream(serve, device, auth_token=auth_token)
    elif shards is not None:
        if not rest:
            raise SystemExit("--shards needs an edge file path argument")
        from gelly_torch.ingest import edge_stream_from_sharded_file

        stream = edge_stream_from_sharded_file(
            rest[0], vertex_capacity=1 << 16, shards=shards, device=device,
        )
    else:
        stream = stream_from_args(rest,
                                  default_edges=sequence_default_edges(),
                                  device=device)
    merge_every = arg(rest, 1, 4)
    if queries is not None:
        if ckpt_dir is not None or serve is not None:
            raise SystemExit(
                "--queries runs the fused multi-query executor "
                "(stream.aggregate(queries=[...])); --checkpoint-dir "
                "and --serve are single-query paths — drop them"
            )
        return _multiquery_main(stream, queries, merge_every, shards,
                                trace_out)
    agg = connected_components(stream.ctx.vertex_capacity,
                               merge_mode=merge_mode)

    def run():
        if ckpt_dir is None:
            result = stream.aggregate(
                agg, merge_every=merge_every,
                codec_workers=codec_workers, h2d_depth=h2d_depth,
                source_provider=True if shards is not None else None,
            )
            labels = None
            try:
                for labels in result:
                    pass  # continuously-improving; print the final
            finally:
                if serve is not None:
                    server.stop()
            return labels
        # The resilient driver runs the plan's RAW fold per chunk — no
        # ingest codec / merge windows — which is correct for this dense
        # CC plan but trades the codec path's throughput for directory
        # checkpoints with rotation, CRC validation, and retry. Plans
        # whose fold exists only through their codec (codec="compact")
        # must instead use aggregate(checkpoint_path=..., resume=True).
        from gelly_torch.engine.resilience import (
            ResilienceConfig,
            ResilientRunner,
        )

        runner = ResilientRunner(
            lambda s, c: (agg.fold(s, c), None),
            stream,
            lambda: agg.init(device),
            checkpoint_dir=ckpt_dir,
            config=ResilienceConfig(checkpoint_every_chunks=merge_every),
            stage=lambda c: c.to(device),
            meta={"example": "connected_components"},
        )
        summary = runner.run()
        if runner.stats["resumed_from"] is not None:
            print(f"# resumed from {runner.stats['resumed_from']}")
        return agg.transform(summary)

    if trace_out is None:
        labels = run()
    else:
        from gelly_torch import obs

        tracer = obs.SpanTracer()
        with obs.scope() as bus, obs.install(tracer):
            labels = run()
        trace = obs.write_chrome_trace(trace_out, tracer, bus=bus)
        print(f"# trace: {len(trace['traceEvents'])} events -> {trace_out} "
              f"(open in ui.perfetto.dev; trace_id={tracer.trace_id})")
    for comp in labels_to_components(labels, stream.ctx):
        print(f"{comp[0]}: {comp}")


if __name__ == "__main__":
    main(sys.argv[1:])
