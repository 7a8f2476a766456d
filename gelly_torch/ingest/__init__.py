"""``gelly_torch.ingest`` — L0-equivalent sources: sharded file readers
and a network edge-ingestion front end.

The reference gets its source layer for free from Flink
(``StreamExecutionEnvironment.readTextFile`` / ``socketTextStream`` →
``SimpleEdgeStream``, PAPER.md L0/L1). A copy of ``gelly_tpu.ingest``
(the port imports nothing of ``gelly_tpu``; the wire is byte-identical,
so a frame either package packs unpacks in the other). Without it a
stream reads files through ONE produce iterator feeding K compress
workers; this package removes the global produce loop and puts a wire
in front of the engine. Every chunk it builds is a host chunk: the
engine's consumer makes the one copy to the device.

- :mod:`~gelly_torch.ingest.readers` — :class:`ShardedEdgeSource`: an
  edge file split into S record-aligned byte ranges, one reader lane
  per codec worker, each lane parsing + compressing its own range with
  no shared iterator; per-shard seekable resume positions that compose
  with the engine's last-retired-chunk checkpoint rule; and a
  :class:`ShardRoutingTable` giving ``engine/coordination.py`` its
  ingest re-shard hook on permanent host loss.
- :mod:`~gelly_torch.ingest.wire` — the framing layer: length-prefixed
  frames, per-stream sequence numbers, CRC32 per frame (the checkpoint
  CRC discipline applied to the wire), and a dict-of-ndarray payload
  codec carrying the existing ~0.25-byte/edge compressed chunk format.
  ``DATA_COMPRESSED`` frames carry payloads the CLIENT already ran
  through the plan's ingest codec — same seq/CRC/resume/ack semantics
  as ``DATA``, zero server-side compress (the shared compression
  plane's wire leg; consume via ``IngestServer.compressed_payloads``
  + ``run_aggregation(precompressed=True)`` or a compressed tenant
  tier).
- :mod:`~gelly_torch.ingest.server` / :mod:`~gelly_torch.ingest.client` —
  a socket ingestion server with gauge-driven backpressure (PAUSE when
  ``pipeline.staged_depth`` exceeds the high-water mark) and a client
  that survives reconnects by resuming at the acked sequence number.

Everything publishes ``ingest.*`` counters/gauges/spans through
``gelly_torch.obs`` so reader lanes and connections show up as their own
Perfetto tracks.
"""

from .client import IngestClient, edge_payload
from .readers import (
    ShardRoutingTable,
    ShardedEdgeSource,
    byte_ranges,
    edge_stream_from_sharded_file,
    write_binary_edges,
)
from .server import IngestServer, TenantRouter
from .wire import (
    FrameError,
    pack_frame,
    pack_json,
    pack_payload,
    read_frame,
    unpack_json,
    unpack_payload,
)

__all__ = [
    "IngestClient",
    "IngestServer",
    "ShardRoutingTable",
    "ShardedEdgeSource",
    "TenantRouter",
    "FrameError",
    "byte_ranges",
    "edge_payload",
    "edge_stream_from_sharded_file",
    "pack_frame",
    "pack_json",
    "pack_payload",
    "read_frame",
    "unpack_json",
    "unpack_payload",
    "write_binary_edges",
]
