"""EdgeStream — the ``GraphStream`` / ``SimpleEdgeStream`` surface of the port.

Counterpart of ``gelly_tpu/core/stream.py``, the parts the ported paths
run: the stream context (with its device), chunk iteration, resume seeks,
the ``aggregate`` plugin boundary and ``slice`` (tumbling windows). The
transforms and property streams of ``gelly_tpu`` come with later slices.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .chunk import EdgeChunk
from .device import DEFAULT_DEVICE, resolve_device, to_numpy
from .io import EdgeChunkSource, TimeCharacteristic, chunks_from_edges, chunks_from_file
from .vertices import IdentityVertexTable, VertexTable


@dataclasses.dataclass
class StreamContext:
    """Shared per-pipeline context: vertex table, static slot capacity and
    the device every summary of the pipeline lives on.

    ``device`` defaults to CUDA; constructing a context for CUDA on a
    machine without a card raises (pass ``device="cpu"`` to run there).
    """

    table: VertexTable | IdentityVertexTable
    vertex_capacity: int
    device: torch.device | str = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def decode(self, slots) -> np.ndarray:
        return self.table.decode(to_numpy(slots))


class EdgeStream:
    """A stream of host edge chunks bound to a :class:`StreamContext`.

    Iterating yields :class:`EdgeChunk`s on the host; consumers (the
    aggregation engine) move them to ``ctx.device``.
    """

    def __init__(self, chunks_fn: Callable[[], Iterator[EdgeChunk]],
                 ctx: StreamContext, source=None):
        self._chunks_fn = chunks_fn
        self.ctx = ctx
        # The underlying seekable EdgeChunkSource when this stream reads one
        # directly: chunks_from then seeks instead of re-iterating.
        self.source = source

    def __iter__(self) -> Iterator[EdgeChunk]:
        return self._chunks_fn()

    def get_edges(self) -> Iterator[EdgeChunk]:
        """The stream of edge chunks (GraphStream.getEdges)."""
        return iter(self)

    def chunks_from(self, position: int) -> Iterator[EdgeChunk]:
        """Chunk iterator starting at chunk index ``position``: seeks through
        the underlying source when it supports ``iter_from``, otherwise skips
        the prefix by iteration."""
        if position <= 0:
            return self._chunks_fn()
        if self.source is not None and hasattr(self.source, "iter_from"):
            return self.source.iter_from(position)
        return itertools.islice(self._chunks_fn(), position, None)

    def aggregate(self, aggregation, **runner_kw):
        """Run a SummaryAggregation over this stream
        (GraphStream.aggregate). Returns a SummaryStream; see
        :mod:`gelly_torch.engine.aggregation`."""
        from ..engine.aggregation import run_aggregation

        return run_aggregation(aggregation, self, **runner_kw)

    def slice(self, window_ms: int, direction: str = "out",
              window_capacity: int | None = None,
              allowed_lateness: int = 0):
        """Discretize into per-vertex tumbling-window neighborhoods
        (SimpleEdgeStream.slice). direction ∈ {out, in, all}. A nonzero
        ``allowed_lateness`` raises ``NotImplementedError`` when the
        windows are drained (not ported yet)."""
        from .snapshot import SnapshotStream

        return SnapshotStream(self, window_ms, direction, window_capacity,
                              allowed_lateness)


def edge_stream_from_source(source: EdgeChunkSource, vertex_capacity: int,
                            device: torch.device | str = DEFAULT_DEVICE
                            ) -> EdgeStream:
    table = source.table
    # Bind the table's capacity to the summary slot space so overflow
    # raises at ingest instead of silently dropping scatter updates.
    if getattr(table, "capacity", None) is None:
        table.capacity = vertex_capacity
    elif table.capacity > vertex_capacity:
        raise ValueError(
            f"table capacity {table.capacity} exceeds vertex_capacity "
            f"{vertex_capacity}"
        )
    ctx = StreamContext(table=table, vertex_capacity=vertex_capacity,
                        device=device)
    return EdgeStream(lambda: iter(source), ctx, source=source)


def edge_stream_from_edges(
    edges: Iterable[tuple],
    vertex_capacity: int = 1 << 12,
    chunk_size: int = 256,
    time: TimeCharacteristic = TimeCharacteristic.INGESTION,
    timestamps=None,
    ts_fn=None,
    table=None,
    device: torch.device | str = DEFAULT_DEVICE,
) -> EdgeStream:
    src = chunks_from_edges(
        edges, chunk_size=chunk_size, table=table, time=time,
        timestamps=timestamps, ts_fn=ts_fn,
    )
    return edge_stream_from_source(src, vertex_capacity, device=device)


def edge_stream_from_file(
    path: str,
    vertex_capacity: int = 1 << 20,
    chunk_size: int = 4096,
    device: torch.device | str = DEFAULT_DEVICE,
    **kw,
) -> EdgeStream:
    src = chunks_from_file(path, chunk_size=chunk_size, **kw)
    return edge_stream_from_source(src, vertex_capacity, device=device)
