"""EdgeStream — the ``GraphStream`` / ``SimpleEdgeStream`` surface of the port.

Counterpart of ``gelly_tpu/core/stream.py``: the stream context (with
its device), chunk iteration, resume seeks, the transforms (map / filter /
distinct / reverse / undirected / union), the ``aggregate`` plugin
boundary, ``slice`` (tumbling windows), ``build_neighborhood``,
``global_aggregate``, and the vertex, degree and count streams.
Transforms run on the chunks where they are (the sources' are host
chunks); ``distinct(device=True)`` moves them to ``ctx.device``, where its
hash set lives.

Emission contract, as in ``gelly_tpu``: a property stream emits one
:class:`Update` per chunk, holding the latest value of every key the
chunk touched (the reference emits one record per edge; final values are
identical). Stream state lives on ``ctx.device``; each chunk moves there
with only the fields its step reads, and an :class:`Update` stays on the
device until the caller asks for numpy (:meth:`Update.to_pairs`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from ..ops import segments
from ..ops.unionfind import host_sync
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


class Update(NamedTuple):
    """A chunk-grained emission: latest ``values`` for the touched ``slots``
    (lanes where ``valid`` is set)."""

    slots: torch.Tensor  # i32[k] dense vertex slots
    values: torch.Tensor
    valid: torch.Tensor  # bool[k]

    def to_pairs(self, ctx: StreamContext) -> list[tuple[int, object]]:
        m = to_numpy(self.valid).astype(bool)
        ids = ctx.decode(to_numpy(self.slots)[m])
        vals = to_numpy(self.values)[m]
        return list(zip(ids.tolist(), vals.tolist()))


def _both_ends(c: EdgeChunk):
    """``(ids, ok)``: both endpoint columns and their validity."""
    return torch.cat([c.src, c.dst]), torch.cat([c.valid, c.valid])


def _vertices_step(seen: torch.Tensor, c: EdgeChunk):
    ids, ok = _both_ends(c)
    raw = torch.cat([c.raw_src, c.raw_dst])
    first_in_chunk = segments.first_occurrence_mask(ids, ok, seen.shape[0])
    new = first_in_chunk & ~seen[ids]
    return segments.mark_seen(seen, ids, ok), Update(ids, raw, new)


def _edge_count_step(total: torch.Tensor, c: EdgeChunk) -> torch.Tensor:
    delta = torch.where(c.event == 1, -1, 1)
    return total + torch.where(c.valid, delta, 0).sum(dtype=torch.int64)


def _vertex_count_step(seen: torch.Tensor, c: EdgeChunk):
    ids, ok = _both_ends(c)
    seen2 = segments.mark_seen(seen, ids, ok)
    return seen2, seen2.sum(dtype=torch.int64)


def scatter_degrees(deg: torch.Tensor, c: EdgeChunk, count_out: bool = True,
                    count_in: bool = True) -> torch.Tensor:
    """``deg`` (``int64``) plus the chunk's ±1 endpoint contributions in the
    chosen directions: -1 for a deletion event, +1 otherwise."""
    delta = torch.where(c.event == 1, -1, 1).to(torch.int64)
    if count_out:
        deg = segments.masked_scatter_add(deg, c.src, delta, c.valid)
    if count_in:
        deg = segments.masked_scatter_add(deg, c.dst, delta, c.valid)
    return deg


def _degree_step(deg: torch.Tensor, c: EdgeChunk, count_out: bool,
                 count_in: bool):
    deg = scatter_degrees(deg, c, count_out, count_in)
    ids = torch.cat([c.src, c.dst])
    ok = torch.cat([c.valid & count_out, c.valid & count_in])
    touched = segments.first_occurrence_mask(ids, ok, deg.shape[0])
    return deg, Update(ids, deg[ids], touched)


# The chunk fields each step reads: only those move to the device.
_VERTEX_FIELDS = ("src", "dst", "raw_src", "raw_dst", "valid")
_EDGE_COUNT_FIELDS = ("event", "valid")
_VERTEX_COUNT_FIELDS = ("src", "dst", "valid")
DEGREE_FIELDS = ("src", "dst", "event", "valid")


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

    def _mapped(self, fn: Callable[[EdgeChunk], EdgeChunk]) -> "EdgeStream":
        src = self._chunks_fn
        return EdgeStream(lambda: (fn(c) for c in src()), self.ctx)

    def collect_edges(self, raw: bool = True) -> list[tuple]:
        """Drain the stream into a host list of (src, dst, val) tuples."""
        out: list[tuple] = []
        for c in self:
            s, d, v = c.compact_edges(raw=raw)
            out.extend(zip(s.tolist(), d.tolist(), v.tolist()))
        return out

    def map_edges(self, fn) -> "EdgeStream":
        """Vectorized edge-value map: ``fn(raw_src, raw_dst, val) ->
        new_val`` on the chunk's tensors (GraphStream.mapEdges)."""
        return self._mapped(
            lambda c: c._replace(val=fn(c.raw_src, c.raw_dst, c.val)))

    def filter_edges(self, pred) -> "EdgeStream":
        """Keep edges where ``pred(raw_src, raw_dst, val)`` holds; only the
        valid mask changes."""
        return self._mapped(
            lambda c: c.mask(pred(c.raw_src, c.raw_dst, c.val)))

    def filter_vertices(self, pred) -> "EdgeStream":
        """Keep an edge iff both endpoints pass ``pred(raw_id)`` (the
        reference's ApplyVertexFilterToEdges)."""
        return self._mapped(
            lambda c: c.mask(pred(c.raw_src) & pred(c.raw_dst)))

    def reverse(self) -> "EdgeStream":
        return self._mapped(lambda c: c.reverse())

    def undirected(self) -> "EdgeStream":
        return self._mapped(lambda c: c.undirected())

    def union(self, other: "EdgeStream") -> "EdgeStream":
        """Merge two streams over the same context; chunks interleave
        round-robin."""
        if other.ctx is not self.ctx:
            raise ValueError("union requires streams sharing a StreamContext")
        a_fn, b_fn = self._chunks_fn, other._chunks_fn

        def gen():
            a, b = a_fn(), b_fn()
            while True:
                stop_a = stop_b = False
                try:
                    yield next(a)
                except StopIteration:
                    stop_a = True
                try:
                    yield next(b)
                except StopIteration:
                    stop_b = True
                if stop_a and stop_b:
                    return

        return EdgeStream(gen, self.ctx)

    def distinct(self, device: bool | None = None) -> "EdgeStream":
        """Drop duplicate (src, dst) pairs, exact first-wins semantics
        (DistinctEdgeMapper).

        The strategy follows the first chunk's residency (``device=None``):
        host chunks (what the sources yield) get the host dedup — the
        first in-chunk occurrence by ``np.unique``, keys of earlier chunks
        dropped against geometrically merged sorted runs. Device chunks,
        or ``device=True``, keep the state in a
        :class:`~gelly_torch.ops.hashset.DeviceHashSet` on ``ctx.device``
        (the hand kernel ``csrc/hashset.cu`` on CUDA); those chunks come
        out on ``ctx.device``. ``self.hashset`` is the last device run's
        set."""
        from ..ops.hashset import DeviceHashSet

        src_fn = self._chunks_fn
        cap = self.ctx.vertex_capacity
        dev = self.ctx.device
        out = EdgeStream(None, self.ctx)

        def dedup_device(chunks):
            hset = out.hashset = DeviceHashSet(device=dev)
            for c in chunks:
                c = c.to(dev)
                keys = c.src.to(torch.int64) * cap + c.dst.to(torch.int64)
                yield c.mask(hset.insert(keys, c.valid))

        def dedup_host(chunks):
            runs: list[np.ndarray] = []  # disjoint sorted key runs
            for c in chunks:
                src, dst = to_numpy(c.src), to_numpy(c.dst)
                keys = src.astype(np.int64) * np.int64(cap) + dst
                v_idx = np.nonzero(to_numpy(c.valid))[0]
                k = keys[v_idx]
                _, first = np.unique(k, return_index=True)
                new_sub = np.zeros(k.shape, bool)
                new_sub[first] = True
                for run in runs:  # probe only still-new candidates
                    cand = np.nonzero(new_sub)[0]
                    if not cand.size:
                        break
                    q = k[cand]
                    pos = np.minimum(np.searchsorted(run, q), run.size - 1)
                    new_sub[cand[run[pos] == q]] = False
                fresh = np.sort(k[new_sub])
                if fresh.size:
                    runs.append(fresh)
                    # Geometric merging bounds the run count at
                    # O(log |seen|).
                    while (len(runs) >= 2
                           and runs[-2].size <= 2 * runs[-1].size):
                        b, a = runs.pop(), runs.pop()
                        runs.append(np.sort(np.concatenate([a, b])))
                is_new = np.zeros(keys.shape, bool)
                is_new[v_idx[new_sub]] = True
                yield c.mask(torch.from_numpy(is_new).to(c.valid.device))

        def gen():
            it = iter(src_fn())
            c0 = next(it, None)
            if c0 is None:
                return
            chunks = itertools.chain([c0], it)
            use_device = device if device is not None else not c0.is_host()
            yield from (
                dedup_device(chunks) if use_device else dedup_host(chunks))

        out._chunks_fn = gen
        return out

    def global_aggregate(self, update_fn, initial_state,
                         emit_on_change: bool = True):
        """Generic centralized aggregate: ``update_fn(state, chunk) ->
        (state, emission)`` per chunk on ``ctx.device``; each emission is
        yielded as numpy (deduplicated while unchanged)."""
        from ..engine.checkpoint import tree_map

        dev = self.ctx.device

        def gen():
            state = initial_state
            last = object()
            for c in self._chunks_fn():
                state, em = update_fn(state, c.to(dev))
                host = tree_map(to_numpy, em)
                if emit_on_change:
                    key = tree_map(lambda a: a.tobytes(), host)
                    if key == last:
                        continue
                    last = key
                yield host

        return gen()

    def build_neighborhood(self, directed: bool = False,
                           capacity: int | None = None,
                           max_degree: int | None = None):
        """Stream of growing adjacency snapshots (BuildNeighborhoods):
        dense ``bool[N, N]``, or the capped-degree row table with
        ``max_degree``; see :mod:`gelly_torch.core.neighborhood`."""
        from .neighborhood import NeighborhoodStream

        return NeighborhoodStream(self, directed, capacity, max_degree)

    def device_chunks(self, fields) -> Iterator[EdgeChunk]:
        """The chunks with the named ``fields`` moved to ``ctx.device``
        (the others stay on the host): what a step that reads only those
        fields consumes."""
        dev = self.ctx.device
        for c in self._chunks_fn():
            yield c.to_fields(dev, fields)

    def get_vertices(self) -> Iterator[Update]:
        """Stream of first-seen vertices (GraphStream.getVertices): per
        chunk, an Update whose valid lanes are the vertices never seen
        before, each once, with its raw id as the value."""
        n = self.ctx.vertex_capacity

        def gen():
            seen = torch.zeros(n, dtype=torch.bool, device=self.ctx.device)
            for c in self.device_chunks(_VERTEX_FIELDS):
                seen, upd = _vertices_step(seen, c)
                yield upd

        return gen()

    def get_degrees(self) -> "DegreeStream":
        """Continuous (vertex, degree) stream counting both directions
        (SimpleEdgeStream.getDegrees)."""
        return DegreeStream(self, count_out=True, count_in=True)

    def get_out_degrees(self) -> "DegreeStream":
        return DegreeStream(self, count_out=True, count_in=False)

    def get_in_degrees(self) -> "DegreeStream":
        return DegreeStream(self, count_out=False, count_in=True)

    def number_of_edges(self) -> Iterator[int]:
        """Running edge count, one value per chunk (TotalEdgeCountMapper);
        a deletion event counts -1, so the total tracks the live graph.
        Each value is one counted host sync."""

        def gen():
            total = torch.zeros((), dtype=torch.int64, device=self.ctx.device)
            for c in self.device_chunks(_EDGE_COUNT_FIELDS):
                total = _edge_count_step(total, c)
                yield int(host_sync(total))

        return gen()

    def number_of_vertices(self) -> Iterator[int]:
        """Running distinct-vertex count, emitted when it changes
        (globalAggregate with emit-on-change). One counted host sync a
        chunk."""
        n = self.ctx.vertex_capacity

        def gen():
            seen = torch.zeros(n, dtype=torch.bool, device=self.ctx.device)
            last = -1
            for c in self.device_chunks(_VERTEX_COUNT_FIELDS):
                seen, count = _vertex_count_step(seen, c)
                count = int(host_sync(count))
                if count != last:
                    last = count
                    yield count

        return gen()

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
        (SimpleEdgeStream.slice). direction ∈ {out, in, all}.
        ``allowed_lateness`` (ms) buffers out-of-order edges up to that
        bound (``core/windows.py`` watermark semantics)."""
        from .snapshot import SnapshotStream

        return SnapshotStream(self, window_ms, direction, window_capacity,
                              allowed_lateness)


class DegreeStream:
    """Continuous degree stream (the reference's getDegrees family).

    Iterating yields one :class:`Update` per chunk with the new ``int64``
    degrees of every vertex the chunk touched, counted in the chosen
    directions; a deletion event contributes -1.
    """

    def __init__(self, stream: EdgeStream, count_out: bool, count_in: bool):
        self.stream = stream
        self.count_out = count_out
        self.count_in = count_in

    def __iter__(self) -> Iterator[Update]:
        ctx = self.stream.ctx
        deg = torch.zeros(ctx.vertex_capacity, dtype=torch.int64,
                          device=ctx.device)
        for c in self.stream.device_chunks(DEGREE_FIELDS):
            deg, upd = _degree_step(deg, c, self.count_out, self.count_in)
            yield upd

    def final_degrees(self) -> dict[int, int]:
        """Drain the stream; return ``{raw_vertex_id: degree}``."""
        ctx = self.stream.ctx
        result: dict[int, int] = {}
        for upd in self:
            for k, v in upd.to_pairs(ctx):
                result[k] = int(v)
        return result


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
