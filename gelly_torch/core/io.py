"""Edge-list ingestion: file/array sources producing padded EdgeChunks.

Counterpart of ``gelly_tpu/core/io.py``: :func:`read_edge_list` tries the
native text parser (``utils/native.parse_edge_list_file``, built with g++
from ``native/edgelist_parser.cc``) first and falls back to the numpy
parser when it raises, as ``gelly_tpu``'s does. Sources are plain Python
iterators of host :class:`~gelly_torch.core.chunk.EdgeChunk`; the engine
moves each chunk to the stream's device.
"""

from __future__ import annotations

import enum
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from .chunk import EdgeChunk, make_chunk
from .vertices import IdentityVertexTable, VertexTable

DEFAULT_CHUNK_SIZE = 4096


class TimeCharacteristic(enum.Enum):
    """SimpleEdgeStream ctor #1 → INGESTION, ctor #2 → EVENT."""

    INGESTION = "ingestion"
    EVENT = "event"


def parse_edge_list_text(
    text: str,
    comment_prefixes: Sequence[str] = ("%", "#"),
    delimiter: str | None = None,
    num_value_cols: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Parse an edge-list string into (src, dst, vals?) numpy arrays.

    Lines starting with any of ``comment_prefixes`` (after strip) are skipped;
    fields split on ``delimiter`` (None = any whitespace). Malformed lines
    are skipped; a missing value column defaults to 1.0.
    """
    srcs: list[int] = []
    dsts: list[int] = []
    vals: list[float] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or any(line.startswith(p) for p in comment_prefixes):
            continue
        fields = line.split(delimiter) if delimiter else line.split()
        try:
            s, d = int(fields[0]), int(fields[1])
        except (ValueError, IndexError):
            continue
        srcs.append(s)
        dsts.append(d)
        if num_value_cols:
            try:
                vals.append(float(fields[2]))
            except (ValueError, IndexError):
                vals.append(1.0)
    src = np.asarray(srcs, dtype=np.int64)
    dst = np.asarray(dsts, dtype=np.int64)
    val = np.asarray(vals, dtype=np.float64) if num_value_cols else None
    return src, dst, val


def read_edge_list(
    path: str,
    comment_prefixes: Sequence[str] = ("%", "#"),
    delimiter: str | None = None,
    num_value_cols: int = 0,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Read a whole edge-list file into numpy arrays (host): the native
    parser when ``use_native`` and the fields split on whitespace, else
    (or when the native parse raises) :func:`parse_edge_list_text`."""
    if use_native and delimiter is None:
        try:
            from ..utils.native import parse_edge_list_file

            if num_value_cols:
                return parse_edge_list_file(path, want_vals=True)
            return (*parse_edge_list_file(path), None)
        except Exception:
            pass  # fall back to the numpy parser
    with open(path) as f:
        return parse_edge_list_text(
            f.read(), comment_prefixes, delimiter, num_value_cols
        )


class EdgeChunkSource:
    """Iterator of host EdgeChunks over host edge arrays, with densification.

    - ``time`` = INGESTION: timestamps are the global arrival index.
    - ``time`` = EVENT: ``timestamps`` (or ``ts_fn(src_raw, dst_raw, val)``)
      supplies event time, assumed ascending.

    Yielded chunks are zero-copy views of the input arrays where the dtype
    already fits: callers must not mutate ``src_raw``/``dst_raw``/``val``
    while chunks may still be in flight.
    """

    def __init__(
        self,
        src_raw: np.ndarray,
        dst_raw: np.ndarray,
        val: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
        events: np.ndarray | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        table: VertexTable | IdentityVertexTable | None = None,
        time: TimeCharacteristic = TimeCharacteristic.INGESTION,
        ts_fn: Callable | None = None,
        val_dtype=np.float32,
    ):
        self.src_raw = np.asarray(src_raw)
        self.dst_raw = np.asarray(dst_raw)
        self.val = None if val is None else np.asarray(val)
        self.events = None if events is None else np.asarray(events, np.int8)
        self.chunk_size = int(chunk_size)
        self.table = table if table is not None else VertexTable()
        self.time = time
        self.val_dtype = val_dtype
        n = self.src_raw.shape[0]
        if time is TimeCharacteristic.EVENT:
            if timestamps is not None:
                self.timestamps = np.asarray(timestamps, np.int64)
            elif ts_fn is not None:
                self.timestamps = np.asarray(
                    ts_fn(self.src_raw, self.dst_raw, self.val), np.int64
                )
            else:
                raise ValueError("EVENT time requires timestamps or ts_fn")
        else:
            self.timestamps = np.arange(n, dtype=np.int64)
        # Edge index the stateful table has been warmed through: a seek at
        # or below it re-encodes nothing (see iter_from).
        self._encoded_upto = 0

    @property
    def num_edges(self) -> int:
        return int(self.src_raw.shape[0])

    @property
    def num_chunks(self) -> int:
        return -(-self.num_edges // self.chunk_size)

    def __iter__(self) -> Iterator[EdgeChunk]:
        return self.iter_from(0)

    def iter_from(self, chunk_index: int) -> Iterator[EdgeChunk]:
        """Chunk iterator starting at ``chunk_index``.

        A stateful :class:`VertexTable` assigns slots in first-seen stream
        order, so the skipped prefix is still ENCODED (same per-chunk
        src-then-dst order as a from-zero run) to warm the table, unless
        this source already encoded it. Identity tables seek in O(1).
        """
        if chunk_index < 0:
            raise ValueError(f"chunk_index must be >= 0, got {chunk_index}")
        return self._iter_impl(chunk_index)

    def _iter_impl(self, chunk_index: int) -> Iterator[EdgeChunk]:
        n = self.num_edges
        cs = self.chunk_size
        start = min(chunk_index * cs, n)
        src_all = dst_all = None
        if isinstance(self.table, IdentityVertexTable):
            # Stateless: encode the whole stream once so per-chunk src/dst
            # are zero-copy views.
            src_all = self.table.encode(self.src_raw)
            dst_all = self.table.encode(self.dst_raw)
        else:
            for lo in range(min(self._encoded_upto, start), start, cs):
                hi = min(lo + cs, n)
                self.table.encode(self.src_raw[lo:hi])
                self.table.encode(self.dst_raw[lo:hi])
            if start > self._encoded_upto:
                self._encoded_upto = start
        for lo in range(start, n, cs):
            hi = min(lo + cs, n)
            if src_all is not None:
                src = src_all[lo:hi]
                dst = dst_all[lo:hi]
            else:
                src = self.table.encode(self.src_raw[lo:hi])
                dst = self.table.encode(self.dst_raw[lo:hi])
                if hi > self._encoded_upto:
                    self._encoded_upto = hi
            yield make_chunk(
                src,
                dst,
                raw_src=self.src_raw[lo:hi],
                raw_dst=self.dst_raw[lo:hi],
                val=None if self.val is None else self.val[lo:hi],
                ts=self.timestamps[lo:hi],
                event=None if self.events is None else self.events[lo:hi],
                capacity=cs,
                val_dtype=self.val_dtype,
                device=None,  # host chunk: the engine stages it
            )


def chunks_from_file(
    path: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    table: VertexTable | IdentityVertexTable | None = None,
    num_value_cols: int = 0,
    time: TimeCharacteristic = TimeCharacteristic.INGESTION,
    ts_fn: Callable | None = None,
    **kw,
) -> EdgeChunkSource:
    src, dst, val = read_edge_list(path, num_value_cols=num_value_cols, **kw)
    return EdgeChunkSource(
        src, dst, val, chunk_size=chunk_size, table=table, time=time, ts_fn=ts_fn
    )


def chunks_from_edges(
    edges: Iterable[tuple],
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    table: VertexTable | IdentityVertexTable | None = None,
    time: TimeCharacteristic = TimeCharacteristic.INGESTION,
    timestamps: np.ndarray | None = None,
    ts_fn: Callable | None = None,
) -> EdgeChunkSource:
    """Source from (src, dst[, val]) tuples — the tests' fixture entry point."""
    rows = list(edges)
    if not rows:
        return EdgeChunkSource(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            chunk_size=chunk_size, table=table,
        )
    src = np.asarray([r[0] for r in rows], dtype=np.int64)
    dst = np.asarray([r[1] for r in rows], dtype=np.int64)
    val = (
        np.asarray([r[2] for r in rows], dtype=np.float64)
        if len(rows[0]) > 2
        else None
    )
    return EdgeChunkSource(
        src, dst, val, chunk_size=chunk_size, table=table, time=time,
        timestamps=timestamps, ts_fn=ts_fn,
    )
