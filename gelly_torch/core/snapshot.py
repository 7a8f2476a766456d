"""SnapshotStream — per-vertex tumbling-window edge buffers.

Counterpart of ``gelly_tpu/core/snapshot.py`` (the reference's
``SnapshotStream``, produced by ``SimpleEdgeStream.slice``): edges are
grouped by a *group vertex* (the edge source after direction normalization)
into tumbling event/ingestion time windows. Direction handling mirrors
``slice``: ``out`` keys edges by source, ``in`` routes through
``reverse()``, ``all`` through ``undirected()`` so each edge lands in both
endpoints' windows.

This slice ports the window buffers the packed window-triangle count reads
(:meth:`SnapshotStream.host_buffers`). The sorted device views and the
three per-vertex aggregations of the reference come with the windows slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..ops.segments import INT_MAX
from .chunk import EdgeChunk
from .windows import tumbling_window_events


def _assemble_buffer(parts, capacity: int, val_dtype, val_shape=(),
                     sort: bool = True):
    """Host-side window assembly: compact each chunk's valid entries with
    numpy boolean indexing, pack into one padded buffer, and key-sort on
    the host (stable). ``parts`` are chunks with numpy fields.
    ``sort=False`` skips the key sort for consumers whose kernels are
    order-independent (the packed triangle count)."""
    bk = np.full((capacity,), INT_MAX, np.int32)  # padding sorts last
    bn = np.zeros((capacity,), np.int32)
    bv = np.zeros((capacity,) + val_shape, np.dtype(val_dtype))
    bo = np.zeros((capacity,), bool)
    fill = 0
    for c in parts:
        m = c.valid
        k = c.src[m]
        fill2 = fill + k.shape[0]
        bk[fill:fill2] = k
        bn[fill:fill2] = c.dst[m]
        bv[fill:fill2] = c.val[m]
        bo[fill:fill2] = True
        fill = fill2
    if sort:
        order = np.argsort(bk[:fill], kind="stable")
        bk[:fill] = bk[:fill][order]
        bn[:fill] = bn[:fill][order]
        bv[:fill] = bv[:fill][order]
    return bk, bn, bv, bo


class SnapshotStream:
    """The graph-window stream.

    ``window_capacity`` bounds edges per window per stream; overflow raises
    rather than silently dropping.
    """

    def __init__(self, stream, window_ms: int, direction: str = "out",
                 window_capacity: int | None = None,
                 allowed_lateness: int = 0):
        if direction not in ("out", "in", "all"):
            raise ValueError(f"direction must be out/in/all, got {direction}")
        self.stream = stream
        self.window_ms = int(window_ms)
        self.direction = direction
        self.window_capacity = window_capacity
        self.allowed_lateness = int(allowed_lateness)
        self.stats = {"late_edges": 0, "windows_closed": 0}

    def _transformed(self) -> Iterator[EdgeChunk]:
        # Direction normalization per slice().
        for c in self.stream:
            if self.direction == "in":
                yield c.reverse()
            elif self.direction == "all":
                yield c.undirected()
            else:
                yield c

    def host_buffers(self, sort: bool = True) -> Iterator[tuple[int, tuple]]:
        """(window, (key, nbr, val, valid)) per closed window with HOST
        numpy arrays — sorted by key (unless ``sort=False``), padding keys
        = INT_MAX. Consumers bring their own wire format (the packed
        window-triangle path): nothing is copied to a device here."""
        self.stats["late_edges"] = 0
        self.stats["windows_closed"] = 0
        parts: list = []
        fill_host = 0
        cap = self.window_capacity
        for kind, w, chunk, n_valid in tumbling_window_events(
            self._transformed(), self.window_ms, self.stats,
            allowed_lateness=self.allowed_lateness,
        ):
            if kind == "close":
                c0 = parts[0]
                yield w, _assemble_buffer(
                    parts, cap, c0.val.dtype, c0.val.shape[1:], sort=sort
                )
                self.stats["windows_closed"] += 1
                parts = []
                fill_host = 0
                continue
            if cap is None:
                cap = max(4 * chunk.capacity, 1024)
            if fill_host + n_valid > cap:
                raise ValueError(
                    f"window buffer overflow (> {cap} edges in one "
                    f"window); raise window_capacity"
                )
            parts.append(chunk.to_numpy())
            fill_host += n_valid
