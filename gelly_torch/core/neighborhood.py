"""NeighborhoodStream — growing adjacency snapshots on the device.

Counterpart of ``gelly_tpu/core/neighborhood.py``
(``SimpleEdgeStream.buildNeighborhood``, ``M/SimpleEdgeStream.java:
531-560``): the reference's per-key ``TreeSet`` adjacency re-emitted after
every edge becomes one snapshot per chunk, either

- a dense ``bool[N, N]`` matrix (``max_degree=None``), updated by a
  scatter, or
- a capped-degree row table (``max_degree=D``: ``nbr`` ``i32[N, D]``,
  ``deg`` ``i32[N]``), filled in stream order with set semantics by
  :func:`~gelly_torch.ops.kernels.row_insert_chunk` (the hand kernel
  ``csrc/row_insert.cu`` on CUDA). An insert past the cap raises.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..ops import kernels
from ..ops.rowtable import put_where_
from ..ops.unionfind import host_sync
from .chunk import EdgeChunk
from .device import to_numpy

_FIELDS = ("src", "dst", "valid")


def _adj_step(adj: torch.Tensor, c: EdgeChunk, directed: bool
              ) -> torch.Tensor:
    """``adj[src, dst] |= valid`` (and ``adj[dst, src]`` undirected), in
    place; an invalid lane writes nothing."""
    n = adj.shape[0]
    flat = adj.view(-1)
    src, dst = c.src.to(torch.int64), c.dst.to(torch.int64)
    on = torch.ones_like(c.valid)
    put_where_(flat, src * n + dst, on, c.valid)
    if not directed:
        put_where_(flat, dst * n + src, on, c.valid)
    return adj


class NeighborhoodStream:
    """Stream of growing adjacency snapshots (the buildNeighborhood
    analog). ``directed=False`` stores both directions of every edge.
    ``capacity`` caps the slot space below the stream's (an edge past it
    raises); ``max_degree`` switches to the capped-degree row table."""

    def __init__(self, stream, directed: bool = False,
                 capacity: int | None = None,
                 max_degree: int | None = None):
        self.stream = stream
        self.directed = directed
        self.capacity = (
            int(capacity) if capacity is not None
            else stream.ctx.vertex_capacity
        )
        self.max_degree = max_degree

    def __iter__(self) -> Iterator:
        """The snapshot after each chunk: ``bool[N, N]``, or ``(nbr,
        deg)``. A snapshot is the live state, written by the next chunk's
        step: copy it to keep it."""
        n = self.capacity
        dev = self.stream.ctx.device
        if self.max_degree is None:
            adj = torch.zeros((n, n), dtype=torch.bool, device=dev)
            for c in self.stream:
                self._check_range(c)
                adj = _adj_step(adj, c.to_fields(dev, _FIELDS),
                                self.directed)
                yield adj
            return
        nbr = torch.full((n, self.max_degree), -1, dtype=torch.int32,
                         device=dev)
        deg = torch.zeros(n, dtype=torch.int32, device=dev)
        over = torch.zeros((), dtype=torch.int32, device=dev)
        for c in self.stream:
            self._check_range(c)
            c = c.to_fields(dev, _FIELDS)
            nbr, deg, over = kernels.row_insert_chunk(
                nbr, deg, over, c.src, c.dst, c.valid, self.directed,
                self.max_degree)
            # Synchronous overflow check: a truncated row must never be
            # observable (one counted host sync a chunk).
            n_over = int(host_sync(over))
            if n_over:
                raise self._overflow_error(n_over)
            yield nbr, deg

    def final_adjacency(self):
        """Drained adjacency, cached so repeated queries (neighbors_of) do
        not re-read the stream."""
        if getattr(self, "_final", None) is None:
            adj = None
            for adj in self:
                pass
            if adj is None:
                dev = self.stream.ctx.device
                if self.max_degree is None:
                    adj = torch.zeros((self.capacity, self.capacity),
                                      dtype=torch.bool, device=dev)
                else:
                    adj = (
                        torch.full((self.capacity, self.max_degree), -1,
                                   dtype=torch.int32, device=dev),
                        torch.zeros(self.capacity, dtype=torch.int32,
                                    device=dev),
                    )
            self._final = adj
        return self._final

    def _overflow_error(self, n: int) -> ValueError:
        return ValueError(
            f"{n} neighbor inserts exceeded max_degree {self.max_degree}; "
            f"raise max_degree or use the dense path"
        )

    def _check_range(self, c: EdgeChunk):
        # Guard against a silent drop when capacity < the stream's space.
        if self.capacity < self.stream.ctx.vertex_capacity:
            m = to_numpy(c.valid)
            hi = max(
                int(to_numpy(c.src)[m].max(initial=0)),
                int(to_numpy(c.dst)[m].max(initial=0)),
            )
            if hi >= self.capacity:
                raise ValueError(
                    f"vertex slot {hi} exceeds neighborhood capacity "
                    f"{self.capacity}"
                )

    def neighbors_of(self, raw_id: int) -> list[int]:
        """Host query: sorted raw neighbor ids in the final adjacency (the
        TreeSet view)."""
        ctx = self.stream.ctx
        adj = self.final_adjacency()  # drains first: the table fills at ingest
        slot = int(ctx.table.lookup(np.array([raw_id]))[0])
        if slot < 0:
            return []
        if self.max_degree is None:
            nbrs = np.nonzero(to_numpy(adj[slot]))[0]
        else:
            nbr, deg = adj
            nbrs = to_numpy(nbr[slot])[: int(deg[slot])]
        return sorted(ctx.decode(nbrs).tolist())
