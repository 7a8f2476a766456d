"""Mesh-sharded snapshot windows — the keyed window operator at scale.

Counterpart of ``gelly_tpu/parallel/sharded_window.py``: the mesh form of
:class:`~gelly_torch.core.snapshot.SnapshotStream`, the reference's
distributed keyed window operator (``slice().keyBy(NeighborKeySelector)``,
``M/SimpleEdgeStream.java:157-158``, feeding ``M/SnapshotStream.java:61-120``):

- each chunk splits evenly across the shards;
- the vertex-hash exchange
  (:func:`~gelly_torch.parallel.partition.repartition_by_key`) delivers
  every edge to the shard owning its group vertex, so a vertex's whole
  window neighbourhood sits on one shard;
- each shard appends what it received to its own window buffer, and at
  the close sorts once by group vertex and aggregates over its runs.

Exchange or buffer overflow is counted and raised, never silent.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch

from ..core.chunk import EdgeChunk
from ..core.snapshot import (
    NeighborhoodView,
    WindowUpdate,
    _segmented_scan,
    fold_view,
)
from ..core.windows import tumbling_window_events
from ..ops import segments
from . import mesh as mesh_lib, partition


class _Buffer:
    """One shard's window buffer: the received entries appended at
    ``fill`` (each append writes a whole exchange block, invalid tail
    included, and advances ``fill`` by the valid count)."""

    def __init__(self, cap: int, val_dtype, val_shape, device):
        self.key = torch.full((cap,), segments.INT_MAX, dtype=torch.int32,
                              device=device)
        self.nbr = torch.zeros(cap, dtype=torch.int32, device=device)
        self.val = torch.zeros((cap,) + tuple(val_shape), dtype=val_dtype,
                               device=device)
        self.valid = torch.zeros(cap, dtype=torch.bool, device=device)
        self.fill = 0
        self.clamped = False


class ShardedSnapshotStream:
    """Mesh-parallel ``SnapshotStream``: the same aggregation surface over
    the keyed exchange and per-shard window buffers.

    ``window_capacity`` is a sizing hint: each shard's buffer holds
    ``window_capacity / S * bucket_slack`` plus one exchange block. An
    exchange drop or a buffer overflow on any shard raises at the
    window's close.
    """

    def __init__(self, stream, window_ms: int, direction: str = "out",
                 window_capacity: int | None = None, mesh=None,
                 bucket_slack: float = 2.0, allowed_lateness: int = 0):
        if direction not in ("out", "in", "all"):
            raise ValueError(f"direction must be out/in/all, got {direction}")
        self.stream = stream
        self.window_ms = int(window_ms)
        self.direction = direction
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.S = mesh_lib.num_shards(self.mesh)
        self.bucket_slack = bucket_slack
        self.window_capacity = window_capacity
        self.allowed_lateness = int(allowed_lateness)
        partition.slots_per_shard(stream.ctx.vertex_capacity, self.S)
        self.stats = {"late_edges": 0, "windows_closed": 0, "dropped": 0}

    def _transformed(self) -> Iterator[EdgeChunk]:
        for c in self.stream:
            if self.direction == "in":
                yield c.reverse()
            elif self.direction == "all":
                yield c.undirected()
            else:
                yield c

    def _plan(self, chunk_cap: int):
        S = self.S
        local_in = -(-chunk_cap // S)
        bucket = partition.default_bucket_capacity(
            local_in, S, self.bucket_slack)
        block = S * bucket  # received entries an exchange
        wc = self.window_capacity or max(4 * chunk_cap, 1024)
        cap_local = int(-(-wc * self.bucket_slack // S)) + block
        return bucket, block, cap_local

    def _append(self, bufs: list, chunk: EdgeChunk, bucket: int,
                block: int, cap_local: int) -> int:
        """Route one chunk to the owners and append; returns the global
        drop count of the exchange (a tensor)."""
        S = self.S
        parts = [p.to_fields(dev, ("src", "dst", "val", "valid"))
                 for p, dev in zip(partition.split_chunk(chunk, S),
                                   self.mesh.devices)]
        key_r, pay_r, valid_r, dropped = partition.repartition_by_key(
            self.mesh, [p.src for p in parts],
            [(p.dst, p.val) for p in parts], [p.valid for p in parts],
            S, bucket)
        for b, k, (nb, v), ok in zip(bufs, key_r, pay_r, valid_r):
            # Received entries compacted to the front (valid first,
            # stable), then written at fill; a start past cap - block is
            # clamped as dynamic_update_slice clamps it, and recorded.
            order = torch.sort((~ok).to(torch.int8), stable=True).indices
            n_recv = int(ok.sum())
            start = b.fill
            if start > cap_local - block:
                b.clamped = True
                start = cap_local - block
            sl = slice(start, start + block)
            b.key[sl] = k[order]
            b.nbr[sl] = nb[order]
            b.val[sl] = v[order].to(b.val.dtype)
            b.valid[sl] = ok[order]
            b.fill += n_recv
        return dropped[0]

    def _views(self, bufs: list) -> list:
        views = []
        for b in bufs:
            sk, so, snbr, sval = segments.sort_by_key(
                b.key, b.valid, b.nbr, b.val)
            starts = segments.segment_starts(sk, so)
            seg_id = torch.cumsum(starts.to(torch.int32), 0,
                                  dtype=torch.int32) - 1
            views.append(NeighborhoodView(sk, snbr, sval, so, starts, seg_id))
        return views

    def _windows(self) -> Iterator[tuple[int, list]]:
        """``(window, per-shard sorted views)`` per closed window; drops
        and overflow checked at each close."""
        self.stats["late_edges"] = 0
        self.stats["windows_closed"] = 0
        plan = None
        bufs = None
        dropped = 0
        for kind, w, chunk, _ in tumbling_window_events(
            self._transformed(), self.window_ms, self.stats,
            allowed_lateness=self.allowed_lateness,
        ):
            if plan is None and kind == "edges":
                plan = self._plan(chunk.capacity)
                val_dtype, val_shape = chunk.val.dtype, chunk.val.shape[1:]
            bucket, block, cap_local = plan
            if bufs is None:
                bufs = [_Buffer(cap_local, val_dtype, val_shape, dev)
                        for dev in self.mesh.devices]
                dropped = 0
            if kind == "close":
                dropped = int(dropped)
                self.stats["dropped"] = dropped
                if dropped:
                    raise ValueError(
                        f"{dropped} edges overflowed the keyed-exchange "
                        f"buckets; raise bucket_slack (no silent drops)"
                    )
                if any(b.clamped for b in bufs):
                    fills = max(b.fill for b in bufs)
                    raise ValueError(
                        f"sharded window buffer overflow (device fill "
                        f"{fills} vs capacity {cap_local}); "
                        f"raise window_capacity or bucket_slack"
                    )
                yield w, self._views(bufs)
                self.stats["windows_closed"] += 1
                bufs = None
                continue
            dropped = dropped + self._append(bufs, chunk, bucket, block,
                                             cap_local)

    def _gather(self, parts: list) -> torch.Tensor:
        dev = self.mesh.devices[0]
        return torch.cat([p.to(dev) for p in parts])

    def reduce_on_edges(self, reduce_fn: Callable) -> Iterator[WindowUpdate]:
        """Mesh form of ``SnapshotStream.reduceOnEdges``
        (M/SnapshotStream.java:100-120): a segmented scan a shard over its
        co-located runs; the ``[S*C]`` results are concatenated in shard
        order on the first shard's device."""
        def gen():
            for w, views in self._windows():
                scanned = [_segmented_scan(v.starts, v.val, reduce_fn)
                           for v in views]
                yield WindowUpdate(
                    w, self._gather([v.key for v in views]),
                    self._gather(scanned),
                    self._gather([v.ends() for v in views]))

        return gen()

    def fold_neighbors(self, initial_value,
                       fold_fn: Callable) -> Iterator[WindowUpdate]:
        """Mesh form of ``SnapshotStream.foldNeighbors``
        (M/SnapshotStream.java:61-86): the per-vertex sequential fold a
        shard (a vertex's whole window neighbourhood sits on one shard, so
        per-vertex fold order is the single-device one)."""
        from ..engine.checkpoint import tree_flatten, tree_unflatten

        def gen():
            for w, views in self._windows():
                folded = [tree_flatten(fold_view(v, initial_value, fold_fn))
                          for v in views]
                spec = folded[0][1]
                leaves = [self._gather([f[0][i] for f in folded])
                          for i in range(len(folded[0][0]))]
                yield WindowUpdate(
                    w, self._gather([v.key for v in views]),
                    tree_unflatten(spec, leaves),
                    self._gather([v.ends() for v in views]))

        return gen()

    def apply_on_neighbors(self, apply_fn: Callable) -> Iterator[tuple]:
        """Mesh form of ``SnapshotStream.applyOnNeighbors``: ``apply_fn
        (view)`` a shard on its local sorted view; yields ``(window,
        outputs)``, the per-shard outputs stacked on the first shard's
        device when they are tensors (else a list)."""
        def gen():
            for w, views in self._windows():
                outs = [apply_fn(v) for v in views]
                if all(isinstance(o, torch.Tensor) for o in outs):
                    outs = torch.stack([o.to(self.mesh.devices[0])
                                        for o in outs])
                yield w, outs

        return gen()

    def views(self) -> Iterator[tuple[int, list]]:
        """Raw ``(window, per-shard sorted views)`` — the escape hatch."""
        return self._windows()


def sharded_slice(stream, window_ms: int, direction: str = "out",
                  window_capacity: int | None = None, mesh=None,
                  bucket_slack: float = 2.0,
                  allowed_lateness: int = 0) -> ShardedSnapshotStream:
    """Mesh form of ``SimpleEdgeStream.slice``
    (M/SimpleEdgeStream.java:135-167)."""
    return ShardedSnapshotStream(
        stream, window_ms, direction, window_capacity, mesh, bucket_slack,
        allowed_lateness,
    )
