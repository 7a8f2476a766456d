"""SnapshotStream — per-vertex tumbling-window edge buffers.

Counterpart of ``gelly_tpu/core/snapshot.py`` (the reference's
``SnapshotStream``, produced by ``SimpleEdgeStream.slice``): edges are
grouped by a *group vertex* (the edge source after direction normalization)
into tumbling event/ingestion time windows. Direction handling mirrors
``slice``: ``out`` keys edges by source, ``in`` routes through
``reverse()``, ``all`` through ``undirected()`` so each edge lands in both
endpoints' windows.

A window is assembled on the host (:meth:`SnapshotStream.host_buffers`,
which the packed window-triangle count reads directly), sorted by group
vertex, copied to ``ctx.device`` once, and every aggregation runs over the
sorted runs (:class:`NeighborhoodView`):

- :meth:`SnapshotStream.reduce_on_edges` — a log-step segmented inclusive
  scan with the user's associative ``reduce_fn`` (integer values and
  min / max are exact in any grouping; float sums group differently from
  ``gelly_tpu``'s ``associative_scan`` tree);
- :meth:`SnapshotStream.fold_neighbors` — the per-vertex sequential fold,
  vectorised by rank within a run: step r folds the r-th edge of every
  neighbourhood at once, so the depth is the longest neighbourhood;
- :meth:`SnapshotStream.apply_on_neighbors` — a UDF over the whole view.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from ..ops import segments
from ..ops.segments import INT_MAX
from .chunk import EdgeChunk
from .device import to_numpy
from .windows import tumbling_window_events


class WindowUpdate(NamedTuple):
    """One closed window's per-vertex results: ``slots`` / ``values``
    aligned, a (group-vertex, result) pair where ``valid`` is set."""

    window: int
    slots: torch.Tensor
    values: Any
    valid: torch.Tensor

    def to_pairs(self, ctx) -> list[tuple[int, Any]]:
        from ..engine.checkpoint import tree_flatten

        m = to_numpy(self.valid).astype(bool)
        ids = ctx.decode(to_numpy(self.slots)[m])
        leaves, _ = tree_flatten(self.values)
        vals = [to_numpy(leaf)[m] for leaf in leaves]
        if isinstance(self.values, torch.Tensor):
            return list(zip(ids.tolist(), vals[0].tolist()))
        return list(zip(ids.tolist(), zip(*(v.tolist() for v in vals))))


class NeighborhoodView(NamedTuple):
    """Sorted per-window COO with segment metadata — the neighbourhood
    contract handed to ``apply_on_neighbors`` UDFs. Every tensor has the
    window buffer's length W:

    - ``key``: i32 group-vertex slots, ascending (padding keys last);
    - ``nbr``: i32 neighbour slots; ``val``: edge values; ``valid``;
    - ``starts``: True at the first edge of each vertex's run;
    - ``seg_id``: i32 dense index of the run each edge belongs to.
    """

    key: torch.Tensor
    nbr: torch.Tensor
    val: torch.Tensor
    valid: torch.Tensor
    starts: torch.Tensor
    seg_id: torch.Tensor

    def ends(self) -> torch.Tensor:
        """True at the last edge of each vertex's run."""
        one = torch.ones(1, dtype=torch.bool, device=self.valid.device)
        nxt = torch.cat([self.starts[1:], one])
        nxt_invalid = torch.cat([~self.valid[1:], one])
        return self.valid & (nxt | nxt_invalid)

    def per_vertex(self, ctx) -> Iterator[tuple[int, list[tuple[int, Any]]]]:
        """Host adapter: ``(raw_vertex_id, [(raw_neighbor, val), ...])``,
        the reference's ``Iterable<Tuple2<K, EV>>`` shape. Slow path."""
        key, nbr, val = (to_numpy(self.key), to_numpy(self.nbr),
                         to_numpy(self.val))
        ok = to_numpy(self.valid).astype(bool)
        groups: dict[int, list] = {}
        for k, n, v in zip(key[ok], nbr[ok], val[ok]):
            groups.setdefault(int(k), []).append((n, v))
        for k in sorted(groups):
            nbrs = groups[k]
            raw_k = int(ctx.decode(np.array([k]))[0])
            raw_n = ctx.decode(np.array([n for n, _ in nbrs]))
            yield raw_k, list(zip(raw_n.tolist(), [v for _, v in nbrs]))


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


def _sorted_view(buf, device) -> NeighborhoodView:
    """The device view of a key-sorted host buffer (padding keys =
    INT_MAX): one copy, then the segment metadata."""
    sk, snbr, sval, so = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in buf)
    starts = segments.segment_starts(sk, so)
    seg_id = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1
    return NeighborhoodView(sk, snbr, sval, so, starts, seg_id)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _segmented_scan(starts: torch.Tensor, val: torch.Tensor, reduce_fn):
    """Inclusive segmented scan (Hillis-Steele): after the step at offset
    d, position i holds the reduce of its run's last ``2d`` edges up to i
    (runs restart at ``starts``)."""
    flag = starts
    n = val.shape[0]
    d = 1
    while d < n:
        a_flag, b_flag = flag[:-d], flag[d:]
        a_val, b_val = val[:-d], val[d:]
        merged = torch.where(_bcast(b_flag, b_val), b_val,
                             reduce_fn(a_val, b_val))
        val = torch.cat([val[:d], merged])
        flag = torch.cat([flag[:d], a_flag | b_flag])
        d *= 2
    return val


def fold_view(view: NeighborhoodView, initial_value, fold_fn: Callable):
    """The per-vertex sequential fold over one sorted view (valid entries
    a prefix): the running accumulator at every position, reset to
    ``initial_value`` at each run start; the padding past the last edge
    holds the last accumulator. Step r folds the r-th edge of every
    neighbourhood at once."""
    from ..engine.checkpoint import tree_flatten, tree_unflatten

    init_leaves, spec = tree_flatten(initial_value)
    dev = view.key.device
    w_len = view.key.shape[0]
    # The fold is host-driven: one round a neighbourhood depth.
    ok = to_numpy(view.valid)  # graphlint: disable=GL001 -- the fill, one read a window
    fill = int(ok.sum())  # valid entries are a prefix
    pos = torch.arange(fill, device=dev)
    start_pos = pos[view.starts[:fill]]
    n_seg = start_pos.shape[0]
    seg_len = torch.diff(torch.cat([
        start_pos, torch.tensor([fill], device=dev)]))
    depth = int(seg_len.max()) if n_seg else 0  # graphlint: disable=GL003 -- the round count, one read a window
    acc = [torch.from_numpy(np.asarray(x)).to(dev).expand(n_seg).clone()
           for x in init_leaves]
    outs = [torch.from_numpy(np.asarray(x)).to(dev).expand(w_len).clone()
            for x in init_leaves]
    order = torch.argsort(seg_len, descending=True, stable=True)
    lens = seg_len[order]
    for r in range(depth):
        live = int((lens > r).sum())  # graphlint: disable=GL003 -- the round's live rows size its gather
        segs = order[:live]
        p = start_pos[segs] + r
        new = fold_fn(tree_unflatten(spec, [a[segs] for a in acc]),
                      view.key[p], view.nbr[p], view.val[p])
        new_leaves, _ = tree_flatten(new)
        for a, o, x in zip(acc, outs, new_leaves):
            x = x.to(a.dtype)
            a[segs] = x
            o[p] = x
    if 0 < fill < w_len:
        for o in outs:
            o[fill:] = o[fill - 1]
    return tree_unflatten(spec, outs)


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

    def _windows(self) -> Iterator[tuple[int, NeighborhoodView]]:
        """Per-window sorted views on ``ctx.device``; ``stats`` reflects
        the most recent drain."""
        dev = self.stream.ctx.device
        for w, buf in self.host_buffers():
            yield w, _sorted_view(buf, dev)

    def reduce_on_edges(self, reduce_fn: Callable) -> Iterator[WindowUpdate]:
        """Per-vertex associative reduce of edge values per window
        (SnapshotStream.reduceOnEdges): ``reduce_fn(a, b)`` on tensors,
        associative, run as a segmented scan; the result sits at each
        run's last edge (``valid`` = ``view.ends()``)."""

        def gen():
            for w, view in self._windows():
                scanned = _segmented_scan(view.starts, view.val, reduce_fn)
                yield WindowUpdate(w, view.key, scanned, view.ends())

        return gen()

    def fold_neighbors(self, initial_value, fold_fn: Callable,
                       ) -> Iterator[WindowUpdate]:
        """Per-vertex sequential fold ``fold_fn(acc, v, nbr, val)`` per
        window (SnapshotStream.foldNeighbors), in buffer order within each
        neighbourhood. ``initial_value`` may be a tuple (pytree) of
        scalars; ``fold_fn`` gets tensors (one lane a neighbourhood) and
        must work elementwise. ``values`` holds the running accumulator at
        every buffer position, reset to ``initial_value`` at each run
        start; the padding past the last edge holds the last
        accumulator."""

        def gen():
            for w, view in self._windows():
                yield WindowUpdate(w, view.key,
                                   fold_view(view, initial_value, fold_fn),
                                   view.ends())

        return gen()

    def apply_on_neighbors(self, apply_fn: Callable) -> Iterator:
        """Whole-neighbourhood UDF per window
        (SnapshotStream.applyOnNeighbors): ``apply_fn(view)`` once per
        window, any result; yields ``(window, result)``. For per-vertex
        UDFs iterate ``view.per_vertex(ctx)`` on the host."""

        def gen():
            for w, view in self._windows():
                yield w, apply_fn(view)

        return gen()

    def views(self) -> Iterator[tuple[int, NeighborhoodView]]:
        """Raw (window, sorted view) stream: the escape hatch for host
        UDFs."""
        return self._windows()
