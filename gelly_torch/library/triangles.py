"""Windowed triangle counting — the dense packed path.

Counterpart of the window-triangle part of ``gelly_tpu/library/triangles.py``
(the reference's ``WindowTriangles.java:48-139``): per tumbling window, the
number of triangles among the window's edges. The candidate-generation /
keyBy / match dataflow collapses into one computation per window: the host
dedups the window's undirected edges into one packed ``i32`` column
(``a*n + b``, ``a < b``), the device rebuilds the adjacency, takes the
upper-triangle wedge mask ``M[u, x] = edge(u, x) & x > u``, and sums, over
the window's edges ``(a, b)``, the common smaller neighbours
``Σ_u M[u,a]·M[u,b]`` — each triangle counted once, from its minimum
vertex.

``method`` picks how that sum is taken: ``"mxu"`` computes ``W = MᵀM`` with
:func:`~gelly_torch.ops.kernels.wedge_count_matrix` (the hand-written CUDA
kernel on a card, its plain version on the CPU), ``"mxu_interpret"`` with
the plain version always, ``"gather"`` per edge as ``(M[:, a] & M[:, b]).sum``,
and ``"auto"`` takes ``"mxu"`` on a card for dense windows.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the capped-degree sparse kernel (``max_degree=``), the unpacked dense
path for ``n*n >= 2^31`` and the degree-bucketed path. The exact, sampled
and sharded triangle counts come with later slices.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..ops import kernels
from ..ops.segments import INT_MAX
from ..utils.prefetch import prefetch_map

_NOT_PORTED = "is not ported to gelly_torch yet: ROADMAP queue 1 item 9"


def _check_slot_range(capacity: int, full_capacity: int, *arrays_with_mask):
    """Raise when a live slot exceeds a narrowed adjacency capacity —
    scatters would silently drop and gathers clamp otherwise."""
    if capacity >= full_capacity:
        return
    for arr, mask in arrays_with_mask:
        a = np.asarray(arr)
        m = np.asarray(mask)
        hi = int(a[m].max(initial=0))
        if hi >= capacity:
            raise ValueError(
                f"vertex slot {hi} exceeds triangle capacity {capacity}"
            )


def _wedge_mask(packed: torch.Tensor, n: int, capacity: int):
    """``(M, a, b)`` of one packed window column: ``M`` the bool
    ``[capacity, capacity]`` wedge mask, ``a``/``b`` the endpoints of its
    live lanes (``int64``, clamped into the matrix like the reference's
    gathers). Scatters drop endpoints outside ``capacity``, as the
    reference's ``mode="drop"`` does.

    One window's dense state: the adjacency is symmetrized and then cut to
    its upper triangle in place, so the mask costs one ``capacity^2``-byte
    tensor and no comparison temporary."""
    valid = packed != INT_MAX
    live = packed[valid]  # non-negative i32: padding is masked first
    a = torch.div(live, n, rounding_mode="floor").long()
    b = torch.remainder(live, n).long()
    inside = (a < capacity) & (b < capacity)
    ai, bi = a[inside], b[inside]
    adj = torch.zeros((capacity, capacity), dtype=torch.bool,
                      device=packed.device)
    adj[ai, bi] = True
    adj[bi, ai] = True
    m = adj.triu_(diagonal=1)
    top = capacity - 1
    return m, a.clamp_(max=top), b.clamp_(max=top)


def _window_triangle_count_packed(packed: torch.Tensor, n: int,
                                  capacity: int, method: str) -> torch.Tensor:
    """Triangles of one window from its packed column ``packed[i] = a*n + b``
    (``a < b``, the window's UNIQUE canonical undirected edges, self-loops
    removed, ``INT_MAX`` padding). Returns an ``int64`` scalar on the
    column's device."""
    m, a, b = _wedge_mask(packed, n, capacity)
    if method.startswith("mxu"):
        wedge = (kernels.wedge_count_matrix_plain if method == "mxu_interpret"
                 else kernels.wedge_count_matrix)
        per_edge = wedge(m)[a, b].to(torch.int32)
    else:
        per_edge = (m[:, a] & m[:, b]).sum(dim=0)
    return per_edge.sum(dtype=torch.int64)


def _window_triangle_count_packed_group(packed_kl: torch.Tensor, n: int,
                                        capacity: int, method: str
                                        ) -> torch.Tensor:
    """``i64[K]`` counts of ``K`` stacked packed window columns, one window
    after the other, so the device holds one window's dense state at a
    time."""
    return torch.stack([
        _window_triangle_count_packed(p, n, capacity, method)
        for p in packed_kl
    ])


def _in_groups(it, batch: int):
    g: list = []
    for item in it:
        g.append(item)
        if len(g) == batch:
            yield g
            g = []
    if g:
        yield g


def _pick_method(method: str, n: int):
    """Resolve ``method="auto"`` per group: ``"mxu"`` for a dense window
    (``view_len >= n``, ``n % 128 == 0``) whose column lies on a card, else
    ``"gather"``. Returns ``pick(view_len, device)``."""
    if method != "auto":
        return lambda view_len, device: method
    return lambda view_len, device: (
        "mxu" if (view_len >= n and n % kernels.TILE == 0
                  and torch.device(device).type == "cuda") else "gather"
    )


def _out_windows(stream, window_ms: int, window_capacity: int | None,
                 n: int) -> Iterator[tuple[int, tuple]]:
    """(window, (key, nbr, valid) host columns) per closed window.

    OUT-direction windows carry each edge once; the count rebuilds both
    directions on the device (both share the edge's timestamp window, so
    symmetrizing after the transfer is exact). ``window_capacity`` is
    calibrated by callers for the doubled ALL-direction buffer; the
    single-copy buffer needs half of it. Unsorted (the count is
    order-independent).
    """
    snap = stream.slice(
        window_ms, "out",
        window_capacity=None if window_capacity is None
        else max(1, window_capacity // 2),
    )
    try:
        for w, (bk, bn, _bv, bo) in snap.host_buffers(sort=False):
            _check_slot_range(n, stream.ctx.vertex_capacity,
                              (bk, bo), (bn, bo))
            yield w, (bk, bn, bo)
    except ValueError as e:
        if "window buffer overflow" in str(e):
            raise ValueError(
                f"{e} — note: the triangle paths store each window "
                "edge once and size their buffer as window_capacity // 2 "
                "(window_capacity keeps the ALL-direction doubled-buffer "
                "calibration)"
            ) from e
        raise


def _packed_out_windows(stream, window_ms: int, window_capacity: int | None,
                        n: int) -> Iterator[tuple[int, np.ndarray]]:
    """(window, packed i32 host column): ``key*n + nbr`` of the window's
    UNIQUE canonical undirected edges, ascending, no padding (requires
    n^2 < 2^31). Deduping on the host ships one lane per edge instead of
    the padded window."""
    for w, (bk, bn, bo) in _out_windows(stream, window_ms,
                                        window_capacity, n):
        a = np.minimum(bk[bo], bn[bo]).astype(np.int64)
        b = np.maximum(bk[bo], bn[bo]).astype(np.int64)
        keep = a != b  # self-loops close no triangles
        yield w, np.unique(a[keep] * n + b[keep]).astype(np.int32)


def _dense_packed_only(n: int, max_degree: int | None) -> None:
    if max_degree is not None:
        raise NotImplementedError(
            f"max_degree= (the capped-degree sparse kernel) {_NOT_PORTED}")
    if n * n >= (1 << 31):
        raise NotImplementedError(
            f"capacity {n}: n*n >= 2^31 needs the unpacked dense path, which "
            f"{_NOT_PORTED}")


def window_triangles_bucketed(stream, window_ms: int,
                              capacity: int | None = None,
                              window_capacity: int | None = None,
                              max_degree: int | None = None,
                              batch: int = 8) -> Iterator[tuple]:
    """The reference's degree-bucketed sparse path (large ``n``)."""
    raise NotImplementedError(f"window_triangles_bucketed {_NOT_PORTED}")


def window_triangle_counts_device(stream, window_ms: int,
                                  capacity: int | None = None,
                                  window_capacity: int | None = None,
                                  method: str = "auto") -> Iterator[tuple]:
    """Like :func:`window_triangles` but yields (window, device scalar)
    without a host sync per window: pull the counts once at the end. The
    per-window path is the ``batch=1`` case of
    :func:`window_triangle_counts_batched`."""
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    _dense_packed_only(n, None)
    return window_triangle_counts_batched(
        stream, window_ms, capacity, window_capacity, method, batch=1
    )


def window_triangle_counts_batched(stream, window_ms: int,
                                   capacity: int | None = None,
                                   window_capacity: int | None = None,
                                   method: str = "auto",
                                   batch: int = 4,
                                   max_degree: int | None = None
                                   ) -> Iterator[tuple]:
    """Per-window counts with up to ``batch`` closed windows per staged
    copy: yields (window_index, ``int64`` scalar on ``stream.ctx.device``).
    Emission latency grows by up to ``batch - 1`` windows; the final
    partial group stages only its own windows.

    Host assembly, dedup and the host-to-device copy of the next group run
    on a worker thread while the device counts the current one. On a card
    the copy goes on a side stream and the consumer's stream waits on its
    event before the count's first kernel.
    """
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    _dense_packed_only(n, max_degree)
    device = torch.device(stream.ctx.device)
    pick = _pick_method(method, n)
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def stage(group):
        # Columns are deduped/compact; pad the group to a shared
        # power-of-two bucket. k rows, not batch: a padding row would
        # still build a full adjacency and count it.
        k = len(group)
        wins = [w for w, _ in group]
        longest = max(c.shape[0] for _, c in group)
        bucket = max(1024, 1 << max(0, longest - 1).bit_length())
        stacked = np.full((k, bucket), INT_MAX, np.int32)
        for i, (_, c) in enumerate(group):
            stacked[i, : c.shape[0]] = c
        host = torch.from_numpy(stacked)
        if copy_stream is None:
            return wins, host.to(device), None
        with torch.cuda.stream(copy_stream):
            dev = host.pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return wins, dev, ready

    def gen():
        for wins, stacked, ready in prefetch_map(
            stage,
            _in_groups(
                _packed_out_windows(stream, window_ms, window_capacity, n),
                batch,
            ),
            depth=2, workers=1,
        ):
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                stacked.record_stream(consumer)
            counts = _window_triangle_count_packed_group(
                stacked, n, n, pick(2 * stacked.shape[1], stacked.device)
            )
            yield from zip(wins, counts)

    return gen()


def window_triangles(stream, window_ms: int, capacity: int | None = None,
                     window_capacity: int | None = None,
                     method: str = "auto",
                     max_degree: int | None = None) -> Iterator[tuple]:
    """Per-window triangle counts: yields (window_index, count).

    The reference emits (count, window.maxTimestamp) per window;
    ``window_index * window_ms + window_ms - 1`` recovers that timestamp.

    ``method``: ``"gather"`` (sparse windows), ``"mxu"`` (the wedge kernel,
    dense windows; needs ``capacity % 128 == 0``), ``"mxu_interpret"`` (the
    kernel's plain version) or ``"auto"`` (``"mxu"`` on a card when the
    window buffer is dense relative to capacity).
    """
    n = capacity if capacity is not None else stream.ctx.vertex_capacity
    _dense_packed_only(n, max_degree)
    counts = window_triangle_counts_device(
        stream, window_ms, capacity, window_capacity, method)
    return ((w, int(c)) for w, c in counts)
