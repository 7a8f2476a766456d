"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``gelly_tpu/ops/pallas_kernels.py``, both of its kernels,
and of the XLA device loops that eager PyTorch cannot run as written
(below):

- :func:`wedge_count_matrix` — the wrapper of the CUDA kernels
  ``csrc/wedge_count_matrix.cu`` (replacing the Pallas ``_wedge_kernel``):
  ``W = MᵀM`` for the window-triangle wedge mask, on the tensor cores,
  upper tiles only and live k-blocks only. On a CPU tensor it runs
  :func:`wedge_count_matrix_plain`; on a CUDA tensor it launches the
  kernels or raises. ``wedge_count_matrix.launches`` counts launches.
  :func:`wedge_tile_schedule`, :func:`wedge_block_flags_plain` and
  :func:`wedge_needed_ops` state the tile order, the block flags and the
  work the kernel does, in plain PyTorch.
- :func:`sorted_window_gather` — the wrapper of the CUDA kernel
  ``csrc/sorted_window_gather.cu`` (replacing the Pallas
  ``_sorted_gather_kernel``). On a CPU tensor it runs
  :func:`sorted_window_gather_plain`; on a CUDA tensor it launches the
  kernel or raises. ``sorted_window_gather.launches`` counts launches.
- :func:`blocked_gather` — exact ``table[idx]`` for any index order, built
  on the kernel (sort, gather, unsort, repair misses).

- :func:`sparse_insert_edges` and :func:`sparse_insert_edges_batched` —
  the wrappers of the two entries of ``csrc/spanner_gate.cu``, replacing
  ``gelly_tpu/library/spanner.py``'s ``_sparse_insert_edges`` (a
  per-edge ``lax.scan``) and ``_sparse_insert_edges_batched`` (the
  combine's ``lax.while_loop`` of 64-candidate batches); they update the
  sparse spanner summary's tensors in place;
- :func:`matching_step` — the wrapper of ``csrc/matching_step.cu``,
  replacing ``gelly_tpu/library/matching.py``'s ``_matching_step``.

- :func:`hashset_insert` and :func:`hashset_contains` — the wrappers of
  ``csrc/hashset.cu``, replacing ``gelly_tpu/ops/hashset.py``'s
  ``insert_chunk`` and ``contains_chunk``;
- :func:`row_insert_chunk` — the wrapper of ``csrc/row_insert.cu``,
  replacing ``gelly_tpu/core/neighborhood.py``'s ``_row_step``;
- :func:`sampler_step` — the wrapper of ``csrc/sampler_step.cu``,
  replacing ``gelly_tpu/library/triangles.py``'s ``_sampler_step``.

Each of these runs its ``*_plain`` version on CPU tensors and its kernel
on CUDA tensors (or raises), and counts launches in ``.launches``.

All keep the reference's contract bit for bit (the gather's ``-1`` lanes
included), and :func:`gatherable` is the reference's, so both packages
accept the same tables. The 2^24 value bound exists only because the TPU
kernel routes values through an f32 matmul; it is kept so the two packages
agree on what they accept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .rowtable import put_where_, row_append_batch, row_insert

# Output tile edge of the wedge kernel; the mask's side must be a multiple.
TILE = 128
# Largest tile count per side the kernel takes (N <= 131072).
WEDGE_MAX_TILES = 1024
# Mask types whose bytes the kernel reads as they are (0/1 entries).
WEDGE_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)


def _check_wedge_mask(m: torch.Tensor) -> int:
    """Side ``n`` of a square wedge mask; raises like the reference on a
    side that is not a multiple of :data:`TILE`.

    The reference casts any input to f32. The port takes one-byte masks
    (``bool``, ``uint8``, ``int8``) with 0/1 entries, the bytes its kernel
    reads, and raises ``TypeError`` on any other type."""
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"wedge mask must be square, got shape {tuple(m.shape)}")
    n = m.shape[0]
    if n % TILE:
        raise ValueError(f"wedge matrix size {n} not a multiple of {TILE}")
    if m.dtype not in WEDGE_MASK_DTYPES:
        raise TypeError(
            f"wedge_count_matrix takes a bool, uint8 or int8 mask, got {m.dtype}")
    return n


def wedge_count_matrix_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`wedge_count_matrix` on any device:
    the mask cast to f32 as the reference casts it, and an f32 product,
    exact for 0/1 entries while counts stay below 2^24."""
    _check_wedge_mask(m)
    mf = m.to(torch.float32)
    return mf.T @ mf


def wedge_tile_schedule(t: int) -> torch.Tensor:
    """The kernel's upper tiles ``(i, j)``, ``i <= j``, of a ``t x t`` tile
    grid, in launch order (``int64 [t(t+1)/2, 2]``): rows of descending
    ``i``, each row by ascending ``j``. Block ``b`` of the kernel takes
    row ``q`` from the bottom with ``q(q+1)/2 <= b < (q+1)(q+2)/2``.

    Tile ``(i, j)`` of a triangular (``triu``) mask has at most ``i + 1``
    live k-blocks, so the heaviest tiles come first."""
    b = torch.arange(t * (t + 1) // 2, dtype=torch.int64)
    q = ((torch.sqrt((8 * b + 1).double()) - 1) / 2).floor().long()
    q += ((q + 1) * (q + 2) // 2 <= b).long()  # exact past float rounding
    q -= (q * (q + 1) // 2 > b).long()
    i = t - 1 - q
    return torch.stack([i, i + b - q * (q + 1) // 2], dim=1)


def wedge_block_flags_plain(m: torch.Tensor) -> torch.Tensor:
    """``flags[k, i]``: does the ``128 x 128`` block of rows ``128k..`` and
    columns ``128i..`` of the mask hold a nonzero entry? (``bool [t, t]``,
    ``t = n / 128``, on the mask's device.) The kernel's pre-pass computes
    the same flags, and tile ``(i, j)`` sums only the k-blocks with
    ``flags[k, i] & flags[k, j]``."""
    n = _check_wedge_mask(m)
    t = n // TILE
    nz = m if m.dtype == torch.bool else m != 0
    return nz.reshape(t, TILE, t, TILE).any(dim=3).any(dim=1)


def wedge_needed_ops(flags: torch.Tensor) -> int:
    """Integer operations the kernel's tensor cores do for a mask with
    block flags ``flags``: ``2 * 128^3`` for every live block triple
    ``(k, i, j)``, ``i <= j``, ``flags[k, i] & flags[k, j]`` (the upper
    tiles only, dead k-blocks skipped)."""
    f = flags.to(torch.float64)
    pairs = f.T @ f  # pairs[i, j] = live k-blocks of tile (i, j), exact
    triples = int((pairs.sum() + pairs.trace()).item()) // 2
    return 2 * TILE ** 3 * triples


def _wedge_launch_args(m: torch.Tensor, n: int):
    if m.device.type != "cuda":
        raise ValueError(f"wedge_count_matrix runs on CPU or CUDA, got {m.device}")
    if not m.is_contiguous() or m.data_ptr() % 16:
        raise ValueError("wedge_count_matrix needs a contiguous, 16-byte "
                         "aligned mask")
    if n // TILE > WEDGE_MAX_TILES:
        raise ValueError(f"wedge_count_matrix takes n <= "
                         f"{WEDGE_MAX_TILES * TILE}, got {n}")
    t = n // TILE
    mt = torch.empty((n, n), dtype=torch.uint8, device=m.device)
    flags = torch.empty((t, t), dtype=torch.uint8, device=m.device)
    return mt, flags


def _wedge_launch(entry: str, m: torch.Tensor, n: int, *scratch_and_out):
    """Call the library's C entry ``entry`` on ``m`` and the given output
    tensors, on the current stream of the mask's card; raises on a
    refused launch."""
    from . import _build

    lib = _build.load("wedge_count_matrix")
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(m.data_ptr(),
                                 *(x.data_ptr() for x in scratch_and_out),
                                 n, stream)
    if rc:
        msg = lib.wedge_count_matrix_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: {msg}")


def wedge_block_prepass(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's pre-pass alone: ``(Mt, flags)`` with ``flags`` the
    ``uint8 [t, t]`` block flags of :func:`wedge_block_flags_plain` and
    ``Mt`` the ``uint8`` transpose of the mask, written on the live blocks
    only (a dead block of ``Mt`` is never read). On a CPU mask the plain
    version (a full transpose); on a CUDA mask the pre-pass kernel, which
    is not counted in ``wedge_count_matrix.launches``. Used to time the
    pre-pass's share of a launch."""
    n = _check_wedge_mask(m)
    if m.device.type == "cpu":
        return (m.T.contiguous().to(torch.uint8),
                wedge_block_flags_plain(m).to(torch.uint8))
    mt, flags = _wedge_launch_args(m, n)
    _wedge_launch("wedge_count_matrix_prepass", m, n, mt, flags)
    return mt, flags


def wedge_count_matrix(m: torch.Tensor) -> torch.Tensor:
    """``W = MᵀM`` in f32 for a square one-byte wedge mask ``M[u, x]``
    (``bool``, ``uint8`` or ``int8``, 0/1 entries) whose side is a
    multiple of 128: ``W[a, b]`` counts the rows ``u`` set in both columns
    ``a`` and ``b`` (common smaller neighbours of ``a`` and ``b``), the
    whole matrix, as the reference's Pallas kernel writes it.

    A CPU mask runs :func:`wedge_count_matrix_plain`; a CUDA mask (which
    must be contiguous) launches the kernel pair (pre-pass and tile
    kernel, with ``n^2 + (n/128)^2`` bytes of scratch), counted once in
    ``wedge_count_matrix.launches``, or raises.
    """
    n = _check_wedge_mask(m)
    if m.device.type == "cpu":
        return wedge_count_matrix_plain(m)
    mt, flags = _wedge_launch_args(m, n)
    out = torch.empty((n, n), dtype=torch.float32, device=m.device)
    if n == 0:
        return out
    _wedge_launch("wedge_count_matrix_launch", m, n, mt, flags, out)
    wedge_count_matrix.launches += 1
    return out


wedge_count_matrix.launches = 0

# Lane width of the reference's 2D table view (the TPU vector lane count);
# the window geometry below is defined in these units.
GATHER_LANE = 128
# Window rows per table block: a window spans GATHER_WINDOW_ROWS * 128 slots.
GATHER_WINDOW_ROWS = 128
# Sorted index lanes per tile (one window pair per tile).
GATHER_TILE = 1024
# The reference kernel's exactness bound on table length and values.
GATHER_MAX_VALUE = 1 << 24


def gatherable(n: int, *, window_rows: int = GATHER_WINDOW_ROWS) -> bool:
    """Can :func:`sorted_window_gather` serve a table of ``n`` slots?"""
    lane = GATHER_LANE
    nr = n // lane
    wr = min(window_rows, max(nr // 2, 1))
    return (
        0 < n <= GATHER_MAX_VALUE
        and n % lane == 0
        and nr % wr == 0
        and nr >= 2 * wr
    )


def _geometry(table: torch.Tensor, sidx: torch.Tensor,
              window_rows: int) -> tuple[int, int]:
    """(span, max_start) of the window walk; raises like the reference."""
    if table.ndim != 1 or sidx.ndim != 1:
        raise ValueError("sorted_window_gather expects 1D table and indices")
    n = table.shape[0]
    lane = GATHER_LANE
    nr = n // lane
    wr = min(window_rows, max(nr // 2, 1))
    if n % lane or nr % wr or nr < 2 * wr:
        raise ValueError(
            f"table length {n} must be a multiple of {lane} and hold at "
            f"least two {wr}-row windows (window_rows={window_rows})"
        )
    if n > GATHER_MAX_VALUE:
        raise ValueError(
            f"table length {n} exceeds the gather's exactness bound "
            f"{GATHER_MAX_VALUE} (values must stay below 2^24)"
        )
    if table.dtype != torch.int32 or sidx.dtype != torch.int32:
        raise TypeError(
            f"sorted_window_gather takes int32 table and indices, got "
            f"{table.dtype} and {sidx.dtype}"
        )
    if table.device != sidx.device:
        raise ValueError(
            f"table on {table.device} but indices on {sidx.device}"
        )
    return lane * wr, nr // wr - 2


def sorted_window_gather_plain(table: torch.Tensor, sidx: torch.Tensor, *,
                               window_rows: int = GATHER_WINDOW_ROWS,
                               tile: int = GATHER_TILE) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_window_gather` (same result,
    bit for bit, on any device): each tile of ``tile`` lanes sees the two
    consecutive windows starting at ``clip(sidx[g*tile] // span, 0,
    nwb - 2)``; lanes outside both come back ``-1``."""
    span, max_start = _geometry(table, sidx, window_rows)
    L = sidx.shape[0]
    if L == 0:
        return torch.zeros(0, dtype=torch.int32, device=table.device)
    starts = torch.div(sidx[::tile], span, rounding_mode="floor")
    starts = starts.clamp(0, max_start).to(torch.int64)
    lo = starts.repeat_interleave(tile)[:L] * span
    hit = (sidx >= lo) & (sidx < lo + 2 * span)
    vals = table[sidx.clamp(0, table.shape[0] - 1)]
    return torch.where(hit, vals, -1)


def sorted_window_gather(table: torch.Tensor, sidx: torch.Tensor, *,
                         window_rows: int = GATHER_WINDOW_ROWS,
                         tile: int = GATHER_TILE) -> torch.Tensor:
    """``table[sidx]`` for SORTED ``sidx`` through per-tile table windows.

    Returns i32 values with ``-1`` marking lanes whose index fell outside
    the tile's double window (possible only where the input is not sorted,
    or a tile spans more than ``2 * window_rows * 128`` slots). Misses are
    never wrong values. Requirements as in the reference: a 1D ``int32``
    table whose length passes :func:`gatherable` for ``window_rows``,
    ``int32`` indices in ``[0, len(table))``, both on one device, and on
    CUDA both contiguous.

    A CPU table runs :func:`sorted_window_gather_plain`; a CUDA table
    launches the kernel (counted in ``sorted_window_gather.launches``).
    """
    span, max_start = _geometry(table, sidx, window_rows)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    if table.device.type == "cpu":
        return sorted_window_gather_plain(
            table, sidx, window_rows=window_rows, tile=tile)
    if table.device.type != "cuda":
        raise ValueError(
            f"sorted_window_gather runs on CPU or CUDA, got {table.device}")
    if not (table.is_contiguous() and sidx.is_contiguous()):
        raise ValueError("sorted_window_gather needs contiguous tensors")
    L = sidx.shape[0]
    out = torch.empty_like(sidx)
    if L == 0:
        return out
    from . import _build

    lib = _build.load("sorted_window_gather")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sorted_window_gather_launch(
            table.data_ptr(), sidx.data_ptr(), out.data_ptr(), L, tile,
            span, max_start, stream,
        )
    if rc:
        msg = lib.sorted_window_gather_error_string(rc).decode()
        raise RuntimeError(f"sorted_window_gather launch failed: {msg}")
    sorted_window_gather.launches += 1
    return out


sorted_window_gather.launches = 0


def blocked_gather(table: torch.Tensor, idx: torch.Tensor, *,
                   window_rows: int = GATHER_WINDOW_ROWS,
                   tile: int = GATHER_TILE) -> torch.Tensor:
    """Exact ``table[idx]`` for ARBITRARY-order indices via the windowed
    kernel: sort the indices, gather, put the values back in call order,
    and repair window misses with one plain gather (only when a miss
    occurred).

    Falls back to the plain gather for a table whose length is not
    window-blockable and for a table holding any value outside
    ``[0, 2^24)`` (the reference's exactness guard; a ``-1`` table value
    would also read as a miss). The result is exact ``table[idx]`` for any
    int32 input with indices in range.
    """
    if not gatherable(table.shape[0], window_rows=window_rows):
        return table[idx]
    values_exact = bool(  # graphlint: disable=GL003 -- picks the kernel or the plain gather, one read a call
        (table.min() >= 0) & (table.max() < GATHER_MAX_VALUE))
    if not values_exact:
        return table[idx]
    sidx, order = torch.sort(idx.to(torch.int32), stable=True)
    svals = sorted_window_gather(
        table, sidx, window_rows=window_rows, tile=tile)
    vals = torch.empty_like(svals)
    vals[order] = svals
    miss = vals < 0
    if bool(miss.any()):  # graphlint: disable=GL003 -- repairs only a call that missed, one read a call
        vals = torch.where(miss, table[idx], vals)
    return vals


# ------------------------------------------------------------------ #
# The sparse spanner's gates (csrc/spanner_gate.cu)

# Candidates a batch of the combine's insert gates at once (gelly_tpu's
# default for _sparse_insert_edges_batched).
GATE_BATCH = 64
# Warps of one entry-2 launch, at most (one block).
GATE_MAX_WARPS = 32


def unique_fill(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Row-wise ``jnp.unique(row, size=size, fill_value=fill)`` of a 2-D
    ``x``: each row's distinct values ascending, cut to the ``size``
    smallest or padded with ``fill``."""
    rows = x.shape[0]
    s, _ = torch.sort(x, dim=1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    pos = torch.cumsum(first, dim=1) - 1
    keep = first & (pos < size)
    out = torch.full((rows, size + 1), fill, dtype=x.dtype, device=x.device)
    out.scatter_(1, torch.where(keep, pos, size), s)
    return out[:, :size]


def within_k_sparse_plain(nbr: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor, k: int,
                          frontier_cap: int) -> torch.Tensor:
    """``dist(u[i], v[i]) <= k`` for each candidate ``i`` (``bool[B]``)
    over the capped-degree rows ``nbr`` with a ``frontier_cap``-id
    frontier: ``gelly_tpu``'s ``_within_k_sparse``, vmapped. Each round
    gathers the rows of the frontier's live ids and keeps the
    ``frontier_cap`` smallest distinct ids of frontier and rows (the
    sentinel ``n`` pads)."""
    n = nbr.shape[0]
    B = u.shape[0]
    f = torch.full((B, frontier_cap), n, dtype=torch.int32, device=nbr.device)
    f[:, 0] = u.to(torch.int32)
    for _ in range(k):
        live = f < n
        rows = nbr[torch.where(live, f, 0).long()]  # [B, F, D]
        cand = torch.where(live[:, :, None] & (rows >= 0), rows, n)
        merged = torch.cat([f, cand.reshape(B, -1)], dim=1)
        f = unique_fill(merged, frontier_cap, n)
    return (f == v.to(torch.int32)[:, None]).any(dim=1)


def _check_spanner_state(nbr, deg, dover, esrc, edst, n, overflow,
                         max_degree: int) -> None:
    for name, t, dtype, shape in (
            ("nbr", nbr, torch.int32, (nbr.shape[0], max_degree)),
            ("deg", deg, torch.int32, (nbr.shape[0],)),
            ("deg_overflow", dover, torch.int32, ()),
            ("esrc", esrc, torch.int32, (esrc.shape[0],)),
            ("edst", edst, torch.int32, (esrc.shape[0],)),
            ("n", n, torch.int32, ()),
            ("overflow", overflow, torch.bool, ())):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"spanner state {name}: want {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != nbr.device:
            raise ValueError(f"spanner state {name} on {t.device}, "
                             f"nbr on {nbr.device}")
        if not t.is_contiguous():
            raise ValueError(f"spanner state {name} is not contiguous")
    if esrc.shape[0] == 0:
        raise ValueError("spanner edge list has no lanes")


def _check_lanes(device, **lanes) -> None:
    """Edge lanes: 1-D, one length, on ``device``, contiguous, of their
    dtype (``int32`` ids, ``bool`` masks)."""
    length = None
    for name, t in lanes.items():
        want = torch.bool if name == "valid" else torch.int32
        if t.dtype != want or t.ndim != 1:
            raise ValueError(f"{name}: want 1-D {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if length is not None and t.shape[0] != length:
            raise ValueError(f"{name} has {t.shape[0]} lanes, not {length}")
        length = t.shape[0]
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, state on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def append_edges_plain(esrc, edst, n, overflow, u, v, take) -> None:
    """The spanner's edge-list append of the lanes where ``take`` is set,
    in lane order, in place: stored while the list has room, the sticky
    ``overflow`` set for the rest, and ``n`` counting every taken lane
    (``gelly_tpu``'s per-edge and batched appends alike)."""
    pos = n + torch.cumsum(take.to(torch.int32), 0) - 1
    store = take & (pos < esrc.shape[0])
    put_where_(esrc, pos, u, store)
    put_where_(edst, pos, v, store)
    overflow.logical_or_((take & ~store).any())
    n.add_(take.sum().to(n.dtype))


def batches_plain(csrc, cdst, n_valid, batch: int):
    """``(u, v, ok)`` of each ``batch``-lane batch of the first
    ``min(n_valid, len(csrc))`` lanes of a donor list (one host read of
    ``n_valid``; the list is zero-padded to whole batches)."""
    ccap = csrc.shape[0]
    nv = min(int(n_valid), ccap)
    pad = (-ccap) % batch
    zeros = torch.zeros(pad, dtype=csrc.dtype, device=csrc.device)
    u_all = torch.cat([csrc, zeros])
    v_all = torch.cat([cdst, zeros])
    lanes = torch.arange(batch, device=csrc.device)
    for start in range(0, nv, batch):
        yield (u_all[start:start + batch], v_all[start:start + batch],
               (start + lanes) < nv)


def sparse_insert_edges_plain(nbr, deg, dover, esrc, edst, n, overflow,
                              src, dst, valid, k: int, max_degree: int,
                              frontier_cap: int) -> None:
    """Plain PyTorch version of :func:`sparse_insert_edges`: the lanes
    gated and inserted one at a time, in order, through
    :func:`within_k_sparse_plain` and ``row_insert(dedupe=False)`` both
    ways (one host read of the lanes, then no sync)."""
    src_h, dst_h, ok_h = src.cpu(), dst.cpu(), valid.cpu()
    live = (ok_h & (src_h != dst_h)).nonzero().flatten().tolist()
    over = dover.clone()
    for i in live:
        # One-element views: they index without a device sync.
        u, v = src[i:i + 1], dst[i:i + 1]
        take = ~within_k_sparse_plain(nbr, u, v, k, frontier_cap)
        for a, b in ((u, v), (v, u)):
            nbr, deg, over = row_insert(nbr, deg, over, a, b, take,
                                        max_degree, dedupe=False)
        append_edges_plain(esrc, edst, n, overflow, u, v, take)
    dover.copy_(over)


def sparse_insert_edges(nbr, deg, dover, esrc, edst, n, overflow, src, dst,
                        valid, k: int, max_degree: int,
                        frontier_cap: int) -> None:
    """Gate and insert the lanes ``(src, dst, valid)`` one at a time, in
    order, into a sparse spanner summary given field by field (``nbr``
    ``i32[N, D]``, ``deg`` ``i32[N]``, ``dover`` 0-d ``i32``, ``esrc`` /
    ``edst`` ``i32[E]``, ``n`` 0-d ``i32``, ``overflow`` 0-d ``bool``),
    updating every field in place: ``gelly_tpu``'s
    ``_sparse_insert_edges``. A live lane is taken when no path of at
    most ``k`` edges joins its endpoints (the ``frontier_cap``-id BFS).

    On CPU tensors it runs :func:`sparse_insert_edges_plain`; on CUDA
    tensors it launches entry 1 of ``csrc/spanner_gate.cu`` (one block,
    the whole lane list; counted in ``sparse_insert_edges.launches``) or
    raises."""
    _check_spanner_state(nbr, deg, dover, esrc, edst, n, overflow,
                         max_degree)
    _check_lanes(nbr.device, src=src, dst=dst, valid=valid)
    if nbr.device.type == "cpu":
        return sparse_insert_edges_plain(
            nbr, deg, dover, esrc, edst, n, overflow, src, dst, valid, k,
            max_degree, frontier_cap)
    lib = _gate_library(nbr, max_degree, frontier_cap, k, 0, 0)
    if src.shape[0] == 0:
        return None
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spanner_sparse_insert_edges(
            nbr.data_ptr(), deg.data_ptr(), dover.data_ptr(),
            esrc.data_ptr(), edst.data_ptr(), n.data_ptr(),
            overflow.data_ptr(), src.data_ptr(), dst.data_ptr(),
            valid.data_ptr(), src.shape[0], nbr.shape[0], esrc.shape[0], k,
            max_degree, frontier_cap, stream)
    if rc:
        msg = lib.spanner_gate_error_string(rc).decode()
        raise RuntimeError(f"spanner_sparse_insert_edges failed: {msg}")
    sparse_insert_edges.launches += 1
    return None


sparse_insert_edges.launches = 0


def _gate_library(nbr, max_degree: int, frontier_cap: int, k: int,
                  batch: int, warps: int) -> ctypes.CDLL:
    """The loaded gate library, after checking the device and that one
    launch's shared memory fits the card (entry 1 when ``batch`` is 0)."""
    if nbr.device.type != "cuda":
        raise ValueError(f"the spanner gates run on CPU or CUDA, got "
                         f"{nbr.device}")
    if max_degree < 1 or frontier_cap < 1:
        raise ValueError(f"max_degree {max_degree} and frontier_cap "
                         f"{frontier_cap} must be positive")
    from . import _build

    lib = _build.load("spanner_gate")
    need = lib.spanner_gate_smem_bytes(max_degree, frontier_cap, k, batch,
                                       warps)
    if need > lib.spanner_gate_smem_limit():
        raise ValueError(
            f"the spanner gate needs {need} B of shared memory for "
            f"max_degree={max_degree}, frontier_cap={frontier_cap}, k={k}, "
            f"more than the card's {lib.spanner_gate_smem_limit()} B")
    return lib


def gate_warps(lib, max_degree: int, frontier_cap: int, k: int,
               batch: int = GATE_BATCH) -> int:
    """Warps of one entry-2 launch: as many as its shared memory holds,
    at most one per candidate and :data:`GATE_MAX_WARPS` (0 when not one
    fits)."""
    limit = lib.spanner_gate_smem_limit()
    for w in range(min(GATE_MAX_WARPS, batch), 0, -1):
        if lib.spanner_gate_smem_bytes(max_degree, frontier_cap, k, batch,
                                       w) <= limit:
            return w
    return 0


def sparse_insert_edges_batched_plain(nbr, deg, dover, esrc, edst, n,
                                      overflow, csrc, cdst, n_valid, k: int,
                                      max_degree: int, frontier_cap: int,
                                      batch: int = GATE_BATCH) -> None:
    """Plain PyTorch version of :func:`sparse_insert_edges_batched`: one
    host read of ``n_valid``, then per batch a vmapped gate
    (:func:`within_k_sparse_plain`), two ``row_append_batch`` passes and
    the edge-list append, with no further sync."""
    over = dover.clone()
    for u, v, ok in batches_plain(csrc, cdst, n_valid, batch):
        reach = within_k_sparse_plain(nbr, u, v, k, frontier_cap)
        take = ok & (u != v) & ~reach
        for a, b in ((u, v), (v, u)):
            nbr, deg, over = row_append_batch(nbr, deg, over, a, b, take,
                                              max_degree)
        append_edges_plain(esrc, edst, n, overflow, u, v, take)
    dover.copy_(over)


def sparse_insert_edges_batched(nbr, deg, dover, esrc, edst, n, overflow,
                                csrc, cdst, n_valid, k: int,
                                max_degree: int, frontier_cap: int,
                                batch: int = GATE_BATCH) -> None:
    """Insert the first ``min(n_valid, len(csrc))`` edges of a donor list
    ``(csrc, cdst)`` into a sparse spanner summary (fields as in
    :func:`sparse_insert_edges`, updated in place), ``batch`` candidates
    at a time: each batch is gated against the adjacency as it stood at
    the batch's start, then every candidate that passed is appended in
    candidate order — ``gelly_tpu``'s ``_sparse_insert_edges_batched``.
    ``n_valid`` is a 0-d ``int32`` tensor (the donor's count).

    On CPU tensors it runs :func:`sparse_insert_edges_batched_plain`; on
    CUDA tensors it launches entry 2 of ``csrc/spanner_gate.cu`` (one
    block, the whole loop, ``n_valid`` read on the device; counted in
    ``sparse_insert_edges_batched.launches``) or raises."""
    _check_spanner_state(nbr, deg, dover, esrc, edst, n, overflow,
                         max_degree)
    _check_lanes(nbr.device, csrc=csrc, cdst=cdst)
    if n_valid.dtype != torch.int32 or n_valid.ndim != 0 \
            or n_valid.device != nbr.device:
        raise ValueError(f"n_valid: want a 0-d int32 tensor on "
                         f"{nbr.device}, got {n_valid.dtype} "
                         f"{tuple(n_valid.shape)} on {n_valid.device}")
    if batch < 1:
        raise ValueError(f"batch must be positive, got {batch}")
    if nbr.device.type == "cpu":
        return sparse_insert_edges_batched_plain(
            nbr, deg, dover, esrc, edst, n, overflow, csrc, cdst, n_valid,
            k, max_degree, frontier_cap, batch)
    lib = _gate_library(nbr, max_degree, frontier_cap, k, batch, 1)
    warps = gate_warps(lib, max_degree, frontier_cap, k, batch)
    if csrc.shape[0] == 0:
        return None
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spanner_sparse_insert_edges_batched(
            nbr.data_ptr(), deg.data_ptr(), dover.data_ptr(),
            esrc.data_ptr(), edst.data_ptr(), n.data_ptr(),
            overflow.data_ptr(), csrc.data_ptr(), cdst.data_ptr(),
            n_valid.data_ptr(), csrc.shape[0], nbr.shape[0], esrc.shape[0],
            k, max_degree, frontier_cap, batch, warps, stream)
    if rc:
        msg = lib.spanner_gate_error_string(rc).decode()
        raise RuntimeError(
            f"spanner_sparse_insert_edges_batched failed: {msg}")
    sparse_insert_edges_batched.launches += 1
    return None


sparse_insert_edges_batched.launches = 0


# ------------------------------------------------------------------ #
# The matching fold (csrc/matching_step.cu)


def _check_matching(partner, weight, src, dst, w, valid) -> None:
    if partner.dtype != torch.int32 or weight.dtype != torch.float32 \
            or partner.ndim != 1 or weight.shape != partner.shape:
        raise ValueError(
            f"matching state: want i32[n] partner and f32[n] weight, got "
            f"{partner.dtype} {tuple(partner.shape)} and {weight.dtype} "
            f"{tuple(weight.shape)}")
    if w.dtype != torch.float32 or w.shape != src.shape:
        raise ValueError(f"w: want f32 of {tuple(src.shape)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if weight.device != partner.device or w.device != partner.device:
        raise ValueError("matching state and weights on different devices")
    _check_lanes(partner.device, src=src, dst=dst, valid=valid)


def matching_step_plain(partner, weight, src, dst, w, valid):
    """Plain PyTorch version of :func:`matching_step`: new ``(partner,
    weight)`` after the live lanes, one at a time, in f32 (one host read of
    the lanes, then no sync)."""
    partner = partner.clone()
    weight = weight.clone()
    src_h, dst_h, ok_h = src.cpu(), dst.cpu(), valid.cpu()
    live = (ok_h & (src_h != dst_h)).nonzero().flatten().tolist()
    minus = torch.full((), -1, dtype=partner.dtype, device=partner.device)
    zero = torch.zeros((), dtype=weight.dtype, device=weight.device)
    for i in live:
        # One-element views: they index without a device sync.
        u, v, we = src[i:i + 1], dst[i:i + 1], w[i:i + 1]
        pu, pv = partner[u], partner[v]
        wu = torch.where(pu >= 0, weight[u], zero)
        wv = torch.where(pv >= 0, weight[v], zero)
        same = (pu == v) & (pv == u) & (pu >= 0)
        coll = torch.where(same, wu, wu + wv)
        take = we > 2.0 * coll
        for x, px in ((u, pu), (v, pv)):
            do = take & (px >= 0)
            pxc = px.clamp(min=0)
            partner[pxc] = torch.where(do, minus, partner[pxc])
            weight[pxc] = torch.where(do, zero, weight[pxc])
            partner[x] = torch.where(do, minus, partner[x])
            weight[x] = torch.where(do, zero, weight[x])
        partner[u] = torch.where(take, v, partner[u])
        partner[v] = torch.where(take, u, partner[v])
        weight[u] = torch.where(take, we, weight[u])
        weight[v] = torch.where(take, we, weight[v])
    return partner, weight


def matching_step(partner, weight, src, dst, w, valid):
    """One chunk of the greedy ½-approximate weighted matching, in stream
    order and in f32 (``gelly_tpu``'s ``_matching_step``): a live edge
    ``(u, v, w)`` is taken when ``w > 2 *`` the weight of the matches it
    collides with, which it then evicts. ``partner`` ``i32[n]`` (-1
    unmatched) and ``weight`` ``f32[n]`` are the state, ``src`` / ``dst``
    ``i32``, ``w`` ``f32`` and ``valid`` ``bool`` the chunk. Returns the
    new ``(partner, weight)``; the inputs are not changed.

    On CPU tensors it runs :func:`matching_step_plain`; on CUDA tensors it
    launches ``csrc/matching_step.cu`` on copies of the state (counted in
    ``matching_step.launches``) or raises."""
    _check_matching(partner, weight, src, dst, w, valid)
    if partner.device.type == "cpu":
        return matching_step_plain(partner, weight, src, dst, w, valid)
    if partner.device.type != "cuda":
        raise ValueError(f"matching_step runs on CPU or CUDA, got "
                         f"{partner.device}")
    if not (partner.is_contiguous() and weight.is_contiguous()):
        raise ValueError("matching_step needs a contiguous state")
    partner = partner.clone()
    weight = weight.clone()
    if src.shape[0] == 0 or partner.shape[0] == 0:
        return partner, weight
    from . import _build

    lib = _build.load("matching_step")
    with torch.cuda.device(partner.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.matching_step_launch(
            partner.data_ptr(), weight.data_ptr(), src.data_ptr(),
            dst.data_ptr(), w.data_ptr(), valid.data_ptr(), src.shape[0],
            partner.shape[0], stream)
    if rc:
        msg = lib.matching_step_error_string(rc).decode()
        raise RuntimeError(f"matching_step launch failed: {msg}")
    matching_step.launches += 1
    return partner, weight


matching_step.launches = 0


# ---------------------------------------------------------------------- #
# The hash set of EdgeStream.distinct (csrc/hashset.cu)

HASH_EMPTY = -(1 << 63)  # int64 min: a free slot
HASH_MUL = -7046029254386353131  # the Fibonacci multiplier (wraps)


def _hash_np(keys: np.ndarray, mask: int) -> np.ndarray:
    """``gelly_tpu``'s Fibonacci hash of int64 keys (the product wraps)."""
    with np.errstate(over="ignore"):
        h = (keys.astype(np.int64) * np.int64(HASH_MUL)) >> np.int64(32)
    return (h & np.int64(mask)).astype(np.int32)


def _check_hash_table(table, count) -> int:
    cap = table.shape[0]
    if table.dtype != torch.int64 or table.ndim != 1 or cap & (cap - 1) \
            or cap == 0:
        raise ValueError(f"hash table: want int64[2^k], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if count is not None and (count.dtype != torch.int32
                              or count.shape != ()):
        raise ValueError(f"hash count: want a 0-d int32, got {count.dtype} "
                         f"{tuple(count.shape)}")
    return cap


def _full_table() -> RuntimeError:
    return RuntimeError("hash set full: a probe visited every slot (grow "
                        "the table before it fills)")


def hashset_insert_plain(table, count, keys, valid):
    """Plain version of :func:`hashset_insert`: the reference's scan, one
    key at a time on the host. Returns ``(table, count, is_new)`` on the
    inputs' device; the inputs are not changed."""
    cap = _check_hash_table(table, count)
    t = table.cpu().numpy().copy()
    k = keys.cpu().numpy().astype(np.int64)
    ok = valid.cpu().numpy().astype(bool)
    h0 = _hash_np(k, cap - 1).tolist()
    cnt = int(count)
    is_new = np.zeros(k.shape[0], bool)
    for i in np.flatnonzero(ok).tolist():
        key = int(k[i])
        h = h0[i]
        for _ in range(cap):
            slot = int(t[h])
            if slot == HASH_EMPTY or slot == key:
                break
            h = (h + 1) & (cap - 1)
        else:
            raise _full_table()
        if slot == HASH_EMPTY:
            t[h] = key
            cnt += 1
            is_new[i] = True
    dev = table.device
    return (torch.from_numpy(t).to(dev),
            torch.tensor(cnt, dtype=torch.int32, device=dev),
            torch.from_numpy(is_new).to(dev))


def hashset_insert(table, count, keys, valid):
    """Insert the live ``keys`` (``int64``) into the open-addressing table
    ``table`` (``int64[2^k]``, :data:`HASH_EMPTY` free) in chunk order
    (``gelly_tpu``'s ``insert_chunk``): returns ``(table, count, is_new)``,
    ``is_new[i]`` set iff ``keys[i]`` was absent before position ``i``.
    The layout, ``count`` and ``is_new`` are bit for bit the reference's.

    On CPU tensors it runs :func:`hashset_insert_plain`; on CUDA tensors it
    launches entry 1 of ``csrc/hashset.cu`` on a copy of the table
    (counted in ``hashset_insert.launches``) or raises."""
    cap = _check_hash_table(table, count)
    _check_keys(table.device, keys, valid)
    if table.device.type == "cpu":
        return hashset_insert_plain(table, count, keys, valid)
    if table.device.type != "cuda":
        raise ValueError(f"hashset_insert runs on CPU or CUDA, got "
                         f"{table.device}")
    table = table.clone()
    count = count.clone()
    is_new = torch.zeros(keys.shape[0], dtype=torch.bool,
                         device=table.device)
    if keys.shape[0] == 0:
        return table, count, is_new
    status = torch.zeros((), dtype=torch.int32, device=table.device)
    from . import _build

    lib = _build.load("hashset")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hashset_insert_launch(
            table.data_ptr(), count.data_ptr(), keys.data_ptr(),
            valid.data_ptr(), is_new.data_ptr(), keys.shape[0], cap,
            status.data_ptr(), stream)
    if rc:
        msg = lib.hashset_error_string(rc).decode()
        raise RuntimeError(f"hashset_insert launch failed: {msg}")
    hashset_insert.launches += 1
    # A probe found no free slot: a full table raises.
    if int(status):  # graphlint: disable=GL003 -- one read a launch
        raise _full_table()
    return table, count, is_new


hashset_insert.launches = 0


def hashset_contains_plain(table, keys):
    """Plain version of :func:`hashset_contains` (vectorised probes)."""
    cap = _check_hash_table(table, None)
    t = table.cpu().numpy()
    k = keys.cpu().numpy().astype(np.int64)
    h = _hash_np(k, cap - 1).astype(np.int64)
    found = np.zeros(k.shape[0], bool)
    live = np.ones(k.shape[0], bool)
    for _ in range(cap):
        if not live.any():
            break
        slot = t[h]
        hit = live & (slot == k)
        found |= hit
        live &= ~hit & (slot != HASH_EMPTY)
        h = (h + 1) & (cap - 1)
    return torch.from_numpy(found).to(table.device)


def hashset_contains(table, keys):
    """``bool`` membership of ``keys`` in ``table`` (``gelly_tpu``'s
    ``contains_chunk``), nothing inserted. On CPU tensors it runs
    :func:`hashset_contains_plain`; on CUDA tensors it launches entry 2 of
    ``csrc/hashset.cu`` (one thread a key; counted in
    ``hashset_contains.launches``) or raises."""
    cap = _check_hash_table(table, None)
    _check_keys(table.device, keys, None)
    if table.device.type == "cpu":
        return hashset_contains_plain(table, keys)
    if table.device.type != "cuda":
        raise ValueError(f"hashset_contains runs on CPU or CUDA, got "
                         f"{table.device}")
    found = torch.zeros(keys.shape[0], dtype=torch.bool, device=table.device)
    if keys.shape[0] == 0:
        return found
    from . import _build

    lib = _build.load("hashset")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hashset_contains_launch(
            table.data_ptr(), keys.data_ptr(), found.data_ptr(),
            keys.shape[0], cap, stream)
    if rc:
        msg = lib.hashset_error_string(rc).decode()
        raise RuntimeError(f"hashset_contains launch failed: {msg}")
    hashset_contains.launches += 1
    return found


hashset_contains.launches = 0


def _check_keys(device, keys, valid) -> None:
    if keys.dtype != torch.int64 or keys.ndim != 1:
        raise ValueError(f"keys: want 1-D int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    for name, t in (("keys", keys), ("valid", valid)):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, table on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != keys.shape):
        raise ValueError(f"valid: want bool {tuple(keys.shape)}, got "
                         f"{valid.dtype} {tuple(valid.shape)}")


# ---------------------------------------------------------------------- #
# The capped-degree row insert of a chunk (csrc/row_insert.cu)


def _row_inserts(src, dst, valid, directed: bool):
    """A chunk's inserts in stream order: ``(a, b, ok)``; undirected, edge
    ``i`` inserts ``(u, v)`` then ``(v, u)``."""
    if directed:
        return src, dst, valid
    return (torch.stack([src, dst], 1).reshape(-1),
            torch.stack([dst, src], 1).reshape(-1),
            torch.stack([valid, valid], 1).reshape(-1))


def _check_rows(nbr, deg, over, src, dst, valid, max_degree: int) -> None:
    if nbr.dtype != torch.int32 or nbr.ndim != 2 \
            or nbr.shape[1] != max_degree:
        raise ValueError(f"nbr: want int32[N, {max_degree}], got "
                         f"{nbr.dtype} {tuple(nbr.shape)}")
    for name, t, shape in (("deg", deg, (nbr.shape[0],)), ("over", over, ())):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != nbr.device:
            raise ValueError(f"{name} on {t.device}, nbr on {nbr.device}")
    _check_lanes(nbr.device, src=src, dst=dst, valid=valid)


def row_insert_chunk_plain(nbr, deg, over, src, dst, valid,
                           directed: bool, max_degree: int):
    """Plain version of :func:`row_insert_chunk`: the reference's scan of
    ``row_insert``, one insert at a time (one host read of the lanes).
    Returns new ``(nbr, deg, over)``; the inputs are not changed."""
    _check_rows(nbr, deg, over, src, dst, valid, max_degree)
    nbr, deg = nbr.clone(), deg.clone()
    a, b, ok = _row_inserts(src, dst, valid, directed)
    for i in ok.cpu().nonzero().flatten().tolist():
        nbr, deg, over = row_insert(nbr, deg, over, a[i:i + 1], b[i:i + 1],
                                    ok[i:i + 1], max_degree)
    return nbr, deg, over.reshape(())


def row_insert_chunk(nbr, deg, over, src, dst, valid, directed: bool,
                     max_degree: int):
    """Insert a chunk's edges into the capped-degree row table with set
    semantics (``gelly_tpu``'s ``_row_step``): ``nbr`` ``int32[N, D]``
    (-1 empty), ``deg`` ``int32[N]``, ``over`` 0-d ``int32`` (inserts past
    the cap). Returns new ``(nbr, deg, over)``, bit for bit the
    reference's; the inputs are not changed.

    On CPU tensors it runs :func:`row_insert_chunk_plain`; on CUDA tensors
    it groups the live inserts by row with a stable sort and launches
    ``csrc/row_insert.cu``, one thread a row (counted in
    ``row_insert_chunk.launches``), or raises."""
    _check_rows(nbr, deg, over, src, dst, valid, max_degree)
    if nbr.device.type == "cpu":
        return row_insert_chunk_plain(nbr, deg, over, src, dst, valid,
                                      directed, max_degree)
    if nbr.device.type != "cuda":
        raise ValueError(f"row_insert_chunk runs on CPU or CUDA, got "
                         f"{nbr.device}")
    nbr, deg, over = nbr.clone(), deg.clone(), over.clone()
    a, b, ok = _row_inserts(src, dst, valid, directed)
    n = nbr.shape[0]
    key = torch.where(ok, a.to(torch.int64), n)
    key_s, order = torch.sort(key, stable=True)
    live = int((key_s < n).sum())  # graphlint: disable=GL003 -- the live inserts size the launch
    if live == 0:
        return nbr, deg, over
    rows = key_s[:live].to(torch.int32).contiguous()
    vals = b[order[:live]].contiguous()
    first = torch.ones(live, dtype=torch.bool, device=nbr.device)
    first[1:] = rows[1:] != rows[:-1]
    starts = torch.cat([first.nonzero().flatten(),  # graphlint: disable=GL003 -- the rows' run starts size the launch
                        torch.tensor([live], device=nbr.device)]
                       ).to(torch.int32)
    from . import _build

    lib = _build.load("row_insert")
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_insert_launch(
            nbr.data_ptr(), deg.data_ptr(), over.data_ptr(), rows.data_ptr(),
            vals.data_ptr(), starts.data_ptr(), starts.shape[0] - 1, n,
            max_degree, stream)
    if rc:
        msg = lib.row_insert_error_string(rc).decode()
        raise RuntimeError(f"row_insert_chunk launch failed: {msg}")
    row_insert_chunk.launches += 1
    return nbr, deg, over


row_insert_chunk.launches = 0


# --------------------------------------------------------------------- #
# the sampled triangle estimator's reservoir step

def _check_sampler(state, src, dst, valid) -> int:
    """The instance count ``S`` of a sampler state ``(src, trg, third,
    src_found, trg_found, v_at, edge_count, keys)``; raises on a field of
    another type, shape or device."""
    s = state[0].shape[0]
    want = (torch.int32, torch.int32, torch.int32, torch.bool, torch.bool,
            torch.int32, torch.int32, torch.int64)
    shapes = ((s,),) * 6 + ((), (s, 2))
    for x, dtype, shape in zip(state, want, shapes):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"sampler state field {x.dtype} "
                             f"{tuple(x.shape)}, want {dtype} {shape}")
    if any(x.device != state[0].device for x in state):
        raise ValueError("sampler state fields on different devices")
    _check_lanes(state[0].device, src=src, dst=dst, valid=valid)
    return s


def sampler_step_plain(state, src, dst, valid, num_vertices: int):
    """Plain PyTorch version of :func:`sampler_step`: the lanes one at a
    time (one host read of the chunk), each vectorised over the ``S``
    instances with :mod:`.threefry`. The third-vertex draw is taken only
    on lanes where some instance's coin lands (it changes nothing where
    none does)."""
    from . import threefry

    srcs, trg, third, src_found, trg_found, v_at, edge_count, keys = (
        x.clone() for x in state)
    span = torch.full_like(v_at, max(int(num_vertices) - 2, 1))
    ec = int(edge_count)
    for u, v, ok in zip(src.tolist(), dst.tolist(), valid.tolist()):
        ok = ok and u != v  # self-loops: no-op events
        parts = threefry.split(keys, 3)
        keys = parts[:, 0].contiguous()
        if not ok:
            continue
        # The f64 coin against the edge index rounded to f32, as JAX's
        # ``uniform(k1) * i.astype(f32) < 1.0`` compares under x64.
        fi = float(np.float32(ec + 1))
        coin = threefry.uniform(parts[:, 1]) * fi < 1.0
        if bool(coin.any()):
            a, b = min(u, v), max(u, v)
            cand = threefry.randint(parts[:, 2], span)
            cand = cand + (cand >= a).to(torch.int32)
            cand = cand + (cand >= b).to(torch.int32)
            srcs = torch.where(coin, u, srcs)
            trg = torch.where(coin, v, trg)
            third = torch.where(coin, cand, third)
            src_found = src_found & ~coin
            trg_found = trg_found & ~coin
            v_at = torch.where(coin, int(num_vertices), v_at)
        src_found |= (((srcs == u) & (third == v))
                      | ((third == u) & (srcs == v)))
        trg_found |= (((trg == u) & (third == v))
                      | ((third == u) & (trg == v)))
        ec += 1
    edge_count = torch.full_like(edge_count, ec)
    return srcs, trg, third, src_found, trg_found, v_at, edge_count, keys


def sampler_step(state, src, dst, valid, num_vertices: int):
    """One chunk of the sampled triangle estimator's reservoir step
    (``gelly_tpu``'s ``_sampler_step``): every instance walks every lane
    in stream order. A lane splits each key in three (the next key, the
    coin's, the draw's); a live lane (``valid`` and not a self-loop) flips
    the f64 coin ``uniform * f32(i) < 1`` (``i`` the 1-based live edge
    index), resamples the instance's edge and third vertex (uniform over
    ``[0, max(V-2, 1))`` shifted past both endpoints) where it lands, and
    marks the wedge edges it closes. ``state`` is the tuple ``(src, trg,
    third, src_found, trg_found, v_at, edge_count, keys)`` (``keys``
    ``int64 [S, 2]`` holding ``u32`` values); returns the new one, the
    input's tensors unchanged.

    On CPU tensors it runs :func:`sampler_step_plain`; on CUDA tensors it
    launches ``csrc/sampler_step.cu`` (one thread an instance, counted in
    ``sampler_step.launches``) on copies of the state, or raises."""
    s = _check_sampler(state, src, dst, valid)
    dev = state[0].device
    if dev.type == "cpu":
        return sampler_step_plain(state, src, dst, valid, num_vertices)
    if dev.type != "cuda":
        raise ValueError(f"sampler_step runs on CPU or CUDA, got {dev}")
    out = [x.clone() for x in state]
    n_lanes = src.shape[0]
    if s == 0 or n_lanes == 0:
        return tuple(out)
    from . import _build

    lib = _build.load("sampler_step")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sampler_step_launch(
            *(x.data_ptr() for x in out), src.data_ptr(), dst.data_ptr(),
            valid.data_ptr(), n_lanes, s, int(num_vertices), stream)
    if rc:
        msg = lib.sampler_step_error_string(rc).decode()
        raise RuntimeError(f"sampler_step launch failed: {msg}")
    sampler_step.launches += 1
    live = (valid & (src != dst)).sum(dtype=torch.int32)
    out[6] = state[6] + live
    return tuple(out)


sampler_step.launches = 0
