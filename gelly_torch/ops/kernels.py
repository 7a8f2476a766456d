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
  combine's ``lax.while_loop`` of 64-candidate batches), and
  :func:`sparse_fold_chunk_k2`, the wrapper of ``csrc/spanner_fold_k2.cu``,
  replacing ``_sparse_fold_chunk_k2`` (the ``gate_batch`` fold's
  ``lax.scan`` of sub-batches); they update the sparse spanner summary's
  tensors in place;
- :func:`matching_step` — the wrapper of ``csrc/matching_step.cu``,
  replacing ``gelly_tpu/library/matching.py``'s ``_matching_step``.

- :func:`hashset_insert` and :func:`hashset_contains` — the wrappers of
  ``csrc/hashset.cu``, replacing ``gelly_tpu/ops/hashset.py``'s
  ``insert_chunk`` and ``contains_chunk``;
- :func:`row_insert_chunk` — the wrapper of ``csrc/row_insert.cu``,
  replacing ``gelly_tpu/core/neighborhood.py``'s ``_row_step``;
- :func:`sampler_step` — the wrapper of ``csrc/sampler_step.cu``,
  replacing ``gelly_tpu/library/triangles.py``'s ``_sampler_step``;
- :func:`rooted_fixpoint`, :func:`pointer_jump` and :func:`union_edges`
  — the wrappers of the three kernels of ``csrc/unionfind_fixpoint.cu``,
  replacing ``gelly_tpu/ops/unionfind.py``'s ``_chase_roots`` /
  ``_rooted_fixpoint``, ``pointer_jump`` and ``union_edges`` loops, every
  round on the card;
- :func:`union_edges_parity` and :func:`pointer_jump_parity` — the
  wrappers of the two parity entries of the same file, replacing
  ``gelly_tpu/ops/parity_unionfind.py``'s ``union_edges_parity`` and
  ``pointer_jump_parity`` loops (the bipartiteness summary), every round
  on the card.

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
from .segments import INT_MAX, masked_scatter_min

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
    lib, _ = _gate_library(nbr, max_degree, frontier_cap, k, 0)
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
                  batch: int) -> tuple[ctypes.CDLL, int]:
    """The loaded gate library and the groups of one launch: 1 for entry
    1 (``batch`` 0), whose block is one group; for entry 2 the warps of
    each block, a warp a candidate. Checks the device and that a block's
    shared memory fits the card."""
    if nbr.device.type != "cuda":
        raise ValueError(f"the spanner gates run on CPU or CUDA, got "
                         f"{nbr.device}")
    if max_degree < 1 or frontier_cap < 1:
        raise ValueError(f"max_degree {max_degree} and frontier_cap "
                         f"{frontier_cap} must be positive")
    from . import _build

    lib = _build.load("spanner_gate")
    groups = 1 if batch == 0 else lib.spanner_gate_groups(
        max_degree, frontier_cap, k, batch)
    need = lib.spanner_gate_smem_bytes(max_degree, frontier_cap, k, batch,
                                       max(groups, 1))
    if groups == 0 or need > lib.spanner_gate_smem_limit():
        raise ValueError(
            f"the spanner gate needs {need} B of shared memory for "
            f"max_degree={max_degree}, frontier_cap={frontier_cap}, k={k}, "
            f"more than the card's {lib.spanner_gate_smem_limit()} B")
    return lib, groups


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
    CUDA tensors it launches entry 2 of ``csrc/spanner_gate.cu`` (a
    cluster of four blocks, a warp a candidate, the whole loop,
    ``n_valid`` read on the device; counted in
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
    lib, groups = _gate_library(nbr, max_degree, frontier_cap, k, batch)
    if csrc.shape[0] == 0:
        return None
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spanner_sparse_insert_edges_batched(
            nbr.data_ptr(), deg.data_ptr(), dover.data_ptr(),
            esrc.data_ptr(), edst.data_ptr(), n.data_ptr(),
            overflow.data_ptr(), csrc.data_ptr(), cdst.data_ptr(),
            n_valid.data_ptr(), csrc.shape[0], nbr.shape[0], esrc.shape[0],
            k, max_degree, frontier_cap, batch, groups, stream)
    if rc:
        msg = lib.spanner_gate_error_string(rc).decode()
        raise RuntimeError(
            f"spanner_sparse_insert_edges_batched failed: {msg}")
    sparse_insert_edges_batched.launches += 1
    return None


sparse_insert_edges_batched.launches = 0


# ------------------------------------------------------------------ #
# The k = 2 chunk fold (csrc/spanner_fold_k2.cu)

def sparse_fold_chunk_k2_plain(nbr, deg, dover, esrc, edst, n, overflow,
                               src, dst, valid, max_degree: int,
                               sub: int) -> None:
    """Plain PyTorch version of :func:`sparse_fold_chunk_k2`: the chunk in
    ``sub``-lane sub-batches, each gated against the rows as they stand at
    its start (direct neighbour or a shared entry), deduplicated by the
    ``int64`` key ``min * N + max`` (first lane kept), then two
    ``row_append_batch`` passes and the edge-list append; no host sync."""
    D = max_degree
    B = src.shape[0]
    pad = (-B) % sub
    u_all = torch.nn.functional.pad(src, (0, pad))
    v_all = torch.nn.functional.pad(dst, (0, pad))
    ok_all = torch.nn.functional.pad(valid, (0, pad))
    n_cap = nbr.shape[0]
    over = dover.clone()
    minus = torch.full((), -1, dtype=torch.int64, device=src.device)
    for lo in range(0, B + pad, sub):
        uu, vv = u_all[lo:lo + sub], v_all[lo:lo + sub]
        live = ok_all[lo:lo + sub] & (uu != vv)
        ru = nbr[uu.long()]  # [sub, D]
        rv = nbr[vv.long()]
        direct = (ru == vv[:, None]).any(dim=1)
        common = ((ru[:, :, None] == rv[:, None, :])
                  & (ru[:, :, None] >= 0)).flatten(1).any(dim=1)
        take = live & ~(direct | common)
        a_ = torch.minimum(uu, vv).long()
        b_ = torch.maximum(uu, vv).long()
        key = torch.where(take, a_ * n_cap + b_, minus)
        skey, sidx = torch.sort(key, stable=True)
        first = skey != torch.roll(skey, 1)
        first[0] = True
        first &= skey >= 0
        take = torch.zeros_like(take).scatter(0, sidx, first)
        for a, b in ((uu, vv), (vv, uu)):
            nbr, deg, over = row_append_batch(nbr, deg, over, a, b, take, D)
        append_edges_plain(esrc, edst, n, overflow, uu, vv, take)
    dover.copy_(over)


def sparse_fold_chunk_k2(nbr, deg, dover, esrc, edst, n, overflow, src,
                         dst, valid, max_degree: int, sub: int) -> None:
    """Fold a chunk's lanes ``(src, dst, valid)`` into a sparse spanner
    summary given field by field (as in :func:`sparse_insert_edges`,
    updated in place) with the closed-form distance-2 gate, ``sub`` lanes
    at a time: ``gelly_tpu``'s ``_sparse_fold_chunk_k2`` bit for bit. Each
    sub-batch gates its live lanes against the rows as they stand at its
    start (rejected: ``dst`` in the row of ``src``, or the two rows share
    an entry ``>= 0``), keeps the first lane of each unordered pair, then
    appends ``src -> dst`` for every kept lane and ``dst -> src`` after
    them (an append to a row in lane order; one past ``max_degree``
    counted in ``dover``), and the kept lanes to the edge list in lane
    order. Rows must hold ``-1`` past their fill count, as every summary
    does.

    On CPU tensors it runs :func:`sparse_fold_chunk_k2_plain`; on CUDA
    tensors it launches ``csrc/spanner_fold_k2.cu`` (a prepass over the
    chunk, one cooperative launch that walks every sub-batch with one grid
    barrier each, and a last launch that writes the edge list; counted
    once a call in ``sparse_fold_chunk_k2.launches``) or raises. A chunk
    holds at most ``2^30 - 1`` lanes on the card. Each launch leaves in
    ``sparse_fold_chunk_k2.barriers`` a 1-element ``int32`` tensor on the
    card that the kernel fills with the grid barriers it met, read off its
    barrier counter (``-1`` if the counter is not a whole number of
    barriers); reading it syncs, so the wrapper never does."""
    _check_spanner_state(nbr, deg, dover, esrc, edst, n, overflow,
                         max_degree)
    _check_lanes(nbr.device, src=src, dst=dst, valid=valid)
    if sub < 1:
        raise ValueError(f"sub must be positive, got {sub}")
    if nbr.device.type == "cpu":
        return sparse_fold_chunk_k2_plain(
            nbr, deg, dover, esrc, edst, n, overflow, src, dst, valid,
            max_degree, sub)
    if nbr.device.type != "cuda":
        raise ValueError(f"the k = 2 fold runs on CPU or CUDA, got "
                         f"{nbr.device}")
    B = src.shape[0]
    if B == 0:
        return None
    span = min(sub, B)
    from . import _build

    lib = _build.load("spanner_fold_k2")
    scratch = torch.empty(lib.spanner_fold_k2_scratch_ints(B, span),
                          dtype=torch.int32, device=nbr.device)
    met = torch.empty(1, dtype=torch.int32, device=nbr.device)
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spanner_fold_k2_launch(
            nbr.data_ptr(), deg.data_ptr(), dover.data_ptr(),
            esrc.data_ptr(), edst.data_ptr(), n.data_ptr(),
            overflow.data_ptr(), src.data_ptr(), dst.data_ptr(),
            valid.data_ptr(), scratch.data_ptr(), met.data_ptr(), B,
            nbr.shape[0], esrc.shape[0], max_degree, span, stream)
    if rc:
        msg = lib.spanner_fold_k2_error_string(rc).decode()
        raise RuntimeError(f"spanner_fold_k2 launch failed: {msg}")
    sparse_fold_chunk_k2.launches += 1
    sparse_fold_chunk_k2.barriers = met
    return None


sparse_fold_chunk_k2.launches = 0
sparse_fold_chunk_k2.barriers = None


def sparse_fold_chunk_k2_floor(nbr, src, max_degree: int, sub: int) -> None:
    """The chain floor of :func:`sparse_fold_chunk_k2` on the card: a
    launch of the kernel's shape over the lanes ``src`` in ``sub``-lane
    sub-batches that runs only its grid barriers and one dependent row
    read a lane a sub-batch (row ``src[lane]``, as the gate reads it),
    with nothing written to the summary. A measurement, not a path: it
    counts no launch."""
    if nbr.device.type != "cuda" or src.device != nbr.device:
        raise ValueError(f"the chain floor runs on a card, got {nbr.device} "
                         f"and {src.device}")
    _check_lanes(nbr.device, src=src)
    if nbr.dtype != torch.int32 or nbr.ndim != 2 \
            or nbr.shape[1] != max_degree or not nbr.is_contiguous():
        raise ValueError(f"nbr: want contiguous i32[n, {max_degree}], got "
                         f"{nbr.dtype} {tuple(nbr.shape)}")
    B = src.shape[0]
    if B == 0 or sub < 1:
        return None
    span = min(sub, B)
    from . import _build

    lib = _build.load("spanner_fold_k2")
    scratch = torch.empty(lib.spanner_fold_k2_scratch_ints(B, span),
                          dtype=torch.int32, device=nbr.device)
    sink = torch.zeros(1, dtype=torch.int32, device=nbr.device)
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.spanner_fold_k2_floor(
            nbr.data_ptr(), src.data_ptr(), scratch.data_ptr(),
            sink.data_ptr(), B, nbr.shape[0], max_degree, span, stream)
    if rc:
        msg = lib.spanner_fold_k2_error_string(rc).decode()
        raise RuntimeError(f"spanner_fold_k2_floor launch failed: {msg}")
    return None


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
    launches entry 1 of ``csrc/hashset.cu`` on a copy of the table (the
    keys walk in parallel and settle in the scan's layout; counted once a
    call in ``hashset_insert.launches``) or raises."""
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
    from . import _build

    lib = _build.load("hashset")
    # The launch's work area; its first word is the full-table flag.
    work = torch.empty(lib.hashset_insert_work_ints(keys.shape[0], cap),
                       dtype=torch.int32, device=table.device)
    status = work[0]
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hashset_insert_launch(
            table.data_ptr(), count.data_ptr(), keys.data_ptr(),
            valid.data_ptr(), is_new.data_ptr(), keys.shape[0], cap,
            work.data_ptr(), stream)
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


# ------------------------------------------------------------------ #
# The union-find fixpoints (csrc/unionfind_fixpoint.cu)

def _check_forest(parent: torch.Tensor) -> None:
    if parent.dtype != torch.int32 or parent.ndim != 1:
        raise ValueError(f"forest: want 1-D int32, got {parent.dtype} "
                         f"{tuple(parent.shape)}")


def _check_scalars(device, **scalars) -> None:
    for name, t in scalars.items():
        if t is not None and (t.numel() != 1 or t.device != device):
            raise ValueError(f"{name}: want one element on {device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _fixpoint_library():
    from . import _build

    return _build.load("unionfind_fixpoint")


def _fixpoint_failed(lib, what: str, rc: int) -> RuntimeError:
    msg = lib.unionfind_error_string(rc).decode()
    return RuntimeError(f"{what} launch failed: {msg}")


def chase_roots_plain(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pair-sized pointer chase of ``x`` to its TRUE roots in the forest
    ``p`` (``gelly_tpu``'s ``_chase_roots``): one counted host sync a
    level."""
    from .unionfind import _any

    g = p[x]
    while _any(g != x):
        x, g = g, p[g]
    return x


def rooted_fixpoint_plain(parent, x, y, valid=None, *, star: bool = False,
                          gate=None, n_valid=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rooted_fixpoint`: the reference's
    ``_rooted_fixpoint`` loop, one counted host sync a round and a chase
    level (:func:`chase_roots_plain`), and one for ``gate``. Leaves its
    rounds in ``rooted_fixpoint_plain.rounds``."""
    from .unionfind import _any, host_sync

    rooted_fixpoint_plain.rounds = 0
    if gate is not None and not bool(host_sync(gate)):
        return parent.clone()
    act = valid
    if act is None:
        act = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    if n_valid is not None:
        act = act & (torch.arange(x.shape[0], device=x.device) < n_valid)
    p = parent
    rounds = 0
    while True:
        rounds += 1
        ru = chase_roots_plain(p, x)
        rv = ru[y] if star else chase_roots_plain(p, y)
        lo = torch.minimum(ru, rv)
        hi = torch.maximum(ru, rv)
        live = act & (lo != hi)
        p = masked_scatter_min(p, hi, lo, live)
        if not _any(live):
            break
    rooted_fixpoint_plain.rounds = rounds
    return p


rooted_fixpoint_plain.rounds = 0


def rooted_fixpoint(parent, x, y, valid=None, *, star: bool = False,
                    gate=None, n_valid=None) -> torch.Tensor:
    """The exact hook loop of the pair-sized unions (``gelly_tpu``'s
    ``_rooted_fixpoint`` with its ``_chase_roots``): each round chases
    the lanes to their TRUE roots in the forest as it stood at the
    round's start, then hooks ``max(ru, rv) -> min(ru, rv)`` with one
    scatter-min over the live lanes (valid, roots apart); it ends after
    the first round with no live lane. Returns a new forest.

    The pair form takes ``rv`` as the chase of ``y``; the star form
    (``star=True``) takes ``rv = ru[y]`` (``y`` is the row index ``ri``,
    every lane's ``ru`` chased). ``x`` and ``y`` are ``int32`` lanes, in
    range on every lane; a lane is valid where ``valid`` (``bool``, None:
    every lane) holds and it lies below ``n_valid`` (a one-element device
    integer, None: no bound). ``gate`` (a one-element device ``bool``,
    None: open) closed runs no round.

    On CPU tensors it runs :func:`rooted_fixpoint_plain`; on CUDA tensors
    it launches ``csrc/unionfind_fixpoint.cu`` (one cooperative launch,
    counted in ``rooted_fixpoint.launches``) or raises. The kernel reads
    ``gate`` and ``n_valid`` itself, so nothing here syncs; each launch
    leaves in ``rooted_fixpoint.met`` a 1-element ``int32`` device tensor
    with the rounds it met (0 for a closed gate, -1 if a walk passed the
    slot count: a cycle)."""
    _check_forest(parent)
    lanes = {"x": x, "ri" if star else "y": y}
    if valid is not None:
        lanes["valid"] = valid
    _check_lanes(parent.device, **lanes)
    _check_scalars(parent.device, gate=gate, n_valid=n_valid)
    if parent.device.type == "cpu":
        return rooted_fixpoint_plain(parent, x, y, valid, star=star,
                                     gate=gate, n_valid=n_valid)
    if parent.device.type != "cuda":
        raise ValueError(f"rooted_fixpoint runs on CPU or CUDA, got "
                         f"{parent.device}")
    p = parent.clone(memory_format=torch.contiguous_format)
    n, L = p.shape[0], x.shape[0]
    if n == 0:
        return p
    lib = _fixpoint_library()
    scratch = torch.empty(lib.unionfind_scratch_ints(L, int(star)),
                          dtype=torch.int32, device=p.device)
    met = torch.empty(1, dtype=torch.int32, device=p.device)
    g = None if gate is None else gate.reshape(1).to(torch.bool)
    nv = None if n_valid is None else torch.clamp(
        n_valid.reshape(1), max=L).to(torch.int32)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.unionfind_rooted_fixpoint_launch(
            p.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if nv is None else nv.data_ptr(),
            None if g is None else g.data_ptr(), scratch.data_ptr(),
            met.data_ptr(), L, n, int(star), stream)
    if rc:
        raise _fixpoint_failed(lib, "rooted_fixpoint", rc)
    rooted_fixpoint.launches += 1
    rooted_fixpoint.met = met
    return p


rooted_fixpoint.launches = 0
rooted_fixpoint.met = None


def pointer_jump_plain(parent: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pointer_jump`: the reference's
    doubling loop ``p <- p[p]``, one counted host sync a round; leaves
    its doubling rounds in ``pointer_jump_plain.rounds``."""
    from .unionfind import _any

    p = parent
    rounds = 0
    while True:
        pp = p[p]
        if not _any(pp != p):
            break
        p = pp
        rounds += 1
    pointer_jump_plain.rounds = rounds
    return p


pointer_jump_plain.rounds = 0


def pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: every slot's root (``gelly_tpu``'s
    ``pointer_jump``, whose doubling loop ends at exactly that). On CPU
    tensors it runs :func:`pointer_jump_plain`; on CUDA tensors it
    launches ``csrc/unionfind_fixpoint.cu`` (one plain launch, a thread
    a slot walking to its root, written to a new tensor; counted in
    ``pointer_jump.launches``) or raises. Each launch leaves in
    ``pointer_jump.met`` a 1-element ``int32`` device tensor with its
    longest walk in hops (``d`` hops take the reference
    ``ceil(log2(d))`` doubling rounds)."""
    _check_forest(parent)
    if parent.device.type == "cpu":
        return pointer_jump_plain(parent)
    if parent.device.type != "cuda":
        raise ValueError(f"pointer_jump runs on CPU or CUDA, got "
                         f"{parent.device}")
    p = parent.contiguous()
    out = torch.empty_like(p)
    if p.shape[0] == 0:
        return out
    lib = _fixpoint_library()
    longest = torch.empty(1, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.unionfind_pointer_jump_launch(
            p.data_ptr(), out.data_ptr(), longest.data_ptr(), p.shape[0],
            stream)
    if rc:
        raise _fixpoint_failed(lib, "pointer_jump", rc)
    pointer_jump.launches += 1
    pointer_jump.met = longest
    return out


pointer_jump.launches = 0
pointer_jump.met = None


def union_edges_plain(parent, src, dst, valid=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`union_edges`: the reference's
    Shiloach-Vishkin loop, one counted host sync a round, then
    :func:`pointer_jump_plain`; leaves its rounds in
    ``union_edges_plain.rounds``."""
    from .unionfind import _any

    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool,
                           device=src.device)
    p = parent
    rounds = 0
    while True:
        rounds += 1
        lu = p[src]
        lv = p[dst]
        lo = torch.minimum(lu, lv)
        hi = torch.maximum(lu, lv)
        live = valid & (lo != hi)
        p2 = masked_scatter_min(p, hi, lo, live)
        p2 = p2[p2]  # one doubling step (monotone: p2[i] <= i)
        changed = _any(p2 != p)
        p = p2
        if not changed:
            break
    union_edges_plain.rounds = rounds
    return pointer_jump_plain(p)


union_edges_plain.rounds = 0


def union_edges(parent, src, dst, valid=None) -> torch.Tensor:
    """Union every valid ``(src, dst)`` edge into the forest and return
    the compressed forest (``gelly_tpu``'s ``union_edges``): each round
    one scatter-min hook of ``max(p[src], p[dst]) -> min(...)`` read from
    the forest at the round's start and one doubling step, until a round
    changes nothing, then :func:`pointer_jump`. ``src`` and ``dst`` are
    ``int32`` lanes in range; ``valid`` a ``bool`` mask (None: every
    lane).

    On CPU tensors it runs :func:`union_edges_plain`; on CUDA tensors it
    launches ``csrc/unionfind_fixpoint.cu`` (one cooperative launch for
    the rounds, counted in ``union_edges.launches``, then
    :func:`pointer_jump`) or raises. Each launch leaves in
    ``union_edges.met`` a 1-element ``int32`` device tensor with the
    rounds it met."""
    _check_forest(parent)
    lanes = {"src": src, "dst": dst}
    if valid is not None:
        lanes["valid"] = valid
    _check_lanes(parent.device, **lanes)
    if parent.device.type == "cpu":
        return union_edges_plain(parent, src, dst, valid)
    if parent.device.type != "cuda":
        raise ValueError(f"union_edges runs on CPU or CUDA, got "
                         f"{parent.device}")
    r = parent.clone(memory_format=torch.contiguous_format)
    n = r.shape[0]
    if n == 0:
        return r
    s = r.clone()
    t = torch.empty_like(r)
    lib = _fixpoint_library()
    scratch = torch.empty(lib.unionfind_scratch_ints(0, -1),
                          dtype=torch.int32, device=r.device)
    met = torch.empty(1, dtype=torch.int32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.unionfind_union_edges_launch(
            r.data_ptr(), s.data_ptr(), t.data_ptr(), src.data_ptr(),
            dst.data_ptr(), None if valid is None else valid.data_ptr(),
            scratch.data_ptr(), met.data_ptr(), src.shape[0], n, stream)
    if rc:
        raise _fixpoint_failed(lib, "union_edges", rc)
    union_edges.launches += 1
    union_edges.met = met
    del s, t  # the scratch goes back before the jump takes its output
    return pointer_jump(r)


union_edges.launches = 0
union_edges.met = None


# ------------------------------------------------------------------ #
# The parity union-find (csrc/unionfind_fixpoint.cu, parity entries)

def _check_parity(parent: torch.Tensor, rel: torch.Tensor) -> None:
    _check_forest(parent)
    if rel.dtype != torch.int32 or rel.shape != parent.shape:
        raise ValueError(f"rel: want int32 {tuple(parent.shape)}, got "
                         f"{rel.dtype} {tuple(rel.shape)}")
    if rel.device != parent.device:
        raise ValueError(f"rel on {rel.device}, parent on {parent.device}")


def pointer_jump_parity_plain(parent: torch.Tensor, rel: torch.Tensor):
    """Plain PyTorch version of :func:`pointer_jump_parity`: the
    reference's doubling loop ``p, r <- p[p], r ^ r[p]``, one counted
    host sync a round; leaves its doubling rounds in
    ``pointer_jump_parity_plain.rounds``."""
    from .unionfind import _any

    p, r = parent, rel
    rounds = 0
    while True:
        pp = p[p]
        if not _any(pp != p):
            break
        p, r = pp, r ^ r[p]
        rounds += 1
    pointer_jump_parity_plain.rounds = rounds
    return p, r


pointer_jump_parity_plain.rounds = 0


def pointer_jump_parity(parent: torch.Tensor, rel: torch.Tensor):
    """Full path compression carrying parity (``gelly_tpu``'s
    ``pointer_jump_parity``): ``(parent', rel')``, new tensors. The
    reference doubles ``p, r <- p[p], r ^ r[p]`` while some slot is at
    depth 2 or more, so with no slot that deep the input comes back as
    it was; otherwise each slot gets its root, and as ``rel`` the XOR of
    ``rel`` along its path without the root's, XORed with the root's
    ``rel`` where its depth is odd (a root gets 0).

    On CPU tensors it runs :func:`pointer_jump_parity_plain`; on CUDA
    tensors it launches ``csrc/unionfind_fixpoint.cu`` (a thread a slot
    walks to its root, then a launch that reads the longest walk on the
    card and puts the input ``rel`` back where it is under 2 hops;
    counted once in ``pointer_jump_parity.launches``) or raises. Each
    call leaves in ``pointer_jump_parity.met`` a 1-element ``int32``
    device tensor with its longest walk in hops (-1 past the slot count:
    a cycle)."""
    _check_parity(parent, rel)
    if parent.device.type == "cpu":
        return pointer_jump_parity_plain(parent, rel)
    if parent.device.type != "cuda":
        raise ValueError(f"pointer_jump_parity runs on CPU or CUDA, got "
                         f"{parent.device}")
    p, r = parent.contiguous(), rel.contiguous()
    out_p, out_r = torch.empty_like(p), torch.empty_like(r)
    n = p.shape[0]
    if n == 0:
        return out_p, out_r
    lib = _fixpoint_library()
    scratch = torch.empty(lib.unionfind_scratch_ints(0, -1),
                          dtype=torch.int32, device=p.device)
    met = torch.empty(1, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.unionfind_pointer_jump_parity_launch(
            p.data_ptr(), r.data_ptr(), out_p.data_ptr(), out_r.data_ptr(),
            scratch.data_ptr(), met.data_ptr(), n, stream)
    if rc:
        raise _fixpoint_failed(lib, "pointer_jump_parity", rc)
    pointer_jump_parity.launches += 1
    pointer_jump_parity.met = met
    return out_p, out_r


pointer_jump_parity.launches = 0
pointer_jump_parity.met = None


def union_edges_parity_plain(parent, rel, failed, u, v, q, valid=None):
    """Plain PyTorch version of :func:`union_edges_parity`: the
    reference's loop, one counted host sync a round, then
    :func:`pointer_jump_parity_plain`; leaves its rounds in
    ``union_edges_parity_plain.rounds``."""
    from .unionfind import _any

    if valid is None:
        valid = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    p, r = parent, rel
    rounds = 0
    while True:
        rounds += 1
        lu, lv = p[u], p[v]
        link_q = r[u] ^ r[v] ^ q
        same = lu == lv
        failed = failed | (valid & same & (link_q == 1)).any()
        live = valid & ~same
        lo = torch.minimum(lu, lv)
        hi = torch.maximum(lu, lv)
        # Ties on one (hi, lo) pair with opposite parity resolve to one
        # link now and surface as a same-parent conflict a round later.
        packed = masked_scatter_min(p * 2 + r, hi, lo * 2 + link_q, live)
        p2, r2 = packed >> 1, packed & 1
        p3 = p2[p2]
        r3 = r2 ^ r2[p2]
        changed = _any((p3 != p) | (r3 != r))
        p, r = p3, r3
        if not changed:
            break
    union_edges_parity_plain.rounds = rounds
    p, r = pointer_jump_parity_plain(p, r)
    return p, r, failed


union_edges_parity_plain.rounds = 0


def union_edges_parity(parent, rel, failed, u, v, q, valid=None):
    """Union every valid lane ``(u, v)`` with required parity ``q``
    between its endpoints into the parity forest ``(parent, rel,
    failed)`` (``gelly_tpu``'s ``union_edges_parity``) and return the
    compressed forest ``(parent', rel', failed')``, new tensors.

    Each round reads ``p[u], p[v]`` and ``rel[u] ^ rel[v] ^ q`` from the
    forest at the round's start; a valid lane whose endpoints share a
    parent against that parity sets ``failed``, the others hook
    ``max -> min`` through one scatter-min of the packed word
    ``parent * 2 + rel``; then one parity-carrying doubling step. The
    loop ends after the first round in which no word moved, then
    :func:`pointer_jump_parity`. ``u``, ``v`` and ``q`` are ``int32``
    lanes (``u``, ``v`` in range on every lane), ``valid`` a
    ``bool`` mask (None: every lane), ``failed`` a one-element ``bool``
    tensor. The packed word is ``int32``: a forest of ``2^30`` slots or
    more is refused on every device, where the reference would overflow.

    On CPU tensors it runs :func:`union_edges_parity_plain`; on CUDA
    tensors it launches ``csrc/unionfind_fixpoint.cu`` (one cooperative
    launch for the rounds, counted in ``union_edges_parity.launches``,
    then :func:`pointer_jump_parity`) or raises. ``failed'`` stays on the
    card. Each launch leaves in ``union_edges_parity.met`` a 1-element
    ``int32`` device tensor with the rounds it met."""
    _check_parity(parent, rel)
    n = parent.shape[0]
    if 2 * n >= INT_MAX:
        raise ValueError(
            "union_edges_parity: vertex capacity must be < 2^30 "
            f"(got {n}; the packed parity scatter word is int32)")
    lanes = {"u": u, "v": v, "q": q}
    if valid is not None:
        lanes["valid"] = valid
    _check_lanes(parent.device, **lanes)
    _check_scalars(parent.device, failed=failed)
    if failed.dtype != torch.bool:
        raise ValueError(f"failed: want bool, got {failed.dtype}")
    if parent.device.type == "cpu":
        return union_edges_parity_plain(parent, rel, failed, u, v, q, valid)
    if parent.device.type != "cuda":
        raise ValueError(f"union_edges_parity runs on CPU or CUDA, got "
                         f"{parent.device}")
    if n == 0:
        return parent.clone(), rel.clone(), failed.clone()
    w = parent * 2 + rel
    s = w.clone()
    t = torch.empty_like(w)
    lib = _fixpoint_library()
    scratch = torch.empty(lib.unionfind_scratch_ints(0, -1),
                          dtype=torch.int32, device=w.device)
    odd = torch.empty(1, dtype=torch.int32, device=w.device)
    met = torch.empty(1, dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.unionfind_union_edges_parity_launch(
            w.data_ptr(), s.data_ptr(), t.data_ptr(), u.data_ptr(),
            v.data_ptr(), q.data_ptr(),
            None if valid is None else valid.data_ptr(), scratch.data_ptr(),
            odd.data_ptr(), met.data_ptr(), u.shape[0], n, stream)
    if rc:
        raise _fixpoint_failed(lib, "union_edges_parity", rc)
    union_edges_parity.launches += 1
    union_edges_parity.met = met
    del s, t  # the scratch goes back before the jump takes its output
    p, r = pointer_jump_parity(w >> 1, w & 1)
    return p, r, failed | (odd[0] != 0).reshape(failed.shape)


union_edges_parity.launches = 0
union_edges_parity.met = None
