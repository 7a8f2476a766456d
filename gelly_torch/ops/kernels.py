"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``gelly_tpu/ops/pallas_kernels.py``, both of its kernels:

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

Both keep the reference's contract bit for bit, including which lanes come
back ``-1``, and :func:`gatherable` is the reference's, so both packages
accept the same tables. The 2^24 value bound exists only because the TPU
kernel routes values through an f32 matmul; it is kept so the two packages
agree on what they accept.
"""

from __future__ import annotations

import torch

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


def _geometry(table: torch.Tensor, sidx: torch.Tensor, window_rows: int):
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
    values_exact = bool(
        (table.min() >= 0) & (table.max() < GATHER_MAX_VALUE))
    if not values_exact:
        return table[idx]
    sidx, order = torch.sort(idx.to(torch.int32), stable=True)
    svals = sorted_window_gather(
        table, sidx, window_rows=window_rows, tile=tile)
    vals = torch.empty_like(svals)
    vals[order] = svals
    miss = vals < 0
    if bool(miss.any()):
        vals = torch.where(miss, table[idx], vals)
    return vals
