"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``gelly_tpu/ops/pallas_kernels.py``, both of its kernels:

- :func:`wedge_count_matrix` — the wrapper of the CUDA kernel
  ``csrc/wedge_count_matrix.cu`` (replacing the Pallas ``_wedge_kernel``):
  ``W = MᵀM`` for the window-triangle wedge mask. On a CPU tensor it runs
  :func:`wedge_count_matrix_plain`; on a CUDA tensor it launches the
  kernel or raises. ``wedge_count_matrix.launches`` counts launches.
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


def _check_wedge_mask(m: torch.Tensor) -> int:
    """Side ``n`` of a square wedge mask; raises like the reference on a
    side that is not a multiple of :data:`TILE`.

    The reference casts any input to f32; the port takes ``bool`` only
    (its stated contract) and raises ``TypeError`` otherwise."""
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"wedge mask must be square, got shape {tuple(m.shape)}")
    n = m.shape[0]
    if n % TILE:
        raise ValueError(f"wedge matrix size {n} not a multiple of {TILE}")
    if m.dtype != torch.bool:
        raise TypeError(f"wedge_count_matrix takes a bool mask, got {m.dtype}")
    return n


def wedge_count_matrix_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`wedge_count_matrix` on any device:
    an f32 product, exact for 0/1 entries while counts stay below 2^24."""
    _check_wedge_mask(m)
    mf = m.to(torch.float32)
    return mf.T @ mf


def wedge_count_matrix(m: torch.Tensor) -> torch.Tensor:
    """``W = MᵀM`` in f32 for a square bool wedge mask ``M[u, x]`` whose
    side is a multiple of 128: ``W[a, b]`` counts the rows ``u`` set in
    both columns ``a`` and ``b`` (common smaller neighbours of ``a`` and
    ``b``), the whole matrix, as the reference's Pallas kernel writes it.

    A CPU mask runs :func:`wedge_count_matrix_plain`; a CUDA mask (which
    must be contiguous) launches the kernel, counted in
    ``wedge_count_matrix.launches``, or raises.
    """
    n = _check_wedge_mask(m)
    if m.device.type == "cpu":
        return wedge_count_matrix_plain(m)
    if m.device.type != "cuda":
        raise ValueError(f"wedge_count_matrix runs on CPU or CUDA, got {m.device}")
    if not m.is_contiguous() or m.data_ptr() % 16:
        raise ValueError("wedge_count_matrix needs a contiguous, 16-byte "
                         "aligned mask")
    out = torch.empty((n, n), dtype=torch.float32, device=m.device)
    if n == 0:
        return out
    from . import _build

    lib = _build.load("wedge_count_matrix")
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wedge_count_matrix_launch(m.data_ptr(), out.data_ptr(), n,
                                           stream)
    if rc:
        msg = lib.wedge_count_matrix_error_string(rc).decode()
        raise RuntimeError(f"wedge_count_matrix launch failed: {msg}")
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
