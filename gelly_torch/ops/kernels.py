"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``gelly_tpu/ops/pallas_kernels.py``. This slice ports the
union-find fold's windowed gather:

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
