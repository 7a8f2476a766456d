"""Capped-degree neighbor-row tables — the sparse adjacency primitive.

Counterpart of ``gelly_tpu/ops/rowtable.py``. A vertex's neighbours live
in a fixed-shape ``i32[N, D]`` table: row ``v`` holds up to ``D``
neighbour slots (-1 empty) with a dense ``deg[N]`` fill counter. Inserts
past the cap are counted in a caller-supplied overflow accumulator.

Where ``gelly_tpu`` returns new arrays, these functions write the table
and the fill counter in place (a Twitter-scale table is a GiB; a copy a
step would be the fold's whole cost) and return them, with the overflow
count as a new tensor. Nothing here synchronises with the device.
"""

from __future__ import annotations

import torch


def put_where_(flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               keep: torch.Tensor) -> None:
    """``flat[idx[i]] = vals[i]`` for the lanes where ``keep`` is set, in
    place, without a device sync: JAX's ``.at[idx].set(vals,
    mode="drop")`` with the dropped lanes' indices out of range.

    A dropped lane writes the first kept lane's value to that lane's index
    (or, when no lane is kept, ``flat[0]`` to itself), so duplicates agree
    and the result does not depend on the scatter's order. Kept lanes with
    one index must carry one value."""
    if idx.numel() == 0:
        return
    first = keep.to(torch.uint8).argmax().reshape(1)  # no host sync
    any_kept = keep[first]
    zero = torch.zeros((), dtype=idx.dtype, device=idx.device)
    idx = torch.where(keep, idx, torch.where(any_kept, idx[first], zero))
    vals = torch.where(keep, vals.to(flat.dtype),
                       torch.where(any_kept, vals[first].to(flat.dtype),
                                   flat[:1]))
    flat.index_put_((idx.long(),), vals)


def row_insert(nbr: torch.Tensor, deg: torch.Tensor, over: torch.Tensor,
               a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor,
               max_degree: int, dedupe: bool = True):
    """Append neighbour ``b`` to row ``a`` (one edge: ``a``, ``b`` and
    ``ok`` are one-element tensors, which index without a device sync).

    ``dedupe=True`` gives set semantics (a neighbour already in the row is
    a no-op); an insert into a full row adds one to ``over`` instead.
    Returns ``(nbr, deg, over)``: ``nbr`` and ``deg`` updated in place."""
    if dedupe:
        fresh = ok & ~(nbr[a] == b.to(nbr.dtype)).any()
    else:
        fresh = ok
    d = deg[a]
    fits = fresh & (d < max_degree)
    slot = d.clamp(max=max_degree - 1)
    nbr[a, slot] = torch.where(fits, b.to(nbr.dtype), nbr[a, slot])
    deg[a] = d + fits.to(deg.dtype)
    over = over + (fresh & ~fits).to(over.dtype).reshape(over.shape)
    return nbr, deg, over


def row_append_batch(nbr: torch.Tensor, deg: torch.Tensor,
                     over: torch.Tensor, key: torch.Tensor,
                     val: torch.Tensor, ok: torch.Tensor, max_degree: int):
    """Append ``val[i]`` to row ``key[i]`` for every lane where ``ok`` is
    set, conflicting appends to one row taking consecutive slots in lane
    order (``gelly_tpu``'s ``_row_append_batch``: a stable sort by row,
    rank within the row, ``deg[row] + rank`` as the slot). Returns
    ``(nbr, deg, over)``: ``nbr`` and ``deg`` updated in place, ``over``
    plus the appends that found their row full."""
    n = nbr.shape[0]
    sort_key = torch.where(ok, key, n).to(torch.int64)
    k_s, order = torch.sort(sort_key, stable=True)
    first = torch.searchsorted(k_s, k_s, side="left")
    rank = torch.arange(k_s.shape[0], device=k_s.device) - first
    slot = deg[k_s.clamp(0, n - 1)].to(torch.int64) + rank
    ok_s = ok[order]
    fits = ok_s & (slot < max_degree)
    over = over + (ok_s & (slot >= max_degree)).sum().to(over.dtype)
    put_where_(nbr.view(-1), k_s * max_degree + slot, val[order], fits)
    deg.index_add_(0, torch.where(fits, k_s, 0),
                   fits.to(deg.dtype))
    return nbr, deg, over
