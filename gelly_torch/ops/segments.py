"""Masked scatter and segment primitives over padded COO chunks.

Counterpart of ``gelly_tpu/ops/segments.py``. JAX's
``target.at[idx].min/max/add(updates, mode="drop")`` becomes
``scatter_reduce(0, idx, updates, "amin"|"amax"|"sum", include_self=True)``
with masked lanes routed to slot 0 carrying the reduction's neutral value,
exactly as the JAX versions do. Every function returns a new tensor (the
callers compare old and new states); ``scatter_reduce`` takes ``int64``
indices, so the cast happens at the call and stored state stays ``i32``.
"""

from __future__ import annotations

import torch

INT_MAX = torch.iinfo(torch.int32).max


def _neutral(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def _masked(target, idx, updates, valid, fill):
    upd = torch.where(valid, updates.to(target.dtype), fill)
    return torch.where(valid, idx, 0).long(), upd


def masked_scatter_add(target: torch.Tensor, idx: torch.Tensor, updates,
                       valid) -> torch.Tensor:
    """target[idx] += updates where valid (padding routed to a no-op)."""
    i, u = _masked(target, idx, updates, valid, 0)
    return target.scatter_reduce(0, i, u, "sum", include_self=True)


def masked_scatter_min(target: torch.Tensor, idx: torch.Tensor, updates,
                       valid) -> torch.Tensor:
    i, u = _masked(target, idx, updates, valid, _neutral(target.dtype, True))
    return target.scatter_reduce(0, i, u, "amin", include_self=True)


def masked_scatter_max(target: torch.Tensor, idx: torch.Tensor, updates,
                       valid) -> torch.Tensor:
    i, u = _masked(target, idx, updates, valid, _neutral(target.dtype, False))
    return target.scatter_reduce(0, i, u, "amax", include_self=True)


def mark_seen(seen: torch.Tensor, idx: torch.Tensor, valid) -> torch.Tensor:
    """seen[idx] |= valid — bool presence scatter.

    Every write stores the same value (True), so duplicate indices need no
    reduction; masked lanes write into a spare slot past the end. The
    fill value is a kernel argument, so nothing is read or copied on the
    host (an index put of ``True`` copies a host scalar to the card and
    synchronizes).
    """
    n = seen.shape[0]
    hit = torch.zeros(n + 1, dtype=torch.bool, device=seen.device)
    hit.index_fill_(0, torch.where(valid, idx, n).long(), True)
    return seen | hit[:n]


def first_occurrence_mask(keys: torch.Tensor, valid: torch.Tensor,
                          num_slots: int) -> torch.Tensor:
    """True for the first valid occurrence of each key within the chunk:
    a scatter-min of positions followed by a gather-compare (first-seen
    semantics without a host-side set). ``keys`` must lie in
    ``[0, num_slots)`` on every lane, masked lanes included."""
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    firsts = torch.full((num_slots,), INT_MAX, dtype=torch.int32,
                        device=keys.device)
    firsts = masked_scatter_min(firsts, keys, pos, valid)
    return valid & (firsts[keys.long()] == pos)


def sort_by_key(keys: torch.Tensor, valid: torch.Tensor, *values):
    """Stable-sort chunk entries by key, padding last (its keys become
    ``INT_MAX``). Returns ``(sorted_keys, sorted_valid, *sorted_values)``."""
    sk = torch.where(valid, keys, torch.full_like(keys, INT_MAX))
    order = torch.sort(sk, stable=True).indices
    return (sk[order], valid[order], *(v[order] for v in values))


def segment_starts(sorted_keys: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Mask of the positions that start a new key run in a sorted, masked
    array."""
    prev = torch.cat([torch.full((1,), -1, dtype=sorted_keys.dtype,
                                 device=sorted_keys.device),
                      sorted_keys[:-1]])
    return valid & (sorted_keys != prev)


def unique_pairs_mask(src: torch.Tensor, dst: torch.Tensor,
                      valid: torch.Tensor, num_slots: int) -> torch.Tensor:
    """First occurrence of each ``(src, dst)`` pair within the chunk: a
    stable ``int64`` key sort and :func:`segment_starts`, scattered back
    to the chunk order."""
    key = src.long() * num_slots + dst.long()
    sk = torch.where(valid, key, torch.iinfo(torch.int64).max)
    order = torch.sort(sk, stable=True).indices
    starts = segment_starts(sk[order], valid[order])
    out = torch.zeros_like(valid)
    out[order] = starts
    return out
