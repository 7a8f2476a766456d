"""Parity (signed) union-find — the bipartiteness summary.

Counterpart of ``gelly_tpu/ops/parity_unionfind.py``. The state is a
union-find forest with one parity bit per vertex: ``rel[i]`` is the color
difference between ``i`` and ``parent[i]``. An edge ``(u, v)`` with
required parity ``q`` asserts ``color(u) ^ color(v) == q`` (graph edges use
``q = 1``); a union that would join two vertices of one component against
their parities is an odd cycle and sets the sticky ``failed`` bit.

Hooks are a scatter-min of the packed word ``parent * 2 + rel``, so parent
and parity move together. The reference's two ``lax.while_loop`` s run as
the hand kernels of ``csrc/unionfind_fixpoint.cu``
(:func:`~gelly_torch.ops.kernels.union_edges_parity`,
:func:`~gelly_torch.ops.kernels.pointer_jump_parity`), every round on the
card, so on the card no function here reads a value on the host;
``failed`` stays a device bool. On CPU tensors the kernels' plain versions
run the same loops in Python, one counted
:func:`~gelly_torch.ops.unionfind.host_sync` a round. The packed word is
``int32``, so a forest of ``2^30`` slots or more is refused. Every
function returns new tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from . import kernels
from .segments import INT_MAX, masked_scatter_min
from .unionfind import _i32, _mask


class ParityForest(NamedTuple):
    parent: torch.Tensor  # i32[N]
    rel: torch.Tensor  # i32[N] in {0, 1}: parity of i relative to parent[i]
    failed: torch.Tensor  # bool[] — an odd cycle was observed (sticky)


def fresh_parity_forest(capacity: int,
                        device: torch.device | str = DEFAULT_DEVICE
                        ) -> ParityForest:
    dev = resolve_device(device)
    return ParityForest(
        parent=torch.arange(capacity, dtype=torch.int32, device=dev),
        rel=torch.zeros(capacity, dtype=torch.int32, device=dev),
        failed=torch.zeros((), dtype=torch.bool, device=dev),
    )


def pointer_jump_parity(parent: torch.Tensor, rel: torch.Tensor):
    """Full path compression carrying parity: ``rel' = rel ^ rel[parent]``
    until ``parent[parent] == parent``
    (:func:`~gelly_torch.ops.kernels.pointer_jump_parity`)."""
    return kernels.pointer_jump_parity(parent, rel)


def union_edges_parity(f: ParityForest, u: torch.Tensor, v: torch.Tensor,
                       q: torch.Tensor, valid: torch.Tensor) -> ParityForest:
    """Union all valid ``(u, v)`` with required parity ``q`` between the
    endpoints; returns the compressed forest.

    Each round hooks ``max(root) -> min(root)`` with the edge-implied
    parity and takes one parity-carrying doubling step
    (:func:`~gelly_torch.ops.kernels.union_edges_parity`). A valid edge
    whose endpoints already share a parent against their parities sets
    ``failed``. The loop exits only after a round in which **both**
    parent and parity are stable: that round re-checked every edge
    against the settled coloring, so no odd cycle escapes (parents settle
    first; the parities within one more round).
    """
    p, r, failed = kernels.union_edges_parity(
        f.parent, f.rel, f.failed, _i32(u), _i32(v), _i32(q), _mask(valid))
    return ParityForest(p, r, failed)


def union_pairs_parity_compact(f: ParityForest, u: torch.Tensor,
                               v: torch.Tensor, q: torch.Tensor,
                               valid: torch.Tensor) -> ParityForest:
    """Parity union through a compacted root space — the sparse codec's
    fold when the lanes are few against the capacity.

    REQUIRES a flat parity forest (``rel[i]`` is the parity of ``i`` to
    its root, ``rel[root] == 0``), which :func:`union_edges_parity` and
    this function both re-establish. Each pair's constraint moves to its
    roots with parity ``rel[u] ^ rel[v] ^ q``; the roots get local ids
    (their first position in the sorted roots, sentinel-padded with
    ``INT_MAX`` so every lookup stays in range), the union runs in that
    space, and every root occurrence writes its new (root, parity) back
    through one packed scatter-min, then one doubling step.
    """
    if 2 * f.parent.shape[0] >= INT_MAX:
        # The packed (parent, rel) scatter word is parent * 2 + rel in
        # int32: beyond 2^30 slots it would overflow (and collide with the
        # INT_MAX dead-lane sentinel), silently corrupting the forest.
        raise ValueError(
            "union_pairs_parity_compact: vertex capacity must be < 2^30 "
            f"(got {f.parent.shape[0]}; the packed parity scatter word "
            "is int32)"
        )
    pu, pv = f.parent[u], f.parent[v]
    link_q = f.rel[u] ^ f.rel[v] ^ q
    roots = torch.cat([pu, pv])
    ok2 = torch.cat([valid, valid])
    sorted_roots, _ = torch.sort(torch.where(ok2, roots, INT_MAX))
    lu = torch.searchsorted(sorted_roots, pu, out_int32=True)
    lv = torch.searchsorted(sorted_roots, pv, out_int32=True)
    local = union_edges_parity(
        fresh_parity_forest(sorted_roots.shape[0], f.parent.device),
        lu, lv, link_q, valid,
    )
    # Every occurrence of a root routes through its first occurrence, so
    # all occurrences write the same packed value.
    first = torch.searchsorted(sorted_roots, sorted_roots, out_int32=True)
    new_parent = sorted_roots[local.parent[first]]
    new_rel = local.rel[first]
    live = sorted_roots != INT_MAX
    packed = masked_scatter_min(f.parent * 2 + f.rel, sorted_roots,
                                new_parent * 2 + new_rel, live)
    p2, r2 = packed >> 1, packed & 1
    return ParityForest(p2[p2], r2 ^ r2[p2], f.failed | local.failed)


def merge_parity_forests(a: ParityForest, b: ParityForest) -> ParityForest:
    """Merge two forests: b's ``(i, parent[i], rel[i])`` entries become
    constraint edges into a (Candidates.merge)."""
    idx = torch.arange(a.parent.shape[0], dtype=torch.int32,
                       device=a.parent.device)
    return union_edges_parity(
        a._replace(failed=a.failed | b.failed), idx, b.parent, b.rel,
        torch.ones_like(idx, dtype=torch.bool),
    )


def merge_parity_stack(stacked: ParityForest) -> ParityForest:
    """Merge K stacked forests ``[K, N]`` in one fixpoint."""
    k, n = stacked.parent.shape
    dev = stacked.parent.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(k, n)
    f = fresh_parity_forest(n, dev)._replace(failed=stacked.failed.any())
    return union_edges_parity(
        f, idx.reshape(-1), stacked.parent.reshape(-1),
        stacked.rel.reshape(-1),
        torch.ones(k * n, dtype=torch.bool, device=dev),
    )


def two_coloring(f: ParityForest, seen: torch.Tensor):
    """``(labels, colors)``: each seen vertex's component label (its min
    slot) and parity color; ``-1`` for unseen slots in both."""
    p, r = pointer_jump_parity(f.parent, f.rel)
    return torch.where(seen, p, -1), torch.where(seen, r, -1)
