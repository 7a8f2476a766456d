"""Collective merges over the shards: the port of ``gelly_tpu``'s ICI
collectives (``gelly_tpu/parallel/collectives.py``).

The reference merges per-partition summaries flat
(``timeWindowAll().reduce``, ``M/SummaryBulkAggregation.java:81-83``) or
as a tree (``M/SummaryTreeReduce.java:95-123``). The port keeps
``gelly_tpu``'s three schedules, bit for bit:

- :func:`butterfly_merge` — recursive doubling: in round ``step`` shard
  ``i`` combines its summary with shard ``i ^ step``'s, both as they were
  at the START of the round (``ppermute`` semantics: every partner copy
  is taken before any combine of the round runs, because a plan may
  combine in place), own summary first;
- :func:`hierarchical_merge` — the ``SummaryTreeReduce`` ``degree`` knob:
  butterflies inside groups, a leader-only exchange across groups, then a
  binomial broadcast down each group;
- :func:`gather_merge` — every shard's summary stacked (shard order) and
  folded with the plan's ``merge_stacked``.

Every value is a list of S per-shard summaries (``parallel/mesh.py``).
``keep`` names the shards whose result the caller reads: the combines
whose results no kept shard depends on are skipped (the engine reads
shard 0 only); the kept results equal ``gelly_tpu``'s. The dirty-delta
helpers (:func:`compact_delta`, :func:`gather_delta`) move only the rows a
window touched.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..engine.checkpoint import tree_flatten, tree_map, tree_unflatten
from .mesh import tree_to


def _check_pow2(num_shards: int, what: str) -> None:
    if num_shards & (num_shards - 1):
        raise ValueError(f"{what} requires power-of-two shards")


def _needed(num_shards: int, steps: list[int], keep) -> list[set]:
    """``need[r]``: the shards whose value after round ``r`` some kept
    shard's result depends on (rounds of XOR partners ``steps``)."""
    want = set(range(num_shards)) if keep is None else set(keep)
    need = [set() for _ in steps]
    for r in range(len(steps) - 1, -1, -1):
        need[r] = set(want)
        want = want | {i ^ steps[r] for i in want}
    return need


def _devices(summaries: list, mesh) -> list:
    if mesh is not None:
        return list(mesh.devices)
    return [_first_device(s) for s in summaries]


def _first_device(tree):
    return next(x.device for x in tree_flatten(tree)[0]
                if isinstance(x, torch.Tensor))


def butterfly_merge(combine: Callable, summaries: list, num_shards: int,
                    mesh=None, keep: Iterable[int] | None = None) -> list:
    """Recursive-doubling allreduce with a custom combine monoid.

    ``combine(a, b)`` must be associative and commutative; it may update
    ``a`` in place (the partner copy ``b`` is private to the call). Returns
    the list of S results (shards outside ``keep`` hold None)."""
    _check_pow2(num_shards, "butterfly_merge")
    devs = _devices(summaries, mesh)
    steps = []
    step = 1
    while step < num_shards:
        steps.append(step)
        step <<= 1
    need = _needed(num_shards, steps, keep)
    cur = list(summaries)
    for r, step in enumerate(steps):
        # The round's partner copies, all taken before any combine.
        other = {i: tree_to(cur[i ^ step], devs[i]) for i in need[r]}
        cur = [combine(cur[i], other[i]) if i in need[r] else None
               for i in range(num_shards)]
    if keep is not None:
        kept = set(keep)
        cur = [c if i in kept else None for i, c in enumerate(cur)]
    return cur


def hierarchical_merge(combine: Callable, summaries: list, num_shards: int,
                       degree: int, mesh=None) -> list:
    """Three-phase merge tree (the ``SummaryTreeReduce`` ``degree`` knob,
    M/SummaryTreeReduce.java:75,95-123): butterflies within aligned groups
    of ``S // degree`` shards, a leader-only butterfly across groups (the
    non-leaders' combines, whose results ``gelly_tpu`` discards, are not
    run), then a binomial broadcast from each leader down its group. Every
    shard ends with the global summary. ``degree`` must divide
    ``num_shards`` and both must be powers of two."""
    if num_shards <= 0 or degree <= 0:
        raise ValueError("hierarchical_merge sizes must be positive")
    if num_shards & (num_shards - 1) or degree & (degree - 1):
        raise ValueError("hierarchical_merge requires power-of-two sizes")
    if num_shards % degree:
        raise ValueError(
            f"degree {degree} must divide num_shards {num_shards}"
        )
    devs = _devices(summaries, mesh)
    group = num_shards // degree
    cur = list(summaries)
    step = 1
    while step < group:  # phase 1: intra-group butterflies
        other = [tree_to(cur[i ^ step], devs[i]) for i in range(num_shards)]
        cur = [combine(cur[i], other[i]) for i in range(num_shards)]
        step <<= 1
    while step < num_shards:  # phase 2: leaders only
        leaders = [i for i in range(num_shards) if i % group == 0]
        other = {i: tree_to(cur[i ^ step], devs[i]) for i in leaders}
        cur = [combine(cur[i], other[i]) if i in other else cur[i]
               for i in range(num_shards)]
        step <<= 1
    st = group >> 1
    while st >= 1:  # phase 3: binomial broadcast, largest stride first
        recv = {i + st: tree_to(cur[i], devs[i + st])
                for i in range(num_shards)
                if (i % group) % (2 * st) == 0 and (i % group) + st < group}
        cur = [recv.get(i, c) for i, c in enumerate(cur)]
        st >>= 1
    return cur


def _zip_leaves(fn, trees: list):
    """``fn(list of the trees' i-th leaves)`` for every leaf position,
    rebuilt into the trees' shape."""
    flat = [tree_flatten(t) for t in trees]
    return tree_unflatten(flat[0][1], [
        fn([f[0][i] for f in flat]) for i in range(len(flat[0][0]))])


def stack_trees(trees: list, device):
    """Stack per-shard trees on a new leading axis (shard order) on
    ``device`` — the ``all_gather`` of a summary."""
    return _zip_leaves(
        lambda xs: torch.stack([x.to(device) for x in xs]), trees)


def gather_merge(merge_stacked: Callable, summaries: list, mesh=None,
                 keep: Iterable[int] | None = None) -> list:
    """Gather every shard's summary (stacked in shard order) and fold with
    ``merge_stacked``; every kept shard computes the same global result."""
    devs = _devices(summaries, mesh)
    kept = range(len(summaries)) if keep is None else keep
    out = [None] * len(summaries)
    for i in kept:
        out[i] = merge_stacked(stack_trees(summaries, devs[i]))
    return out


def psum_tree(trees: list, mesh=None) -> list:
    """Elementwise-additive merge (degree histograms, counters): every
    shard gets the sum, added in shard order."""
    devs = _devices(trees, mesh)

    def add(xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return total

    total = _zip_leaves(add, trees)
    return [tree_to(total, d) for d in devs]


# ---------------------------------------------------------------------- #
# dirty-delta merge primitives: a summary whose folds mark the entries
# they change exchanges only the dirty (slot, value) rows, so a window's
# merge costs its hooks, not the capacity.


def compact_delta(dirty: torch.Tensor, values, bucket: int):
    """Compact a dirty mask into ``(slots, values, count)`` rows.

    ``slots`` is ``i32[bucket]``: the first ``bucket`` dirty indices in
    ascending order, ``-1``-padded; ``values`` (a tensor or a dict / tuple
    of tensors with leading dim ``n``) gathered at them, zero on the
    padding; ``count`` the TRUE number of dirty entries (entries past the
    bucket are dropped, which is why callers size the bucket from the
    count). ``gelly_tpu`` finds the same rows through a blocked two-level
    scan; here one device prefix sum, no host sync."""
    n = dirty.shape[0]
    dev = dirty.device
    d32 = dirty.to(torch.int32)
    pos = torch.cumsum(d32, 0, dtype=torch.int64) - 1
    tgt = torch.where(dirty & (pos < bucket), pos, bucket)
    idx = torch.full((bucket + 1,), -1, dtype=torch.int32, device=dev)
    idx[tgt] = torch.arange(n, dtype=torch.int32, device=dev)
    idx = idx[:bucket].clone()
    ok = idx >= 0
    safe = torch.where(ok, idx, 0).long()

    def take(v: torch.Tensor) -> torch.Tensor:
        g = v[safe]
        return torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), g,
                           torch.zeros((), dtype=v.dtype, device=dev))

    return idx, tree_map(take, values), d32.sum()


def gather_delta(slots: list, vals: list, device):
    """Every shard's compacted delta rows, concatenated in shard order on
    ``device``: ``(slots[S*bucket], vals[S*bucket, ...])`` with the
    ``-1``-padded lanes kept (callers mask on ``slots >= 0``)."""
    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    return cat(slots), _zip_leaves(cat, vals)
