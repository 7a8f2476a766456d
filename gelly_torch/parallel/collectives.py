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

On a mesh that spans processes (pass ``mesh=``), each process holds and
combines its own shards (``None`` elsewhere), and the schedules are the
same: a partner in the same process is a ``tree_to`` copy, and a partner
in another process is exchanged through the process group. Each leaf is
staged through a host buffer (pinned when the shard is on a card: gloo's
point-to-point ops take CPU tensors), and every send and receive of a
round is posted before any is waited on (``isend`` / ``irecv``), so two
partners that both send first cannot deadlock. Partners' summaries share
their leaves' shapes and dtypes, as every mesh summary does.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..engine.checkpoint import tree_flatten, tree_map, tree_unflatten
from .mesh import all_gather_shards, tree_to


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


def _procs(mesh, n: int) -> tuple:
    return mesh.processes if mesh is not None else (0,) * n


def host_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    """A ``uint8`` host staging buffer (pinned for copies to or from a
    card)."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)


def _leaf_bytes(x) -> torch.Tensor:
    return torch.as_tensor(x).contiguous().reshape(-1).view(torch.uint8)


def _tree_nbytes(tree) -> int:
    return sum(_leaf_bytes(x).numel() for x in tree_flatten(tree)[0])


def _pack(tree) -> torch.Tensor:
    """Every leaf's bytes, in leaf order, in one host buffer."""
    parts = [_leaf_bytes(x) for x in tree_flatten(tree)[0]]
    buf = host_buffer(sum(p.numel() for p in parts),
                       any(p.is_cuda for p in parts))
    off = 0
    for p in parts:
        buf[off:off + p.numel()].copy_(p)
        off += p.numel()
    return buf


def _unpack(buf: torch.Tensor, like, device):
    """The tree ``_pack`` wrote into ``buf``, shaped like ``like``, on
    ``device`` (fresh tensors: nothing aliases the buffer)."""
    leaves, spec = tree_flatten(like)
    out, off = [], 0
    for x in leaves:
        x = torch.as_tensor(x)
        n = x.numel() * x.element_size()
        part = buf[off:off + n]
        part = part.clone() if device.type == "cpu" else part.to(device)
        out.append(part.view(x.dtype).reshape(x.shape))
        off += n
    return tree_unflatten(spec, out)


def _fetch(mesh, cur: list, wants, devs: list) -> dict:
    """``{(i, j): copy of cur[j] on devs[i]}`` for every pair ``(i, j)`` of
    ``wants`` whose receiver ``i`` this process holds (every process
    passes the same ``wants``). A shard held elsewhere comes through the
    process group, once for all of this process's receivers; a shard held
    here is copied with ``tree_to``."""
    procs = _procs(mesh, len(cur))
    me = procs[0] if mesh is None else mesh.process_index
    out: dict = {}
    inbound: dict = {}   # j held elsewhere -> its receivers held here
    outbound = set()     # (process, j): j held here, a receiver there
    for i, j in wants:
        if procs[i] == me and procs[j] == me:
            out[(i, j)] = tree_to(cur[j], devs[i])
        elif procs[i] == me:
            inbound.setdefault(j, []).append(i)
        elif procs[j] == me:
            outbound.add((procs[i], j))
    if not inbound and not outbound:
        return out
    import torch.distributed as dist

    works, bufs = [], {}
    for q, j in sorted(outbound):
        buf = _pack(cur[j])
        bufs[(q, j)] = buf
        mesh.sent_bytes += buf.numel()
        works.append(dist.isend(buf, dst=q, tag=j))
    for j, recv in sorted(inbound.items()):
        buf = host_buffer(_tree_nbytes(cur[recv[0]]),
                           any(devs[i].type == "cuda" for i in recv))
        bufs[j] = buf
        works.append(dist.irecv(buf, src=procs[j], tag=j))
    for w in works:
        w.wait()
    for j, recv in inbound.items():
        mesh.received_bytes += bufs[j].numel()
        for i in recv:
            out[(i, j)] = _unpack(bufs[j], cur[i], devs[i])
    return out


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
        other = _fetch(mesh, cur, [(i, i ^ step) for i in sorted(need[r])],
                       devs)
        cur = [combine(cur[i], other[(i, i ^ step)])
               if (i, i ^ step) in other else None
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
    while step < num_shards:
        # Phase 1 (intra-group butterflies, strides below ``group``), then
        # phase 2 (leaders only).
        pairs = [(i, i ^ step) for i in range(num_shards)
                 if step < group or i % group == 0]
        other = _fetch(mesh, cur, pairs, devs)
        cur = [combine(cur[i], other[(i, j)]) if (i, j) in other else cur[i]
               for i, j in ((i, i ^ step) for i in range(num_shards))]
        step <<= 1
    st = group >> 1
    while st >= 1:  # phase 3: binomial broadcast, largest stride first
        got = _fetch(mesh, cur, [
            (i + st, i) for i in range(num_shards)
            if (i % group) % (2 * st) == 0 and (i % group) + st < group],
            devs)
        recv = {i: v for (i, _), v in got.items()}
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
    procs = _procs(mesh, len(summaries))
    kept = range(len(summaries)) if keep is None else keep
    got = _fetch(mesh, summaries, [
        (i, j) for i in kept for j in range(len(summaries))
        if procs[j] != procs[i]], devs)
    out = [None] * len(summaries)
    for i in kept:
        if devs[i] is not None:
            out[i] = merge_stacked(stack_trees(
                [got.get((i, j), s) for j, s in enumerate(summaries)],
                devs[i]))
    return out


def psum_tree(trees: list, mesh=None) -> list:
    """Elementwise-additive merge (degree histograms, counters): every
    shard gets the sum, added in shard order."""
    devs = _devices(trees, mesh)
    procs = _procs(mesh, len(trees))
    # Each process's first shard receives every shard held elsewhere.
    first = {p: procs.index(p) for p in set(procs)}
    got = _fetch(mesh, trees, [
        (first[p], j) for p in sorted(first) for j in range(len(trees))
        if procs[j] != p], devs)
    mine = first[procs[0] if mesh is None else mesh.process_index]

    def add(xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return total

    total = _zip_leaves(add, [got.get((mine, j), t)
                              for j, t in enumerate(trees)])
    return [tree_to(total, d) if d is not None else None for d in devs]


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


def gather_delta(slots: list, vals: list, device, mesh=None):
    """Every shard's compacted delta rows, concatenated in shard order on
    ``device``: ``(slots[S*bucket], vals[S*bucket, ...])`` with the
    ``-1``-padded lanes kept (callers mask on ``slots >= 0``). On a mesh
    that spans processes (``None`` at other processes' shards) the rows
    are all-gathered first, so every process gets every shard's rows."""
    if mesh is not None and mesh.process_count > 1:
        got = all_gather_shards(mesh, [
            None if s is None else (s, v) for s, v in zip(slots, vals)],
            device)
        slots, vals = [g[0] for g in got], [g[1] for g in got]

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    return cat(slots), _zip_leaves(cat, vals)
