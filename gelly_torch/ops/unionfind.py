"""Tensor union-find: scatter-min hooking + pointer jumping.

Counterpart of ``gelly_tpu/ops/unionfind.py``: the raw-chunk CC fold and
the codec plans' payload folds (:func:`union_pairs_compact`,
:func:`union_pairs_star`).
The forest is a dense ``i32 parent[capacity]`` tensor over vertex slots;
a whole chunk of edges is unioned at once. At convergence every vertex's
root is the **minimum vertex slot in its component**, the canonical label
both packages emit.

Each ``lax.while_loop`` of the reference becomes a Python loop whose
condition is one host sync per round, and each ``lax.cond`` a Python ``if``
on a synced scalar; ``host_sync.count`` counts those syncs. Keeping the
fixpoints on the device is later work. Every function returns new tensors
and leaves its inputs untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device, to_numpy
from .segments import INT_MAX, masked_scatter_min


def host_sync(t: torch.Tensor):
    """Python value of a one-element tensor: the one device->host sync per
    fixpoint round or branch. ``host_sync.count`` counts calls."""
    host_sync.count += 1
    return t.item()


host_sync.count = 0


def _any(mask: torch.Tensor) -> bool:
    return bool(host_sync(mask.any()))


def fresh_forest(capacity: int,
                 device: torch.device | str = DEFAULT_DEVICE) -> torch.Tensor:
    """parent[i] = i — every slot its own singleton root."""
    return torch.arange(capacity, dtype=torch.int32,
                        device=resolve_device(device))


def pointer_jump(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: parent <- parent[parent] until fixpoint."""
    p = parent
    while True:
        pp = p[p]
        if not _any(pp != p):
            return p
        p = pp


def union_edges(parent: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Union all valid (src, dst) edges into the forest; returns the
    compressed forest.

    Shiloach-Vishkin shape: each round one masked scatter-min hook
    (``max(root) -> min(root)``) and one pointer-doubling step, until a
    round changes nothing; then a full :func:`pointer_jump`. Order-free:
    the result is the same canonical forest for any edge order.
    """
    p = parent
    while True:
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
            return pointer_jump(p)


def _chase_roots(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pair-sized pointer chase to the TRUE roots of x."""
    g = p[x]
    while _any(g != x):
        x, g = g, p[g]
    return x


def _rooted_fixpoint(parent: torch.Tensor, src: torch.Tensor, rv_fn,
                     valid: torch.Tensor, live0: bool) -> torch.Tensor:
    """Shared exact hook loop of the pair-sized union kernels: per round,
    chase ``src`` to true roots, resolve the partner roots with
    ``rv_fn(p, ru)``, hook root-to-root with one scatter-min; exit after
    the first round in which no pair is live. ``live0`` False runs zero
    rounds.

    Hooks write ``lo < p[hi] = hi`` at true roots only, so chains stay
    strictly decreasing (acyclic) and every live round strictly lowers
    some entry (termination).
    """
    p = parent
    live_any = bool(live0)
    while live_any:
        ru = _chase_roots(p, src)
        rv = rv_fn(p, ru)
        lo = torch.minimum(ru, rv)
        hi = torch.maximum(ru, rv)
        live = valid & (lo != hi)
        p = masked_scatter_min(p, hi, lo, live)
        live_any = _any(live)
    return p


def union_pairs_rooted(parent: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Union (src, dst) pairs with all per-round work sized to the pairs.

    Each round chases both endpoints to their TRUE roots and hooks
    root-to-root with one masked scatter-min, until every valid pair's
    roots agree. The forest is returned **without** a global flatten
    (depth can grow by O(1) per call; the window-close transform runs one
    :func:`pointer_jump`).
    """
    src = torch.where(valid, src, 0)
    dst = torch.where(valid, dst, 0)
    return _rooted_fixpoint(
        parent, src, lambda p, ru: _chase_roots(p, dst), valid, True
    )


def union_pairs_compact(parent: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Union (src, dst) pairs through a compacted root space — the sparse
    codec's payload fold, where touched slots << capacity.

    REQUIRES a flat forest (``parent[parent] == parent``), which
    :func:`union_edges` and this function both (re)establish. Each round
    of the inner fixpoint works on arrays sized to the pairs:

    1. gather the pairs' current roots;
    2. sort + searchsorted give each distinct root a local id equal to
       its first position in the sorted roots (order-preserving, so
       min-local-id unions keep the canonical min-slot convention);
    3. :func:`union_edges` in the local space;
    4. scatter-min each root occurrence's new global root back, then one
       ``parent[parent]`` restores flatness.

    Invalid lanes' lookups stay in range: with any invalid lane the
    sorted roots end in ``INT_MAX`` sentinels, so ``searchsorted`` never
    returns past the last slot.
    """
    ps = parent[src]
    pd = parent[dst]
    roots = torch.cat([ps, pd])
    ok2 = torch.cat([valid, valid])
    sorted_roots, _ = torch.sort(torch.where(ok2, roots, INT_MAX))
    lsrc = torch.searchsorted(sorted_roots, ps).to(torch.int32)
    ldst = torch.searchsorted(sorted_roots, pd).to(torch.int32)
    local = union_edges(
        fresh_forest(sorted_roots.shape[0], parent.device), lsrc, ldst,
        valid,
    )
    # Route every occurrence of a root through its FIRST occurrence's
    # local root, so all occurrences write the same value.
    first = torch.searchsorted(sorted_roots, sorted_roots)
    new_root = sorted_roots[local[first]]
    live = sorted_roots != INT_MAX
    parent = masked_scatter_min(parent, sorted_roots, new_root, live)
    return parent[parent]


def union_pairs_star(parent: torch.Tensor, v: torch.Tensor, ri: torch.Tensor,
                     valid: torch.Tensor,
                     fast_depths: tuple[int, ...] = (2, 3),
                     check_depth: int = 3) -> torch.Tensor:
    """Union star-forest payload rows — the compact codec's device fold.

    ``(v[j], v[ri[j]])`` are the pairs: every payload row is a
    host-combined spanning forest whose root is itself a row entry, and
    ``ri`` is the root's row index (in range for every lane, padding
    included), so the root side of each pair is one gather from the
    already-chased array (``rv = ru[ri]``).

    1. one round per ``fast_depths`` entry: a fixed-depth pointer chase,
       then one scatter-min hook MASKED to verified roots
       (``p[hi] == hi``; a hook at an interior node would replace a real
       parent edge). No host sync.
    2. a depth-limited check: ``any(valid & (ru != ru[ri]))`` — the ONE
       counted :func:`host_sync` of a call that converges in step 1.
    3. the exact fixpoint (:func:`_rooted_fixpoint`) only when the check
       found live pairs.

    Every step is a deterministic scatter-min, so the forest equals
    ``gelly_tpu``'s bit for bit. Like :func:`union_pairs_rooted`, it is
    returned without a global flatten.
    """
    v = torch.where(valid, v, 0)

    def chase_fixed(p, x, depth):
        g = p[x]
        for _ in range(depth - 1):
            g = p[g]
        return g

    p = parent
    for depth in fast_depths:
        ru = chase_fixed(p, v, depth)
        rv = ru[ri]
        lo = torch.minimum(ru, rv)
        hi = torch.maximum(ru, rv)
        live = valid & (lo != hi) & (p[hi] == hi)
        p = masked_scatter_min(p, hi, lo, live)
    ru = chase_fixed(p, v, check_depth)
    live0 = bool(host_sync((valid & (ru != ru[ri])).any()))
    return _rooted_fixpoint(p, v, lambda p_, ru_: ru_[ri], valid, live0)


def _dedup_pairs(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 unique_cap: int):
    """Exact undirected dedup of a chunk's pairs (steps 1-2 of
    :func:`union_edges_dedup`).

    Returns ``(uu_c, vv_c, live0, ucount)``: the first ``unique_cap`` lanes
    of the distinct ``(min, max)`` pairs in ascending lexicographic order
    followed by the duplicate and masked lanes (also ascending), the mask
    of the live distinct lanes, and the distinct-pair count as a tensor.

    The reference's 2-key ``lax.sort`` becomes one sort of the int64 key
    ``(u << 32) | v`` (both halves are non-negative i32, so the key order
    is the lexicographic order), and its stable flag partition a stable
    sort of the flag.
    """
    u = torch.minimum(src, dst)
    v = torch.maximum(src, dst)
    u = torch.where(valid, u, INT_MAX)
    v = torch.where(valid, v, INT_MAX)
    key = (u.to(torch.int64) << 32) | v.to(torch.int64)
    key, _ = torch.sort(key, stable=True)
    su = (key >> 32).to(torch.int32)
    sv = (key & 0xFFFFFFFF).to(torch.int32)
    first = (su != torch.roll(su, 1)) | (sv != torch.roll(sv, 1))
    first[:1] = True
    first = first & (su != INT_MAX)
    flag = (~first).to(torch.int32)
    _, order = torch.sort(flag, stable=True)
    uu = su[order]
    vv = sv[order]
    ucount = first.sum(dtype=torch.int64)
    lanes = torch.arange(unique_cap, dtype=torch.int64, device=src.device)
    live0 = lanes < torch.clamp(ucount, max=unique_cap)
    return uu[:unique_cap], vv[:unique_cap], live0, ucount


def union_edges_dedup(parent: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, valid: torch.Tensor,
                      unique_cap: int, tail_cap: int | None = None,
                      backend: str = "plain") -> torch.Tensor:
    """Sort-dedup raw-edge fold — the large-chunk RAW device path.

    1. canonicalize + 2-key sort + first-occurrence mask: exact
       UNDIRECTED dedup;
    2. stable partition of the distinct pairs into ``unique_cap`` lanes;
    3. three unrolled hook rounds at depths 1/2/3: chase both endpoints,
       hook lo under hi MASKED to verified roots (``p[hi] == hi``);
    4. survivors compact into ``tail_cap`` lanes (cumsum + scatter) and
       finish in the exact pair-sized fixpoint
       (:func:`union_pairs_rooted`);
    5. one ``p[p]`` halving keeps entry depth low for the next chunk.

    Exactness never depends on the caps: ``unique_cap`` overflow falls
    back to the exact fixpoint over the ORIGINAL pairs, ``tail_cap``
    overflow re-runs it over the distinct pairs.

    ``backend`` selects how the hook rounds' first-level chases of the lo
    endpoints run: ``"plain"`` (the reference's ``"xla"``) gathers
    directly; ``"kernel"`` (the reference's ``"pallas"``) runs them through
    :func:`~gelly_torch.ops.kernels.sorted_window_gather` — the lo
    endpoints of the distinct pairs are sorted by step 1. A lane the kernel
    misses (-1) skips that round's hook and stays alive for the exact tail,
    so the returned forest equals the reference's ``"pallas"`` forest bit
    for bit. ``"kernel"`` needs a :func:`~gelly_torch.ops.kernels.gatherable`
    capacity; on CPU tensors it runs the kernel's plain version.
    """
    if backend not in ("plain", "kernel"):
        raise ValueError(f"backend must be plain/kernel, got {backend!r}")
    n_cap = parent.shape[0]
    if backend == "kernel":
        from .kernels import GATHER_LANE, gatherable

        if not gatherable(n_cap):
            raise ValueError(
                f"backend='kernel' needs a window-blockable capacity "
                f"(multiple of {GATHER_LANE} lanes spanning >= 2 windows, "
                f"<= 2^24); got {n_cap}"
            )
    unique_cap = min(unique_cap, src.shape[0])
    if tail_cap is None:
        tail_cap = max(1 << 16, unique_cap // 4)
    tail_cap = min(tail_cap, unique_cap)
    uu_c, vv_c, live0, ucount = _dedup_pairs(src, dst, valid, unique_cap)

    if host_sync(ucount) > unique_cap:
        # unique_cap overflow: distinct pairs beyond the cap were sliced
        # away, so run the exact fixpoint over the ORIGINAL pairs.
        p = union_pairs_rooted(
            parent, torch.where(valid, src, 0), torch.where(valid, dst, 0),
            valid,
        )
        return p[p]

    # Dead lanes (duplicates, masked pairs) never hook and never reach the
    # tail; slot 0 keeps their gathers in range.
    uu_s = torch.where(live0, uu_c, 0)
    vv_s = torch.where(live0, vv_c, 0)
    if backend == "kernel":
        from .kernels import sorted_window_gather

        # The reference's kernel view: live lanes ascending, dead lanes
        # mapped to the last slot so the index array stays sorted.
        uu_k = torch.where(live0, uu_c, n_cap - 1)

    p = parent
    alive = live0
    for depth in (1, 2, 3):
        if backend == "kernel":
            g1 = sorted_window_gather(p, uu_k)
            hit = g1 >= 0
            g = torch.where(hit, g1, 0)
        else:
            g = p[uu_s]
            hit = None
        for _ in range(depth - 1):
            g = p[g]
        h = p[vv_s]
        for _ in range(depth - 1):
            h = p[h]
        lo = torch.minimum(g, h)
        hi = torch.maximum(g, h)
        alive = live0 & (lo != hi)
        hook = alive & (p[hi] == hi)
        if hit is not None:
            # Window-missed lanes: their chased root is unknown, so they
            # may not hook this round; they resolve in the exact tail.
            alive = live0 & ((lo != hi) | ~hit)
            hook = hook & hit
        p = masked_scatter_min(p, hi, lo, hook)
    alive32 = alive.to(torch.int32)
    pos = torch.cumsum(alive32, 0, dtype=torch.int32) - 1
    nalive = host_sync(alive32.sum())
    tgt = torch.where(alive & (pos < tail_cap), pos, tail_cap).long()
    cu = torch.zeros(tail_cap + 1, dtype=torch.int32, device=p.device)
    cv = torch.zeros(tail_cap + 1, dtype=torch.int32, device=p.device)
    cu = cu.scatter(0, tgt, uu_s)[:tail_cap]
    cv = cv.scatter(0, tgt, vv_s)[:tail_cap]
    clive = (torch.arange(tail_cap, dtype=torch.int32, device=p.device)
             < min(nalive, tail_cap))
    p = union_pairs_rooted(p, cu, cv, clive)
    if nalive > tail_cap:
        # Tail overflow: exact fixpoint over ALL distinct pairs.
        p = union_pairs_rooted(p, uu_c, vv_c, live0)
    return p[p]


def merge_forests(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union two forests over the same slot space (DisjointSet.merge)."""
    idx = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return union_edges(a, idx, b, torch.ones_like(idx, dtype=torch.bool))


def merge_forest_stack(stacked: torch.Tensor) -> torch.Tensor:
    """Merge K forests [K, N] into one: every (i, stacked[k, i]) is a union
    edge, all unioned in one fixpoint."""
    k, n = stacked.shape
    idx = torch.arange(n, dtype=torch.int32,
                       device=stacked.device).expand(k, n).reshape(-1)
    dsts = stacked.reshape(-1)
    return union_edges(
        fresh_forest(n, stacked.device), idx, dsts,
        torch.ones(k * n, dtype=torch.bool, device=stacked.device),
    )


def chase_depth(parent) -> int:
    """Maximum chain length in the forest (host-side diagnostic): 0 for the
    identity forest, 1 for a flat forest. Raises on a cycle."""
    p = to_numpy(parent)
    x = np.arange(p.shape[0], dtype=p.dtype)
    for depth in range(p.shape[0] + 1):
        nx = p[x]
        if np.array_equal(nx, x):
            return depth
        x = nx
    raise ValueError(
        f"parent array of {p.shape[0]} slots has no root fixpoint "
        "within n hops — the forest contains a cycle"
    )


def component_labels(parent: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Labels for seen vertices (min slot in component); -1 for unseen slots.
    Always a fresh tensor, never a view of ``parent``."""
    p = pointer_jump(parent)
    return torch.where(seen, p, -1)
