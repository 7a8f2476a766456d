"""Shared cases of the parity union-find tests (CPU and card), and numpy
models of the schedules of the parity entries of
``gelly_torch/csrc/unionfind_fixpoint.cu``.

Every case is made with numpy from a seed. A forest is a parity forest
as the folds leave it mid-stream (a numpy parity union of Zipf lanes with
random parities, conflicts skipped), deepened so that the walks follow
real chains (``p[i] <= i``, a component's root its minimum slot, ``rel``
the color difference to the parent); some carry ``rel = 1`` at their
roots, one is flat (the reference's jump runs no round) and one is a
chain. The lane cases name what each one reaches: even and odd cycles,
self-loops, invalid lanes, two lanes on one ``(hi, lo)`` pair with
opposite parities. The models run each kernel as the card does: a
round's hooks applied one lane at a time in a seeded random order, as
the ``atomicMin`` s land in some order, into the second of three
rotating buffers.
"""

from __future__ import annotations

import numpy as np

from _unionfind_cases import deepen, zipf_pairs

INT_MAX = np.iinfo(np.int32).max
ZIPF_SIZES = (64, 512, 4096)
CHAIN_N = 1024
CHAIN_DEPTH = 100
FLAT_N = 1024
LANE_N = 64  # the forest of the named lane cases


def zipf_lanes(rng, n: int, e: int, p_valid: float = 0.9,
               parities: str = "random"):
    """``(u, v, q, valid)``: ``e`` Zipf-endpoint lanes over ``n`` slots;
    ``q`` all 1 (graph edges) or random bits (forest-merge edges)."""
    u, v, valid = zipf_pairs(rng, n, e, p_valid)
    q = (np.ones(e, np.int32) if parities == "graph"
         else rng.integers(0, 2, e).astype(np.int32))
    return u, v, q, valid


def _colors(n: int, u, v, q, valid):
    """``(labels, colors)`` of a numpy parity union-find over the lanes:
    each slot's minimum slot in its component and its parity to it; a
    lane against its component's coloring is skipped."""
    par = np.arange(n)
    rel = np.zeros(n, np.int64)

    def find(a):
        c = 0
        while par[a] != a:
            c ^= rel[a]
            a = par[a]
        return a, c

    for a, b, w, ok in zip(u.tolist(), v.tolist(), q.tolist(),
                           valid.tolist()):
        if not ok:
            continue
        (ra, ca), (rb, cb) = find(a), find(b)
        if ra != rb:
            lo, hi = min(ra, rb), max(ra, rb)
            par[hi] = lo
            rel[hi] = ca ^ cb ^ w
    found = [find(i) for i in range(n)]
    return (np.array([x for x, _ in found], np.int32),
            np.array([c for _, c in found], np.int32))


def parity_forest(rng, n: int, rel1_roots: bool = False):
    """A mid-stream parity forest ``(parent, rel)``: ``n // 2`` Zipf lanes
    with random parities unioned, then deepened; ``rel1_roots`` gives
    every root ``rel = 1``."""
    labels, colors = _colors(n, *zipf_lanes(rng, n, n // 2, 1.0))
    parent = deepen(rng, labels)
    rel = (colors ^ colors[parent]).astype(np.int32)
    if rel1_roots:
        rel[parent == np.arange(n)] = 1
    return parent, rel


def flat_forest(rng, n: int):
    """Depth 1 at most, roots with ``rel`` 0 and 1: the reference's jump
    runs no round and gives the input back."""
    labels, colors = _colors(n, *zipf_lanes(rng, n, n // 2, 1.0))
    rel = colors.copy()
    roots = labels == np.arange(n)
    rel[roots] = rng.integers(0, 2, int(roots.sum()))
    return labels.copy(), rel.astype(np.int32)


def chain(rng, n: int, depth: int):
    """Slots ``0..depth`` one chain ``depth`` deep with random ``rel``
    (its root's 1), the rest singletons."""
    parent = np.arange(n, dtype=np.int32)
    parent[1:depth + 1] = np.arange(depth, dtype=np.int32)
    rel = np.zeros(n, np.int32)
    rel[1:depth + 1] = rng.integers(0, 2, depth)
    rel[0] = 1
    return parent, rel


def cases(seed: int = 0) -> dict:
    """name -> ``(parent, rel)``: Zipf forests of each size, the same with
    ``rel = 1`` at the roots, a flat forest and a chain."""
    rng = np.random.default_rng(seed)
    out = {f"zipf-{n}": parity_forest(rng, n) for n in ZIPF_SIZES}
    out.update({f"roots-rel1-{n}": parity_forest(rng, n, True)
                for n in ZIPF_SIZES})
    out[f"flat-{FLAT_N}"] = flat_forest(rng, FLAT_N)
    out[f"chain-{CHAIN_DEPTH}"] = chain(rng, CHAIN_N, CHAIN_DEPTH)
    return out


def case_lanes(name: str, n: int):
    """The Zipf lanes (random parities) unioned into case ``name``."""
    rng = np.random.default_rng(len(name) * 1009 + n)
    return zipf_lanes(rng, n, max(16, n // 2))


def _cycle(length: int, offset: int = 3):
    u = np.arange(length, dtype=np.int32) + offset
    return u, np.roll(u, -1), np.ones(length, np.int32), np.ones(length, bool)


def lane_cases() -> dict:
    """name -> ``(u, v, q, valid, odd)`` on a fresh forest of
    :data:`LANE_N` slots; ``odd``: whether ``failed`` must be set."""
    out = {}
    for length in (4, 16):
        out[f"even-cycle-{length}"] = (*_cycle(length), False)
    for length in (3, 31):
        out[f"odd-cycle-{length}"] = (*_cycle(length), True)
    one = np.ones(1, np.int32)
    out["self-loop"] = (np.array([9], np.int32), np.array([9], np.int32),
                        one, np.ones(1, bool), True)
    u, v, q, _ = _cycle(5)
    out["invalid-odd-cycle"] = (u, v, q, np.zeros(5, bool), False)
    # Lanes 1 and 3 of an odd cycle invalid: a path, no cycle.
    out["odd-cycle-half-invalid"] = (u, v, q,
                                     np.array([1, 0, 1, 0, 1], bool), False)
    # One (hi, lo) pair with opposite parities, both lane orders: the
    # lower parity hooks first, the other is a same-parent conflict.
    for order, (a, b) in (("lo-first", (0, 1)), ("hi-first", (1, 0))):
        lanes = np.array([[5, 9, 0], [9, 5, 1]], np.int32)[[a, b]]
        out[f"opposite-pair-{order}"] = (
            lanes[:, 0].copy(), lanes[:, 1].copy(), lanes[:, 2].copy(),
            np.ones(2, bool), True)
    # The same pair with one parity twice: no conflict.
    out["same-pair-same-parity"] = (
        np.array([5, 9], np.int32), np.array([9, 5], np.int32),
        np.ones(2, np.int32), np.ones(2, bool), False)
    return out


# ------------------------------------------------------------------ #
# numpy models of the kernels' schedules


def model_pointer_jump_parity(p: np.ndarray, r: np.ndarray):
    """Kernel 2: ``(parent, rel, longest walk)``. A walk a slot to its
    root; with no walk of 2 hops or more the input comes back."""
    x = np.arange(p.shape[0])
    acc = np.zeros(p.shape[0], np.int32)
    hops = np.zeros(p.shape[0], np.int64)
    while True:
        g = p[x]
        moving = g != x
        if not moving.any():
            break
        acc[moving] ^= r[x[moving]]
        x = np.where(moving, g, x)
        hops += moving
    longest = int(hops.max()) if hops.size else 0
    if longest <= 1:
        return p.copy(), r.copy(), longest
    out_r = acc ^ np.where(hops & 1, r[x], 0)
    return x.astype(np.int32), out_r.astype(np.int32), longest


def model_union_edges_parity(rng, parent, rel, failed, u, v, q, valid):
    """Kernel 1 and the jump after it: ``(parent, rel, failed, rounds)``.
    A round reads the forest ``w`` at its start, applies the hooks one
    lane at a time in a random order into ``b`` (equal to ``w``), then
    doubles from ``b`` into ``w`` and ``c``; ``b`` and ``c`` swap. It ends
    after a round in which no word moved."""
    w = parent.astype(np.int64) * 2 + rel
    s, t = w.copy(), np.empty_like(w)
    odd = False
    rounds = 0
    while True:
        b, c = (t, s) if rounds & 1 else (s, t)
        for e in rng.permutation(np.flatnonzero(valid)):
            wu, wv = w[u[e]], w[v[e]]
            lu, lv = wu >> 1, wv >> 1
            link = (wu & 1) ^ (wv & 1) ^ q[e]
            if lu == lv:
                odd |= bool(link == 1)
            else:
                hi = max(lu, lv)
                b[hi] = min(b[hi], min(lu, lv) * 2 + link)
        sp = b[b >> 1]
        nw = (sp >> 1) * 2 + ((b ^ sp) & 1)
        moved = not np.array_equal(nw, w)
        w[:] = nw
        c[:] = nw
        rounds += 1
        if not moved:
            break
    p, r, _ = model_pointer_jump_parity((w >> 1).astype(np.int32),
                                        (w & 1).astype(np.int32))
    return p, r, bool(failed) or odd, rounds


def model_compact(rng, parent, rel, failed, u, v, q, valid):
    """``union_pairs_parity_compact`` around kernel 1: the roots' local
    ids, the model's union in that space, the writeback and one
    doubling step (the library calls of the port, in numpy)."""
    pu, pv = parent[u], parent[v]
    link = rel[u] ^ rel[v] ^ q
    ok2 = np.concatenate([valid, valid])
    roots = np.sort(np.where(ok2, np.concatenate([pu, pv]), INT_MAX))
    lu = np.searchsorted(roots, pu).astype(np.int32)
    lv = np.searchsorted(roots, pv).astype(np.int32)
    m = roots.shape[0]
    lp, lr, lf, _ = model_union_edges_parity(
        rng, np.arange(m, dtype=np.int32), np.zeros(m, np.int32), False,
        lu, lv, link, valid)
    first = np.searchsorted(roots, roots)
    live = roots != INT_MAX
    new = roots.astype(np.int64)[lp[first]] * 2 + lr[first]
    packed = parent.astype(np.int64) * 2 + rel
    np.minimum.at(packed, roots[live], new[live])
    p2, r2 = packed >> 1, packed & 1
    return (p2[p2].astype(np.int32), (r2 ^ r2[p2]).astype(np.int32),
            bool(failed) or lf)


def model_merge_stack(rng, parents, rels, faileds):
    """``merge_parity_stack`` of ``[K, n]`` forests through the model."""
    k, n = parents.shape
    idx = np.tile(np.arange(n, dtype=np.int32), k)
    p, r, f, _ = model_union_edges_parity(
        rng, np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
        bool(np.any(faileds)), idx, parents.reshape(-1), rels.reshape(-1),
        np.ones(k * n, bool))
    return p, r, f


def model_two_coloring(parent, rel, seen):
    p, r, _ = model_pointer_jump_parity(parent, rel)
    return np.where(seen, p, -1), np.where(seen, r, -1)
