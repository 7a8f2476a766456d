"""Shared cases of the union-find fixpoint tests (CPU and card), and numpy
models of the schedules of ``gelly_torch/csrc/unionfind_fixpoint.cu``.

Every case is made with numpy from a seed. A forest keeps the
invariants the folds keep (``p[i] <= i``, a component's root its
minimum slot) and is deepened, so the chases walk real chains. The
models run each kernel's rounds as the card does, with the hooks of a
round applied one lane at a time in a seeded random order, as the
``atomicMin`` s land in some order on the card.
"""

from __future__ import annotations

import numpy as np

ZIPF_SIZES = (64, 512, 4096)
CHAIN_DEPTH = 200


def zipf_pairs(rng, n: int, e: int, p_valid: float = 0.9):
    """``e`` Zipf-endpoint lanes over ``n`` slots and a validity mask."""
    perm = rng.permutation(n).astype(np.int32)
    s = perm[rng.zipf(1.3, e) % n]
    d = perm[rng.zipf(1.3, e) % n]
    return s, d, rng.random(e) < p_valid


def canonical_labels(n: int, s, d, valid) -> np.ndarray:
    """Each slot's minimum slot in its component (a numpy union-find)."""
    par = np.arange(n)

    def find(a):
        while par[a] != a:
            par[a] = par[par[a]]
            a = par[a]
        return a

    for a, b, ok in zip(s.tolist(), d.tolist(), valid.tolist()):
        if ok:
            ra, rb = find(a), find(b)
            if ra != rb:
                par[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], dtype=np.int32)


def deepen(rng, labels: np.ndarray) -> np.ndarray:
    """A forest with the components of ``labels`` whose chains are deep:
    each slot's parent a random smaller slot of its component, so
    ``p[i] <= i`` and every root is its component's minimum."""
    n = labels.shape[0]
    parent = np.arange(n, dtype=np.int32)
    members: dict[int, list[int]] = {}
    for i in range(n):
        group = members.setdefault(int(labels[i]), [])
        if group:
            # Bias toward recent members: long chains, not stars.
            k = len(group) - 1 - min(int(rng.geometric(0.5)) - 1,
                                     len(group) - 1)
            parent[i] = group[k]
        group.append(i)
    return parent


def zipf_forest(rng, n: int) -> np.ndarray:
    """A mid-stream forest: ``n // 2`` Zipf edges unioned, then deepened."""
    s, d, v = zipf_pairs(rng, n, n // 2, 1.0)
    return deepen(rng, canonical_labels(n, s, d, v))


def chain(n: int, depth: int) -> np.ndarray:
    """Slots ``0..depth`` one chain ``depth`` deep, the rest singletons."""
    parent = np.arange(n, dtype=np.int32)
    parent[1:depth + 1] = np.arange(depth, dtype=np.int32)
    return parent


def star_rows(rng, n: int, rows: int, width: int, fill: float = 0.8):
    """Star-forest payload rows over ``n`` slots: ``(v, ri, valid)``.
    Each row holds distinct slots; its root is its first valid entry, and
    ``ri`` (in range on every lane, padding included) its row index."""
    v = np.zeros(rows * width, dtype=np.int32)
    ri = np.zeros(rows * width, dtype=np.int32)
    valid = np.zeros(rows * width, dtype=bool)
    for r in range(rows):
        k = max(1, int(rng.binomial(width, fill)))
        base = r * width
        v[base:base + k] = rng.choice(n, k, replace=False)
        valid[base:base + k] = True
        ri[base:base + width] = base
    return v, ri, valid


def after_dedup(rng, n: int) -> np.ndarray:
    """A non-flat forest as the raw fold leaves it: a Zipf forest after
    one ``union_edges_dedup`` chunk (its closing ``p[p]``), on the CPU."""
    import torch

    from gelly_torch.ops import unionfind

    s, d, v = zipf_pairs(rng, n, 2 * n)
    p = unionfind.union_edges_dedup(
        torch.from_numpy(zipf_forest(rng, n)), torch.from_numpy(s),
        torch.from_numpy(d), torch.from_numpy(v), unique_cap=2 * n)
    return p.numpy()


def cases(seed: int = 0) -> dict:
    """name -> forest: Zipf forests of each size, a forest after a dedup
    fold, and a chain."""
    rng = np.random.default_rng(seed)
    out = {f"zipf-{n}": zipf_forest(rng, n) for n in ZIPF_SIZES}
    out["after-dedup-1024"] = after_dedup(rng, 1024)
    out[f"chain-{CHAIN_DEPTH}"] = chain(1024, CHAIN_DEPTH)
    return out


# ------------------------------------------------------------------ #
# numpy models of the kernels' schedules


def roots(p: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Each lane of ``x`` walked to its root in ``p``."""
    x = x.copy()
    while True:
        g = p[x]
        if np.array_equal(g, x):
            return x
        x = g


def model_pointer_jump(p: np.ndarray):
    """Kernel 2: ``(every slot's root, the longest walk in hops)``."""
    x = np.arange(p.shape[0], dtype=p.dtype)
    hops = 0
    while True:
        g = p[x]
        if np.array_equal(g, x):
            return x, hops
        x = g
        hops += 1


def model_rooted_fixpoint(rng, parent, x, y, valid=None, *, star=False,
                          gate=True, n_valid=None):
    """Kernel 1: ``(forest, rounds)``. Phase A walks every active lane
    (star form: every lane, then ``ru[ri]``) in the forest at the
    round's start; if no lane is live the loop ends; phase B applies the
    hooks one lane at a time in a random order."""
    p = parent.copy()
    if not gate:
        return p, 0
    lanes = x.shape[0]
    act = np.ones(lanes, bool) if valid is None else valid.copy()
    if n_valid is not None:
        act &= np.arange(lanes) < n_valid
    rounds = 0
    while True:
        rounds += 1
        ru = roots(p, x)
        rv = ru[y] if star else roots(p, y)
        lo, hi = np.minimum(ru, rv), np.maximum(ru, rv)
        live = act & (lo != hi)
        if not live.any():
            return p, rounds
        for i in rng.permutation(np.flatnonzero(live)):
            p[hi[i]] = min(p[hi[i]], lo[i])


def model_union_edges(rng, parent, src, dst, valid=None):
    """Kernel 3 and the jump after it: ``(forest, rounds)``. A round
    reads ``r`` at the round's start, scatter-mins into a copy one lane
    at a time in a random order, then doubles from the copy; it ends
    after a round that moved nothing."""
    r = parent.copy()
    act = np.ones(src.shape[0], bool) if valid is None else valid
    rounds = 0
    while True:
        rounds += 1
        b = r.copy()
        lu, lv = r[src], r[dst]
        lo, hi = np.minimum(lu, lv), np.maximum(lu, lv)
        for i in rng.permutation(np.flatnonzero(act & (lo != hi))):
            b[hi[i]] = min(b[hi[i]], lo[i])
        nv = b[b]
        moved = not np.array_equal(nv, r)
        r = nv
        if not moved:
            return model_pointer_jump(r)[0], rounds
