"""gelly_torch's parity union-find vs gelly_tpu's (CPU).

Every function of ``ops/parity_unionfind.py`` gets the same numpy inputs
(made from a seed) in both packages: random graphs with random validity
masks and required parities, even and odd cycles, cross-forest conflicts,
stacked merges, and the compacted-root-space union on flat forests.
Tolerance: exact equality of every leaf, dtype included (i32 parent and
rel, bool failed, i32 labels and colors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.ops import parity_unionfind as tp
from gelly_torch.ops import unionfind as tuf
from gelly_tpu.ops import parity_unionfind as jp


# Jitted once per shape: eager while_loops would re-trace on every call.
_J_UNION = jax.jit(jp.union_edges_parity)
_J_COMPACT = jax.jit(jp.union_pairs_parity_compact)
_J_MERGE = jax.jit(jp.merge_parity_forests)
_J_STACK = jax.jit(jp.merge_parity_stack)
_J_JUMP = jax.jit(jp.pointer_jump_parity)
_J_COLOR = jax.jit(jp.two_coloring)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(jax_tree, torch_tree):
    assert len(jax_tree) == len(torch_tree)
    for a, b in zip(jax_tree, torch_tree):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _random_edges(rng, n, lanes, p_valid=0.8, parities="graph"):
    u = rng.integers(0, n, lanes).astype(np.int32)
    v = rng.integers(0, n, lanes).astype(np.int32)
    valid = rng.random(lanes) < p_valid
    q = (np.ones(lanes, np.int32) if parities == "graph"
         else rng.integers(0, 2, lanes).astype(np.int32))
    return u, v, q, valid


def _both_union(f_j, f_t, u, v, q, valid):
    g_j = _J_UNION(f_j, _j(u), _j(v), _j(q), _j(valid))
    g_t = tp.union_edges_parity(f_t, _t(u), _t(v), _t(q), _t(valid))
    _same(g_j, g_t)
    return g_j, g_t


def _fresh(n):
    return jp.fresh_parity_forest(n), tp.fresh_parity_forest(n, "cpu")


def _cycle(length, offset=0):
    u = np.arange(length, dtype=np.int32) + offset
    return u, np.roll(u, -1), np.ones(length, np.int32), np.ones(length, bool)


def test_fresh_forest_equals_gelly_tpu():
    _same(jp.fresh_parity_forest(9), tp.fresh_parity_forest(9, "cpu"))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n,lanes", [(16, 12), (64, 40), (256, 600)])
@pytest.mark.parametrize("parities", ["graph", "random"])
def test_union_edges_parity_random_graphs(seed, n, lanes, parities):
    rng = np.random.default_rng(seed * 1000 + n)
    f_j, f_t = _fresh(n)
    # Two successive unions: the second starts from a non-trivial forest.
    for _ in range(2):
        f_j, f_t = _both_union(f_j, f_t, *_random_edges(
            rng, n, lanes, parities=parities))


@pytest.mark.parametrize("length,odd", [(3, True), (4, False), (9, True),
                                        (16, False), (31, True), (2, False)])
def test_union_edges_parity_cycles(length, odd):
    f_j, f_t = _fresh(40)
    f_j, f_t = _both_union(f_j, f_t, *_cycle(length, offset=5))
    assert bool(f_t.failed) is odd
    labels, colors = tp.two_coloring(f_t, torch.ones(40, dtype=torch.bool))
    _same(_J_COLOR(f_j, jnp.ones(40, bool)), (labels, colors))
    if not odd:
        c = colors[5:5 + length]
        assert bool((c[1:] != c[:-1]).all())


def test_union_parity_self_loop_is_odd():
    f_j, f_t = _fresh(8)
    ones = np.ones(1, np.int32)
    f_j, f_t = _both_union(f_j, f_t, np.array([3], np.int32),
                           np.array([3], np.int32), ones, np.ones(1, bool))
    assert bool(f_t.failed)


def test_union_parity_invalid_lanes_never_fail():
    f_j, f_t = _fresh(8)
    tri = _cycle(3)
    f_j, f_t = _both_union(f_j, f_t, tri[0], tri[1], tri[2],
                           np.zeros(3, bool))
    assert not bool(f_t.failed)
    assert torch.equal(f_t.parent, torch.arange(8, dtype=torch.int32))


@pytest.mark.parametrize("seed", range(6))
def test_pointer_jump_parity_on_random_forests(seed):
    rng = np.random.default_rng(seed)
    n = 200
    # A random forest with parent[i] <= i and random parities (rel = 0 at
    # the roots), several levels deep.
    parent = np.array([rng.integers(0, i + 1) for i in range(n)], np.int32)
    rel = rng.integers(0, 2, n).astype(np.int32)
    rel[parent == np.arange(n)] = 0
    got = tp.pointer_jump_parity(_t(parent), _t(rel))
    _same(_J_JUMP(_j(parent), _j(rel)), got)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("parities", ["graph", "random"])
def test_union_pairs_parity_compact_on_flat_forests(seed, parities):
    rng = np.random.default_rng(100 + seed)
    n = 256
    f_j, f_t = _fresh(n)
    f_j, f_t = _both_union(f_j, f_t, *_random_edges(rng, n, 120,
                                                    parities=parities))
    for lanes, p_valid in ((24, 0.7), (24, 1.0), (1, 1.0), (64, 0.5)):
        u, v, q, valid = _random_edges(rng, n, lanes, p_valid, parities)
        g_j = _J_COMPACT(f_j, _j(u), _j(v), _j(q), _j(valid))
        g_t = tp.union_pairs_parity_compact(f_t, _t(u), _t(v), _t(q),
                                            _t(valid))
        _same(g_j, g_t)
        f_j, f_t = g_j, g_t


def test_union_pairs_parity_compact_equals_full_union_when_clean():
    # On a clean (bipartite) stream both unions give the same flat forest.
    rng = np.random.default_rng(7)
    n = 128
    left = rng.integers(0, n // 2, 50).astype(np.int32)
    right = (rng.integers(0, n // 2, 50) + n // 2).astype(np.int32)
    ones, valid = np.ones(50, np.int32), np.ones(50, bool)
    f = tp.fresh_parity_forest(n, "cpu")
    full = tp.union_edges_parity(f, _t(left), _t(right), _t(ones),
                                 _t(valid))
    compact = tp.union_pairs_parity_compact(f, _t(left), _t(right),
                                            _t(ones), _t(valid))
    for a, b in zip(full, compact):
        assert torch.equal(a, b)
    assert not bool(full.failed)


def test_union_pairs_parity_compact_capacity_guard_message():
    # Only the shape is read before the guard raises: no 2^30 allocation.
    big = 1 << 30
    f_j = jp.ParityForest(jax.ShapeDtypeStruct((big,), jnp.int32),
                          jax.ShapeDtypeStruct((big,), jnp.int32),
                          jnp.zeros((), bool))
    f_t = tp.ParityForest(torch.zeros(1, dtype=torch.int32).expand(big),
                          torch.zeros(1, dtype=torch.int32).expand(big),
                          torch.zeros((), dtype=torch.bool))
    lane = np.zeros(1, np.int32)
    with pytest.raises(ValueError) as ej:
        jp.union_pairs_parity_compact(f_j, _j(lane), _j(lane), _j(lane),
                                      _j(np.ones(1, bool)))
    with pytest.raises(ValueError) as et:
        tp.union_pairs_parity_compact(f_t, _t(lane), _t(lane), _t(lane),
                                      _t(np.ones(1, bool)))
    assert str(et.value) == str(ej.value)
    assert "< 2^30" in str(et.value)


@pytest.mark.parametrize("case", ["triangle", "even-square", "random"])
def test_merge_parity_forests(case):
    rng = np.random.default_rng(len(case))
    n = 32
    if case == "random":
        a_edges = _random_edges(rng, n, 20)
        b_edges = _random_edges(rng, n, 20)
    else:
        # Path 0-1-2 in forest a; b closes it: 0-2 (odd) or 0-3-2 (even).
        a_edges = (np.array([0, 1], np.int32), np.array([1, 2], np.int32),
                   np.ones(2, np.int32), np.ones(2, bool))
        bu, bv = (([0], [2]) if case == "triangle" else ([0, 3], [3, 2]))
        b_edges = (np.array(bu, np.int32), np.array(bv, np.int32),
                   np.ones(len(bu), np.int32), np.ones(len(bu), bool))
    a_j, a_t = _both_union(*_fresh(n), *a_edges)
    b_j, b_t = _both_union(*_fresh(n), *b_edges)
    merged = tp.merge_parity_forests(a_t, b_t)
    _same(_J_MERGE(a_j, b_j), merged)
    if case != "random":
        assert bool(merged.failed) is (case == "triangle")


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("k", [1, 4])
def test_merge_parity_stack(seed, k):
    rng = np.random.default_rng(seed)
    n = 16
    js, ts = [], []
    for _ in range(k):
        f_j, f_t = _both_union(*_fresh(n), *_random_edges(rng, n, 6, 1.0))
        js.append(f_j)
        ts.append(f_t)
    st_j = jp.ParityForest(*(jnp.stack(x) for x in zip(*js)))
    st_t = tp.ParityForest(*(torch.stack(x) for x in zip(*ts)))
    via_stack = tp.merge_parity_stack(st_t)
    _same(_J_STACK(st_j), via_stack)
    # The stacked merge equals the pairwise merges' verdict and labels.
    via_pairs = ts[0]
    for f in ts[1:]:
        via_pairs = tp.merge_parity_forests(via_pairs, f)
    assert bool(via_stack.failed) == bool(via_pairs.failed)
    if not bool(via_stack.failed):
        seen = torch.ones(n, dtype=torch.bool)
        assert torch.equal(tp.two_coloring(via_stack, seen)[0],
                           tp.two_coloring(via_pairs, seen)[0])


@pytest.mark.parametrize("seed", range(4))
def test_two_coloring_with_unseen_slots(seed):
    rng = np.random.default_rng(seed)
    n = 48
    f_j, f_t = _both_union(*_fresh(n), *_random_edges(rng, n, 30))
    seen = rng.random(n) < 0.6
    got = tp.two_coloring(f_t, _t(seen))
    _same(_J_COLOR(f_j, _j(seen)), got)
    assert bool((got[0][~_t(seen)] == -1).all())


def test_rounds_are_counted_host_syncs():
    # On CPU tensors the kernels' plain versions run: each fixpoint round
    # is one counted sync (the union's rounds, then the jump's doubling
    # rounds and its last test); the odd-cycle flag is not synced inside
    # the loops (a failing run takes as many syncs as the same parents
    # with a clean verdict). On the card no round is read on the host.
    from gelly_torch.ops import kernels as tk

    f = tp.fresh_parity_forest(16, "cpu")
    u, v, q, valid = _cycle(9)
    before = tuf.host_sync.count
    odd = tp.union_edges_parity(f, _t(u), _t(v), _t(q), _t(valid))
    odd_syncs = tuf.host_sync.count - before
    assert odd_syncs == (tk.union_edges_parity_plain.rounds
                         + tk.pointer_jump_parity_plain.rounds + 1)
    before = tuf.host_sync.count
    even = tp.union_edges_parity(f, _t(u), _t(v), _t(1 - q), _t(valid))
    even_syncs = tuf.host_sync.count - before
    assert bool(odd.failed) and not bool(even.failed)
    assert torch.equal(odd.parent, even.parent)
    assert odd_syncs >= 2 and even_syncs >= 2
