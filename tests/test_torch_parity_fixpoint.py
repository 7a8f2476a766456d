"""The parity union-find of ``gelly_torch/csrc/unionfind_fixpoint.cu``
against ``gelly_tpu`` (CPU).

Numpy models of the two parity kernels (``tests/_parity_cases.py``:
kernel 1's rounds on the packed word with three rotating buffers and a
round's hooks applied one lane at a time in a seeded random order, as the
card's ``atomicMin`` s land; kernel 2's walk-to-root rule) and the
kernels' plain versions are held bit for bit (``parent``, ``rel``,
``failed``) to ``gelly_tpu``'s ``union_edges_parity``,
``pointer_jump_parity``, ``union_pairs_parity_compact``,
``merge_parity_stack`` and ``two_coloring``, run jitted on the CPU, on
seeded Zipf forests of 64-4096 slots, the same with ``rel = 1`` at their
roots, a flat forest (the jump runs no round), a chain 100 deep, even and
odd cycles, self-loops, invalid lanes, two lanes on one ``(hi, lo)`` pair
with opposite parities and K-stacked merges; the rounds to the plain
loops' rounds. ``segments.mark_seen`` is held to ``gelly_tpu``'s on
masked and duplicate indices. Tolerance: exact equality, dtype included.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.ops import kernels as tk
from gelly_torch.ops import parity_unionfind as tp
from gelly_torch.ops import segments as ts
from gelly_tpu.ops import parity_unionfind as jp
from gelly_tpu.ops import segments as js

import _parity_cases as pc

CASES = pc.cases()
LANE_CASES = pc.lane_cases()
ORDERS = (0, 1, 2)  # seeds of the model's hook orders

J_UNION = jax.jit(jp.union_edges_parity)
J_JUMP = jax.jit(jp.pointer_jump_parity)
J_COMPACT = jax.jit(jp.union_pairs_parity_compact)
J_STACK = jax.jit(jp.merge_parity_stack)
J_COLOR = jax.jit(jp.two_coloring)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


def _same_forest(got, want):
    """Two ``(parent, rel, failed)`` triples: numpy model output (a
    Python bool failed), torch or JAX."""
    for a, b in zip(got[:2], want[:2]):
        _same(a, b)
    assert bool(got[2]) is bool(want[2])
    if not isinstance(got[2], bool) and not isinstance(want[2], bool):
        _same(got[2], want[2])


def _j_forest(parent, rel, failed=False):
    return jp.ParityForest(jnp.asarray(parent), jnp.asarray(rel),
                           jnp.asarray(failed))


def _t_forest(parent, rel, failed=False):
    return tp.ParityForest(_t(parent), _t(rel), torch.tensor(failed))


def _depths(p):
    x = np.arange(p.shape[0])
    d = np.zeros(p.shape[0], np.int64)
    while not np.array_equal(p[x], x):
        moving = p[x] != x
        x = np.where(moving, p[x], x)
        d += moving
    return d


def test_cases_reach_what_they_name():
    for name, (p, r) in CASES.items():
        roots = p == np.arange(p.shape[0])
        assert (p <= np.arange(p.shape[0])).all(), name
        assert set(np.unique(r)) <= {0, 1}, name
        longest = int(_depths(p).max())
        if name.startswith("roots-rel1"):
            assert (r[roots] == 1).all() and longest >= 2, name
        elif name.startswith("flat"):
            assert longest == 1 and (r[roots] == 1).any() \
                and (r[roots] == 0).any(), name
        elif name.startswith("chain"):
            assert longest == pc.CHAIN_DEPTH >= 64 and r[0] == 1, name
        else:
            assert longest >= 3 and (r[roots] == 0).all(), name
    # The opposite-parity pair conflicts only in the second round.
    u, v, q, valid, _ = LANE_CASES["opposite-pair-lo-first"]
    f = tp.fresh_parity_forest(pc.LANE_N, "cpu")
    out = tk.union_edges_parity_plain(f.parent, f.rel, f.failed, _t(u),
                                      _t(v), _t(q), _t(valid))
    assert bool(out[2]) and tk.union_edges_parity_plain.rounds >= 2


@pytest.mark.parametrize("name", list(CASES))
def test_pointer_jump_parity_model_plain_and_gelly_tpu(name):
    p, r = CASES[name]
    mp, mr, longest = pc.model_pointer_jump_parity(p, r)
    want = J_JUMP(jnp.asarray(p), jnp.asarray(r))
    _same(mp, want[0])
    _same(mr, want[1])
    got = tp.pointer_jump_parity(_t(p), _t(r))
    _same(got[0], want[0])
    _same(got[1], want[1])
    # The doubling loop takes ceil(log2(d)) rounds for a walk of d hops.
    rounds = tk.pointer_jump_parity_plain.rounds
    assert rounds == (0 if longest <= 1 else math.ceil(math.log2(longest)))
    if name.startswith("flat"):
        assert rounds == 0
        _same(mr, r)  # roots keep rel = 1: no round ran
    else:
        assert rounds >= 2
        roots = mp == np.arange(p.shape[0])
        assert (mr[roots] == 0).all()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(CASES))
def test_union_edges_parity_model_plain_and_gelly_tpu(name, order):
    p, r = CASES[name]
    u, v, q, valid = pc.case_lanes(name, p.shape[0])
    got = pc.model_union_edges_parity(np.random.default_rng(order), p, r,
                                      False, u, v, q, valid)
    want = J_UNION(_j_forest(p, r), *(jnp.asarray(a) for a in (u, v, q,
                                                              valid)))
    _same_forest(got[:3], want)
    plain = tp.union_edges_parity(_t_forest(p, r), _t(u), _t(v), _t(q),
                                  _t(valid))
    _same_forest(plain, want)
    assert tk.union_edges_parity_plain.rounds == got[3] >= 2


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_lane_cases_model_plain_and_gelly_tpu(name):
    u, v, q, valid, odd = LANE_CASES[name]
    n = pc.LANE_N
    p0, r0 = np.arange(n, dtype=np.int32), np.zeros(n, np.int32)
    want = J_UNION(_j_forest(p0, r0), *(jnp.asarray(a) for a in (
        u, v, q, valid)))
    assert bool(want.failed) is odd
    for order in ORDERS:
        got = pc.model_union_edges_parity(np.random.default_rng(order), p0,
                                          r0, False, u, v, q, valid)
        _same_forest(got[:3], want)
    plain = tp.union_edges_parity(_t_forest(p0, r0), _t(u), _t(v), _t(q),
                                  _t(valid))
    _same_forest(plain, want)
    assert tk.union_edges_parity_plain.rounds == got[3]
    # A failed forest stays failed; the parents do not depend on it.
    again = tp.union_edges_parity(_t_forest(p0, r0, True), _t(u), _t(v),
                                  _t(q), _t(valid))
    assert bool(again.failed)
    _same(again.parent, plain.parent)


@pytest.mark.parametrize("seed", range(4))
def test_compact_model_plain_and_gelly_tpu(seed):
    rng = np.random.default_rng(200 + seed)
    n = 512
    u, v, q, valid = pc.zipf_lanes(rng, n, 200, parities="graph")
    f0 = J_UNION(_j_forest(np.arange(n, dtype=np.int32),
                           np.zeros(n, np.int32)),
                 *(jnp.asarray(a) for a in (u, v, q, valid)))
    p, r, failed = (np.array(x) for x in f0)
    for lanes, p_valid in ((24, 0.7), (1, 1.0), (64, 0.5)):
        u, v, q, valid = pc.zipf_lanes(rng, n, lanes, p_valid)
        want = J_COMPACT(_j_forest(p, r, failed),
                         *(jnp.asarray(a) for a in (u, v, q, valid)))
        got = pc.model_compact(np.random.default_rng(seed), p, r,
                               bool(failed), u, v, q, valid)
        _same_forest(got, want)
        plain = tp.union_pairs_parity_compact(
            _t_forest(p, r, bool(failed)), _t(u), _t(v), _t(q), _t(valid))
        _same_forest(plain, want)
        p, r, failed = (np.array(x) for x in want)


@pytest.mark.parametrize("k", [2, 4])
def test_merge_parity_stack_model_plain_and_gelly_tpu(k):
    rng = np.random.default_rng(k)
    n = 512
    forests = [pc.parity_forest(rng, n) for _ in range(k - 1)]
    forests.append(pc.chain(rng, n, 64))
    parents = np.stack([f[0] for f in forests])
    rels = np.stack([f[1] for f in forests])
    faileds = np.zeros(k, bool)
    faileds[-1] = k == 4
    want = J_STACK(jp.ParityForest(jnp.asarray(parents), jnp.asarray(rels),
                                   jnp.asarray(faileds)))
    got = pc.model_merge_stack(np.random.default_rng(0), parents, rels,
                               faileds)
    _same_forest(got, want)
    plain = tp.merge_parity_stack(tp.ParityForest(
        _t(parents), _t(rels), _t(faileds)))
    _same_forest(plain, want)


@pytest.mark.parametrize("name", list(CASES))
def test_two_coloring_model_plain_and_gelly_tpu(name):
    p, r = CASES[name]
    seen = np.random.default_rng(len(name)).random(p.shape[0]) < 0.7
    want = J_COLOR(_j_forest(p, r), jnp.asarray(seen))
    got = pc.model_two_coloring(p, r, seen)
    plain = tp.two_coloring(_t_forest(p, r), _t(seen))
    for a, b, c in zip(got, plain, want):
        _same(a.astype(np.int32), c)
        _same(b, c)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = torch.arange(8, dtype=torch.int32)
    r = torch.zeros(8, dtype=torch.int32)
    f = torch.tensor(False)
    lanes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="rel"):
        tk.pointer_jump_parity(p, r[:4])
    with pytest.raises(ValueError, match="forest"):
        tk.pointer_jump_parity(p.long(), r)
    with pytest.raises(ValueError, match="q"):
        tk.union_edges_parity(p, r, f, lanes, lanes, lanes.long())
    with pytest.raises(ValueError, match="failed"):
        tk.union_edges_parity(p, r, torch.zeros(2, dtype=torch.bool),
                              lanes, lanes, lanes)
    with pytest.raises(ValueError, match="meta"):
        tk.pointer_jump_parity(p.to("meta"), r.to("meta"))
    # The packed word is int32: 2^30 slots are refused before anything is
    # read (no 2^30 allocation), on every device.
    big = 1 << 30
    wide = torch.zeros(1, dtype=torch.int32).expand(big)
    with pytest.raises(ValueError) as e:
        tk.union_edges_parity(wide, wide, f, lanes, lanes, lanes)
    assert str(e.value) == (
        "union_edges_parity: vertex capacity must be < 2^30 (got "
        f"{big}; the packed parity scatter word is int32)")


@pytest.mark.parametrize("case", ["masked", "duplicates", "all-masked"])
def test_mark_seen_equals_gelly_tpu(case):
    rng = np.random.default_rng(len(case))
    n = 64
    seen = rng.random(n) < 0.2
    idx = rng.integers(0, n, 200).astype(np.int32)
    if case == "duplicates":
        idx[:100] = idx[100:]
    valid = {"masked": rng.random(200) < 0.5,
             "duplicates": np.ones(200, bool),
             "all-masked": np.zeros(200, bool)}[case]
    want = js.mark_seen(jnp.asarray(seen), jnp.asarray(idx),
                        jnp.asarray(valid))
    _same(ts.mark_seen(_t(seen), _t(idx), _t(valid)), want)
