"""The union-find fixpoints of ``gelly_torch/csrc/unionfind_fixpoint.cu``
against ``gelly_tpu`` (CPU).

Numpy models of the three kernels' schedules (``tests/_unionfind_cases.py``:
a round's chases in the forest at its start, then its hooks one lane at
a time in a seeded random order, as the card's ``atomicMin`` s land) and
the kernels' plain versions are held bit for bit to ``gelly_tpu``'s
``union_pairs_rooted``, ``union_pairs_star``, ``union_edges`` and
``pointer_jump`` on seeded Zipf forests of 64-4096 slots, a forest after
a dedup fold (not flat) and a chain 200 deep; their rounds to the plain
loops' rounds. The restructured ``union_edges_dedup`` (device gates, no
host read on the card) is held to the reference in each branch: the
distinct pairs fit, ``unique_cap`` overflows, ``tail_cap`` overflows, and
the kernel backend's window misses (the reference's Pallas kernel in
interpret mode). Tolerance: exact equality, dtype included.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.ops import kernels as tk
from gelly_torch.ops import unionfind as tu
from gelly_tpu.ops import unionfind as ju

import _unionfind_cases as uc

CASES = uc.cases()
ORDERS = (0, 1, 2)  # seeds of the models' hook orders

J_ROOTED = jax.jit(ju.union_pairs_rooted)
J_EDGES = jax.jit(ju.union_edges)
J_JUMP = jax.jit(ju.pointer_jump)
J_MERGE = jax.jit(ju.merge_forests)
J_STAR = jax.jit(ju.union_pairs_star)
J_STAR_FIXPOINT = jax.jit(lambda p, v, ri, valid: ju._rooted_fixpoint(
    p, v, lambda p_, ru: ru[ri], valid, jnp.bool_(True)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _lanes(name: str, n: int):
    rng = np.random.default_rng(len(name) * 1009 + n)
    return uc.zipf_pairs(rng, n, max(16, n // 2))


def _masked(s, d, v):
    return np.where(v, s, 0).astype(np.int32), np.where(v, d, 0).astype(
        np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_pointer_jump_model_plain_and_gelly_tpu(name):
    p = CASES[name]
    roots, hops = uc.model_pointer_jump(p)
    want = J_JUMP(jnp.asarray(p))
    _same(roots, want)
    _same(tu.pointer_jump(_t(p)), want)
    # The doubling loop takes ceil(log2(d)) rounds for a walk of d hops.
    assert hops > 1
    assert tk.pointer_jump_plain.rounds == math.ceil(math.log2(hops))
    seen = np.random.default_rng(3).random(p.shape[0]) > 0.3
    _same(tu.component_labels(_t(p), _t(seen)),
          ju.component_labels(jnp.asarray(p), jnp.asarray(seen)))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(CASES))
def test_rooted_pair_form_model_plain_and_gelly_tpu(name, order):
    p = CASES[name]
    s, d, v = _lanes(name, p.shape[0])
    ms, md = _masked(s, d, v)
    got, rounds = uc.model_rooted_fixpoint(
        np.random.default_rng(order), p, ms, md, v)
    want = J_ROOTED(*(jnp.asarray(a) for a in (p, s, d, v)))
    _same(got, want)
    _same(tu.union_pairs_rooted(_t(p), _t(s), _t(d), _t(v)), want)
    assert tk.rooted_fixpoint_plain.rounds == rounds >= 2


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(CASES))
def test_rooted_star_form_model_plain_and_gelly_tpu(name, order):
    p = CASES[name]
    n = p.shape[0]
    v, ri, valid = uc.star_rows(np.random.default_rng(n), n,
                                max(2, n // 32), 8)
    vm = np.where(valid, v, 0).astype(np.int32)
    got, rounds = uc.model_rooted_fixpoint(
        np.random.default_rng(order), p, vm, ri, valid, star=True)
    want = J_STAR_FIXPOINT(*(jnp.asarray(a) for a in (p, vm, ri, valid)))
    _same(got, want)
    _same(tk.rooted_fixpoint_plain(_t(p), _t(vm), _t(ri), _t(valid),
                                   star=True), want)
    assert tk.rooted_fixpoint_plain.rounds == rounds >= 2
    # The whole star fold: fast rounds, the device check, the fixpoint.
    _same(tu.union_pairs_star(_t(p), _t(v), _t(ri), _t(valid)),
          J_STAR(*(jnp.asarray(a) for a in (p, v, ri, valid))))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(CASES))
def test_union_edges_model_plain_and_gelly_tpu(name, order):
    p = CASES[name]
    s, d, v = _lanes(name, p.shape[0])
    got, rounds = uc.model_union_edges(np.random.default_rng(order), p, s,
                                       d, v)
    want = J_EDGES(*(jnp.asarray(a) for a in (p, s, d, v)))
    _same(got, want)
    _same(tu.union_edges(_t(p), _t(s), _t(d), _t(v)), want)
    assert tk.union_edges_plain.rounds == rounds >= 2


@pytest.mark.parametrize("name", list(CASES))
def test_merges_model_plain_and_gelly_tpu(name):
    a = CASES[name]
    n = a.shape[0]
    b = uc.zipf_forest(np.random.default_rng(n + 1), n)
    idx = np.arange(n, dtype=np.int32)
    got, rounds = uc.model_union_edges(np.random.default_rng(0), a, idx, b)
    want = J_MERGE(jnp.asarray(a), jnp.asarray(b))
    _same(got, want)
    _same(tu.merge_forests(_t(a), _t(b)), want)
    assert tk.union_edges_plain.rounds == rounds
    st = np.stack([a, b, uc.chain(n, min(n - 1, 64))])
    _same(tu.merge_forest_stack(_t(st)),
          ju.merge_forest_stack(jnp.asarray(st)))


@pytest.mark.parametrize("star", [False, True])
def test_rooted_fixpoint_gate_and_lane_bound(star):
    p = CASES["zipf-512"]
    s, d, v = _lanes("gate", 512)
    s, d = _masked(s, d, v)
    if star:
        d = np.random.default_rng(9).integers(0, s.shape[0], s.shape[0])
        d = d.astype(np.int32)
    args = (_t(p), _t(s), _t(d), _t(v))
    # A closed gate runs no round: one counted read, the forest as it was.
    before = tu.host_sync.count
    got = tk.rooted_fixpoint(*args, star=star, gate=torch.tensor(False))
    assert tu.host_sync.count - before == 1
    _same(got, p)
    assert tk.rooted_fixpoint_plain.rounds == 0
    # n_valid bounds the valid lanes, as the dedup fold's tail takes them.
    k = s.shape[0] // 3
    want, rounds = uc.model_rooted_fixpoint(
        np.random.default_rng(0), p, s, d, v, star=star, n_valid=k)
    got = tk.rooted_fixpoint(*args, star=star, gate=torch.tensor(True),
                             n_valid=torch.tensor(k))
    _same(got, want)
    assert tk.rooted_fixpoint_plain.rounds == rounds
    if not star:
        _same(want, J_ROOTED(*(jnp.asarray(a) for a in (
            p, s, d, v & (np.arange(s.shape[0]) < k)))))


def test_wrappers_reject_what_the_kernels_do_not_take():
    p = torch.arange(8, dtype=torch.int32)
    lanes = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="forest"):
        tk.pointer_jump(p.long())
    with pytest.raises(ValueError, match="dst"):
        tk.union_edges(p, lanes, lanes.long())
    with pytest.raises(ValueError, match="lanes"):
        tk.rooted_fixpoint(p, lanes, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="gate"):
        tk.rooted_fixpoint(p, lanes, lanes, gate=torch.ones(2, dtype=bool))
    with pytest.raises(ValueError, match="meta"):
        tk.pointer_jump(p.to("meta"))


# --------------------------------------------------------------------- #
# union_edges_dedup: each branch of the reference's two lax.conds


N_DEDUP = 1 << 12
N_MISS = 1 << 16  # a tile's double window covers half the table


def _dedup_branch(branch: str):
    """``(forest, src, dst, valid, unique_cap, tail_cap, open gates)``:
    the gates of the tail, the tail-overflow re-run and the unique-cap
    fallback that the branch opens."""
    rng = np.random.default_rng(len(branch))
    if branch == "window-misses":
        s = rng.integers(0, N_MISS, 2048).astype(np.int32)
        d = rng.integers(0, N_MISS, 2048).astype(np.int32)
        p = uc.zipf_forest(rng, N_MISS)
        return p, s, d, np.ones(2048, bool), 2048, None, (True, False, False)
    p = uc.zipf_forest(rng, N_DEDUP)
    if branch == "fits":
        s, d, v = uc.zipf_pairs(rng, N_DEDUP, 2048)
        return p, s, d, v, 2048, None, (True, False, False)
    if branch == "unique-cap-overflow":
        s, d, v = uc.zipf_pairs(rng, N_DEDUP, 2048)
        return p, s, d, v, 64, None, (False, False, True)
    # tail-cap-overflow: a path, whose depth-2 and depth-3 rounds find
    # interior nodes and leave most lanes alive for the tail.
    perm = rng.permutation(N_DEDUP).astype(np.int32)
    s, d = perm[:-1], perm[1:]
    return (np.arange(N_DEDUP, dtype=np.int32), s, d,
            np.ones(s.shape[0], bool), s.shape[0], 64, (True, True, False))


_JAX_DEDUP: dict = {}


def _jax_dedup(backend, unique_cap, tail_cap):
    key = (backend, unique_cap, tail_cap)
    if key not in _JAX_DEDUP:
        _JAX_DEDUP[key] = jax.jit(lambda p, s, d, v: ju.union_edges_dedup(
            p, s, d, v, unique_cap=unique_cap, tail_cap=tail_cap,
            backend=backend, interpret=True))
    return _JAX_DEDUP[key]


@pytest.mark.parametrize("branch,backend", [
    (b, k) for b in ("fits", "unique-cap-overflow", "tail-cap-overflow")
    for k in ("plain", "kernel")] + [("window-misses", "kernel")])
def test_dedup_branches_equal_gelly_tpu(branch, backend, monkeypatch):
    p, s, d, v, ucap, tcap, want_gates = _dedup_branch(branch)
    gates, gathers = [], []
    rooted, gather = tk.rooted_fixpoint, tk.sorted_window_gather

    def spy_rooted(*args, gate=None, **kw):
        gates.append(bool(gate))
        return rooted(*args, gate=gate, **kw)

    def spy_gather(table, sidx, **kw):
        out = gather(table, sidx, **kw)
        gathers.append(bool((out < 0).any()))
        return out

    monkeypatch.setattr(tk, "rooted_fixpoint", spy_rooted)
    monkeypatch.setattr(tk, "sorted_window_gather", spy_gather)
    got = tu.union_edges_dedup(_t(p), _t(s), _t(d), _t(v), unique_cap=ucap,
                               tail_cap=tcap, backend=backend)
    want = _jax_dedup({"plain": "xla", "kernel": "pallas"}[backend], ucap,
                      tcap)(*(jnp.asarray(a) for a in (p, s, d, v)))
    _same(got, want)
    assert tuple(gates) == want_gates
    # The kernel backend gathers in each of its three rounds, overflow or
    # not; only the window-miss case misses.
    assert len(gathers) == (3 if backend == "kernel" else 0)
    assert any(gathers) == (branch == "window-misses")
    # The branch is what numpy says it is.
    lo, hi = np.minimum(s, d)[v], np.maximum(s, d)[v]
    distinct = np.unique(lo.astype(np.int64) << 32 | hi).size
    assert (distinct > ucap) == (branch == "unique-cap-overflow")
