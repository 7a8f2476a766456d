"""gelly_torch union-find and scatter ops vs gelly_tpu's (CPU).

Same numpy inputs into both packages; tolerance: exact equality of the
returned arrays, dtype included. ``backend="kernel"`` on CPU tensors runs
the kernel's plain version and is held to the JAX ``"pallas"`` backend in
interpret mode, forest for forest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch.ops import kernels as tk
from gelly_torch.ops import segments as ts
from gelly_torch.ops import unionfind as tu
from gelly_tpu.ops import segments as js
from gelly_tpu.ops import unionfind as ju

N = 1 << 12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _random_forest(rng, n=N, depth_bias=0.7):
    # parent[i] <= i with long chains: a mid-stream forest, not flat.
    parent = np.arange(n, dtype=np.int32)
    for i in range(1, n):
        if rng.random() < depth_bias:
            parent[i] = rng.integers(max(0, i - 8), i)
    return parent


def _chain(n, shift=1):
    return np.maximum(np.arange(n, dtype=np.int32) - shift, 0).astype(np.int32)


def test_fresh_forest_and_segments():
    _same(tu.fresh_forest(N, "cpu"), ju.fresh_forest(N))
    rng = np.random.default_rng(0)
    tgt = rng.integers(0, 100, 64).astype(np.int32)
    idx = rng.integers(0, 64, 500).astype(np.int32)
    upd = rng.integers(-50, 150, 500).astype(np.int32)
    valid = rng.random(500) > 0.3
    for tf, jf in ((ts.masked_scatter_min, js.masked_scatter_min),
                   (ts.masked_scatter_max, js.masked_scatter_max),
                   (ts.masked_scatter_add, js.masked_scatter_add)):
        _same(tf(_t(tgt), _t(idx), _t(upd), _t(valid)),
              jf(jnp.asarray(tgt), jnp.asarray(idx), jnp.asarray(upd),
                 jnp.asarray(valid)))
    seen = rng.random(64) > 0.8
    _same(ts.mark_seen(_t(seen), _t(idx), _t(valid)),
          js.mark_seen(jnp.asarray(seen), jnp.asarray(idx),
                       jnp.asarray(valid)))
    assert ts.INT_MAX == js.INT_MAX


@pytest.mark.parametrize("name", ["deep-chain", "random-forest"])
def test_pointer_jump_labels_depth(name):
    rng = np.random.default_rng(1)
    parent = _chain(N) if name == "deep-chain" else _random_forest(rng)
    seen = rng.random(N) > 0.2
    _same(tu.pointer_jump(_t(parent)), ju.pointer_jump(jnp.asarray(parent)))
    _same(tu.component_labels(_t(parent), _t(seen)),
          ju.component_labels(jnp.asarray(parent), jnp.asarray(seen)))
    assert tu.chase_depth(_t(parent)) == ju.chase_depth(parent)
    x = rng.integers(0, N, 300).astype(np.int32)
    _same(tk.chase_roots_plain(_t(parent), _t(x)),
          ju._chase_roots(jnp.asarray(parent), jnp.asarray(x)))


def test_component_labels_is_fresh_tensor():
    parent = torch.arange(N, dtype=torch.int32)
    seen = torch.ones(N, dtype=torch.bool)
    lab = tu.component_labels(parent, seen)
    lab[0] = 7
    assert int(parent[0]) == 0


def test_chase_depth_rejects_cycle():
    with pytest.raises(ValueError, match="cycle"):
        tu.chase_depth(torch.tensor([1, 0], dtype=torch.int32))


def _pairs(rng, e=700):
    s = rng.integers(0, N, e).astype(np.int32)
    d = rng.integers(0, N, e).astype(np.int32)
    v = rng.random(e) > 0.1
    return s, d, v


def test_union_edges_rooted_and_fixpoint():
    rng = np.random.default_rng(2)
    parent = _random_forest(rng)
    s, d, v = _pairs(rng)
    P, S, D, V = (jnp.asarray(a) for a in (parent, s, d, v))
    _same(tu.union_edges(_t(parent), _t(s), _t(d), _t(v)),
          ju.union_edges(P, S, D, V))
    _same(tu.union_pairs_rooted(_t(parent), _t(s), _t(d), _t(v)),
          ju.union_pairs_rooted(P, S, D, V))
    # The fixpoint's star form (rv = ru[ri]), and with live0 off.
    ri = rng.integers(0, s.shape[0], s.shape[0]).astype(np.int32)
    _same(tk.rooted_fixpoint_plain(_t(parent), _t(s), _t(ri), _t(v),
                                   star=True),
          ju._rooted_fixpoint(P, S, lambda p, ru: ru[jnp.asarray(ri)], V,
                              jnp.bool_(True)))
    _same(tk.rooted_fixpoint_plain(_t(parent), _t(s), _t(s), _t(v),
                                   gate=torch.tensor(False)), P)


def test_merge_forests_and_stack():
    rng = np.random.default_rng(3)
    a = _random_forest(rng)
    b = _random_forest(rng, depth_bias=0.3)
    c = _chain(N, shift=3)
    _same(tu.merge_forests(_t(a), _t(b)),
          ju.merge_forests(jnp.asarray(a), jnp.asarray(b)))
    st = np.stack([a, b, c])
    _same(tu.merge_forest_stack(_t(st)), ju.merge_forest_stack(jnp.asarray(st)))


# --------------------------------------------------------------------- #
# union_edges_dedup — the adversarial streams of tests/test_pallas_fold.py


def _adversarial_streams():
    rng = np.random.default_rng(7)
    E = 1024
    ones = np.ones(E, bool)
    hot_s = np.where(rng.random(E) < 0.5, 3, rng.integers(0, N, E))
    hot_d = rng.integers(0, N, E)
    hot_d[::17] = hot_s[::17]
    rep_s = rng.integers(0, N, E)
    rep_d = rng.integers(0, N, E)
    perm = rng.permutation(2 * E)
    order = rng.permutation(2 * E - 1)
    ch_s = perm[:-1][order]
    ch_d = perm[1:][order]
    mk_s = rng.integers(0, N, E)
    mk_d = np.concatenate([mk_s[: E // 2], rng.integers(0, N, E // 2)])
    mask = rng.random(E) > 0.4
    i32 = np.int32
    return {
        "hot-vertex+self-loops": [
            (hot_s.astype(i32), hot_d.astype(i32), ones)],
        "already-rooted-repeat": [
            (rep_s.astype(i32), rep_d.astype(i32), ones),
            (rep_s.astype(i32), rep_d.astype(i32), ones)],
        "chain-merge": [
            (ch_s[:E].astype(i32), ch_d[:E].astype(i32), ones),
            # padded to E lanes so both chunks share one shape
            (np.append(ch_s[E:], 0).astype(i32),
             np.append(ch_d[E:], 0).astype(i32), np.append(ones[:E - 1], False))],
        "masked-duplicates": [
            (mk_s.astype(i32), mk_d.astype(i32), mask)],
    }


def _cap_overflow_streams():
    rng = np.random.default_rng(11)
    E = 512
    s = (np.arange(E, dtype=np.int32) * 2) % N
    d = ((np.arange(E, dtype=np.int32) * 2) + 1) % N
    zs = (rng.zipf(1.3, E) % N).astype(np.int32)
    zd = (rng.zipf(1.3, E) % N).astype(np.int32)
    ones = np.ones(E, bool)
    return {
        "unique-cap-overflow": ([(s, d, ones)], 64, None),
        "tail-cap-overflow": ([(s, d, ones)], E, 8),
        "zipf-both-caps": ([(zs, zd, ones)], 64, 8),
    }


_JAX_FOLDS: dict = {}


def _jax_fold(backend, unique_cap, tail_cap):
    key = (backend, unique_cap, tail_cap)
    if key not in _JAX_FOLDS:
        _JAX_FOLDS[key] = jax.jit(
            lambda p, s, d, v: ju.union_edges_dedup(
                p, s, d, v, unique_cap=unique_cap, tail_cap=tail_cap,
                backend=backend, interpret=True))
    return _JAX_FOLDS[key]


def _check_stream(chunks, backend, unique_cap, tail_cap=None):
    jbackend = {"plain": "xla", "kernel": "pallas"}[backend]
    jf = _jax_fold(jbackend, unique_cap, tail_cap)
    pj = ju.fresh_forest(N)
    pt = tu.fresh_forest(N, "cpu")
    for s, d, v in chunks:
        pj = jf(pj, jnp.asarray(s), jnp.asarray(d), jnp.asarray(v))
        pt = tu.union_edges_dedup(pt, _t(s), _t(d), _t(v),
                                  unique_cap=unique_cap, tail_cap=tail_cap,
                                  backend=backend)
        _same(pt, pj)  # the returned forest, chunk by chunk


@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("name", list(_adversarial_streams()))
def test_dedup_adversarial_streams(backend, name):
    _check_stream(_adversarial_streams()[name], backend, unique_cap=1024)


@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("name", list(_cap_overflow_streams()))
def test_dedup_cap_overflows(backend, name):
    chunks, ucap, tcap = _cap_overflow_streams()[name]
    _check_stream(chunks, backend, unique_cap=ucap, tail_cap=tcap)


def test_dedup_kernel_backend_with_window_misses():
    # At 2^16 slots a tile's double window covers half the table, so a
    # sparse uniform chunk makes the kernel miss: the missed lanes must
    # skip their hooks, resolve in the exact tail, and leave exactly the
    # reference "pallas" forest.
    from gelly_torch.ops.kernels import sorted_window_gather

    n = 1 << 16
    rng = np.random.default_rng(4)
    s = rng.integers(0, n, 2048).astype(np.int32)
    d = rng.integers(0, n, 2048).astype(np.int32)
    v = np.ones(2048, bool)
    uu, _, live0, _ = tu._dedup_pairs(_t(s), _t(d), _t(v), 2048)
    uu_k = torch.where(live0, uu, n - 1)
    assert (sorted_window_gather(tu.fresh_forest(n, "cpu"), uu_k) < 0).any()
    got = tu.union_edges_dedup(tu.fresh_forest(n, "cpu"), _t(s), _t(d),
                               _t(v), unique_cap=2048, backend="kernel")
    want = ju.union_edges_dedup(ju.fresh_forest(n), jnp.asarray(s),
                                jnp.asarray(d), jnp.asarray(v),
                                unique_cap=2048, backend="pallas",
                                interpret=True)
    _same(got, want)


def test_dedup_rejects_bad_backend_and_capacity():
    with pytest.raises(ValueError, match="kernel"):
        tu.union_edges_dedup(
            torch.arange(1000, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
            torch.ones(8, dtype=torch.bool), unique_cap=8, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        tu.union_edges_dedup(
            tu.fresh_forest(N, "cpu"), torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool),
            unique_cap=8, backend="pallas")


def test_fresh_forest_default_device_needs_a_card():
    if torch.cuda.is_available():
        assert tu.fresh_forest(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tu.fresh_forest(8)
