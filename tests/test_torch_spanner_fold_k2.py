"""gelly_torch's k = 2 chunk fold vs gelly_tpu's (CPU).

Holds ``kernels.sparse_fold_chunk_k2`` (on CPU tensors its plain version,
the reference of ``csrc/spanner_fold_k2.cu``) to ``gelly_tpu``'s
``_sparse_fold_chunk_k2`` (jitted, ``max_degree`` and ``sub`` static) on
every summary field: sub-batch sizes of 1, one that does not divide the
chunk and one larger than it; duplicate pairs inside a sub-batch, across
sub-batches and reversed; self-loops, dead lanes, ids at ``N - 1``; rows
that reach ``D`` and an edge list that overflows; a vertex that is the
source of some kept lanes and the destination of others in one
sub-batch. Inputs are made from a seed with numpy; states start empty or
folded by ``gelly_tpu``. Then the wrapper's contract on the CPU. The
kernel itself is held to this plain version on the card in
``tests/test_torch_cuda.py``. Tolerance: exact equality, dtype included.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.ops import kernels

jsp = importlib.import_module("gelly_tpu.library.spanner")

_j_k2 = jax.jit(jsp._sparse_fold_chunk_k2, static_argnums=(4, 5))

FIELDS = ("nbr", "deg", "esrc", "edst", "n", "overflow", "deg_overflow")


def _empty(n, D, E):
    return jsp.SparseSpannerSummary(
        jnp.full((n, D), -1, jnp.int32), jnp.zeros(n, jnp.int32),
        jnp.zeros(E, jnp.int32), jnp.zeros(E, jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
        jnp.zeros((), jnp.int32))


def _random_lanes(rng, n, L, share=0.9):
    src = (rng.zipf(1.4, L) % n).astype(np.int32)
    dst = rng.integers(0, n, L).astype(np.int32)
    valid = rng.random(L) < share
    return src, dst, valid


def _torch_fields(s):
    """The port's summary of a JAX one, as the wrapper's field order."""
    t = convert.sparse_spanner_summary_from_numpy(
        *[np.asarray(x) for x in s], device="cpu")
    return [t.nbr, t.deg, t.deg_overflow, t.esrc, t.edst, t.n, t.overflow]


def _case(name):
    """``(state, src, dst, valid, D, sub)`` of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, D, E, L, sub = 64, 4, 400, 250, 16
    pre = None
    if name == "sub-1":
        L, sub = 60, 1
    elif name == "sub-not-dividing":
        sub = 37
    elif name == "sub-larger-than-chunk":
        L, sub = 100, 300
    elif name.startswith("random-"):
        seed = int(name.split("-")[1])
        rng = np.random.default_rng(seed)
        n = int(rng.integers(8, 200))
        D = int(rng.integers(1, 9))
        E = int(rng.integers(4, 600))
        L = int(rng.integers(1, 400))
        sub = int(rng.integers(1, L + 40))
        pre = _random_lanes(rng, n, int(rng.integers(0, 200)))
    src, dst, valid = _random_lanes(rng, n, L)
    if name == "dups-within":
        src[20:30], dst[20:30] = src[0:10], dst[0:10]
        valid[:30] = True
    elif name == "dups-across":
        src[40:60], dst[40:60] = src[0:20], dst[0:20]
        valid[:60] = True
    elif name == "reversed":
        src[10:20], dst[10:20] = dst[0:10], src[0:10]  # same sub-batch
        src[50:60], dst[50:60] = dst[0:10], src[0:10]  # a later one
        valid[:60] = True
    elif name == "self-loops":
        loops = rng.random(L) < 0.4
        dst[loops] = src[loops]
    elif name == "all-dead":
        valid[:] = False
    elif name == "ids-at-n-1":
        hub = rng.random(L) < 0.3
        src[hub] = n - 1
        dst[rng.random(L) < 0.2] = n - 1
    elif name == "full-rows":
        D = 2
        src[rng.random(L) < 0.5] = 3  # one row takes many appends
    elif name == "list-overflow":
        E = 8
    elif name == "u-and-v":
        # Vertex 5 is the source of some lanes and the destination of
        # others in every sub-batch, with its row partly filled first.
        pre = (np.array([5, 5], np.int32), np.array([60, 61], np.int32),
               np.ones(2, bool))
        D = 6
        x = np.arange(L)
        src[x % 4 == 0] = 5
        dst[x % 4 == 2] = 5
        valid[:] = True
    state = _empty(n, D, E)
    if pre is not None:
        state = _j_k2(state, *pre, D, 7)
    return state, src, dst, valid, D, sub


CASES = ["sub-1", "sub-not-dividing", "sub-larger-than-chunk",
         "dups-within", "dups-across", "reversed", "self-loops",
         "all-dead", "ids-at-n-1", "full-rows", "list-overflow",
         "u-and-v"] + [f"random-{s}" for s in range(8)]


@pytest.mark.parametrize("name", CASES)
def test_fold_equals_jax(name):
    state, src, dst, valid, D, sub = _case(name)
    want = _j_k2(state, src, dst, valid, D, sub)
    got = _torch_fields(state)
    before = kernels.sparse_fold_chunk_k2.launches
    kernels.sparse_fold_chunk_k2(
        *got, *(torch.from_numpy(x) for x in (src, dst, valid)), D, sub)
    assert kernels.sparse_fold_chunk_k2.launches == before
    order = dict(zip(("nbr", "deg", "deg_overflow", "esrc", "edst", "n",
                      "overflow"), got))
    for field in FIELDS:
        a = order[field].numpy()
        b = np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


@pytest.mark.parametrize("name,what", [
    ("full-rows", "deg_overflow"), ("list-overflow", "overflow"),
    ("dups-within", "dedup"), ("dups-across", "dedup"),
    ("reversed", "dedup"), ("u-and-v", "both ways")])
def test_cases_reach_what_they_name(name, what):
    # The cases above must exercise what they are named for.
    state, src, dst, valid, D, sub = _case(name)
    out = _j_k2(state, src, dst, valid, D, sub)
    if what == "deg_overflow":
        assert int(out.deg_overflow) > int(state.deg_overflow)
    elif what == "overflow":
        assert bool(out.overflow) and int(out.n) > out.esrc.shape[0]
    elif what == "dedup":
        # Fewer pairs kept than lanes that clear the gate of an empty
        # state with the duplicates taken out of the chunk.
        keys = np.minimum(src, dst).astype(np.int64) * 64 + np.maximum(
            src, dst)
        live = valid & (src != dst)
        assert np.unique(keys[live]).size < int(live.sum())
    else:
        kept = np.asarray(out.nbr)[5]
        assert (kept >= 0).sum() == D  # row 5 filled from both passes
        assert int(out.deg[5]) == D


def test_wrapper_refuses_what_it_cannot_take():
    state, src, dst, valid, D, sub = _case("sub-not-dividing")
    fields = _torch_fields(state)
    s, d, v = (torch.from_numpy(x) for x in (src, dst, valid))
    with pytest.raises(ValueError, match="src"):
        kernels.sparse_fold_chunk_k2(*fields, s.long(), d, v, D, sub)
    with pytest.raises(ValueError, match="valid"):
        kernels.sparse_fold_chunk_k2(*fields, s, d, v.to(torch.uint8), D,
                                     sub)
    with pytest.raises(ValueError, match="dst"):
        kernels.sparse_fold_chunk_k2(*fields, s, d[:-1], v[:-1], D, sub)
    with pytest.raises(ValueError, match="on meta"):
        kernels.sparse_fold_chunk_k2(*fields, s.to("meta"), d, v, D, sub)
    wide = torch.stack([s, s], 1)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.sparse_fold_chunk_k2(*fields, wide[:, 0], d, v, D, sub)
    with pytest.raises(ValueError, match="sub must be positive"):
        kernels.sparse_fold_chunk_k2(*fields, s, d, v, D, 0)
    with pytest.raises(ValueError, match="spanner state nbr"):
        kernels.sparse_fold_chunk_k2(*fields, s, d, v, D + 1, sub)
    bad = list(fields)
    bad[1] = bad[1].long()
    with pytest.raises(ValueError, match="spanner state deg"):
        kernels.sparse_fold_chunk_k2(*bad, s, d, v, D, sub)


def test_wrapper_updates_in_place_and_counts_no_launch_on_cpu():
    state, src, dst, valid, D, sub = _case("dups-across")
    fields = _torch_fields(state)
    ptrs = [f.data_ptr() for f in fields]
    before = kernels.sparse_fold_chunk_k2.launches
    out = kernels.sparse_fold_chunk_k2(
        *fields, *(torch.from_numpy(x) for x in (src, dst, valid)), D, sub)
    assert out is None
    assert [f.data_ptr() for f in fields] == ptrs
    assert int(fields[5]) > 0  # n: edges were kept
    assert kernels.sparse_fold_chunk_k2.launches == before
