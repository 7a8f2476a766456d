"""gelly_torch's device hash set and ``distinct`` vs gelly_tpu's (CPU).

Holds ``insert_chunk`` (the table's slot layout bit for bit, ``count``,
``is_new``), ``contains_chunk``, ``_hash``, ``DeviceHashSet``'s growth by
rehash, and ``EdgeStream.distinct`` on both of its paths (the host LSM
runs and ``device=True``) to ``gelly_tpu`` on the same seeded keys, and to
a numpy first-occurrence oracle. JAX's scans run under ``jax.jit``. On
the CPU the port runs the kernels' plain versions. Tolerance: exact.
"""

import jax
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.ops import hashset as ths
from gelly_torch.ops import kernels
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.ops import hashset as jhs

_j_insert = jax.jit(jhs.insert_chunk)
_j_contains = jax.jit(jhs.contains_chunk)


def _keys(n, seed, hi=300, dup=0.3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, hi, n).astype(np.int64)
    k[rng.random(n) < dup] = k[0]  # in-chunk duplicates
    valid = rng.random(n) < 0.85
    return k, valid


def _t_state(cap):
    return ths.make_hashset(cap, device="cpu")


def test_empty_sentinel_and_hash_equal_jax():
    assert ths.EMPTY == int(jhs.EMPTY)
    keys = np.array([0, 1, 7, -5, 2**40 + 3, 2**62, -(2**62), 123456789],
                    np.int64)
    for mask in (15, 1023, (1 << 20) - 1):
        want = np.asarray(jhs._hash(jax.numpy.asarray(keys),
                                    jax.numpy.int32(mask)))
        got = ths._hash(torch.from_numpy(keys), mask).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(kernels._hash_np(keys, mask), want)


@pytest.mark.parametrize("cap,n,chunks,seed", [
    (16, 8, 1, 0), (64, 40, 1, 1), (256, 60, 3, 2), (1024, 200, 3, 3),
    (64, 30, 2, 4),
])
def test_insert_chunk_layout_count_is_new_equal_jax(cap, n, chunks, seed):
    js = jhs.make_hashset(cap)
    ts = _t_state(cap)
    for c in range(chunks):
        k, v = _keys(n, seed * 10 + c, hi=3 * cap)
        js, jnew = _j_insert(js, jax.numpy.asarray(k), jax.numpy.asarray(v))
        ts, tnew = ths.insert_chunk(ts, torch.from_numpy(k),
                                    torch.from_numpy(v))
        assert np.array_equal(tnew.numpy(), np.asarray(jnew))
        assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys))
        assert int(ts.count) == int(js.count)
        assert ts.count.dtype == torch.int32 and ts.count.shape == ()


def test_insert_wraps_probe_past_the_table_end():
    cap = 16
    # Keys whose home slot is the last slot: the probe wraps to slot 0.
    cand = np.arange(4000, dtype=np.int64)
    last = cand[kernels._hash_np(cand, cap - 1) == cap - 1][:5]
    assert last.size == 5
    v = np.ones(5, bool)
    js, jnew = _j_insert(jhs.make_hashset(cap), jax.numpy.asarray(last),
                         jax.numpy.asarray(v))
    ts, tnew = ths.insert_chunk(_t_state(cap), torch.from_numpy(last),
                                torch.from_numpy(v))
    assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys))
    assert ts.keys[0] != ths.EMPTY  # wrapped
    assert tnew.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contains_chunk_equal_jax(seed):
    cap = 128
    k, v = _keys(70, seed, hi=400)
    js, _ = _j_insert(jhs.make_hashset(cap), jax.numpy.asarray(k),
                      jax.numpy.asarray(v))
    ts, _ = ths.insert_chunk(_t_state(cap), torch.from_numpy(k),
                             torch.from_numpy(v))
    q = np.random.default_rng(seed + 50).integers(0, 500, 200).astype(
        np.int64)
    want = np.asarray(_j_contains(js, jax.numpy.asarray(q)))
    got = ths.contains_chunk(ts, torch.from_numpy(q)).numpy()
    assert np.array_equal(got, want)
    assert got[np.isin(q, k[v])].all()
    assert not got[~np.isin(q, k[v])].any()


def test_full_table_raises():
    keys = torch.arange(5, dtype=torch.int64)
    st = _t_state(4)
    with pytest.raises(RuntimeError, match="hash set full"):
        ths.insert_chunk(st, keys, torch.ones(5, dtype=torch.bool))


def test_device_hashset_growth_equals_jax():
    jset = jhs.DeviceHashSet(capacity=16)
    tset = ths.DeviceHashSet(capacity=16, device="cpu")
    for c in range(4):
        k, v = _keys(40, 100 + c, hi=500, dup=0.1)
        jn = jset.insert(jax.numpy.asarray(k), jax.numpy.asarray(v))
        tn = tset.insert(torch.from_numpy(k), torch.from_numpy(v))
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        assert np.array_equal(tset.state.keys.numpy(),
                              np.asarray(jset.state.keys))
        assert int(tset.state.count) == int(jset.state.count)
    assert tset.rehashes >= 2  # 16 -> ... grew by rehash


def test_hashset_state_convert_round_trip():
    """A JAX table continues in the port and the port's in JAX: the slot
    layout, ``count`` and ``is_new`` stay JAX's."""
    cap = 256
    chunks = [_keys(60, 70 + c, hi=600) for c in range(4)]
    js = jhs.make_hashset(cap)
    for k, v in chunks[:2]:
        js, _ = _j_insert(js, jax.numpy.asarray(k), jax.numpy.asarray(v))
    ts = convert.hashset_state_from_numpy(np.asarray(js.keys),
                                          np.asarray(js.count), device="cpu")
    keys, count = convert.hashset_state_to_numpy(ts)
    assert keys.dtype == np.int64 and count.dtype == np.int32
    assert np.array_equal(keys, np.asarray(js.keys))
    assert int(count) == int(js.count)
    k, v = chunks[2]
    js, jnew = _j_insert(js, jax.numpy.asarray(k), jax.numpy.asarray(v))
    ts, tnew = ths.insert_chunk(ts, torch.from_numpy(k), torch.from_numpy(v))
    assert np.array_equal(tnew.numpy(), np.asarray(jnew))
    assert np.array_equal(ts.keys.numpy(), np.asarray(js.keys))
    # The other way: the port's table continues in gelly_tpu.
    keys, count = convert.hashset_state_to_numpy(ts)
    back = jhs.HashSetState(jax.numpy.asarray(keys),
                            jax.numpy.asarray(count))
    k, v = chunks[3]
    jb, jbnew = _j_insert(back, jax.numpy.asarray(k), jax.numpy.asarray(v))
    js, jnew = _j_insert(js, jax.numpy.asarray(k), jax.numpy.asarray(v))
    assert np.array_equal(np.asarray(jbnew), np.asarray(jnew))
    assert np.array_equal(np.asarray(jb.keys), np.asarray(js.keys))
    with pytest.raises(TypeError, match="keys must be int64"):
        convert.hashset_state_from_numpy(keys.astype(np.int32), count,
                                         device="cpu")
    with pytest.raises(TypeError, match="count must be int32"):
        convert.hashset_state_from_numpy(keys, count.astype(np.int64),
                                         device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        convert.hashset_state_from_numpy(keys[:100], count, device="cpu")


def test_make_hashset_refuses_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        ths.make_hashset(12, device="cpu")


def _streams(src, dst, chunk, n_v):
    t = t_stream(TSource(src, dst, chunk_size=chunk, table=TIdentity(n_v)),
                 n_v, device="cpu")
    j = j_stream(JSource(src, dst, chunk_size=chunk, table=JIdentity(n_v)),
                 n_v)
    return t, j


def _first_occurrence(src, dst):
    seen, out = set(), []
    for s, d in zip(src.tolist(), dst.tolist()):
        out.append((s, d) not in seen)
        seen.add((s, d))
    return np.array(out)


@pytest.mark.parametrize("device", [None, True])
@pytest.mark.parametrize("chunk,seed", [(16, 0), (50, 1), (7, 2)])
def test_distinct_masks_equal_jax_and_oracle(device, chunk, seed):
    rng = np.random.default_rng(seed)
    n_v = 32
    src = rng.integers(0, 12, 300).astype(np.int64)
    dst = rng.integers(0, 12, 300).astype(np.int64)
    t, j = _streams(src, dst, chunk, n_v)
    tch = list(t.distinct(device=device))
    jch = list(j.distinct(device=device))
    assert len(tch) == len(jch)
    got = np.concatenate([c.valid.cpu().numpy() for c in tch])
    want = np.concatenate([np.asarray(c.valid) for c in jch])
    assert np.array_equal(got, want)
    n = src.size
    assert np.array_equal(got[:n], _first_occurrence(src, dst))
    assert not got[n:].any()


def test_distinct_picks_the_host_path_for_host_chunks():
    src = np.array([1, 1, 2, 1], np.int64)
    dst = np.array([2, 2, 3, 2], np.int64)
    t, _ = _streams(src, dst, 2, 8)
    d = t.distinct()
    chunks = list(d)
    assert all(c.is_host() for c in chunks)
    assert not hasattr(d, "hashset")  # no device set was built
    forced = t.distinct(device=True)
    out = list(forced)
    assert forced.hashset.rehashes == 0
    assert int(forced.hashset.state.count) == 2
    assert [c.valid.tolist() for c in out] == [[True, False],
                                              [True, False]]


def test_distinct_collect_edges_equal_jax(reference_edges):
    from gelly_torch import edge_stream_from_edges as t_edges
    from gelly_tpu import edge_stream_from_edges as j_edges

    edges = list(reference_edges) * 3
    t = t_edges(edges, vertex_capacity=16, chunk_size=4, device="cpu")
    j = j_edges(edges, vertex_capacity=16, chunk_size=4)
    for dev in (None, True):
        assert t.distinct(device=dev).collect_edges() == \
            j.distinct(device=dev).collect_edges()
