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


# ---------------------------------------------------------------------- #
# The parallel insert of csrc/hashset.cu, modelled in numpy
#
# Entry 1 of the kernel inserts a chunk in parallel: a dedup pass keeps
# the first lane of each key, then each first lane walks from its home
# slot with its lane as priority (keys already in the table first), taking
# a free slot or one held by a chunk key of lower priority, the displaced
# key walking on. The model runs those passes with each CUDA thread a
# generator that yields after every memory access, the threads interleaved
# in an order drawn from a seed (or highest lane first), and must give the
# scan's table, count and is_new whatever the order.

_EMPTY = kernels.HASH_EMPTY


def _run_threads(threads, rng):
    """Step the generators to their ends: ``rng`` picks the next thread at
    every step; without one, the highest-numbered runnable thread runs."""
    live = list(threads)
    while live:
        k = int(rng.integers(len(live))) if rng is not None else -1
        try:
            next(live[k])
        except StopIteration:
            live.pop(k)


def _model_insert(table, count, keys, valid, rng):
    """The kernel's four launches on numpy arrays: ``(table, count,
    is_new)``, or RuntimeError on a full table as the reference raises."""
    table = np.array(table, np.int64)
    keys = np.asarray(keys, np.int64)
    valid = np.asarray(valid, bool)
    cap = table.shape[0]
    mask = cap - 1
    n = keys.shape[0]
    slots = 64
    while slots < 2 * n:
        slots *= 2
    dedup = np.full(slots, -1, np.int64)
    owner = np.full(cap, -1, np.int64)
    lane_slot = np.full(n, -1, np.int64)
    is_new = np.zeros(n, bool)
    w = {"count": int(count), "status": 0, "sentinel": -1, "last_new": -1}
    homes = kernels._hash_np(keys, mask).astype(np.int64)
    dhomes = kernels._hash_np(keys, slots - 1).astype(np.int64)

    def cas(arr, i, old, new):
        if arr[i] == old:
            arr[i] = new
            return old
        return int(arr[i])

    def dedup_thread(i):
        if not valid[i]:
            return
        if keys[i] == _EMPTY:  # never stored; new at every live lane
            lane_slot[i] = -2
            is_new[i] = True
            w["count"] += 1
            w["sentinel"] = max(w["sentinel"], i)
            return
        s = int(dhomes[i])
        while True:
            o = int(dedup[s])
            yield
            if o == -1:
                o = cas(dedup, s, -1, i)
                yield
                if o == -1:
                    break
            if keys[o] == keys[i]:
                if o < i:
                    break
                got = cas(dedup, s, o, i)
                yield
                if got == o:
                    break
                continue
            s = (s + 1) & (slots - 1)
        lane_slot[i] = s

    def walk_thread(i):
        slot = int(lane_slot[i])
        if slot < 0 or dedup[slot] != i:
            return
        me, key, s, dist, fresh = i, keys[i], int(homes[i]), 0, False
        while True:
            if dist >= cap:
                w["status"] = 1
                return
            if dist % 64 == 63 and w["status"]:
                return
            if table[s] != _EMPTY:  # a key from before the chunk
                if table[s] == key:
                    return
                s, dist = (s + 1) & mask, dist + 1
                continue
            o = int(owner[s])
            yield
            if o == -1:
                o = cas(owner, s, -1, me)
                yield
                if o == -1:
                    fresh = True
                    break
            if o < me:
                s, dist = (s + 1) & mask, dist + 1
                continue
            got = cas(owner, s, o, me)
            yield
            if got != o:
                continue
            fresh = True
            me, key = o, keys[o]
            dist = ((s - int(homes[o])) & mask) + 1
            s = (s + 1) & mask
        if fresh:
            is_new[i] = True
            w["count"] += 1
            w["last_new"] = max(w["last_new"], i)

    _run_threads([dedup_thread(i) for i in range(n)], rng)
    _run_threads([walk_thread(i) for i in range(n)], rng)
    if w["status"]:
        raise RuntimeError("hash set full")
    free = bool(((owner == -1) & (table == _EMPTY)).any())
    out = np.where(owner >= 0, keys[np.maximum(owner, 0)], table)
    if w["sentinel"] >= 0 and not free and w["sentinel"] > w["last_new"]:
        raise RuntimeError("hash set full")
    return out, np.int32(w["count"]), is_new


def _keys_homed(cap, homes, count, rng, skip=()):
    """``count`` distinct keys whose home slots are the slots ``homes``."""
    cand = np.arange(1, 400 * cap, dtype=np.int64)
    cand = cand[np.isin(kernels._hash_np(cand, cap - 1), homes)
                & ~np.isin(cand, skip)]
    return rng.choice(cand, count, replace=False)


def _adversarial(name):
    """``(table, count, keys, valid)`` of a named case, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cap = 64
    pre = np.zeros(0, np.int64)
    if name == "few-homes":
        keys = _keys_homed(cap, [5, 6, 40], 24, rng)
        keys = np.concatenate([keys, keys[:6]])
    elif name == "wrap":
        keys = _keys_homed(cap, [cap - 2, cap - 1], 14, rng)
        keys = np.concatenate([keys, keys[3:7]])
    elif name == "prefilled-0.65":
        cap = 256
        pre = rng.choice(1 << 30, int(0.65 * cap), replace=False)
        keys = rng.choice(1 << 30, 60).astype(np.int64)
        keys[40:50] = pre[:10]  # keys already in the table
        keys[50:60] = keys[:10]
    elif name == "later-duplicate-first":
        # Lanes 2k and 2k + 1 share a key; lanes 1, 3, ... would reach
        # the slots first if threads ran highest lane first.
        keys = np.repeat(_keys_homed(cap, [9], 10, rng), 2)
        keys = np.concatenate([_keys_homed(cap, [8], 6, rng, keys), keys])
    elif name == "sentinel":
        keys = rng.choice(1 << 30, 40).astype(np.int64)
        keys[[3, 17, 30]] = _EMPTY
    elif name == "dead-lanes":
        keys = _keys_homed(cap, [20, 21], 30, rng)
        keys[10:20] = keys[:10]
    else:  # a seeded mix
        seed = int(name.split("-")[1])
        rng = np.random.default_rng(seed)
        cap = int(2 ** rng.integers(4, 9))
        pre = rng.choice(1 << 20, int(rng.integers(0, cap // 2)),
                         replace=False)
        # Fewer keys than free slots: the table never fills.
        keys = rng.integers(0, 3 * cap, int(rng.integers(1, cap // 2))
                            ).astype(np.int64)
    table = np.full(cap, _EMPTY, np.int64)
    count = np.int32(0)
    if pre.size:
        t, c, _ = kernels.hashset_insert_plain(
            torch.from_numpy(table), torch.zeros((), dtype=torch.int32),
            torch.from_numpy(pre.astype(np.int64)),
            torch.ones(pre.size, dtype=torch.bool))
        table, count = t.numpy(), np.int32(int(c))
    share = 0.7 if name == "dead-lanes" else 0.95
    valid = rng.random(keys.size) < share
    return table, count, keys.astype(np.int64), valid


_ADVERSARIAL = ["few-homes", "wrap", "prefilled-0.65",
                "later-duplicate-first", "sentinel", "dead-lanes"] + [
    f"mixed-{s}" for s in range(6)]


@pytest.mark.parametrize("order", ["highest-lane-first", 0, 1, 2])
@pytest.mark.parametrize("name", _ADVERSARIAL)
def test_parallel_insert_model_equals_jax(name, order):
    table, count, keys, valid = _adversarial(name)
    rng = None if order == "highest-lane-first" else \
        np.random.default_rng(order)
    got = _model_insert(table, count, keys, valid, rng)
    js, jnew = _j_insert(
        jhs.HashSetState(jax.numpy.asarray(table), jax.numpy.asarray(count)),
        jax.numpy.asarray(keys), jax.numpy.asarray(valid))
    want = (np.asarray(js.keys), np.asarray(js.count), np.asarray(jnew))
    plain = [x.numpy() for x in kernels.hashset_insert_plain(
        *(torch.from_numpy(np.asarray(x)) for x in (table, count, keys,
                                                    valid)))]
    for a, b, c, what in zip(got, want, plain, ("table", "count", "is_new")):
        assert np.array_equal(a, b), what
        assert np.array_equal(c, b), what
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


def test_adversarial_cases_reach_what_they_name():
    # Few homes and the wrap make long shared probe runs; the duplicate
    # case's later copies would win a race to the slot.
    table, _, keys, _ = _adversarial("few-homes")
    assert np.unique(kernels._hash_np(keys, table.size - 1)).size == 3
    table, _, keys, _ = _adversarial("wrap")
    homes = kernels._hash_np(keys, table.size - 1)
    assert set(homes.tolist()) == {table.size - 2, table.size - 1}
    table, count, keys, valid = _adversarial("prefilled-0.65")
    assert int(count) == int(0.65 * table.size)
    assert np.isin(keys, table).sum() >= 10
    _, _, keys, _ = _adversarial("sentinel")
    assert (keys == _EMPTY).sum() == 3
    _, _, _, valid = _adversarial("dead-lanes")
    assert (~valid).sum() >= 3


@pytest.mark.parametrize("order", [None, 0, 1])
@pytest.mark.parametrize("case", [
    "over-by-one", "exactly-full", "full-then-present", "sentinel-at-full",
    "sentinel-before-full"])
def test_parallel_insert_model_full_table_matches_reference(case, order):
    # The reference raises where its scan finds no free slot; the model
    # raises there too, and only there (JAX's scan would never end).
    cap = 16
    rng = np.random.default_rng(len(case))
    pre = rng.choice(1 << 20, 10, replace=False).astype(np.int64)
    fresh = rng.choice(np.arange(1 << 21, 1 << 22), 7, replace=False)
    keys = {"over-by-one": fresh,
            "exactly-full": fresh[:6],
            "full-then-present": np.concatenate([fresh[:6], pre[:3]]),
            "sentinel-at-full": np.concatenate([fresh[:6], [_EMPTY]]),
            "sentinel-before-full": np.concatenate([[_EMPTY], fresh[:6]]),
            }[case].astype(np.int64)
    t, c, _ = kernels.hashset_insert_plain(
        torch.full((cap,), _EMPTY, dtype=torch.int64),
        torch.zeros((), dtype=torch.int32), torch.from_numpy(pre),
        torch.ones(pre.size, dtype=torch.bool))
    valid = np.ones(keys.size, bool)
    args = (t.numpy(), np.int32(int(c)), keys, valid)
    try:
        want = [x.numpy() for x in kernels.hashset_insert_plain(
            *(torch.from_numpy(np.asarray(x)) for x in args))]
    except RuntimeError as e:
        assert "hash set full" in str(e)
        want = None
    assert (want is None) == (case in ("over-by-one", "sentinel-at-full"))
    rng = None if order is None else np.random.default_rng(order)
    if want is None:
        with pytest.raises(RuntimeError, match="hash set full"):
            _model_insert(*args, rng)
        return
    got = _model_insert(*args, rng)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
