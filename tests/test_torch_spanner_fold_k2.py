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
folded by ``gelly_tpu``. The cases of ``tests/_fold_k2_cases.py`` add
both orientations of a pair in one sub-batch gated apart, an ordered pair
three times, pass-1 and pass-2 appends past ``D`` in one row, a pair
across a sub-batch seam and ragged last sub-batches.

Then a numpy model of ``csrc/spanner_fold_k2.cu``'s steps, held to
``gelly_tpu`` on every case and every field: the prepass (a hash table of
the first live lane of each ordered pair in its sub-batch, and the first
lane of the reversed pair), the kept rule a lane decides alone from both
orientations' gates, one ``(pass, lane)``-ordered placement of marks with
``atomicMin`` and carry from the fill count read off the rows, and the
next gates decoding the marks of the sub-batches before (its own read as
free slots). The model runs every row read and atomic as its own step, in
an order a scheduler picks (random, every read first, or lane by lane),
as the card's threads may, and after the last sub-batch lists the kept
lanes and writes their values over their marks, as the kernel's tail.
Then the wrapper's contract on the CPU. The kernel itself is
held to the plain version on the card in ``tests/test_torch_cuda.py``.
Tolerance: exact equality, dtype included.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch.ops import kernels

import _fold_k2_cases as named

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


def _wrapper_order(s):
    """A JAX summary's fields as numpy arrays in the wrapper's order."""
    return [np.asarray(getattr(s, f)) for f in (
        "nbr", "deg", "deg_overflow", "esrc", "edst", "n", "overflow")]


def _torch_fields(s):
    """The port's summary of a JAX one, as the wrapper's field order."""
    t = convert.sparse_spanner_summary_from_numpy(
        *[np.asarray(x) for x in s], device="cpu")
    return [t.nbr, t.deg, t.deg_overflow, t.esrc, t.edst, t.n, t.overflow]


def _case(name):
    """``(state, src, dst, valid, D, sub)`` of a named case."""
    if name in named.NAMES:
        fields, src, dst, valid, D, sub = named.case(name)
        nbr, deg, dover, esrc, edst, n, overflow = (
            jnp.asarray(x) for x in fields)
        return (jsp.SparseSpannerSummary(nbr, deg, esrc, edst, n, overflow,
                                         dover), src, dst, valid, D, sub)
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
         "u-and-v"] + list(named.NAMES) + [
             f"random-{s}" for s in range(8)]


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
    ("reversed", "dedup"), ("u-and-v", "both ways")] + [
        (x, "named") for x in named.NAMES])
def test_cases_reach_what_they_name(name, what):
    # The cases above must exercise what they are named for.
    state, src, dst, valid, D, sub = _case(name)
    out = _j_k2(state, src, dst, valid, D, sub)
    if what == "named":
        named.check_reaches(name, _wrapper_order(state), src, dst, valid, D,
                            sub, _wrapper_order(out))
    elif what == "deg_overflow":
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


# ------------------------------------------------------------------ #
# A numpy model of csrc/spanner_fold_k2.cu's steps

INT_MIN = -(1 << 31)
NONE = (1 << 31) - 1  # no reversed pair in the sub-batch
M64 = (1 << 64) - 1


def _mark(pas, g):
    """A pending append: its pass and the lane's index g in the chunk."""
    return INT_MIN + (pas << 30) + g


def _decode(x, lo, src, dst):
    """A row slot as the gate of the sub-batch whose lanes start at `lo`
    reads it: its own marks (g >= lo) are free (-1), an earlier mark is
    its value, ``dst[g]`` (pass 1) or ``src[g]`` (pass 2)."""
    if x >= -1:
        return x
    y = x - INT_MIN
    g = y & ((1 << 30) - 1)
    if g >= lo:
        return -1
    return int(src[g] if (y >> 30) & 1 else dst[g])


def _pair_slot(j, a, b, n, mask):
    key = ((a * n + b) ^ (j * 0xD6E8FEB86659FD93)) & M64
    return ((key * 0x9E3779B97F4A7C15) & M64) >> 32 & mask


def _slots(lanes):
    s = 64
    while s < 2 * lanes:
        s <<= 1
    return s


def _model_prepass(src, dst, valid, n, span, rng):
    """Per lane: -1 when it is not the first live lane of its ordered
    pair in its sub-batch, else the first lane of the reversed pair in
    that sub-batch (``NONE`` if none). As the kernel: every live lane
    inserts itself, in any order, into one table of lanes for the chunk
    keyed by its sub-batch and ordered pair, each key's slot keeping its
    lowest lane; then each lane that holds its key's slot probes for the
    reversed key."""
    B = src.shape[0]
    live = valid & (src != dst) & (src >= 0) & (src < n) & (dst >= 0) & (
        dst < n)
    rev = np.full(B, -1, np.int64)
    mask = _slots(B) - 1
    table = [-1] * (mask + 1)

    def key(g):
        return g // span, int(src[g]), int(dst[g])

    def home(j, a, b):
        return _pair_slot(j, a, b, n, mask)

    info = {}
    for g in rng.permutation(B).tolist():
        if not live[g]:
            continue
        k = key(g)
        s = home(*k)
        while True:
            o = table[s]
            if o == -1 or (key(o) == k and o > g):
                table[s] = g
                break
            if key(o) == k:
                break
            s = (s + 1) & mask
        info[g] = s
    for g, s in info.items():
        if table[s] != g:
            continue
        j, a, b = key(g)
        s = home(j, b, a)
        while table[s] != -1 and key(table[s]) != (j, b, a):
            s = (s + 1) & mask
        rev[g] = NONE if table[s] == -1 else table[s] - j * span
    return rev


def _model_fold(fields, src, dst, valid, D, sub, rng, policy, trace=None):
    """The kernel on numpy copies of ``fields`` (wrapper order): the
    prepass, one phase a sub-batch, then the tail. In a phase each
    candidate lane reads both its rows, decodes them, gates both
    orientations, decides alone whether it is kept and places its two
    marks (``atomicMin`` and carry from the fill count it read). Every
    read and atomic is a step of its own; ``policy`` orders the steps of
    the lanes: "random", "reads-first" (every lane reads before any
    places: no own mark is seen) or "lane-by-lane" (a lane reads after
    the lanes before it placed, in a random order). After the last phase
    the kept lanes go to the edge list in lane order, and each writes its
    values over its marks, one more in deg each. ``trace``, a dict, gets
    each sub-batch's kept lanes, its rows as they stand at the barrier,
    and how many marks the gates decoded, and of those how many were of
    the sub-batch just before."""
    nbr = fields[0].astype(np.int64).copy()
    deg = fields[1].astype(np.int64).copy()
    esrc, edst = fields[3].copy(), fields[4].copy()
    n_run, overflow = int(fields[5]), bool(fields[6])
    n, cap = nbr.shape[0], esrc.shape[0]
    B = src.shape[0]
    span = min(sub, B)
    rev = _model_prepass(src, dst, valid, n, span, rng)
    kept = np.zeros(B, bool)
    dropped = [0]
    decoded = [0, 0]

    def gate(g, lo):
        l = g - lo
        u, v, r = int(src[g]), int(dst[g]), int(rev[g])
        x = []
        for row in (u, v):
            for k in range(D):
                x.append(int(nbr[row, k]))
                yield "read"
        for y in x:
            if y < -1 and _decode(y, lo, src, dst) >= 0:
                decoded[0] += 1
                decoded[1] += ((y - INT_MIN) & ((1 << 30) - 1)) >= lo - span
        du = [_decode(y, lo, src, dst) for y in x[:D]]
        dv = [_decode(y, lo, src, dst) for y in x[D:]]
        direct_ab, direct_ba = v in du, u in dv
        common = any(y >= 0 and y in dv for y in du)
        keep = not (direct_ab or common) and (
            r == NONE or r > l or direct_ba)
        kept[g] = keep
        if not keep:
            return
        yield "decided"
        # One placement for both passes: (row, slot, carried mark).
        chains = [[u, sum(y >= 0 for y in du), _mark(0, g)],
                  [v, sum(y >= 0 for y in dv), _mark(1, g)]]
        for c in chains:
            if c[1] >= D:
                dropped[0] += 1
        chains = [c for c in chains if c[1] < D]
        while chains:
            for c in list(chains):
                old = int(nbr[c[0], c[1]])
                nbr[c[0], c[1]] = min(old, c[2])
                yield "place"
                if old == -1:
                    chains.remove(c)
                    continue
                c[2] = max(old, c[2])
                c[1] += 1
                if c[1] == D:
                    dropped[0] += 1
                    chains.remove(c)

    for lo in range(0, B, span):
        tasks = [[gate(g, lo), None] for g in range(lo, min(lo + span, B))
                 if rev[g] >= 0]
        if policy == "lane-by-lane":
            tasks = [tasks[i] for i in rng.permutation(len(tasks))]
        before = decoded[0]
        before_prev = decoded[1]
        while tasks:
            if policy == "lane-by-lane":
                i = 0
            elif policy == "reads-first":
                reading = [i for i, t in enumerate(tasks)
                           if t[1] in (None, "read")]
                i = int(rng.choice(reading or range(len(tasks))))
            else:
                i = int(rng.integers(len(tasks)))
            try:
                tasks[i][1] = next(tasks[i][0])
            except StopIteration:
                tasks.pop(i)
        if trace is not None:
            rows = np.array([[_decode(y, lo + span, src, dst) for y in row]
                             for row in nbr.tolist()])
            trace.setdefault("kept", []).append(
                set((np.flatnonzero(kept[lo:lo + span])).tolist()))
            trace.setdefault("rows", []).append(rows)
            trace.setdefault("decoded", []).append(decoded[0] - before)
            trace.setdefault("decoded_prev", []).append(
                decoded[1] - before_prev)
    # The tail and the finish launch.
    for g in np.flatnonzero(kept).tolist():
        if n_run < cap:
            esrc[n_run], edst[n_run] = src[g], dst[g]
        else:
            overflow = True
        n_run += 1
        for pas, row, val in ((0, src[g], dst[g]), (1, dst[g], src[g])):
            hit = np.flatnonzero(nbr[row] == _mark(pas, g))
            if hit.size:
                nbr[row, hit[0]] = val
                deg[row] += 1
    assert not (nbr < -1).any()  # no mark left when the launch returns
    return [nbr.astype(np.int32), deg.astype(np.int32),
            np.array(int(fields[2]) + dropped[0], np.int32), esrc, edst,
            np.array(n_run, np.int32), np.array(overflow)]


def _reference_steps(fields, src, dst, valid, D, sub):
    """``gelly_tpu``'s semantics sub-batch by sub-batch, written plainly:
    each sub-batch's kept lanes and its rows after its appends."""
    nbr = fields[0].astype(np.int64).copy()
    deg = fields[1].astype(np.int64).copy()
    n = nbr.shape[0]
    B = src.shape[0]
    span = min(sub, B)
    out = {"kept": [], "rows": []}
    for lo in range(0, B, span):
        hi = min(lo + span, B)
        first = {}
        for g in range(lo, hi):
            u, v = int(src[g]), int(dst[g])
            if not (valid[g] and u != v and 0 <= u < n and 0 <= v < n):
                continue
            ru, rv = nbr[u], nbr[v]
            if v in ru or any(y >= 0 and y in rv for y in ru):
                continue
            first.setdefault((min(u, v), max(u, v)), g)
        keep = sorted(first.values())
        for pas in (0, 1):
            for g in keep:
                a, b = (src[g], dst[g]) if pas == 0 else (dst[g], src[g])
                if deg[a] < D:
                    nbr[a, deg[a]] = b
                    deg[a] += 1
        out["kept"].append({g - lo for g in keep})
        out["rows"].append(nbr.copy())
    return out


POLICIES = ("random", "reads-first", "lane-by-lane")


@pytest.mark.parametrize("name", CASES + ["wide-sub-batch"])
def test_model_prepass_answers(name):
    if name == "wide-sub-batch":  # sub-batches wider than 2^14 lanes
        rng = np.random.default_rng(5)
        n, sub = 40, (1 << 14) + 100
        src, dst, valid = _random_lanes(rng, n, 2 * sub + 7)
    else:
        state, src, dst, valid, D, sub = _case(name)
        n = state.nbr.shape[0]
    span = min(sub, src.shape[0])
    rev = _model_prepass(src, dst, valid, n, span,
                         np.random.default_rng(len(name)))
    for lo in range(0, src.shape[0], span):
        first = {}
        for g in range(lo, min(lo + span, src.shape[0])):
            u, v = int(src[g]), int(dst[g])
            if valid[g] and u != v and 0 <= u < n and 0 <= v < n:
                first.setdefault((u, v), g - lo)
        for g in range(lo, min(lo + span, src.shape[0])):
            key = (int(src[g]), int(dst[g]))
            if first.get(key) != g - lo:
                assert rev[g] == -1, g
            else:
                assert rev[g] == first.get(key[::-1], NONE), g


@pytest.mark.parametrize("name", CASES)
def test_model_steps_equal_reference(name):
    # Each sub-batch: the lanes kept by the rule a lane decides alone,
    # and the rows after one (pass, lane)-ordered placement from the
    # fill count read off the rows, equal to the reference's
    # lowest-taken-lane dedup and its two passes.
    state, src, dst, valid, D, sub = _case(name)
    fields = _wrapper_order(state)
    trace = {}
    _model_fold(fields, src, dst, valid, D, sub,
                np.random.default_rng(len(name) + 1), "random", trace)
    want = _reference_steps(fields, src, dst, valid, D, sub)
    assert trace["kept"] == want["kept"]
    for got_rows, want_rows in zip(trace["rows"], want["rows"]):
        assert np.array_equal(got_rows, want_rows)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", CASES)
def test_model_equals_jax(name, policy):
    state, src, dst, valid, D, sub = _case(name)
    want = _wrapper_order(_j_k2(state, src, dst, valid, D, sub))
    got = _model_fold(_wrapper_order(state), src, dst, valid, D, sub,
                      np.random.default_rng(sum(map(ord, name + policy))),
                      policy)
    for field, a, b in zip(("nbr", "deg", "deg_overflow", "esrc", "edst",
                            "n", "overflow"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


@pytest.mark.parametrize("name", ["pair-across-boundary", "subs-3-ragged",
                                  "u-and-v", "dups-across", "random-5"])
def test_next_gate_decodes_previous_marks(name):
    # The gates read the marks of the sub-batch just before (and older
    # ones) pending and decode them, and the fold still equals
    # gelly_tpu's.
    state, src, dst, valid, D, sub = _case(name)
    trace = {}
    got = _model_fold(_wrapper_order(state), src, dst, valid, D, sub,
                      np.random.default_rng(7), "random", trace)
    assert sum(trace["decoded_prev"]) > 0
    want = _wrapper_order(_j_k2(state, src, dst, valid, D, sub))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_chain_floor_runs_only_on_a_card():
    state, src, dst, valid, D, sub = _case("sub-not-dividing")
    nbr = _torch_fields(state)[0]
    with pytest.raises(ValueError, match="runs on a card"):
        kernels.sparse_fold_chunk_k2_floor(nbr, torch.from_numpy(src), D,
                                           sub)
