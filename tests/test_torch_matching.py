"""gelly_torch's weighted matching vs gelly_tpu's (CPU).

Mirrors ``tests/test_examples.py``'s matching cases on the port (the
reference oracle, eviction, the f32/f64 threshold divergence, the native
fold against the Python fallback, the ½-approximation bound, the device
path against the host, the event stream, the same-edge re-match), then
holds the port to ``gelly_tpu`` on seeded weighted streams: the host path
(native and Python fallback, final matchings and ordered events), the
``matching_chunk_fold`` binding, and the device path's fold, whose plain
version (the kernel's, on the CPU) must equal JAX's f32
``_matching_step`` bit for bit, state by state. Tolerance: exact
equality (f64 on the host paths, f32 on the device paths).
"""

import importlib

import numpy as np
import pytest
import torch

from gelly_torch import convert
from gelly_torch import edge_stream_from_edges as t_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library.matching import weighted_matching
from gelly_torch.utils import native as tnative
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.utils import native as jnative

from _torch_native import load_jax_native

TM = importlib.import_module("gelly_torch.library.matching")
JM = importlib.import_module("gelly_tpu.library.matching")


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    # A lost build race with another test process is a wait.
    load_jax_native("matching")


def _stream(edges, n_v, chunk):
    return t_edges(edges, vertex_capacity=n_v, chunk_size=chunk,
                   device="cpu")


def reference_matching(edges):
    """The reference's exact sequential algorithm
    (CentralizedWeightedMatching.java:76-107)."""
    matching: set = set()
    for u, v, w in edges:
        coll = {e for e in matching if u in e[:2] or v in e[:2]}
        if w > 2 * sum(e[2] for e in coll):
            matching -= coll
            matching.add((u, v, w))
    return {(min(a, b), max(a, b), w) for a, b, w in matching}


def _random_edges(seed, n_e, n_v, wmax=100, loops=True):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b), float(w)) for (a, b), w in zip(
        rng.integers(0, n_v, (n_e, 2)), rng.integers(1, wmax, n_e))
        if loops or a != b]


# ---------------------------------------------------------------------- #
# tests/test_examples.py's matching cases, on the port


@pytest.mark.parametrize("chunk_size", [1, 4, 16])
def test_matching_parity_with_reference_oracle(chunk_size):
    edges = _random_edges(2, 50, 20, loops=False)
    got = {(min(a, b), max(a, b), w) for a, b, w in
           weighted_matching(_stream(edges, 32, chunk_size)).final_matching()}
    assert got == reference_matching(edges)


def test_matching_eviction():
    edges = [(1, 2, 10.0), (3, 4, 10.0), (2, 3, 45.0)]
    assert weighted_matching(_stream(edges, 8, 3)).final_matching() == [
        (2, 3, 45.0)]
    edges2 = [(1, 2, 10.0), (3, 4, 10.0), (2, 3, 20.0)]
    assert sorted(weighted_matching(_stream(edges2, 8, 3)).final_matching()
                  ) == [(1, 2, 10.0), (3, 4, 10.0)]


def test_matching_f32_f64_threshold_divergence():
    b, c = 1.0, 3 * 2**-24
    w = 2 + 2**-21
    assert w > 2.0 * (b + c)
    assert not (
        np.float32(w) > np.float32(2.0) * (np.float32(b) + np.float32(c)))
    edges = [(0, 1, b), (2, 3, c), (1, 3, w)]
    host = weighted_matching(_stream(edges, 8, 4)).final_matching()
    assert host == [(1, 3, w)]
    dev = weighted_matching(_stream(edges, 8, 4), device=True
                            ).final_matching()
    assert dev == [(0, 1, b), (2, 3, c)]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_matching_native_fold_matches_python_fallback(monkeypatch, pkg):
    mod, mk = (TM, _stream) if pkg == "torch" else (
        JM, lambda e, n, c: j_edges(e, vertex_capacity=n, chunk_size=c))
    edges = _random_edges(11, 2000, 128, wmax=500)

    def run():
        ws = mod.weighted_matching(mk(edges, 128, 64))
        evs = list(ws.events())
        return evs, sorted(ws.final_matching())

    monkeypatch.setattr(mod, "_NATIVE", False)  # the Python loop
    evs_py, fin_py = run()
    monkeypatch.setattr(mod, "_NATIVE", None)  # re-probe the native fold
    assert mod._native_ok()
    evs_nat, fin_nat = run()
    assert fin_nat == fin_py
    assert evs_nat == evs_py


def test_matching_half_approximation_bound():
    edges = _random_edges(8, 40, 12, wmax=50, loops=False)
    greedy = weighted_matching(_stream(edges, 16, 8)).total_weight()
    best: dict = {}
    for u, v, w in edges:
        k = (min(u, v), max(u, v))
        best[k] = max(best.get(k, 0), w)
    items = list(best.items())

    def brute(i, used):
        if i == len(items):
            return 0.0
        (u, v), w = items[i]
        skip = brute(i + 1, used)
        if u not in used and v not in used:
            return max(skip, w + brute(i + 1, used | {u, v}))
        return skip

    assert greedy * 2 >= brute(0, frozenset()) * 0.999


def test_matching_device_path_matches_host():
    edges = _random_edges(12, 40, 16, loops=False)
    host = weighted_matching(_stream(edges, 32, 8)).final_matching()
    dev = weighted_matching(_stream(edges, 32, 8), device=True
                            ).final_matching()
    assert host == dev


def test_matching_event_stream():
    edges = [(1, 2, 10.0), (3, 4, 10.0), (2, 3, 45.0)]
    evs = list(weighted_matching(_stream(edges, 8, 1)).events())
    assert [(e.type, frozenset((e.src, e.dst))) for e in evs] == [
        ("ADD", frozenset({1, 2})),
        ("ADD", frozenset({3, 4})),
        ("REMOVE", frozenset({1, 2})),
        ("REMOVE", frozenset({3, 4})),
        ("ADD", frozenset({2, 3})),
    ]


def test_matching_same_edge_rematch_single_remove():
    wm = weighted_matching(_stream([(1, 2, 10.0), (1, 2, 45.0)], 8, 1))
    evs = [(e.type, frozenset((e.src, e.dst)), e.weight)
           for e in wm.events()]
    assert evs == [
        ("ADD", frozenset({1, 2}), 10.0),
        ("REMOVE", frozenset({1, 2}), 10.0),
        ("ADD", frozenset({1, 2}), 45.0),
    ]
    assert wm.total_weight() == 45.0


def test_device_events_refused_and_empty_stream():
    with pytest.raises(NotImplementedError, match="host-path only"):
        list(weighted_matching(_stream([(1, 2, 1.0)], 8, 1),
                               device=True).events())
    empty = weighted_matching(_stream([], 8, 4))
    assert empty.final_matching() == [] and empty.total_weight() == 0


# ---------------------------------------------------------------------- #
# Against gelly_tpu on the same streams


def _both(edges, n_v, chunk, device=False, ids=None):
    """Final matchings and events of both packages over one stream (raw
    ids through a VertexTable, or identity slots with ``ids``)."""
    if ids is None:
        ts = _stream(edges, n_v, chunk)
        js = j_edges(edges, vertex_capacity=n_v, chunk_size=chunk)
    else:
        src = np.array([a for a, _, _ in edges], np.int64)
        dst = np.array([b for _, b, _ in edges], np.int64)
        w = np.array([x for _, _, x in edges], np.float64)
        ts = t_stream(TSource(src, dst, val=w, chunk_size=chunk,
                              table=TIdentity(n_v)), n_v, device="cpu")
        js = j_stream(JSource(src, dst, val=w, chunk_size=chunk,
                              table=JIdentity(n_v)), n_v)
    return (weighted_matching(ts, device=device),
            JM.weighted_matching(js, device=device))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed,n_e,n_v,chunk", [
    (1, 500, 16, 7), (2, 3000, 256, 128), (3, 1500, 64, 1000)])
def test_host_path_equals_jax(monkeypatch, native, seed, n_e, n_v, chunk):
    for mod in (TM, JM):
        monkeypatch.setattr(mod, "_NATIVE", None if native else False)
    edges = _random_edges(seed, n_e, n_v, wmax=300)
    t, j = _both(edges, n_v, chunk)
    assert list(t.events()) == list(j.events())
    assert t.final_matching() == j.final_matching()
    assert t.total_weight() == j.total_weight()
    t, j = _both(edges, n_v, chunk, ids=True)
    for a, b in zip(t, j):
        assert np.array_equal(a.partner, np.asarray(b.partner))
        assert a.weight.dtype == np.float64
        assert np.array_equal(a.weight, np.asarray(b.weight))


@pytest.mark.parametrize("seed,n_e,n_v,chunk", [
    (4, 400, 16, 9), (5, 1200, 128, 256)])
def test_device_path_equals_jax_state_by_state(seed, n_e, n_v, chunk):
    rng = np.random.default_rng(seed)
    # Weights with fractions, so f32 and f64 sums differ somewhere.
    edges = [(a, b, float(w) * f) for (a, b, w), f in zip(
        _random_edges(seed, n_e, n_v, wmax=40),
        rng.choice([1.0, 0.1, 0.3, 1 / 3], n_e))]
    t, j = _both(edges, n_v, chunk, device=True, ids=True)
    states = list(t)
    jstates = list(j)
    assert len(states) == len(jstates) == -(-n_e // chunk)
    for a, b in zip(states, jstates):
        assert a.weight.dtype == torch.float32
        assert np.array_equal(a.partner.numpy(), np.asarray(b.partner))
        assert np.array_equal(a.weight.numpy(), np.asarray(b.weight))


def test_device_fold_from_a_jax_state_equals_jax():
    """One step of each package's device fold from the same mid-stream
    state (carried with ``convert``)."""
    n_v = 64
    edges = _random_edges(6, 900, n_v, wmax=60)
    t, j = _both(edges, n_v, 300, device=True, ids=True)
    mid = list(j)[1]
    state = convert.matching_state_from_numpy(
        np.asarray(mid.partner), np.asarray(mid.weight), device="cpu")
    chunks_t = list(t.stream)
    chunks_j = list(j.stream)
    got = TM._matching_step(state, chunks_t[2])
    want = JM._matching_step(mid, chunks_j[2])
    p, w = convert.matching_state_to_numpy(got)
    assert np.array_equal(p, np.asarray(want.partner))
    assert np.array_equal(w, np.asarray(want.weight))


def test_matching_chunk_fold_binding_equals_jax():
    rng = np.random.default_rng(3)
    n_v, n = 100, 3000
    src = rng.integers(0, n_v, n).astype(np.int32)
    dst = rng.integers(0, n_v, n).astype(np.int32)
    w = rng.integers(1, 99, n).astype(np.float64)
    valid = rng.random(n) < 0.9
    outs = []
    for mod in (tnative, jnative):
        partner = np.full(n_v, -1, np.int32)
        weight = np.zeros(n_v, np.float64)
        ev = mod.matching_chunk_fold(src, dst, w, valid, n_v, partner,
                                     weight, want_events=True)
        none = mod.matching_chunk_fold(dst, src, w, None, n_v, partner,
                                       weight)
        outs.append((partner, weight, ev, none))
        with pytest.raises(ValueError, match="bad vertex slot"):
            mod.matching_chunk_fold(src + n_v, dst, w, None, n_v, partner,
                                    weight)
    (p1, w1, e1, n1), (p2, w2, e2, n2) = outs
    assert np.array_equal(p1, p2) and np.array_equal(w1, w2)
    assert n1 is None and n2 is None
    for a, b in zip(e1, e2):
        assert np.array_equal(a, b)
