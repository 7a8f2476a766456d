"""gelly_torch's vertex, degree and count streams vs gelly_tpu's (CPU).

Mirrors ``test_core.py``'s degree, vertex and count cases
(``TestGetDegrees``, ``TestNumberOfEntities`` on the canonical fixture)
and ``test_examples.py``'s deletion-honoring degree stream on the port,
then holds every ``Update`` (slots, values, valid) of ``get_vertices`` and
the three degree streams, and every value of ``number_of_edges`` and
``number_of_vertices``, to ``gelly_tpu``'s chunk by chunk on seeded
streams with deletions and padded last chunks. Tolerance: exact equality,
dtype included.
"""

import numpy as np
import pytest
import torch

from gelly_torch import edge_stream_from_edges
from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import Update
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.ops import segments as tseg
from gelly_torch.ops import unionfind as tuf
from gelly_tpu import edge_stream_from_edges as j_edges
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.ops import segments as jseg


def stream_of(edges, **kw):
    kw.setdefault("vertex_capacity", 64)
    kw.setdefault("chunk_size", 4)
    return edge_stream_from_edges(edges, device="cpu", **kw)


# ---------------------------------------------------------------------- #
# test_core.py's cases on the port


def test_get_vertices(reference_edges):
    s = stream_of(reference_edges)
    seen = []
    for upd in s.get_vertices():
        assert isinstance(upd, Update)
        seen.extend(i for i, _ in upd.to_pairs(s.ctx))
    assert sorted(seen) == [1, 2, 3, 4, 5]
    assert len(seen) == 5


def test_degrees(reference_edges):
    s = stream_of(reference_edges, chunk_size=3)
    assert s.get_degrees().final_degrees() == {1: 3, 2: 2, 3: 4, 4: 2, 5: 3}
    s = stream_of(reference_edges, chunk_size=3)
    assert s.get_out_degrees().final_degrees() == {1: 2, 2: 1, 3: 2, 4: 1,
                                                   5: 1}
    s = stream_of(reference_edges, chunk_size=3)
    assert s.get_in_degrees().final_degrees() == {1: 1, 2: 1, 3: 2, 4: 1,
                                                  5: 2}


def test_degrees_continuously_improving(reference_edges):
    s = stream_of(reference_edges, chunk_size=1)
    updates = [dict(u.to_pairs(s.ctx)) for u in s.get_degrees()]
    assert updates[0] == {1: 1, 2: 1}
    assert updates[1] == {1: 2, 3: 1}
    assert updates[-1][1] == 3 and updates[-1][5] == 3


def test_counts(reference_edges):
    s = stream_of(reference_edges, chunk_size=2)
    assert list(s.number_of_edges())[-1] == 7
    s = stream_of(reference_edges, chunk_size=2)
    counts = list(s.number_of_vertices())
    assert counts[-1] == 5
    assert counts == sorted(counts)


def _deletion_source():
    return TSource(np.array([1, 1, 1]), np.array([2, 3, 2]),
                   events=np.array([0, 0, 1], np.int8), chunk_size=2)


def test_deletion_events_decrement_degrees():
    make = lambda: t_stream(_deletion_source(), 16,  # noqa: E731
                            device="cpu")
    assert make().get_degrees().final_degrees() == {1: 1, 2: 0, 3: 1}
    assert list(make().number_of_edges())[-1] == 1


def test_degree_stream_honors_deletions():
    data = [(1, 2, 0), (2, 3, 0), (1, 4, 0), (2, 3, 1), (3, 4, 0), (1, 2, 1)]
    s = t_stream(TSource(np.array([e[0] for e in data]),
                         np.array([e[1] for e in data]),
                         events=np.array([e[2] for e in data], np.int8),
                         chunk_size=2), 16, device="cpu")
    assert s.get_degrees().final_degrees() == {1: 1, 2: 0, 3: 1, 4: 2}


def test_get_vertices_emits_raw_ids():
    big = 5_000_000_000
    s = stream_of([(big, 7, 1.0)])
    upds = list(s.get_vertices())
    assert sorted(i for u in upds for i, _ in u.to_pairs(s.ctx)) == [7, big]
    assert sorted(int(v) for u in upds for _, v in u.to_pairs(s.ctx)) == \
        [7, big]


def test_emissions_stay_on_the_stream_device(reference_edges):
    s = stream_of(reference_edges)
    upd = next(iter(s.get_degrees()))
    assert upd.values.dtype == torch.int64
    assert upd.slots.device == upd.values.device == s.ctx.device


def test_default_device_is_the_card(reference_edges):
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edge_stream_from_edges(reference_edges)


# ---------------------------------------------------------------------- #
# chunk by chunk against gelly_tpu


@pytest.mark.parametrize("seed", range(4))
def test_first_occurrence_mask_equals_gelly_tpu(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 32, 200).astype(np.int32)
    valid = rng.random(200) < 0.7
    want = np.asarray(jseg.first_occurrence_mask(keys, valid, 32))
    got = tseg.first_occurrence_mask(torch.from_numpy(keys),
                                     torch.from_numpy(valid), 32)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def _arrays(seed, n_e, n_v, deletions):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.4, n_e) % n_v
    dst = rng.zipf(1.4, n_e) % n_v
    ev = ((rng.random(n_e) < 0.25) if deletions
          else np.zeros(n_e, bool)).astype(np.int8)
    return src.astype(np.int64), dst.astype(np.int64), ev


def _pair(seed, deletions, chunk, n_v=128, n_e=333, raw_ids=False):
    src, dst, ev = _arrays(seed, n_e, n_v, deletions)
    if raw_ids:
        # Sparse raw ids through a VertexTable (first-seen slots).
        src, dst = src * 1_000_003 + 7, dst * 1_000_003 + 7
        return (t_stream(TSource(src, dst, events=ev, chunk_size=chunk),
                         n_v, device="cpu"),
                j_stream(JSource(src, dst, events=ev, chunk_size=chunk), n_v))
    return (t_stream(TSource(src, dst, events=ev, chunk_size=chunk,
                             table=TIdentity(n_v)), n_v, device="cpu"),
            j_stream(JSource(src, dst, events=ev, chunk_size=chunk,
                             table=JIdentity(n_v)), n_v))


def _same_updates(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(w, g):
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("deletions", [False, True])
@pytest.mark.parametrize("chunk", [16, 50])
@pytest.mark.parametrize("method", ["get_degrees", "get_out_degrees",
                                    "get_in_degrees", "get_vertices"])
def test_updates_equal_gelly_tpu(seed, deletions, chunk, method):
    ts, js = _pair(seed, deletions, chunk)
    _same_updates(getattr(ts, method)(), getattr(js, method)())


@pytest.mark.parametrize("method", ["get_degrees", "get_vertices"])
def test_updates_equal_gelly_tpu_through_a_vertex_table(method):
    ts, js = _pair(9, True, 40, raw_ids=True)
    _same_updates(getattr(ts, method)(), getattr(js, method)())
    ts, js = _pair(9, True, 40, raw_ids=True)
    pairs_t = [u.to_pairs(ts.ctx) for u in getattr(ts, method)()]
    pairs_j = [u.to_pairs(js.ctx) for u in getattr(js, method)()]
    assert pairs_t == pairs_j


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("deletions", [False, True])
@pytest.mark.parametrize("chunk", [16, 50])
def test_counts_equal_gelly_tpu(seed, deletions, chunk):
    ts, js = _pair(seed, deletions, chunk)
    before = tuf.host_sync.count
    edges = list(ts.number_of_edges())
    assert tuf.host_sync.count - before == len(edges)  # one per chunk
    assert edges == list(js.number_of_edges())
    ts, js = _pair(seed, deletions, chunk)
    assert list(ts.number_of_vertices()) == list(js.number_of_vertices())


@pytest.mark.parametrize("deletions", [False, True])
def test_final_degrees_equal_gelly_tpu(deletions):
    ts, js = _pair(4, deletions, 32)
    assert ts.get_degrees().final_degrees() == js.get_degrees().final_degrees()


def test_streams_restart_with_fresh_state(reference_edges):
    s = stream_of(reference_edges, chunk_size=2)
    first = s.get_degrees().final_degrees()
    assert s.get_degrees().final_degrees() == first
    assert list(s.number_of_vertices()) == list(s.number_of_vertices())
    assert j_edges(reference_edges, vertex_capacity=64, chunk_size=2) \
        .get_degrees().final_degrees() == first
