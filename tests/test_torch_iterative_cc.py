"""gelly_torch's IterativeCCStream vs gelly_tpu's (CPU).

Holds every per-chunk ``Update`` (slots, labels, valid) and
``final_labels`` to ``gelly_tpu``'s on the same seeded streams (Zipf hubs,
self-loops, chains that merge across chunks, which need the label-pointer
chase). Against a numpy oracle (the minimum slot of each component, ``-1``
unseen): every label lies in its slot's component, and on the streams
where no component root goes stale, the labels are the oracle's. The
reference leaves a root stale when its component joins a smaller one in
a chunk the root is absent from; the port keeps that behaviour (a test
below shows it on the smallest input). Each fixpoint round is one counted
``host_sync``. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from gelly_torch.core.io import EdgeChunkSource as TSource
from gelly_torch.core.stream import edge_stream_from_source as t_stream
from gelly_torch.core.vertices import IdentityVertexTable as TIdentity
from gelly_torch.library import IterativeCCStream as TIter
from gelly_torch.library.connected_components import (
    cc_labels_numpy,
    connected_components,
)
from gelly_torch.ops import unionfind as tuf
from gelly_tpu.core.io import EdgeChunkSource as JSource
from gelly_tpu.core.stream import edge_stream_from_source as j_stream
from gelly_tpu.core.vertices import IdentityVertexTable as JIdentity
from gelly_tpu.library import IterativeCCStream as JIter


def _streams(src, dst, chunk, n_v):
    return (t_stream(TSource(src, dst, chunk_size=chunk,
                             table=TIdentity(n_v)), n_v, device="cpu"),
            j_stream(JSource(src, dst, chunk_size=chunk,
                             table=JIdentity(n_v)), n_v))


def _zipf(n_e, n_v, seed):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.4, n_e) % n_v).astype(np.int64)
    dst = rng.integers(0, n_v, n_e).astype(np.int64)
    src[::17] = dst[::17]  # self-loops
    return src, dst


def _chain(n_v):
    # Reversed chain pieces: each chunk links a higher block to a lower
    # one, so earlier chunks' labels go stale without the pointer chase.
    order = np.arange(n_v)[::-1]
    return order[:-1].astype(np.int64), order[1:].astype(np.int64)


# (kind, edges, slots, chunk, seed, oracle-exact?)
CASES = [("zipf", 300, 64, 32, 0, True), ("zipf", 500, 128, 50, 1, True),
         ("zipf", 200, 256, 7, 2, False), ("chain", None, 64, 5, None, True),
         ("chain", None, 128, 16, None, True)]


@pytest.mark.parametrize("kind,n_e,n_v,chunk,seed,exact", CASES)
def test_updates_and_final_labels_equal_jax(kind, n_e, n_v, chunk, seed,
                                            exact):
    src, dst = _zipf(n_e, n_v, seed) if kind == "zipf" else _chain(n_v)
    t, j = _streams(src, dst, chunk, n_v)
    tu = list(TIter(t))
    ju = list(JIter(j))
    assert len(tu) == len(ju)
    for a, b in zip(tu, ju):
        assert np.array_equal(a.slots.numpy(), np.asarray(b.slots))
        assert np.array_equal(a.values.numpy(), np.asarray(b.values))
        assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
    got = TIter(t).final_labels()
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JIter(j).final_labels()))
    oracle = cc_labels_numpy(src, dst, None, n_v)
    plan = connected_components(n_v, ingest_combine=False)
    assert np.array_equal(t.aggregate(plan).result().numpy(), oracle)
    lab = got.numpy()
    assert np.array_equal(lab < 0, oracle < 0)
    seen = lab >= 0
    # A label is a slot of the same component, never below its minimum.
    assert np.array_equal(oracle[lab[seen]], oracle[seen])
    assert (lab[seen] >= oracle[seen]).all()
    assert np.array_equal(lab, oracle) == exact


def test_stale_root_kept_as_the_reference_keeps_it():
    # Chunk 1 joins 12 and 40 (label 12); chunk 2 joins 40 to 0, and 12 is
    # absent from it: both packages leave 12 labelled 12 in component 0.
    src, dst = np.array([12, 40]), np.array([40, 0])
    t, j = _streams(src, dst, 1, 64)
    got = TIter(t).final_labels().numpy()
    assert np.array_equal(got, np.asarray(JIter(j).final_labels()))
    assert (got[0], got[12], got[40]) == (0, 12, 0)
    assert cc_labels_numpy(src, dst, None, 64)[12] == 0


def test_rounds_are_counted_host_syncs():
    src, dst = _chain(64)
    t, _ = _streams(src, dst, 5, 64)
    tuf.host_sync.count = 0
    TIter(t).final_labels()
    n_chunks = -(-src.size // 5)
    # Every chunk runs at least one round (the one that sees no change).
    assert tuf.host_sync.count >= 2 * n_chunks


def test_empty_stream_final_labels_all_unseen():
    src = np.zeros(0, np.int64)
    t, j = _streams(src, src, 4, 16)
    assert list(TIter(t)) == []
    assert np.array_equal(TIter(t).final_labels().numpy(),
                          np.full(16, -1, np.int32))
    assert np.array_equal(np.asarray(JIter(j).final_labels()),
                          np.full(16, -1, np.int32))
