"""Named cases of the k = 2 chunk fold that hit the steps of
``csrc/spanner_fold_k2.cu`` one by one (no JAX: ``tests/test_torch_cuda.py``
runs them on the card against the plain fold, and
``tests/test_torch_spanner_fold_k2.py`` against ``gelly_tpu``).

Each case is ``(fields, src, dst, valid, D, sub)``: ``fields`` the summary
as numpy arrays in the wrapper's order (``nbr, deg, dover, esrc, edst, n,
overflow``), its earlier chunk folded by the port's plain fold on the CPU.
The special lanes use vertices below :data:`SPECIAL`; the random lanes
around them never do, so nothing else touches the rows a case is about.
:func:`check_reaches` asserts, on the summary a fold returned, that the
case does what its name says.
"""

import numpy as np
import torch

from gelly_torch.ops import kernels

N = 64
SPECIAL = 12  # vertices 0 .. SPECIAL - 1 are the cases' own

NAMES = ("orient-rev-lower", "orient-rev-higher", "ordered-pair-x3",
         "pass1-pass2-past-D", "pair-across-boundary", "subs-2-ragged",
         "subs-3-ragged")


def _fold(fields, src, dst, valid, D, sub):
    """``fields`` after the plain fold of the lanes (numpy in and out)."""
    t = [torch.from_numpy(np.array(f)) for f in fields]
    kernels.sparse_fold_chunk_k2_plain(
        *t, *(torch.from_numpy(np.asarray(x)) for x in (src, dst, valid)),
        D, sub)
    return [x.numpy() for x in t]


def _empty(D, E):
    return [np.full((N, D), -1, np.int32), np.zeros(N, np.int32),
            np.zeros((), np.int32), np.zeros(E, np.int32),
            np.zeros(E, np.int32), np.zeros((), np.int32),
            np.zeros((), bool)]


def _lanes(rng, L):
    src = (SPECIAL + rng.zipf(1.4, L) % (N - SPECIAL)).astype(np.int32)
    dst = rng.integers(SPECIAL, N, L).astype(np.int32)
    return src, dst, rng.random(L) < 0.9


def case(name):
    """``(fields, src, dst, valid, D, sub)`` of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    D, E, L, sub = 4, 400, 64, 16
    fields = _empty(D, E)
    if name.startswith("orient-"):
        # Row 0 full (D = 2) before 0 -> 1 was taken: that append was
        # dropped and 1 -> 0 landed, so 1 is not in row 0 but 0 is in
        # row 1, and the rows share nothing. Both orientations then come
        # in one sub-batch: (0, 1) clears the gate, (1, 0) does not.
        D = 2
        fields = _fold(_empty(D, E), np.array([0, 0, 0], np.int32),
                       np.array([2, 3, 1], np.int32), np.ones(3, bool), D, 1)
    if name == "subs-2-ragged":
        L = 2 * sub - 5
    elif name == "subs-3-ragged":
        L, sub = 3 * 13 - 7, 13
    src, dst, valid = _lanes(rng, L)
    if name == "orient-rev-lower":
        src[3], dst[3], src[7], dst[7] = 1, 0, 0, 1
    elif name == "orient-rev-higher":
        src[3], dst[3], src[7], dst[7] = 0, 1, 1, 0
    elif name == "ordered-pair-x3":
        src[[5, 9, 14]], dst[[5, 9, 14]] = 4, 5
        src[[20, 27]], dst[[20, 27]] = 6, 7  # and one pair twice
    elif name == "pass1-pass2-past-D":
        # Row 0 holds one entry; then in one sub-batch it is the source
        # of two lanes and the destination of two: 4 appends, 3 slots.
        D = 4
        fields = _fold(_empty(D, E), np.array([0], np.int32),
                       np.array([11], np.int32), np.ones(1, bool), D, 1)
        src[[2, 6, 9, 12]] = [0, 3, 0, 4]
        dst[[2, 6, 9, 12]] = [1, 0, 2, 0]
    elif name == "pair-across-boundary":
        # The last lane of sub-batch 0 and the first of sub-batch 1 hold
        # one pair; lanes 31 and 32 a pair reversed across the next seam.
        src[15], dst[15], src[16], dst[16] = 2, 3, 2, 3
        src[31], dst[31], src[32], dst[32] = 4, 5, 5, 4
    special = (src < SPECIAL) | (dst < SPECIAL)
    valid[special] = True
    return fields, src, dst, valid, D, sub


def _new_edges(before, after):
    """The ``(u, v)`` pairs the fold appended to the edge list."""
    n0, n1 = int(before[5]), int(after[5])
    return list(zip(after[3][n0:n1].tolist(), after[4][n0:n1].tolist()))


def check_reaches(name, before, src, dst, valid, D, sub, after):
    """Assert that the case reaches what it names, on the summary
    ``after`` that a fold of it returned (numpy fields, wrapper order)."""
    new = _new_edges(before, after)
    nbr0 = before[0]
    if name.startswith("orient-"):
        assert 1 not in nbr0[0] and 0 in nbr0[1]
        assert not (set(nbr0[0][nbr0[0] >= 0]) & set(nbr0[1]))
        lanes = {(int(src[i]), int(dst[i])): i for i in (3, 7)}
        assert lanes[(0, 1)] // sub == lanes[(1, 0)] // sub
        lower = lanes[(1, 0)] < lanes[(0, 1)]
        assert lower == (name == "orient-rev-lower")
        # Only the orientation that clears the gate is kept.
        assert new.count((0, 1)) == 1 and (1, 0) not in new
    elif name == "ordered-pair-x3":
        assert {i // sub for i in (5, 9, 14)} == {0}
        assert new.count((4, 5)) == 1 and new.count((6, 7)) == 1
    elif name == "pass1-pass2-past-D":
        assert int(before[1][0]) == 1
        assert int(after[2]) > int(before[2])  # deg_overflow
        assert int(after[1][0]) == D
        # One slot left after two pass-1 appends: lane order, pass 1 first.
        assert after[0][0].tolist() == [11, 1, 2, 3]
    elif name == "pair-across-boundary":
        assert 15 // sub == 0 and 16 // sub == 1
        assert 31 // sub == 1 and 32 // sub == 2
        assert new.count((2, 3)) == 1
        assert ((4, 5) in new) != ((5, 4) in new)
    else:
        subs = -(-src.shape[0] // sub)
        assert subs == (2 if name == "subs-2-ragged" else 3)
        assert src.shape[0] % sub != 0
        live = valid & (src != dst)
        assert int(after[5]) > int(before[5])
        assert live[(subs - 1) * sub:].any()
